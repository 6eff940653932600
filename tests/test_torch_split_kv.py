"""Split-KV decode of the port on the CPU: gloo ranks stand in for the
cards (one spawn a mesh shape, as ``test_torch_mesh_serving.py``).

The port's ``build_decode_step(mesh=)`` under the decode rules
(``sharding.decode_rules``: rows over data, each dense KV and MLA latent
cache split by position over model, a batch that does not split over the
data axis replicated with the positions over (data, model)) is held to
JAX's ``repro.training.steps.build_decode_step`` on one device, on the
same carried parameters (``convert.params_from_flat`` of JAX's packed
8-bit tree) and the same numpy-filled caches, with each row's cursor
placed before, at and past a block's edge so that a step writes on one
rank and then on the next, and some ranks' blocks hold no valid key:

* gemma3-smoke (global dense caches beside head-sharded rings, qk-norm)
  on (2, 2) with B = 4 and on (1, 2) with B = 1;
* zamba2-smoke (the shared block's cache, its QKV held whole) on (2, 2)
  with B = 1 (the batch-1 override: four blocks over data and model) and
  on (1, 2) with B = 2;
* deepseek-smoke (MLA's ``c_kv`` and ``k_rope``, heads gathered before
  the partial attention) on (2, 2) with B = 1 and on (1, 2) with B = 2;
* granite-smoke, a plain GQA config, on (2, 2) with B = 4: two rows a
  rank over data, the positions over model.

Each case takes 4 decode steps on JAX's greedy tokens. Tolerances: the
logits within ``LOGIT_ATOL`` of JAX's and ``SPLIT_ATOL`` of the port's
one-device step on the same process (the merge sums the blocks in
another order, so floats are held to a tolerance, not bit for bit);
every greedy token equals JAX's wherever the top-2 gap is above
``LOGIT_ATOL`` (a closer step is printed, as H17's test prints its tie).
After every step each rank's cache shards equal the one-device step's
caches sliced to the rank's placement: bit for bit at every position no
step has written yet, within ``CACHE_ATOL`` at the written ones (a
rank's rows go through its GEMMs alone, and a CPU GEMM sums another
row count in another order), and every cursor bit for bit. No rank's
row count is cut to 1 where the one device's is larger: a CPU
``torch.matmul`` at M = 1 sums in another order (ROADMAP), and a Q_A code
that flips there moves gemma3's logits by 9e-3, which is not the split
under test; at B = 1 both sides run M = 1.

Unit cases: the merge over four ranks' blocks (two of them with no valid
key) equals a one-block softmax within 1e-6 and an empty block adds
exactly nothing; a rank's Q_A scale is the whole batch's; every cache
leaf's placement equals JAX's ``spec_for`` under the same rules (rings and
recurrent state: the port's documented placement).
"""
import pickle
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

MAX_LEN = 32
STEPS = 4
FMT_BITS = 8
LOGIT_ATOL = 1e-5
SPLIT_ATOL = 2e-6
CACHE_ATOL = 1e-6
# (name, arch, global batch, each row's cursor)
CASES = {
    (2, 2): [("gemma3-b4", "gemma3-12b", 4, [6, 13, 2, 15]),
             ("granite-b4", "granite-8b", 4, [3, 14, 15, 20]),
             ("zamba2-b1", "zamba2-7b", 1, [6]),
             ("deepseek-b1", "deepseek-v3-671b", 1, [15])],
    (1, 2): [("gemma3-b1", "gemma3-12b", 1, [14]),
             ("zamba2-b2", "zamba2-7b", 2, [5, 16]),
             ("deepseek-b2", "deepseek-v3-671b", 2, [7, 15])],
}
ARCHS = ("gemma3-12b", "granite-8b", "zamba2-7b", "deepseek-v3-671b")


def _key(path):
    return "::".join(str(k) for k in path)


def _fill(shapes, idx, seed):
    """Numpy values for every cache leaf (``key -> (shape, dtype
    name)``): cursors at ``idx``, the rest standard normal / 2."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, (shape, dt) in sorted(shapes.items()):
        if key.endswith("idx"):
            out[key] = np.broadcast_to(np.asarray(idx, np.int32),
                                       shape).copy()
        else:
            out[key] = (rng.standard_normal(shape) / 2).astype(dt)
    return out


# ---------------------------------------------------------------------------
# the ranks (no JAX is imported here)


def _port_caches(cfg, B, values):
    from repro_torch.models.model import init_caches
    from repro_torch.tree import leaves
    caches = init_caches(B, MAX_LEN, cfg, device="cpu")
    for path, leaf in leaves(caches):
        leaf.copy_(torch.from_numpy(values[_key(path)]))
    return caches


def _case(mesh, name, arch, B, idx, flat, values, tokens):
    from repro_torch.configs import get_rules, get_smoke_config
    from repro_torch.convert import params_from_flat
    from repro_torch.core.lns import LNSFormat
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.distributed.params_sharding import (batch_rows,
                                                         shard_tree)
    from repro_torch.distributed.sharding import decode_rules, shard_ctx
    from repro_torch.models.model import init_caches
    from repro_torch.training.steps import build_decode_step
    from repro_torch.tree import leaves, tree_map
    cfg = get_smoke_config(arch)
    qcfg = QuantConfig.lns_madam()
    rules = decode_rules(cfg, mesh, B, get_rules(arch))
    full = params_from_flat(flat, LNSFormat(FMT_BITS, 8), device="cpu")
    local = shard_tree(full, mesh, rules)
    whole = _port_caches(cfg, B, values)
    mine = shard_tree(_port_caches(cfg, B, values), mesh, rules,
                      caches=True, cfg=cfg)
    with shard_ctx(mesh, rules):
        shapes = {_key(p): tuple(t.shape) for p, t in
                  leaves(init_caches(B, MAX_LEN, cfg, device="meta"))}
    out = {"shapes_match": shapes == {_key(p): tuple(t.shape)
                                       for p, t in leaves(mine)},
           "logits": [], "one_logits": [], "caches_equal": [],
           "rows": None}
    split = build_decode_step(cfg, qcfg, mesh=mesh, rules=rules)
    one = build_decode_step(cfg, qcfg)
    pos = np.asarray(idx, np.int32)
    rows = batch_rows({"r": torch.arange(B)}, mesh, rules)["r"]
    out["rows"] = rows.tolist()
    for t in range(STEPS):
        batch = {"tokens": tokens[t]}
        before = tree_map(torch.clone, whole)
        got, back = split(local, mine, batch, torch.from_numpy(pos + t))
        want, _ = one(full, whole, batch, torch.from_numpy(pos + t))
        assert back is mine
        out["logits"].append(got.numpy().copy())
        out["one_logits"].append(want[rows].numpy().copy())
        sliced = shard_tree(whole, mesh, rules, caches=True, cfg=cfg)
        # what the one-device steps wrote so far, placed as the shard
        now = tree_map(torch.ne, whole, before)
        ever = now if t == 0 else tree_map(torch.logical_or, ever, now)
        wrote = shard_tree(ever, mesh, rules, caches=True, cfg=cfg)
        eq = {}
        for (p, a), (_, b), (_, w) in zip(leaves(mine), leaves(sliced),
                                          leaves(wrote)):
            d = (a.to(torch.float64) - b.to(torch.float64)).abs()
            tol = 0.0 if p[-1] == "idx" else CACHE_ATOL
            eq[_key(p)] = (float(d[~w].max()) if (~w).any() else 0.0,
                           float(d[w].max()) if w.any() else 0.0, tol)
        out["caches_equal"].append(eq)
    return out


def _merge_case(group, r, n):
    """Four ranks' blocks of 8 positions: a query at position 13 sees
    blocks 0 and 1; blocks 2 and 3 hold no valid key. The merged output
    against ``_attend_plain`` over the whole 32 positions."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.attention import (_attend_plain,
                                              merge_partials,
                                              partial_attend)
    cfg = get_smoke_config("gemma3-12b")
    rng = np.random.default_rng(11)
    B, L, h, kv, hd = 2, 8, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, 1, h, hd)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((B, n * L, kv, hd)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((B, n * L, kv, hd)).astype(
        np.float32))
    q_abs = torch.tensor([[13], [9]])
    lo = r * L
    m, l, o = partial_attend(q, k[:, lo:lo + L], v[:, lo:lo + L],
                             lo + torch.arange(L), q_abs, cfg, chunk=3)
    got = merge_partials(m, l, o, group).permute(0, 3, 1, 2, 4).reshape(
        B, 1, h, hd)
    slot = torch.arange(n * L)
    want = _attend_plain(q, k, v, q_abs, slot[None].expand(B, n * L),
                         slot[None] < q_abs + 1, cfg, None)
    empty = bool((m == float("-inf")).all()) and bool((l == 0).all()) \
        and bool((o == 0).all())
    return dict(err=float((got - want).abs().max()), empty=empty,
                finite=bool(torch.isfinite(got).all()))


def _scale_case(mesh, rules):
    """Rows over data: a rank's Q_A statistic, reduced over the batch
    group, against the whole batch's scale (rank 1's rows are 8x
    larger, so a rank's own scale would differ)."""
    from repro_torch.core.lns import LNSFormat, compute_scale
    from repro_torch.core.quantizer import global_stat
    from repro_torch.distributed.params_sharding import batch_rows
    from repro_torch.distributed.sharding import batch_group, shard_ctx
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, 1, 16), generator=g)
    x[2:] *= 8.0
    with shard_ctx(mesh, rules):
        mine = batch_rows({"x": x}, mesh)["x"]
        st = global_stat(mine, LNSFormat(8, 8), None, batch_group())
    return (torch.equal(st.reshape(()), compute_scale(x).reshape(())),
            torch.equal(compute_scale(mine).reshape(()),
                        compute_scale(x).reshape(())))


def _rank(r, n, store, shape, jobs, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=r,
                            world_size=n)
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import decode_rules
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(*shape, device="cpu")
    out = {"cases": {}}
    for name, arch, B, idx, flat, values, tokens in jobs:
        collectives.reset_counts()
        out["cases"][name] = _case(mesh, name, arch, B, idx, flat, values,
                                   tokens)
        out["cases"][name]["collectives"] = collectives.counts()
    if shape == (2, 2):
        world = dist.new_group(list(range(n)))
        out["merge"] = _merge_case(world, r, n)
        rules = decode_rules(get_smoke_config("granite-8b"), mesh, 4)
        out["scale"] = _scale_case(mesh, rules)
    with open(Path(out_dir) / f"rank{r}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: JAX's side, then one spawn a mesh shape


def _flat(tree):
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "::".join(str(getattr(k, "key", getattr(k, "idx",
                                                      getattr(k, "name", k))))
                        for k in path)
        out[key] = np.array(leaf)
    return out


def _jax_case(params, arch, B, idx, seed):
    """JAX's one-device decode over the numpy-filled caches: the caches'
    values, the greedy tokens fed at each step and the logits."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.core.lns import LNSFormat
    from repro.core.quantizer import QuantConfig
    from repro.kernels import dispatch as jd
    from repro.models import init_caches
    from repro.optim.madam import MadamConfig
    from repro.training import build_decode_step
    cfg = get_smoke_config(arch)
    shapes = jax.eval_shape(lambda: init_caches(B, MAX_LEN, cfg))
    values = _fill({k: (v.shape, np.dtype(v.dtype).name)
                    for k, v in _flat_shapes(shapes).items()}, idx, seed)
    caches = jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(values[_jkey(p)]), shapes)
    mcfg = MadamConfig(update_format=LNSFormat(bits=FMT_BITS, gamma=8))
    step = jax.jit(build_decode_step(cfg, QuantConfig.lns_madam(), mcfg))
    rng = np.random.default_rng(seed + 1)
    tok = rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32)
    tokens, logits = [], []
    pos = np.asarray(idx, np.int32)
    with jd.configured(backend="reference"):
        for t in range(STEPS):
            tokens.append(tok)
            lg, caches = step(params, caches, {"tokens": jnp.asarray(tok)},
                              jnp.asarray(pos + t))
            lg = np.asarray(lg)
            logits.append(lg)
            tok = np.argmax(lg, axis=-1).astype(np.int32)[:, None]
    return values, tokens, logits


def _jkey(path):
    return "::".join(str(getattr(k, "key", getattr(k, "idx",
                                                   getattr(k, "name", k))))
                     for k in path)


def _flat_shapes(tree):
    import jax
    return {_jkey(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def split_run():
    """JAX's draws and decode steps, then one spawn of gloo ranks a mesh
    shape. Returns ``({name: (jax tokens, jax logits)}, {shape: per-rank
    results})``."""
    import jax
    import torch.multiprocessing as mp
    from repro.configs import get_smoke_config
    from repro.core.lns import LNSFormat
    from repro.optim.madam import MadamConfig
    from repro.training import init_train_state
    mcfg = MadamConfig(update_format=LNSFormat(bits=FMT_BITS, gamma=8))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    params, flats = {}, {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        params[arch] = jax.jit(lambda k: init_train_state(k, cfg, mcfg)
                               .params)(jax.random.PRNGKey(0))
        flats[arch] = _flat(params[arch])
    ref, jobs = {}, {}
    for shape, cases in CASES.items():
        jobs[shape] = []
        for i, (name, arch, B, idx) in enumerate(cases):
            values, tokens, logits = _jax_case(params[arch], arch, B, idx,
                                               seed=10 * i + B)
            ref[name] = (tokens, logits)
            jobs[shape].append((name, arch, B, idx, flats[arch], values,
                                tokens))
    with tempfile.TemporaryDirectory() as d:
        procs = {}
        for shape in CASES:
            n = shape[0] * shape[1]
            sub = Path(d) / f"{shape[0]}x{shape[1]}"
            sub.mkdir()
            procs[shape] = (n, sub, mp.start_processes(
                _rank, args=(n, f"{sub}/store", shape, jobs[shape],
                             str(sub)),
                nprocs=n, join=False, start_method="spawn"))
        out = {}
        for shape, (n, sub, ctx) in procs.items():
            while not ctx.join():
                pass
            out[shape] = [pickle.loads((sub / f"rank{r}.pkl").read_bytes())
                          for r in range(n)]
    torch.set_num_threads(threads)
    return ref, out


@pytest.mark.parametrize("shape,name", [(s, c[0]) for s, cs in CASES.items()
                                        for c in cs])
def test_split_decode_equals_jax_one_device(split_run, shape, name):
    ref, out = split_run
    jtok, jlog = ref[name]
    for r, res in enumerate(out[shape]):
        case = res["cases"][name]
        rows = case["rows"]
        assert case["shapes_match"], (name, r)
        for t in range(STEPS):
            got, want = case["logits"][t], jlog[t][rows]
            assert got.shape == want.shape and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL,
                                       err_msg=f"{name} rank {r} step {t}")
            np.testing.assert_allclose(got, case["one_logits"][t], rtol=0,
                                       atol=SPLIT_ATOL)
            srt = np.sort(want, axis=-1)
            clear = srt[:, -1] - srt[:, -2] > LOGIT_ATOL
            if not clear.all():
                print(f"{name} rank {r} step {t}: top-2 gap under "
                      f"{LOGIT_ATOL} in rows {np.flatnonzero(~clear)}")
            nxt = np.argmax(got, axis=-1)
            assert (nxt[clear] == np.argmax(want, axis=-1)[clear]).all(), (
                name, r, t)
            bad = [(k, e) for k, e in case["caches_equal"][t].items()
                   if e[0] > 0 or e[1] > e[2]]
            assert not bad, f"{name} rank {r} step {t}: {bad}"


def test_split_decode_merges_over_kv_seq(split_run):
    """Each case's step takes one MAX and one SUM reduce a split layer;
    the rows split only where the batch divides the data axis."""
    out = split_run[1]
    for shape, cases in CASES.items():
        for name, arch, B, idx in cases:
            for res in out[shape]:
                c = res["cases"][name]
                assert c["collectives"]["sum"] > 0, (shape, name)
                assert c["collectives"]["max_reduce"] > 0, (shape, name)
            rows = [res["cases"][name]["rows"] for res in out[shape]]
            if B % shape[0] == 0:
                assert sorted(sum(rows[::shape[1]], [])) == list(range(B))
            else:
                assert all(r == list(range(B)) for r in rows)


def test_merge_matches_one_block_softmax(split_run):
    for res in split_run[1][(2, 2)]:
        assert res["merge"]["err"] < 1e-6 and res["merge"]["finite"]
    # ranks 2 and 3 hold no valid key: their partials are exactly nothing
    assert [res["merge"]["empty"] for res in split_run[1][(2, 2)]] == [
        False, False, True, True]


def test_merge_of_one_block_is_its_softmax():
    """No group: the merge normalises the block, and a row whose block
    holds no valid key gives 0, not NaN."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.attention import (_attend_plain,
                                              merge_partials,
                                              partial_attend)
    cfg = get_smoke_config("gemma3-12b")
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 1, 4, 16), generator=g)
    k = torch.randn((2, 10, 2, 16), generator=g)
    v = torch.randn((2, 10, 2, 16), generator=g)
    q_abs = torch.tensor([[4], [-1]])
    m, l, o = partial_attend(q, k, v, torch.arange(10), q_abs, cfg, chunk=4)
    got = merge_partials(m, l, o, None).permute(0, 3, 1, 2, 4).reshape(
        2, 1, 4, 16)
    slot = torch.arange(10)[None].expand(2, 10)
    want = _attend_plain(q[:1], k[:1], v[:1], q_abs[:1], slot[:1],
                         slot[:1] <= 4, cfg, None)
    torch.testing.assert_close(got[:1], want, rtol=0, atol=1e-6)
    assert torch.equal(got[1], torch.zeros_like(got[1]))


def test_rank_scale_is_the_whole_batch(split_run):
    for res in split_run[1][(2, 2)]:
        shared, own = res["scale"]
        assert shared
    # the rank holding the small rows would take a smaller scale alone
    assert not all(res["scale"][1] for res in split_run[1][(2, 2)])


class _Mesh:
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.mark.parametrize("arch", ["gemma3-12b", "zamba2-7b",
                                  "deepseek-v3-671b", "smollm-135m",
                                  "granite-8b", "rwkv6-1.6b"])
@pytest.mark.parametrize("mesh,B", [({"data": 2, "model": 2}, 4),
                                    ({"data": 2, "model": 2}, 1),
                                    ({"data": 1, "model": 4}, 1),
                                    ({"pod": 2, "data": 2, "model": 2}, 8)])
def test_cache_placement_equals_jax_spec_for(arch, mesh, B):
    """Every cache leaf's placement under the decode rules against JAX's
    ``spec_for`` under ``get_rules(arch)`` with its batch-1 override:
    equal for the dense KV caches and MLA latents, the cursors and the
    paged pools; a ring keeps JAX's rows and heads by the serving rules
    with its slots whole, recurrent state JAX's rows only."""
    import jax
    from repro.configs import get_rules as j_rules
    from repro.configs import get_smoke_config as j_smoke
    from repro.distributed import params_sharding as jps
    from repro.distributed import sharding as jsh
    from repro.models import init_caches as j_init_caches
    from repro_torch.configs import get_rules, get_smoke_config
    from repro_torch.distributed import params_sharding as tps
    from repro_torch.distributed import sharding as tsh
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    m = _Mesh(mesh)
    rules = tsh.decode_rules(cfg, m, B, get_rules(arch))
    # the port's rows go over the data axes only and its KV heads as its
    # weights hold them (``decode_rules``)
    jrules = dict(j_rules(arch), batch=("pod", "data"),
                  kv_heads=rules["kv_heads"])
    if B % tsh.batch_divisor(m):
        jrules.update(batch=None, kv_seq=("data", "model"))
    jc = jax.eval_shape(lambda: j_init_caches(B, 16, jcfg))
    want = {_jkey(p): a for p, a in jax.tree_util.tree_flatten_with_path(
        jps.cache_logical_axes(jc), is_leaf=lambda x: isinstance(x, tuple)
        and all(e is None or isinstance(e, str) for e in x))[0]}
    prefix, _, period = cfg.layer_pattern()
    seen = set()
    for key, jaxes in want.items():
        parts = key.split("::")
        kind = (prefix[int(parts[1])] if parts[0] == "prefix"
                else period[int(parts[1][3:])])
        name = parts[-1]
        axes = tps.cache_leaf_axes(name, len(jaxes), kind)
        assert tps.cache_leaf_axes(name, len(jaxes)) == tuple(jaxes)
        got = tsh.spec_for(axes, m, rules)
        jspec = tuple(jsh.spec_for(jaxes, m, jrules))
        jspec = jspec + (None,) * (len(jaxes) - len(jspec))
        got = got + (None,) * (len(jaxes) - len(got))
        if kind == "local" and name in ("k", "v", "k_scale", "v_scale"):
            b = list(jaxes).index("batch")
            assert got[b] == jspec[b], (arch, key)
            assert got[b + 1] is None, (arch, key)
            assert got[b + 2] == tsh.spec_for(("kv_heads",), m, rules)[0]
        elif kind in tps.STATE_KINDS:
            b = list(jaxes).index("batch")
            assert got[b] == jspec[b], (arch, key)
            assert all(e is None for i, e in enumerate(got) if i != b)
        else:
            assert got == jspec, (arch, key, got, jspec)
            seen.add(name)
    if arch in ("gemma3-12b", "zamba2-7b", "granite-8b", "smollm-135m"):
        assert {"k", "v", "idx"} <= seen
    if arch == "deepseek-v3-671b":
        assert {"c_kv", "k_rope", "idx"} <= seen

