"""Mesh serving of the port on the CPU: gloo ranks stand in for the cards.

The JAX package's mesh contract (``tests/test_mesh_serving.py``) held
against the port: the port's ``Engine(mesh=)`` on a ``(2, 2)`` and a
``(1, 2)`` mesh must give, stream for stream, the tokens of JAX's
``Engine`` on the same carried parameters (JAX's packed 8-bit tree
through ``convert.params_from_flat``, each rank slicing its shard). The
greedy rows of JAX's trace are held to JAX's engine; its seeded rows to
the port's one-device engine, because the port's seeded noise is its
own (ROADMAP H4: a counter hash, not JAX's stream). Every row is also
held to the port's one-device engine. The cases:

* smollm-smoke, dense and paged on demand, speculation k = 0 and 2, on
  JAX's mixed greedy and seeded trace (3 heads over 1 KV head cannot
  split: the MLP is column-parallel, attention replicated);
* gemma3-smoke head-sharded (4 / 2 heads over model = 2: the paged global
  layers through K5's plain version by head group, the ring layers on
  head-sharded rings, qk-norm and Q_A's per-tensor scales max-reduced);
* kimi-smoke expert-parallel and head-sharded. JAX's streams are its
  engine's with the mesh's dispatch groups (``_dp_groups`` = the data
  axis, patched on JAX's single device: the groups set the capacity, the
  placement changes no value).

deepseek-smoke admits and completes with ``w_up`` sharded on its expert
dim; the (2, 2) mesh holds ``up`` column-parallel and ``down`` whole;
an abort returns every page; ``dispatch.paged_attend`` by head group,
heads gathered, is bitwise the unsharded call at JAX's case shapes; a per-tensor scale of a
head-sharded tensor whose ranks' maxima differ equals the whole tensor's
(and a rank's own scale would not); ``make_host_mesh`` raises on a mesh
the world does not fill; the compression psums over a 2-rank group equal
JAX's per-rank quantization summed (codes equal, values within H12's
scale error, ROADMAP). Every rank's streams are rank 0's.

Each mesh shape is one ``torch.multiprocessing`` spawn of gloo ranks
(file store, loopback) that runs every scenario; the ranks import no JAX.
Tolerances: token streams, page counts and kernel outputs exact;
compressed sums within 1e-6 relative.
"""
import pickle
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

MAX_LEN = 32
FMT_BITS = 8
# (name, arch, engine kwargs)
SCENARIOS = [
    ("smollm-dense-k0", "smollm-135m", dict(num_slots=3, speculate_k=0)),
    ("smollm-dense-k2", "smollm-135m", dict(num_slots=3, speculate_k=2)),
    ("smollm-paged-k0", "smollm-135m",
     dict(num_slots=3, speculate_k=0, page_size=8, alloc_policy="ondemand",
          num_pages=10)),
    ("smollm-paged-k2", "smollm-135m",
     dict(num_slots=3, speculate_k=2, page_size=8, alloc_policy="ondemand",
          num_pages=10)),
    ("gemma3", "gemma3-12b", dict(num_slots=2, page_size=8, num_pages=12)),
    ("kimi", "kimi-k2-1t-a32b", dict(num_slots=2, page_size=8,
                                     num_pages=12)),
]
# capacity couples the rows of a call (ROADMAP H18), so a seeded row's own
# tokens would move kimi's greedy rows off JAX's: its trace is greedy
GREEDY = {"kimi"}
MESHES = {(2, 2): [s[0] for s in SCENARIOS],
          (1, 2): ["smollm-paged-k2", "gemma3", "kimi"]}
# carried from JAX; deepseek (admission and completion only) is the port's
# own draw
ARCHS = ("smollm-135m", "gemma3-12b", "kimi-k2-1t-a32b")


def _trace(vocab: int, n: int = 6, seed: int = 0, greedy: bool = False):
    """JAX's ``_trace`` as plain data: ``(rid, prompt, max_new, (temp,
    top_k, seed) or None)``, greedy and seeded rows interleaved (all
    greedy with ``greedy``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(3, 10))
        prompt = rng.integers(1, vocab, size=(plen,)).tolist()
        samp = (0.7, 40, 1000 + i) if i % 2 and not greedy else None
        out.append((i, prompt, int(rng.integers(4, 10)), samp))
    return out


# ---------------------------------------------------------------------------
# the ranks (no JAX is imported here)


def _requests(vocab, n=6, greedy=False):
    from repro_torch.server.sampling import SamplingParams
    from repro_torch.serving import Request
    return [Request(rid=i, prompt=p, max_new_tokens=m,
                    sampling=None if s is None else SamplingParams(
                        temperature=s[0], top_k=s[1], seed=s[2]))
            for i, p, m, s in _trace(vocab, n, greedy=greedy)]


def _streams(eng):
    return {rs.request.rid: list(rs.generated)
            for rs in eng.finished + eng.aborted}


def _engine(arch, flats, mesh, **kw):
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_flat
    from repro_torch.core.lns import LNSFormat
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.serving import Engine
    cfg = get_smoke_config(arch)
    if arch in flats:
        params = params_from_flat(flats[arch], LNSFormat(FMT_BITS, 8),
                                  device="cpu")
    else:
        from repro_torch.models.model import init_params
        from repro_torch.optim.madam import MadamConfig, lns_leaf_encoder
        params = init_params(cfg, device="cpu", leaf_fn=lns_leaf_encoder(
            MadamConfig(update_format=LNSFormat(FMT_BITS, 8))))
    return cfg, Engine(cfg, QuantConfig.lns_madam(), params, max_len=MAX_LEN,
                       mesh=mesh, **kw)


def _paged_attend_case(quantized, group, r, m):
    """JAX's ``test_paged_attend_shard_map_bitwise`` case: B 2, S 1, 8
    heads over 4 KV heads, head_dim 16, 6 pages of 8 (+ the null page):
    K5's plain version on this rank's head group and its pools' KV
    group, the heads all-gathered (attention's paged path), against the
    whole call."""
    from repro_torch.core.lns import LNSFormat
    from repro_torch.distributed import collectives
    from repro_torch.kernels import dispatch
    B, S, h, kv, hd, pages, page = 2, 1, 8, 4, 16, 6, 8
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, S, h, hd)).astype(np.float32))
    if quantized:
        kp = torch.from_numpy(rng.integers(0, 255, (pages + 1, page, kv, hd))
                              .astype(np.uint8))
        vp = torch.from_numpy(rng.integers(0, 255, (pages + 1, page, kv, hd))
                              .astype(np.uint8))
        ks = torch.exp2(torch.from_numpy(rng.integers(
            -2, 3, (pages + 1, page, kv, 1)).astype(np.float32))).to(
            torch.bfloat16)
        vs = torch.ones((pages + 1, page, kv, 1), dtype=torch.bfloat16)
        fmt = LNSFormat(8, 8)
    else:
        kp = torch.from_numpy(rng.standard_normal((pages + 1, page, kv, hd))
                              .astype(np.float32))
        vp = torch.from_numpy(rng.standard_normal((pages + 1, page, kv, hd))
                              .astype(np.float32))
        ks = vs = fmt = None
    bt = torch.tensor([[0, 2, pages], [1, 3, pages]], dtype=torch.int32)
    ln = torch.tensor([9, 13], dtype=torch.int32)
    kw = dict(fmt=fmt, softcap=None, sm_scale=hd ** -0.5)
    want = dispatch.paged_attend(q, kp, vp, ks, vs, bt, ln, **kw)
    hs, gs = slice(r * h // m, (r + 1) * h // m), slice(r * kv // m,
                                                       (r + 1) * kv // m)
    part = lambda t: None if t is None else t[:, :, gs].contiguous()
    got = collectives.gather(dispatch.paged_attend(
        q[:, :, hs].contiguous(), part(kp), part(vp), part(ks), part(vs),
        bt, ln, **kw), group, dim=2)
    return torch.equal(got, want)


def _global_scale_case(group, r, m):
    """q-like ``(2, 3, 8, 16)`` of magnitudes 2^-U·10 (U uniform), head
    group i scaled by 2^(10·i): Q_A on a rank's heads with the group
    equals the whole tensor's Q_A there. Q_log under a power-of-two scale
    moves only where the grid's range clips, so a smaller group's own
    scale keeps values that the whole tensor's range flushes to its
    smallest code: without the reduce that rank differs."""
    from repro_torch.core.lns import LNSFormat
    from repro_torch.core.quantizer import ste_quantize, ste_quantize_sharded
    fmt = LNSFormat(8, 8)
    g = torch.Generator().manual_seed(7)
    x = torch.exp2(-10 * torch.rand((2, 3, 8, 16), generator=g))
    x = torch.where(torch.rand(x.shape, generator=g) < 0.5, -x, x)
    for i in range(m):
        x[:, :, i * 8 // m:(i + 1) * 8 // m] *= 2.0 ** (10 * i)
    sl = slice(r * 8 // m, (r + 1) * 8 // m)
    whole = ste_quantize(x, fmt, None)[:, :, sl]
    loc = x[:, :, sl].contiguous()
    # with a second operand in the same collective, as attention's q, k, v
    shared, other = ste_quantize_sharded([loc, loc * 0.5], fmt, group)
    return (torch.equal(shared, whole)
            and torch.equal(other, ste_quantize(x * 0.5, fmt, None)[:, :, sl]),
            torch.equal(ste_quantize(loc, fmt, None), whole))


def _compression_case(group, r):
    from repro_torch.core.lns import LNSFormat
    from repro_torch.optim.compression import (lns_compressed_psum,
                                               sign_majority_psum)
    g, res = _compression_inputs(r)
    fmt = LNSFormat(8, 8)
    plain, none = lns_compressed_psum(g, group, fmt)
    summed, new_res = lns_compressed_psum(g, group, fmt, residuals=res)
    votes = sign_majority_psum(g, group)
    as_np = lambda t: {"a": t["a"].numpy(), "b": [t["b"][0].numpy()]}
    return dict(plain=as_np(plain), none=none, summed=as_np(summed),
                res=as_np(new_res), votes=as_np(votes))


def _compression_inputs(r):
    rng = np.random.default_rng(100 + r)
    g = {"a": torch.from_numpy((rng.standard_normal((8, 16)) * (r + 1))
                               .astype(np.float32)),
         "b": [torch.from_numpy(rng.standard_normal(5).astype(np.float32))]}
    res = {"a": torch.from_numpy((rng.standard_normal((8, 16)) * 1e-2)
                                 .astype(np.float32)),
           "b": [torch.zeros(5)]}
    return g, res


def _rank(r, n, store, shape, flats, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=r,
                            world_size=n)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(*shape, device="cpu")
    root = mesh.rank == 0
    out = {"streams": {}}
    try:
        make_host_mesh(n, 2, device="cpu")
    except ValueError as e:
        out["oversubscribed"] = str(e)
    names = MESHES[shape]
    for name, arch, kw in SCENARIOS:
        if name not in names:
            continue
        cfg, eng = _engine(arch, flats, mesh, **kw)
        eng.run(_requests(cfg.vocab_size, greedy=name in GREEDY) if root
                else ())
        out["streams"][name] = _streams(eng)
        if eng.allocator is not None:
            out.setdefault("pages_back", {})[name] = (
                eng.allocator.available == eng.num_pages)
        if name == "smollm-dense-k0":
            mlp = eng.params["period"]["pos0"]["mlp"]
            out["up"] = tuple(mlp["up"].packed.shape)
            out["down"] = tuple(mlp["down"].packed.shape)
        if name == "gemma3":
            out["gemma3_pool"] = tuple(
                eng.caches["period"]["pos5"]["kp"].shape)
    if shape == (2, 2):
        # deepseek: expert-parallel MLA with the dense latent cache
        cfg, eng = _engine("deepseek-v3-671b", flats, mesh, num_slots=2)
        from repro_torch.serving import Request
        eng.run([Request(rid=i, prompt=[1 + i, 2, 3], max_new_tokens=4)
                 for i in range(3)] if root else ())
        out["deepseek"] = dict(
            w_up=tuple(eng.params["period"]["pos0"]["moe"]["w_up"]
                       .packed.shape),
            finished=sorted((rs.request.rid, len(rs.generated))
                            for rs in eng.finished))
        # abort: one running request, then drain; every page comes back
        cfg, eng = _engine("smollm-135m", flats, mesh, num_slots=3,
                           page_size=8, alloc_policy="ondemand",
                           num_pages=10)
        if root:
            for req in _requests(cfg.vocab_size, 4):
                eng.submit(req)
        for _ in range(3):
            eng.step()
        running = sorted(rs.request.rid
                         for rs in eng.scheduler.running.values())
        if root:
            eng.abort(running[0])
        eng.run(())
        out["abort"] = dict(running=running, aborted=[
            rs.request.rid for rs in eng.aborted],
            pages_back=eng.allocator.available == eng.num_pages)
        grp, m, mr = mesh.group("model"), 2, mesh.coords["model"]
        out["paged_attend"] = [_paged_attend_case(qz, grp, mr, m)
                               for qz in (False, True)]
        out["global_scale"] = _global_scale_case(grp, mr, m)
        out["compression"] = _compression_case(mesh.group("data"),
                                               mesh.coords["data"])
    with open(Path(out_dir) / f"rank{r}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: JAX's side, then one spawn a mesh shape


def _flat(params):
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "::".join(str(getattr(k, "key", getattr(k, "idx",
                                                      getattr(k, "name", k))))
                        for k in path)
        out[key] = np.array(leaf)
    return out


def _jax_streams(flats, params):
    """JAX's engine streams and the port's one-device engine's for every
    (mesh shape, scenario); the data axis sets both packages' MoE
    dispatch groups (JAX's ``_dp_groups`` and the port's patched)."""
    from repro.configs import get_smoke_config
    from repro.core.lns import LNSFormat
    from repro.core.quantizer import QuantConfig
    from repro.kernels import dispatch as jd
    from repro.models import moe as jmoe
    from repro.optim.madam import MadamConfig
    from repro.server.sampling import SamplingParams
    from repro.serving import Engine, Request
    from repro_torch.models import moe as tmoe
    mcfg = MadamConfig(update_format=LNSFormat(bits=FMT_BITS, gamma=8))
    want, port = {}, {}
    kws = {name: (arch, kw) for name, arch, kw in SCENARIOS}
    real_groups, real_tgroups = jmoe._dp_groups, tmoe._dp_groups
    for shape, names in MESHES.items():
        for name in names:
            arch, kw = kws[name]
            cfg = get_smoke_config(arch)
            greedy = name in GREEDY
            key = (arch, tuple(sorted(kw.items())),
                   shape[0] if arch == "kimi-k2-1t-a32b" else 1)
            if key not in want:
                jmoe._dp_groups = tmoe._dp_groups = lambda: key[2]
                try:
                    tcfg, teng = _engine(arch, flats, None, device="cpu",
                                         **kw)
                    teng.run(_requests(tcfg.vocab_size, greedy=greedy))
                    with jd.configured(backend="reference"):
                        eng = Engine(cfg, QuantConfig.lns_madam(), mcfg,
                                     params[arch], max_len=MAX_LEN, **kw)
                        eng.run([Request(
                            rid=i, prompt=p, max_new_tokens=m,
                            sampling=None if s is None else SamplingParams(
                                temperature=s[0], top_k=s[1], seed=s[2]))
                            for i, p, m, s in _trace(cfg.vocab_size,
                                                     greedy=greedy)])
                finally:
                    jmoe._dp_groups, tmoe._dp_groups = (real_groups,
                                                        real_tgroups)
                want[key] = {rs.request.rid: list(rs.generated)
                             for rs in eng.finished}
                port[key] = _streams(teng)
            want[(shape, name)], port[(shape, name)] = want[key], port[key]
    return want, port


@pytest.fixture(scope="module")
def mesh_run():
    """One spawn of gloo ranks a mesh shape, started as soon as JAX's
    draws are carried; JAX's engines and the port's one-device engines run
    in this process meanwhile. Returns ``(jax streams, port streams,
    each shape's per-rank results)``."""
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
    with tempfile.TemporaryDirectory() as d:
        procs = {}
        for shape in MESHES:
            n = shape[0] * shape[1]
            sub = Path(d) / f"{shape[0]}x{shape[1]}"
            sub.mkdir()
            procs[shape] = (n, sub, mp.start_processes(
                _rank, args=(n, f"{sub}/store", shape, flats, str(sub)),
                nprocs=n, join=False, start_method="spawn"))
        want, port = _jax_streams(flats, params)
        out = {}
        for shape, (n, sub, ctx) in procs.items():
            while not ctx.join():
                pass
            out[shape] = [pickle.loads((sub / f"rank{r}.pkl").read_bytes())
                          for r in range(n)]
    torch.set_num_threads(threads)
    return want, port, out


@pytest.fixture(scope="module")
def ranks(mesh_run):
    return mesh_run[2]


@pytest.mark.parametrize("shape,name", [(s, n) for s, ns in MESHES.items()
                                        for n in ns])
def test_mesh_streams_equal_jax_engine(mesh_run, shape, name):
    want, port, ranks = mesh_run
    seeded = {i for i, _, _, s in _trace(512) if s is not None}
    for r, res in enumerate(ranks[shape]):
        got = res["streams"][name]
        assert got == port[(shape, name)], (
            f"{shape} {name} rank {r}: a stream left the port's one-device "
            f"engine's")
        assert set(got) == set(want[(shape, name)]), (shape, name, r)
        for rid in set(want[(shape, name)]) - seeded:
            assert got[rid] == want[(shape, name)][rid], (
                f"{shape} {name} rank {r} rid {rid}: the greedy stream "
                f"left JAX's")
        if name in res.get("pages_back", {}):
            assert res["pages_back"][name]


def test_mesh_weights_actually_sharded(ranks):
    """(2, 2): smollm's d_ff 128 splits over model = 2 (``up`` holds 64
    columns a rank), ``down`` keeps its 128 rows; gemma3's pools hold one
    of its two KV heads a rank."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("smollm-135m")
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    for res in ranks[(2, 2)]:
        assert res["up"] == (L, d, f // 2)
        assert res["down"] == (L, f, d)
        assert res["gemma3_pool"][-2:] == (1, 16)


def test_mesh_sharded_moe_admits_and_completes(ranks):
    for res in ranks[(2, 2)]:
        # (stack, experts, embed, moe_ff): 8 experts, 4 a rank
        assert res["deepseek"]["w_up"][:2] == (2, 4)
        assert res["deepseek"]["finished"] == [(0, 4), (1, 4), (2, 4)]


def test_mesh_abort_returns_pages_to_baseline(ranks):
    first = ranks[(2, 2)][0]["abort"]
    assert first["running"], "nothing admitted: the harness is broken"
    for res in ranks[(2, 2)]:
        assert res["abort"]["running"] == first["running"]
        assert res["abort"]["aborted"] == [first["running"][0]]
        assert res["abort"]["pages_back"]


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_attend_head_groups_bitwise(ranks, quantized):
    for res in ranks[(2, 2)]:
        assert res["paged_attend"][int(quantized)]


def test_global_scale_of_a_head_sharded_tensor(ranks):
    """The group's MAX reduce gives every rank the whole tensor's Q_A;
    without it the smaller head group's own scale quantizes differently
    (so this test fails if the reduce is removed)."""
    shared = [res["global_scale"] for res in ranks[(2, 2)]]
    assert all(with_group for with_group, _ in shared)
    assert not all(alone for _, alone in shared)


def test_make_host_mesh_refuses_a_mesh_the_world_does_not_fill(ranks):
    from repro_torch.launch.mesh import make_host_mesh
    for res in ranks[(2, 2)]:
        assert "needs 8 processes but the world has 4" in res[
            "oversubscribed"]
    with pytest.raises(ValueError, match="torchrun"):
        make_host_mesh(2, 2, device="cpu")


def test_compression_psums_match_jax_per_rank_quantization(ranks):
    """Two ranks of the data axis: each contribution quantized per tensor
    (JAX's ``lns_quantize``) and summed; with residuals, error feedback;
    signSGD's majority vote exactly."""
    import jax.numpy as jnp
    from repro.core.lns import LNSFormat, lns_quantize
    fmt = LNSFormat(bits=8, gamma=8)
    per = [_compression_inputs(r) for r in range(2)]
    flat = lambda t: [t["a"], t["b"][0]]

    def jq(x):
        return np.asarray(lns_quantize(jnp.asarray(x), fmt, scale_axis=None))

    for rank, res in enumerate(ranks[(2, 2)]):
        got = res["compression"]
        assert got["none"] is None
        for i in range(2):
            plain = sum(jq(flat(g)[i].numpy()) for g, _ in per)
            locs = [flat(g)[i].numpy() + flat(r)[i].numpy() for g, r in per]
            summed = sum(jq(x) for x in locs)
            np.testing.assert_allclose(flat(got["plain"])[i], plain,
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(flat(got["summed"])[i], summed,
                                       rtol=1e-6, atol=0)
            votes = np.sign(sum(np.sign(flat(g)[i].numpy()) for g, _ in per))
            np.testing.assert_array_equal(flat(got["votes"])[i], votes)
        # this rank's residual: its own contribution minus its quantization
        r = rank // 2                    # the rank's data index
        for i in range(2):
            loc = flat(per[r][0])[i].numpy() + flat(per[r][1])[i].numpy()
            np.testing.assert_allclose(flat(got["res"])[i], loc - jq(loc),
                                       rtol=1e-5, atol=1e-6)


def test_mesh_ranks_agree(ranks):
    for shape, per in ranks.items():
        for res in per[1:]:
            assert res["streams"] == per[0]["streams"], shape
