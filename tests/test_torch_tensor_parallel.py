"""JAX's (data, model) placement for prefill and training, on the CPU:
gloo ranks stand in for the cards (one spawn a mesh shape, as
``test_torch_split_kv.py`` and ``test_torch_data_parallel.py``).

Under ``sharding.data_rules`` the rows of the global batch split over the
data axes and the weights sit on the serving rules: column-parallel
``up``/``gate`` (and ``wq``/``wk``/``wv`` where both head counts divide
the model axis), every other leaf whole. Two smoke configs of the dense
family cover both kinds of split:

* smollm-smoke: the MLP split (d_ff 128), the heads whole (3 heads over
  1 KV head do not divide 2);
* gemma3-smoke: 4 heads over 2 KV heads split at m = 2 beside the MLP,
  qk-norm gains read inside the split heads, local (window 8) and global
  layers.

Both run on (1, 2) and (2, 2), against JAX's one-device step
(``repro.training``) and the port's own one-process step, on the same
numpy parameters (JAX's draws, carried with ``repro_torch.convert``) and
``SyntheticLM`` batches of 4 x 16.

Tolerances and why:

* Prefill (the 8-bit serving words). Every rank holds only its rows'
  last-position logits. Against JAX: within ``PREFILL_ATOL`` (2e-5, the
  dense variants' f32 logit bound). Against the port's one-process
  prefill: bit for bit. A rank's rows go through K2's plain version at
  another row count and the column blocks at their own width, and on
  this CPU both sum each output in the same order (measured on both
  meshes and both configs), so nothing is reordered.
* Training (lns8, 2 steps, the 16-bit update store). Against the
  port's one-process step: the forward is the same computation (step 0's
  loss equal within 1e-7 relative, measured), but the backward sums
  each column-parallel GEMM's input gradient over the model group, a
  reordering of the one device's sum; Q_E then flips a code wherever a
  reordered value sits on a rounding tie, and the flips compound down
  the layers as ``test_torch_train.py`` describes for JAX against the
  port. On this CPU, from the carried state, both configs happen to sum
  in the one process's order and equal its words over both steps (the
  test prints the share apart); on the card they part (``chip_smoke.py``
  phase 31). So the limits are ``test_torch_train.py``'s
  lns8 limits against JAX, for both references: step-0 loss rtol 1e-5,
  losses rtol 1e-3, grad norms 10%, and after step 1 at most 2% of the
  words apart (a word moves by 16 codes at step 1, so a parted word is a
  gradient whose sign flipped at a tie: the H6 band), the share printed.
  The rank's words are the concatenated column shards of each split leaf
  (every model-group rank's block in rank order), so the whole tree is
  compared. Every model-group rank's whole (replicated) leaves equal
  each other bit for bit after every step, and every data-group rank's
  words equal each other's.
* The observed step (``numerics=True``, Q_G only so the gradients agree
  up to the reordered sums): each leaf's K4 and encode-site statistics
  are the whole leaf's, within ``STATS_RTOL`` of the one-process step's
  (fractions within one element of ``STATS_ATOL``).
* The trap: with ``model > 1``, a gradient through the model group's
  gathers (the MLP's hidden state, the attention heads) equals the one
  process's within ``TRAP_ATOL`` (f32, no quantizer, gradients of
  magnitude ~1: the input's gradient is the sum of the ranks' halves of
  the contraction, measured 1.9e-6 from the one process's), and a plain
  ``collectives.gather`` of a tensor that requires a gradient raises.

The other families keep raising at ``model > 1``, each naming its family
and ROADMAP 7j (no gloo needed: the check reads the mesh's shape).
"""
import contextlib
import pickle
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCHS = ("smollm-135m", "gemma3-12b")
MESHES = [(1, 2), (2, 2)]
BATCH, SEQ, STEPS = 4, 16, 2
PREFILL_ATOL = 2e-5
STEP0_RTOL, LOSS_RTOL, GNORM_RTOL, WORD_SHARE = 1e-5, 1e-3, 0.1, 0.02
STATS_RTOL, STATS_ATOL = 1e-4, 1e-3
TRAP_ATOL = 1e-5


def _qcfg(name="lns8"):
    from repro_torch.core.lns import LNSFormat
    from repro_torch.core.quantizer import QuantConfig
    if name == "grad":
        return QuantConfig(grad=LNSFormat(8, 8))
    return QuantConfig.lns_madam()


def _batches(arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.training.data import SyntheticLM
    data = SyntheticLM(get_smoke_config(arch), batch=BATCH, seq=SEQ)
    return [data.batch_at(i) for i in range(STEPS)]


def _words(params):
    from repro_torch.checkpoint.manager import flatten_state
    return {k: v for k, v in flatten_state(params).items()
            if k.endswith("packed")}


def _stats(m):
    return {part: {leaf: {k: float(v) for k, v in st.items()}
                   for leaf, st in m["numerics"][part].items()}
            for part in ("update", "grad_encode")}


def _port_train(flat, arch, mesh=None, rules=None, q="lns8", steps=STEPS,
                numerics=False):
    """The port's steps from a carried state (this rank's shard of it
    under ``mesh``): per step (loss, grad norm, words), and the observed
    step's statistics with ``numerics``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import train_state_from_flat
    from repro_torch.distributed.sharding import shard_ctx
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.steps import (build_train_step,
                                            shard_train_state)
    cfg = get_smoke_config(arch)
    ts = train_state_from_flat(flat, MadamConfig(), device="cpu")
    ctx = (shard_ctx(mesh, rules) if mesh is not None
           else contextlib.nullcontext())
    out = []
    with ctx:
        if mesh is not None:
            ts = shard_train_state(ts, mesh, rules)
        step = build_train_step(cfg, _qcfg(q), MadamConfig(),
                                numerics=numerics)
        for b in _batches(arch)[:steps]:
            ts, m = step(ts, b)
            out.append((float(m["loss"]), float(m["grad_norm"]),
                        _words(ts.params)))
    return (out, _stats(m)) if numerics else out


def _port_prefill(flat, arch, mesh=None, rules=None):
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_flat
    from repro_torch.core.lns import LNSFormat
    from repro_torch.distributed.params_sharding import shard_tree
    from repro_torch.training.steps import build_prefill_step
    cfg = get_smoke_config(arch)
    params = params_from_flat(flat, LNSFormat(8, 8), device="cpu")
    if mesh is not None:
        params = shard_tree(params, mesh, rules)
    step = build_prefill_step(cfg, _qcfg(), mesh=mesh, rules=rules)
    return step(params, _batches(arch)[0]).numpy()


# ---------------------------------------------------------------------------
# the ranks (no JAX is imported here)


def _trap(mesh):
    """f32, no quantizer: the MLP and gemma3's attention under the mesh,
    the gradients of the input and of every weight the rank holds; and a
    plain gather of a tensor that requires a gradient."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import (axis_group, data_rules,
                                                  shard_ctx)
    out = {}
    for name, x, p in _trap_inputs():
        cfg = get_smoke_config("gemma3-12b")
        rules = data_rules(cfg, mesh)
        with shard_ctx(mesh, rules):
            got = _trap_grads(name, x, p, cfg, mesh, rules)
        out[name] = got
    with shard_ctx(mesh, data_rules(get_smoke_config("gemma3-12b"), mesh)):
        y = torch.ones((2, 3), requires_grad=True) * 2.0
        try:
            collectives.gather(y, axis_group("mlp"))
            out["plain_gather"] = None
        except RuntimeError as e:
            out["plain_gather"] = str(e)
    return out


def _trap_inputs():
    """Numpy-drawn input rows and f32 weights of gemma3-smoke's MLP and
    attention (one layer)."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("gemma3-12b")
    rng = np.random.default_rng(7)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    draw = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(
        np.float32)
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    mlp = {"up": draw(d, f), "gate": draw(d, f), "down": draw(f, d)}
    attn = {"wq": draw(d, h * hd), "wk": draw(d, kv * hd),
            "wv": draw(d, kv * hd), "wo": draw(h * hd, d),
            "q_norm": rng.standard_normal(hd).astype(np.float32) / 4,
            "k_norm": rng.standard_normal(hd).astype(np.float32) / 4}
    return [("mlp", x, mlp), ("attn", x, attn)]


def _trap_grads(name, x, p, cfg, mesh=None, rules=None):
    from repro_torch.distributed.params_sharding import shard_tree
    from repro_torch.models.attention import attn_apply
    from repro_torch.models.layers import mlp_apply
    xt = torch.from_numpy(x).requires_grad_(True)
    tree = {k: torch.from_numpy(v) for k, v in p.items()}
    tree = {"layer": {name: tree}}
    if mesh is not None:
        tree = shard_tree(tree, mesh, rules)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tree["layer"][name].items()}
    if name == "mlp":
        y = mlp_apply(leaves, xt, cfg, None)
    else:
        y = attn_apply(leaves, xt, cfg, None,
                       positions=torch.arange(x.shape[1]))
    (y * torch.linspace(-1, 1, y.shape[-1])).square().sum().backward()
    return {"x": xt.grad.numpy().copy(),
            **{k: v.grad.numpy().copy() for k, v in leaves.items()}}


def _rank(r, n, store, shape, flats, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=r,
                            world_size=n)
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import collectives
    from repro_torch.distributed.params_sharding import batch_rows
    from repro_torch.distributed.sharding import data_rules, shard_ctx
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(*shape, device="cpu")
    out = {"coords": dict(mesh.coords)}
    for arch in ARCHS:
        rules = data_rules(get_smoke_config(arch), mesh, BATCH)
        with shard_ctx(mesh, rules):
            rows = batch_rows({"r": torch.arange(BATCH)}, mesh)["r"]
        collectives.reset_counts()
        out[arch] = {
            "rows": rows.tolist(),
            "prefill": _port_prefill(flats[arch]["serve"], arch, mesh,
                                     rules),
            "prefill_collectives": collectives.counts()}
        collectives.reset_counts()
        out[arch]["train"] = _port_train(flats[arch]["train"], arch, mesh,
                                         rules)
        out[arch]["train_collectives"] = collectives.counts()
        out[arch]["train_bytes"] = collectives.byte_counts()
    if shape == (1, 2):
        rules = data_rules(get_smoke_config("gemma3-12b"), mesh, BATCH)
        out["numerics"] = _port_train(flats["gemma3-12b"]["train"],
                                      "gemma3-12b", mesh, rules, q="grad",
                                      steps=1, numerics=True)[1]
        out["trap"] = _trap(mesh)
    with open(Path(out_dir) / f"rank{r}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: JAX's side and the port's one-process references, then the
# ranks' results


def _flat(tree):
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "::".join(str(getattr(k, "key", getattr(k, "idx",
                                                      getattr(k, "name", k))))
                        for k in path)
        out[key] = np.array(leaf)
    return out


def _jax_refs(arch, train_state, serve_params):
    """JAX's one-device prefill on the 8-bit words and its lns8 steps."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.core.quantizer import QuantConfig as JQ
    from repro.kernels import dispatch as jd
    from repro.optim.madam import MadamConfig as JM
    from repro.training import build_prefill_step, build_train_step
    cfg = get_smoke_config(arch)
    batches = _batches(arch)
    with jd.configured(backend="reference"):
        pre = jax.jit(build_prefill_step(cfg, JQ.lns_madam()))
        logits = np.asarray(pre(serve_params, {
            "tokens": jnp.asarray(batches[0]["tokens"])}))
        step = jax.jit(build_train_step(cfg, JQ.lns_madam(), JM()))
        state, steps = train_state, []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            words = {k: v for k, v in _flat(state.params).items()
                     if k.endswith("packed")}
            steps.append((float(m["loss"]), float(m["grad_norm"]), words))
    return logits, steps


@pytest.fixture(scope="module")
def tp_run():
    import jax
    import torch.multiprocessing as mp
    from repro.configs import get_smoke_config as j_smoke
    from repro.core.lns import LNSFormat as JFormat
    from repro.optim.madam import MadamConfig as JM
    from repro.training import init_train_state as j_init
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    states, serve, flats = {}, {}, {}
    for arch in ARCHS:
        c = j_smoke(arch)
        states[arch] = jax.jit(lambda k, c=c: j_init(k, c, JM()))(
            jax.random.PRNGKey(0))
        serve[arch] = jax.jit(lambda k, c=c: j_init(
            k, c, JM(update_format=JFormat(bits=8, gamma=8))).params)(
                jax.random.PRNGKey(0))
        flats[arch] = {"train": _flat(states[arch]),
                       "serve": _flat(serve[arch])}
    with tempfile.TemporaryDirectory() as d:
        procs = {}
        for shape in MESHES:
            n = shape[0] * shape[1]
            sub = Path(d) / f"{shape[0]}x{shape[1]}"
            sub.mkdir()
            procs[shape] = (n, sub, mp.start_processes(
                _rank, args=(n, f"{sub}/store", shape, flats, str(sub)),
                nprocs=n, join=False, start_method="spawn"))
        jax_ref, one = {}, {}
        for arch in ARCHS:
            jax_ref[arch] = _jax_refs(arch, states[arch], serve[arch])
            one[arch] = {"prefill": _port_prefill(flats[arch]["serve"],
                                                  arch),
                         "train": _port_train(flats[arch]["train"], arch)}
        one["numerics"] = _port_train(flats["gemma3-12b"]["train"],
                                      "gemma3-12b", q="grad", steps=1,
                                      numerics=True)[1]
        from repro_torch.configs import get_smoke_config
        one["trap"] = {name: _trap_grads(name, x, p,
                                         get_smoke_config("gemma3-12b"))
                       for name, x, p in _trap_inputs()}
        out = {}
        for shape, (n, sub, ctx) in procs.items():
            while not ctx.join():
                pass
            out[shape] = [pickle.loads((sub / f"rank{r}.pkl").read_bytes())
                          for r in range(n)]
    torch.set_num_threads(threads)
    return jax_ref, one, out


def _whole(ranks, arch, i, shape):
    """Step ``i``'s words of the data-group-0 ranks with each split
    leaf's column shards concatenated in model-group order."""
    group = [res for res in ranks if res["coords"]["data"] == 0]
    group.sort(key=lambda res: res["coords"]["model"])
    parts = [res[arch]["train"][i][2] for res in group]
    out = {}
    for k, w in parts[0].items():
        if all(p[k].shape == w.shape and np.array_equal(p[k], w)
               for p in parts):
            out[k] = w
        else:
            out[k] = np.concatenate([p[k] for p in parts], axis=-1)
    return out


def _word_diffs(a, b):
    n = tot = 0
    for k in b:
        x, y = a[k].astype(np.int64), b[k].astype(np.int64)
        assert x.shape == y.shape, (k, x.shape, y.shape)
        n += int((x != y).sum())
        tot += x.size
    return n, tot


def _hold(got, ref, what):
    for i, ((gl, gn, _), (rl, rn, _)) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(gl, rl, rtol=STEP0_RTOL if i == 0
                                   else LOSS_RTOL,
                                   err_msg=f"{what}: loss, step {i}")
        np.testing.assert_allclose(gn, rn, rtol=GNORM_RTOL,
                                   err_msg=f"{what}: grad norm, step {i}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_prefill_rows_over_data_equal_jax_one_device(tp_run, shape, arch):
    """Each rank's rows of last-position logits: JAX's within
    ``PREFILL_ATOL``, the port's one-process prefill bit for bit; the
    rank holds its rows only, and where the rows split its Q_A scales
    came from MAX reduces."""
    jax_ref, one, out = tp_run
    want, mine = jax_ref[arch][0], one[arch]["prefill"]
    np.testing.assert_allclose(mine, want, rtol=0, atol=PREFILL_ATOL)
    seen = []
    for r, res in enumerate(out[shape]):
        got, rows = res[arch]["prefill"], res[arch]["rows"]
        assert len(rows) == BATCH // shape[0], (r, rows)
        assert got.shape == (len(rows), want.shape[-1])
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want[rows], rtol=0,
                                   atol=PREFILL_ATOL,
                                   err_msg=f"{arch} {shape} rank {r}")
        assert np.array_equal(got, mine[rows]), (
            f"{arch} {shape} rank {r}: not the one-process logits, max "
            f"apart {np.abs(got - mine[rows]).max()}")
        if shape[0] > 1:   # Q_A's scales over the data group
            assert res[arch]["prefill_collectives"]["max_reduce"] > 0
        seen += rows if res["coords"]["model"] == 0 else []
    assert sorted(seen) == list(range(BATCH))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_train_step_tracks_jax_and_one_process(tp_run, shape, arch):
    jax_ref, one, out = tp_run
    ranks = out[shape]
    r0 = ranks[0][arch]["train"]
    for r, res in enumerate(ranks):
        got = res[arch]["train"]
        assert [x[:2] for x in got] == [x[:2] for x in r0], (
            f"{arch} {shape} rank {r}: losses or grad norms differ")
    _hold(r0, one[arch]["train"], "one process")
    _hold(r0, jax_ref[arch][1], "JAX")
    for i in range(STEPS):
        whole = _whole(ranks, arch, i, shape)
        for what, ref in (("one process", one[arch]["train"][i][2]),
                          ("JAX", jax_ref[arch][1][i][2])):
            n, tot = _word_diffs(whole, ref)
            print(f"{arch} {shape} step {i}: {n} of {tot} words "
                  f"({n / tot:.3%}) apart from {what}")
            if i == 0:
                assert n <= WORD_SHARE * tot, (
                    f"{arch} {shape} step 1: {n / tot:.3%} of the words "
                    f"apart from {what} (limit {WORD_SHARE:.0%})")
    c = ranks[0][arch]["train_collectives"]
    assert c["gather"] > 0 and c["sum"] > 0 and c["max_reduce"] > 0, c
    assert "model" in ranks[0][arch]["train_bytes"]["by_axis"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_whole_leaves_equal_across_the_model_group(tp_run, shape, arch):
    """After every step, each whole leaf is bit-equal on every rank, and
    a split leaf's shard is equal on the ranks of its data group."""
    ranks = tp_run[2][shape]
    split = set()
    for i in range(STEPS):
        for res in ranks:
            w, w0 = res[arch]["train"][i][2], ranks[0][arch]["train"][i][2]
            for k in w0:
                if w[k].shape == w0[k].shape and np.array_equal(w[k], w0[k]):
                    continue
                same_cols = [x for x in ranks if x["coords"]["model"]
                             == res["coords"]["model"]]
                assert all(np.array_equal(x[arch]["train"][i][2][k], w[k])
                           for x in same_cols), (arch, shape, k, i)
                split.add(k)
        assert all(k.endswith("packed") for k in split)
    mlp = {k for k in split if "::mlp::" in k}
    attn = {k for k in split if "::attn::" in k}
    assert mlp and all(k.split("::")[-2] in ("up", "gate") for k in mlp)
    if arch == "gemma3-12b":
        assert {k.split("::")[-2] for k in attn} == {"wq", "wk", "wv"}
    else:
        assert not attn


def test_observed_step_reports_whole_leaf_stats(tp_run):
    one, ranks = tp_run[1]["numerics"], tp_run[2][(1, 2)]
    for r, res in enumerate(ranks):
        for part in ("update", "grad_encode"):
            assert set(res["numerics"][part]) == set(one[part])
            for leaf, st in one[part].items():
                for k, v in st.items():
                    got = res["numerics"][part][leaf][k]
                    assert abs(got - v) <= STATS_ATOL * abs(v) + (
                        STATS_RTOL if k != "scale_log2" else 0.0) or \
                        abs(got - v) <= STATS_RTOL * abs(v), (
                            r, part, leaf, k, got, v)


def test_gathers_carry_their_gradient(tp_run):
    """The trap: at m = 2 the input's and every held weight's gradient
    through the model group's gathers equal the one process's (the rank's
    columns of a split weight), and a plain gather that requires a
    gradient raises."""
    one, ranks = tp_run[1]["trap"], tp_run[2][(1, 2)]
    for res in ranks:
        m = res["coords"]["model"]
        assert res["trap"]["plain_gather"] and "gather_with_grad" in \
            res["trap"]["plain_gather"]
        for name, grads in one.items():
            got = res["trap"][name]
            for k, want in grads.items():
                g = got[k]
                if g.shape != want.shape:       # the rank's columns
                    w = g.shape[-1]
                    want = want[..., m * w:(m + 1) * w]
                assert np.abs(g).max() > 0, (name, k)
                np.testing.assert_allclose(g, want, rtol=0, atol=TRAP_ATOL,
                                           err_msg=f"{name} {k} rank {m}")


class _Mesh:
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "phi-3-vision-4.2b",
                                  "musicgen-medium", "rwkv6-1.6b",
                                  "zamba2-7b"])
def test_other_families_raise_at_model_above_one(arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import data_rules, shard_ctx
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.steps import build_train_step
    cfg = get_smoke_config(arch)
    mesh = _Mesh({"data": 1, "model": 2})
    with shard_ctx(mesh, data_rules(cfg, mesh)):
        with pytest.raises(NotImplementedError) as e:
            build_train_step(cfg, _qcfg(), MadamConfig())
    assert cfg.family in str(e.value) and "ROADMAP 7j" in str(e.value)


def test_data_rules_refuse_a_batch_that_does_not_split():
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (LOGICAL_RULES, data_rules,
                                                  decode_rules,
                                                  serving_rules)
    cfg = get_smoke_config("gemma3-12b")
    mesh = _Mesh({"pod": 2, "data": 2, "model": 2})
    rules = data_rules(cfg, mesh, 8)
    assert rules == dict(serving_rules(cfg, mesh),
                         batch=LOGICAL_RULES["batch"])
    with pytest.raises(ValueError, match="batch of 6.*pod\\+data"):
        data_rules(cfg, mesh, 6)
    # decode keeps its batch-1 override instead of refusing, and the dry
    # run's prefill replicates such a batch (JAX's dry run overrides
    # ``batch`` for any cell its data axes do not divide)
    assert decode_rules(cfg, mesh, 1)["batch"] is None
    from repro_torch.launch.dryrun import cell_rules
    assert cell_rules("gemma3-12b", cfg, "prefill", mesh, 6)["batch"] is None
    assert cell_rules("gemma3-12b", cfg, "prefill", mesh, 8) == rules
    with pytest.raises(ValueError, match="batch of 6"):
        cell_rules("gemma3-12b", cfg, "train", mesh, 6)


def test_tensor_parallel_step_refuses_other_rules():
    """The step's state is sharded by ``data_rules``, so other rules
    (smollm's own, which put its rows over model) raise, and so does a
    factored second moment (its row marginal spans every column)."""
    from repro_torch.configs import get_rules, get_smoke_config
    from repro_torch.distributed.sharding import data_rules, shard_ctx
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.steps import build_train_step
    cfg = get_smoke_config("smollm-135m")
    mesh = _Mesh({"data": 1, "model": 2})
    with shard_ctx(mesh, get_rules("smollm-135m")):
        with pytest.raises(ValueError, match="data_rules"):
            build_train_step(cfg, _qcfg(), MadamConfig())
    with shard_ctx(mesh, data_rules(cfg, mesh)):
        with pytest.raises(ValueError, match="unfactored"):
            build_train_step(cfg, _qcfg(), MadamConfig(factored=True))
