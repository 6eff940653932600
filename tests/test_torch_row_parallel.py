"""JAX's training placement for the dense family (``sharding.train_rules``)
on the CPU: gloo ranks stand in for the cards (one spawn a mesh shape,
as ``test_torch_tensor_parallel.py``).

Under ``train_rules`` the rows split over the data axes, the column-
parallel leaves hold a rank's columns, and their row-parallel partners
``wo`` and ``down`` hold its rows (the partial products SUM-reduced over
the model group); the embedding table's rows, an untied head's columns
and the logits split by vocabulary. Two smoke configs of the dense
family:

* gemma3-smoke on (1, 2) and (2, 2): at m = 2 everything splits: 4 heads
  over 2 KV heads with ``wo``, the MLP (d_ff 160) with ``down``, and the
  512-word vocabulary of its untied head;
* granite-smoke on (1, 2): tied embeddings; its single KV head keeps the
  attention whole (``wo`` too), so ``down`` and the vocabulary are the
  split parts.

Each trains 2 lns8 steps from JAX's draw (carried with
``repro_torch.convert`` and sliced by ``shard_train_state``), against
JAX's one-device step and the port's one-process step, at
``test_torch_train.py``'s lns8 limits: step-0 loss rtol 1e-5, losses
1e-3, grad norms 10%, and after step 1 at most 2% of the words apart
(the rank's shards concatenated by rows, columns or vocabulary as they
split). The row blocks' SUM reorders the forward's contraction, so the
step is not bit-equal to one process's; the limits are those of JAX
against the port. The carried shards equal the placement's slices of
JAX's numpy words exactly, and every whole leaf is bit-equal across the
model group after every step.

The unit cases, on (1, 2):

* the vocabulary-parallel cross entropy and its gradient against the
  whole logits' within ``XENT_TOL`` (f32; labels < 0 and at each block's
  first and last column): the block sums and their sum reorder
  ``torch.logsumexp``'s one reduction;
* the vocabulary-parallel lookup and its table gradient equal to the
  whole table's value for value (each token's row comes from one rank,
  the others add -0.0);
* the row-parallel ``qeinsum`` (lns8, the rank's columns against the
  rank's rows, Q_A's scale MAX-reduced, the f32 partials SUM-reduced) and
  its input and weight gradients against the whole GEMM's: in f32 within
  ``ROW_TOL`` of max |value| (Q_A gives the same codes, and only the
  partial sums' order differs); in bf16 each output within one bf16 ulp,
  since the partials are rounded once after their sum.

Beside them, the placement of every leaf of gemma3-12b, granite-8b and
qwen2.5-32b under ``train_rules`` equals JAX's ``spec_for(
params_logical_axes(params, serving=False), mesh)`` on (1, 4), (2, 2)
and (32, 8) wherever the dims divide (they all do there), and
``train_rules`` refuses a batch that does not split.
"""
import pickle
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

MESHES = {(1, 2): ("gemma3-12b", "granite-8b"), (2, 2): ("gemma3-12b",)}
CASES = [(shape, arch) for shape, archs in MESHES.items() for arch in archs]
ARCHS = ("gemma3-12b", "granite-8b")
BATCH, SEQ, STEPS = 4, 16, 2
STEP0_RTOL, LOSS_RTOL, GNORM_RTOL, WORD_SHARE = 1e-5, 1e-3, 0.1, 0.02
XENT_TOL = 1e-6
ROW_TOL = 1e-5
STATS_RTOL, STATS_ATOL = 1e-4, 1e-3


def _qcfg():
    from repro_torch.core.quantizer import QuantConfig
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


def _port_train(flat, arch, mesh=None, rules=None):
    """The port's steps from a carried state (this rank's shard of it
    under ``mesh``): the carried words, then per step (loss, grad norm,
    words)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import train_state_from_flat
    from repro_torch.distributed.sharding import shard_ctx
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.steps import (build_train_step,
                                            shard_train_state)
    import contextlib
    cfg = get_smoke_config(arch)
    ts = train_state_from_flat(flat, MadamConfig(), device="cpu")
    ctx = (shard_ctx(mesh, rules) if mesh is not None
           else contextlib.nullcontext())
    out = []
    with ctx:
        if mesh is not None:
            ts = shard_train_state(ts, mesh, rules)
        carried = _words(ts.params)
        step = build_train_step(cfg, _qcfg(), MadamConfig())
        for b in _batches(arch):
            ts, m = step(ts, b)
            out.append((float(m["loss"]), float(m["grad_norm"]),
                        _words(ts.params)))
    return carried, out


def _observed(flat, arch, mesh=None, rules=None):
    """One observed step (``numerics=True``) from a carried state, Q_G
    only as ``test_torch_tensor_parallel.py``'s, so the gradients agree up
    to the reordered sums: each leaf's K4 and encode-site statistics."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import train_state_from_flat
    from repro_torch.core.lns import LNSFormat
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.distributed.sharding import shard_ctx
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.steps import (build_train_step,
                                            shard_train_state)
    import contextlib
    cfg = get_smoke_config(arch)
    ts = train_state_from_flat(flat, MadamConfig(), device="cpu")
    ctx = (shard_ctx(mesh, rules) if mesh is not None
           else contextlib.nullcontext())
    with ctx:
        if mesh is not None:
            ts = shard_train_state(ts, mesh, rules)
        step = build_train_step(cfg, QuantConfig(grad=LNSFormat(8, 8)),
                                MadamConfig(), numerics=True)
        _, m = step(ts, _batches(arch)[0])
    return {part: {leaf: {k: float(v) for k, v in st.items()}
                   for leaf, st in m["numerics"][part].items()}
            for part in ("update", "grad_encode")}


# ---------------------------------------------------------------------------
# the unit cases' inputs and computations (whole in the parent, split on
# the ranks)


def _unit_inputs():
    rng = np.random.default_rng(11)
    logits = (3 * rng.standard_normal((2, 3, 16))).astype(np.float32)
    labels = np.array([[-1, 0, 7], [8, 15, 3]], dtype=np.int64)
    tokens = np.array([[0, 255, 256, 511, 7, 7], [300, 511, 0, 42, 256,
                                                  255]], dtype=np.int64)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 24)) / np.sqrt(32)).astype(np.float32)
    return logits, labels, tokens, x, w


def _units(flat, mesh=None):
    """The three unit computations, whole without ``mesh``, the rank's
    blocks under ``train_rules`` with it."""
    import contextlib
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import train_state_from_flat
    from repro_torch.core.lns import LNSWeight
    from repro_torch.core.quantizer import act_stat, qeinsum
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import (axis_group, axis_index,
                                                  shard_ctx, train_rules)
    from repro_torch.models.layers import embed_lookup
    from repro_torch.models.model import _xent
    from repro_torch.optim.madam import (MadamConfig, attach_proxies,
                                         grad_proxies, lns_leaf_encoder)
    from repro_torch.training.steps import shard_train_state
    cfg = get_smoke_config("gemma3-12b")
    logits, labels, tokens, x, w = _unit_inputs()
    rules = None if mesh is None else train_rules(cfg, mesh, BATCH)
    ctx = (contextlib.nullcontext() if mesh is None
           else shard_ctx(mesh, rules))
    out = {}
    with ctx:
        m = 0 if mesh is None else axis_index("vocab")
        n = 16 if mesh is None else 16 // mesh.shape["model"]
        lf = torch.from_numpy(logits[..., m * n:(m + 1) * n].copy())
        lf.requires_grad_(True)
        loss = _xent(lf, torch.from_numpy(labels),
                     None if mesh is None else axis_group("vocab"))
        loss.backward()
        out["xent"] = (float(loss.detach()), lf.grad.numpy().copy())

        ts = train_state_from_flat(flat, MadamConfig(), device="cpu")
        if mesh is not None:
            ts = shard_train_state(ts, mesh, rules)
        tree = {"tok": ts.params["embed"]["tok"]}
        prox = grad_proxies(tree, cfg.compute_dtype)
        emb = embed_lookup(attach_proxies(tree, prox)["tok"],
                           torch.from_numpy(tokens), cfg)
        (emb * torch.linspace(-1, 1, emb.shape[-1])).sum().backward()
        out["lookup"] = (emb.detach().numpy().copy(),
                         prox["tok"].grad.numpy().copy())

        q = _qcfg()
        out["row_gemm"] = {}
        for dt in (torch.float32, torch.bfloat16):
            wt = lns_leaf_encoder(MadamConfig())(("down",),
                                                 torch.from_numpy(w))
            xt = torch.from_numpy(x).to(dt)
            if mesh is not None:
                k = axis_index("act_ff")
                c = x.shape[-1] // mesh.shape["model"]
                xt = xt[..., k * c:(k + 1) * c].contiguous()
                wt = LNSWeight(wt.packed[k * c:(k + 1) * c].contiguous(),
                               wt.scale, wt.fmt)
            xt.requires_grad_(True)
            delta = torch.zeros(wt.shape, dtype=dt, requires_grad=True)
            wd = wt.replace(delta=delta)
            if mesh is None:
                y = qeinsum("bsf,fd->bsd", xt, wd, q)
            else:       # as layers.mlp_apply: f32 partials, rounded once
                y = collectives.sum_forward(
                    qeinsum("bsf,fd->bsd", xt, wd, q,
                            x_stat=act_stat(xt, q, "act_ff"),
                            out_dtype=torch.float32),
                    axis_group("act_ff")).to(dt)
            (y * torch.linspace(-1, 1, y.shape[-1])).square().sum(
                ).backward()
            out["row_gemm"][str(dt)] = tuple(
                t.detach().float().numpy().copy()
                for t in (y, xt.grad, delta.grad))
    return out


# ---------------------------------------------------------------------------
# the ranks (no JAX is imported here)


def _rank(r, n, store, shape, flats, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=r,
                            world_size=n)
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import train_rules
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(*shape, device="cpu")
    out = {"coords": dict(mesh.coords)}
    for arch in MESHES[shape]:
        rules = train_rules(get_smoke_config(arch), mesh, BATCH)
        collectives.reset_counts()
        carried, steps = _port_train(flats[arch], arch, mesh, rules)
        out[arch] = {"carried": carried, "train": steps,
                     "collectives": collectives.counts(),
                     "bytes": collectives.byte_counts()}
    if shape == (1, 2):
        out["units"] = _units(flats["gemma3-12b"], mesh)
        out["numerics"] = _observed(
            flats["gemma3-12b"], "gemma3-12b", mesh,
            train_rules(get_smoke_config("gemma3-12b"), mesh, BATCH))
    with open(Path(out_dir) / f"rank{r}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: JAX's steps and the port's one-process references, then the
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


def _jax_steps(arch, state):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.core.quantizer import QuantConfig as JQ
    from repro.kernels import dispatch as jd
    from repro.optim.madam import MadamConfig as JM
    from repro.training import build_train_step
    cfg = get_smoke_config(arch)
    steps = []
    with jd.configured(backend="reference"):
        step = jax.jit(build_train_step(cfg, JQ.lns_madam(), JM()))
        for b in _batches(arch):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            words = {k: v for k, v in _flat(state.params).items()
                     if k.endswith("packed")}
            steps.append((float(m["loss"]), float(m["grad_norm"]), words))
    return steps


@pytest.fixture(scope="module")
def rp_run():
    import jax
    import torch.multiprocessing as mp
    from repro.configs import get_smoke_config as j_smoke
    from repro.optim.madam import MadamConfig as JM
    from repro.training import init_train_state as j_init
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    states, flats = {}, {}
    for arch in ARCHS:
        c = j_smoke(arch)
        states[arch] = jax.jit(lambda k, c=c: j_init(k, c, JM()))(
            jax.random.PRNGKey(0))
        flats[arch] = _flat(states[arch])
    with tempfile.TemporaryDirectory() as d:
        procs = {}
        for shape in MESHES:
            n = shape[0] * shape[1]
            sub = Path(d) / f"{shape[0]}x{shape[1]}"
            sub.mkdir()
            procs[shape] = (n, sub, mp.start_processes(
                _rank, args=(n, f"{sub}/store", shape, flats, str(sub)),
                nprocs=n, join=False, start_method="spawn"))
        jax_ref = {arch: _jax_steps(arch, states[arch]) for arch in ARCHS}
        one = {arch: _port_train(flats[arch], arch)[1] for arch in ARCHS}
        one["units"] = _units(flats["gemma3-12b"])
        one["numerics"] = _observed(flats["gemma3-12b"], "gemma3-12b")
        out = {}
        for shape, (n, sub, ctx) in procs.items():
            while not ctx.join():
                pass
            out[shape] = [pickle.loads((sub / f"rank{r}.pkl").read_bytes())
                          for r in range(n)]
    torch.set_num_threads(threads)
    flat_words = {arch: {k[len("params::"):]: v for k, v in flats[arch].items()
                         if k.startswith("params::") and k.endswith("packed")}
                  for arch in ARCHS}
    return jax_ref, one, out, flat_words


def _joined(parts, whole):
    """Shards of one leaf in model-group order made whole: equal parts are
    a whole leaf; else concatenated along the one dim where a part is
    narrower than ``whole``."""
    p0 = parts[0]
    if p0.shape == whole.shape:
        assert all(np.array_equal(p, p0) for p in parts)
        return p0
    dims = [i for i, (a, b) in enumerate(zip(p0.shape, whole.shape))
            if a != b]
    assert len(dims) == 1, (p0.shape, whole.shape)
    return np.concatenate(parts, axis=dims[0])


def _model_group(ranks):
    group = [res for res in ranks if res["coords"]["data"] == 0]
    return sorted(group, key=lambda res: res["coords"]["model"])


def _whole_words(ranks, arch, pick, ref):
    group = _model_group(ranks)
    return {k: _joined([pick(res[arch])[k] for res in group], ref[k])
            for k in ref}


def _word_diffs(a, b):
    n = tot = 0
    for k in b:
        x, y = a[k].astype(np.int64), b[k].astype(np.int64)
        assert x.shape == y.shape, (k, x.shape, y.shape)
        n += int((x != y).sum())
        tot += x.size
    return n, tot


@pytest.mark.parametrize("shape,arch", CASES)
def test_carried_shards_are_the_placements_slices(rp_run, shape, arch):
    """``convert`` then ``shard_train_state`` gives each rank the slice of
    JAX's numpy words its placement names: the shards put back together
    are JAX's words, word for word, and each split leaf is split where
    ``train_rules`` says."""
    flat = rp_run[3][arch]
    ranks = rp_run[2][shape]
    whole = _whole_words(ranks, arch, lambda res: res["carried"], flat)
    for k, w in flat.items():
        assert np.array_equal(whole[k], w), k
    r0 = _model_group(ranks)[0][arch]["carried"]
    split = {k.split("::")[-2] for k in flat if r0[k].shape != flat[k].shape}
    want = {"up", "gate", "down", "tok" if arch == "granite-8b" else "head"}
    if arch == "gemma3-12b":
        want |= {"wq", "wk", "wv", "wo", "tok"}
    assert split == want, (arch, shape, split)


@pytest.mark.parametrize("shape,arch", CASES)
def test_train_step_tracks_jax_and_one_process(rp_run, shape, arch):
    jax_ref, one, out, _ = rp_run
    ranks = out[shape]
    r0 = ranks[0][arch]["train"]
    for r, res in enumerate(ranks):
        assert [x[:2] for x in res[arch]["train"]] == [x[:2] for x in r0], (
            f"{arch} {shape} rank {r}: losses or grad norms differ")
    for what, ref in (("one process", one[arch]), ("JAX", jax_ref[arch])):
        for i, ((gl, gn, _), (rl, rn, _)) in enumerate(zip(r0, ref)):
            np.testing.assert_allclose(
                gl, rl, rtol=STEP0_RTOL if i == 0 else LOSS_RTOL,
                err_msg=f"{what}: loss, step {i}")
            np.testing.assert_allclose(gn, rn, rtol=GNORM_RTOL,
                                       err_msg=f"{what}: grad norm, step {i}")
    for i in range(STEPS):
        for what, ref in (("one process", one[arch][i][2]),
                          ("JAX", jax_ref[arch][i][2])):
            whole = _whole_words(ranks, arch,
                                 lambda res, i=i: res["train"][i][2], ref)
            n, tot = _word_diffs(whole, ref)
            print(f"{arch} {shape} step {i}: {n} of {tot} words "
                  f"({n / tot:.3%}) apart from {what}")
            if i == 0:
                assert n <= WORD_SHARE * tot, (
                    f"{arch} {shape} step 1: {n / tot:.3%} of the words "
                    f"apart from {what} (limit {WORD_SHARE:.0%})")
    c = ranks[0][arch]["collectives"]
    # the row blocks' and the vocabulary's SUMs run in the forward; the
    # hidden state is never gathered (granite's whole heads gather nothing)
    assert c["gather"] == 0 and c["sum"] > 0 and c["max_reduce"] > 0, c
    assert "model" in ranks[0][arch]["bytes"]["by_axis"]


@pytest.mark.parametrize("shape,arch", CASES)
def test_whole_leaves_equal_across_the_model_group(rp_run, shape, arch):
    """After every step each whole leaf is bit-equal on every rank, and a
    shard is equal on the ranks of its data group."""
    ranks = rp_run[2][shape]
    for i in range(STEPS):
        w0 = ranks[0][arch]["train"][i][2]
        for res in ranks:
            w = res[arch]["train"][i][2]
            same = [x for x in ranks
                    if x["coords"]["model"] == res["coords"]["model"]]
            for k in w0:
                if w[k].shape == w0[k].shape and np.array_equal(w[k], w0[k]):
                    continue
                assert w[k].shape != w0[k].shape or res["coords"][
                    "model"] != ranks[0]["coords"]["model"], (k, i)
                assert all(np.array_equal(x[arch]["train"][i][2][k], w[k])
                           for x in same), (arch, shape, k, i)


def test_vocab_parallel_cross_entropy(rp_run):
    one, ranks = rp_run[1]["units"], rp_run[2][(1, 2)]
    loss, grad = one["xent"]
    assert np.abs(grad).max() > 0
    for res in ranks:
        m = res["coords"]["model"]
        got_loss, got_grad = res["units"]["xent"]
        n = got_grad.shape[-1]
        assert n == grad.shape[-1] // 2
        np.testing.assert_allclose(got_loss, loss, rtol=XENT_TOL, atol=0)
        np.testing.assert_allclose(got_grad, grad[..., m * n:(m + 1) * n],
                                   rtol=0, atol=XENT_TOL)


def test_vocab_parallel_lookup_equals_the_whole_table(rp_run):
    one, ranks = rp_run[1]["units"], rp_run[2][(1, 2)]
    emb, grad = one["lookup"]
    for res in ranks:
        m = res["coords"]["model"]
        got, got_grad = res["units"]["lookup"]
        n = got_grad.shape[0]
        assert n == grad.shape[0] // 2
        assert np.array_equal(got, emb), np.abs(got - emb).max()
        assert np.array_equal(got_grad, grad[m * n:(m + 1) * n])
        assert np.abs(got_grad).max() > 0


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_row_parallel_qeinsum_and_gradients(rp_run, dtype):
    """f32: within ``ROW_TOL`` of max |value|. bf16: the partials are
    summed in f32 and rounded once, so each output is within one bf16
    ulp (at most 2^-7 of its magnitude) of the whole GEMM's, and the
    gradients within 2^-7 of their max."""
    one, ranks = rp_run[1]["units"], rp_run[2][(1, 2)]
    y, dx, dw = one["row_gemm"][dtype]
    tol = ROW_TOL if dtype == "torch.float32" else 2.0 ** -7
    for res in ranks:
        m = res["coords"]["model"]
        gy, gdx, gdw = res["units"]["row_gemm"][dtype]
        c = gdx.shape[-1]
        assert c == dx.shape[-1] // 2
        for got, want, what in ((gy, y, "y"),
                                (gdx, dx[..., m * c:(m + 1) * c], "dx"),
                                (gdw, dw[m * c:(m + 1) * c], "dW")):
            assert np.abs(want).max() > 0
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=tol * np.abs(want).max(),
                                       err_msg=f"{what} rank {m}")
        if dtype == "torch.bfloat16":
            assert (np.abs(gy - y) <= tol * np.abs(y)).all(), (
                np.abs(gy - y).max())


def test_observed_step_reports_whole_leaf_stats(rp_run):
    """gemma3-smoke's observed step on (1, 2), where ``wo`` and ``down``
    hold row shards and ``tok`` and ``head`` vocabulary shards: each
    leaf's K4 and encode-site statistics are the whole leaf's, within
    ``STATS_RTOL`` of the one-process step's (fractions within one element
    of ``STATS_ATOL``), on every rank."""
    one, ranks = rp_run[1]["numerics"], rp_run[2][(1, 2)]
    for leaf in ("wo", "down", "tok", "head"):
        assert any(k.split(".")[-1] == leaf for k in one["update"]), (
            leaf, sorted(one["update"]))
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


# ---------------------------------------------------------------------------
# placement against JAX's (no ranks)


class _Mesh:
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.mark.parametrize("arch", ["gemma3-12b", "granite-8b", "qwen2.5-32b"])
def test_train_placement_equals_jax(arch):
    """Every leaf of the full config under ``train_rules`` is placed as
    JAX places it under its default rules with the non-serving axes,
    wherever the dims divide the mesh."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as j_config
    from repro.distributed import params_sharding as jps
    from repro.distributed import sharding as jsh
    from repro.optim.madam import MadamConfig as JM
    from repro.training import init_train_state as j_init
    from repro_torch.configs import get_config
    from repro_torch.core.lns import LNSFormat, LNSWeight
    from repro_torch.distributed import params_sharding as tps
    from repro_torch.distributed.sharding import train_rules
    jcfg, cfg = j_config(arch), get_config(arch)
    st = jax.eval_shape(lambda k: j_init(k, jcfg, JM()),
                        jax.random.PRNGKey(0))
    jw = type(st.params["embed"]["tok"])

    def meta(t):
        if isinstance(t, jw):
            return LNSWeight(torch.empty(t.packed.shape, device="meta"),
                             torch.empty(t.scale.shape, device="meta"),
                             LNSFormat(16, 8))
        if isinstance(t, dict):
            return {k: meta(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [meta(v) for v in t]
        return torch.empty(tuple(t.shape), device="meta")

    def flat(tree, out, path=""):
        if isinstance(tree, (LNSWeight, jw)):
            out[path] = (tuple(tree.packed.shape) if hasattr(
                tree.packed, "shape") else tuple(tree.packed))
            return out
        if isinstance(tree, dict):
            for k, v in tree.items():
                flat(v, out, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                flat(v, out, f"{path}/{i}")
        else:
            out[path] = tuple(tree.shape) if hasattr(tree, "shape") \
                else tuple(tree)
        return out

    params = meta(st.params)
    shapes = flat(params, {})
    j_axes = jps.params_logical_axes(st.params, serving=False)
    for shape in ((1, 4), (2, 2), (32, 8)):
        mesh = _Mesh({"data": shape[0], "model": shape[1]})
        rules = train_rules(cfg, mesh, 256)
        assert not tps.serving_placement(rules)
        got = flat(tps.tree_shardings(tps.params_logical_axes(
            params, serving=tps.serving_placement(rules)), mesh, rules), {})
        want = {}
        for k, axes in flat(j_axes, {}).items():
            want[k] = tuple(jsh.spec_for(axes, mesh))
        assert got.keys() == want.keys()
        split = set()
        for k, spec in want.items():
            divides = all(
                size % (mesh.shape[e] if isinstance(e, str) else 1) == 0
                for size, e in zip(shapes[k], spec))
            if divides:
                assert got[k] == spec, (arch, shape, k, got[k], spec)
            split |= {k.split("/")[-1] for e in got[k] if e == "model"}
        want_split = {"wq", "wk", "wv", "wo", "up", "gate", "down", "tok"}
        if not cfg.tie_embeddings:
            want_split.add("head")
        if cfg.qkv_bias:
            want_split |= {"bq", "bk", "bv"}
        assert split == want_split, (arch, shape, split)


def test_train_rules_refuse_a_batch_that_does_not_split():
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.params_sharding import serving_placement
    from repro_torch.distributed.sharding import (LOGICAL_RULES, data_rules,
                                                  train_rules)
    cfg = get_smoke_config("gemma3-12b")
    mesh = _Mesh({"pod": 2, "data": 2, "model": 2})
    rules = train_rules(cfg, mesh, 8)
    assert rules == dict(data_rules(cfg, mesh, 8), attn_out="model",
                         act_ff="model", vocab="model")
    assert not serving_placement(rules)
    assert not serving_placement(LOGICAL_RULES)
    assert serving_placement(data_rules(cfg, mesh, 8))
    with pytest.raises(ValueError, match="batch of 6.*pod\\+data"):
        train_rules(cfg, mesh, 6)
    # granite-smoke's single KV head keeps the heads and wo whole
    g = train_rules(get_smoke_config("granite-8b"), _Mesh(
        {"data": 1, "model": 2}))
    assert g["qkv_out"] is None and g["attn_out"] is None
    assert g["act_ff"] == "model" and g["vocab"] == "model"
