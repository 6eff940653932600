"""Data-parallel training of the port on the CPU: gloo ranks stand in for
the cards.

The port's data-parallel step (``build_train_step`` under a ``(DATA, 1)``
mesh, one process a rank, the global batch on every rank) is held to two
references on the same global batch, from the same JAX train state
carried across with ``convert.train_state_from_flat``:

* the port's one-process step (the plain path the DP step must equal
  but for the order of the cross-rank sums), and
* JAX's one-device step, the parity target (JAX's own mesh train test
  fails, ROADMAP H5). For MoE both references run with ``_dp_groups``
  patched to the data size, JAX's and the port's, as
  ``test_torch_mesh_serving.py`` patches it: the reference gives each
  data shard its own dispatch group and capacity.

Each mesh shape is one ``torch.multiprocessing`` spawn of gloo ranks
(file store) that runs every scenario; the ranks import no JAX, and the
parent runs JAX and the port's one-process references meanwhile.

Tolerances and why:

* Every rank's words equal rank 0's after every step, bit for bit: the
  gradients are summed once and every rank updates from the same sum.
* Against the port's one-process step. The per-tensor scales are the
  global batch's (max-reduced, exact); only the order of the cross-rank
  sums (the loss shares, the gradients after each rank computed its
  rows' part) differs, by an ulp or so. Measured on the CPU over 3 steps
  of every scenario: losses within 1.6e-7, grad norms and every word
  equal. Held, fp32 and lns8 alike, to rtol 1e-6 on losses and grad
  norms and at most 0.1% of words apart after any step, each by one
  code: a reordered sum that lands on a rounding tie flips one code.
* Against JAX's one-device step: ``test_torch_train.py``'s limits for
  each quantizer config (fp32: loss and grad norm rtol 1e-5, step-1
  words equal but for 0.5% one code apart; lns8: step-0 loss rtol 1e-5,
  losses rtol 1e-3, grad norms 10%, step-1 words apart on at most 2%).
* MoE (deepseek-smoke at f32, MLA, MTP and the balance loss, lns8):
  ``test_torch_moe_train.py``'s lns8 limits against JAX (loss rtol 1e-3,
  grad norm 10%, words 5%); the balance loss summed over the ranks
  equals the one-process port's to rtol 1e-6 (the route counts are
  integers, summed exactly; only the probabilities' sum is reordered).
* Global scales: a rank's Q_A and Q_E codes equal the whole tensor's bit
  for bit, where the rank's own scale differs.
"""
import contextlib
import dataclasses
import os
import pickle
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

BATCH, SEQ, STEPS = 8, 32, 3
MOE_ARCH, MOE_BATCH, MOE_SEQ, MOE_STEPS = "deepseek-v3-671b", 4, 16, 2
# (name, quantizers, accum)
SCENARIOS = [("fp32-a1", "fp32", 1), ("fp32-a2", "fp32", 2),
             ("lns8-a1", "lns8", 1), ("lns8-a2", "lns8", 2)]
MESHES = [(2, 1), (4, 1)]


def _qcfg(name):
    from repro_torch.core.quantizer import QuantConfig
    return {"fp32": QuantConfig.full_precision(),
            "lns8": QuantConfig.lns_madam()}[name]


def _moe_cfg():
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(MOE_ARCH), dtype="float32")


def _words(params):
    from repro_torch.checkpoint.manager import flatten_state
    return {k: v for k, v in flatten_state(params).items()
            if k.endswith("packed")}


def _run_port(flat, cfg, qcfg, batches, accum):
    """The port's steps from a carried state: per-step (loss, grad norm,
    packed words)."""
    from repro_torch.convert import train_state_from_flat
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.steps import build_train_step
    ts = train_state_from_flat(flat, MadamConfig(), device="cpu")
    step = build_train_step(cfg, qcfg, MadamConfig(), accum_steps=accum)
    out = []
    for b in batches:
        ts, m = step(ts, b)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    _words(ts.params)))
    return out


def _smollm_batches(n=STEPS):
    from repro_torch.configs import get_smoke_config
    from repro_torch.training.data import SyntheticLM
    data = SyntheticLM(get_smoke_config("smollm-135m"), batch=BATCH,
                       seq=SEQ)
    return [data.batch_at(i) for i in range(n)]


def _moe_batches():
    from repro_torch.training.data import SyntheticLM
    data = SyntheticLM(_moe_cfg(), batch=MOE_BATCH, seq=MOE_SEQ)
    return [data.batch_at(i) for i in range(MOE_STEPS)]


def _rank_split(batch, n, accum):
    """The batch reordered so that the data-parallel step's microbatch i
    on rank r holds rank r's own contiguous rows ``i``-th part (cutting
    microbatches out of each rank's rows, the wrong order)."""
    B = next(iter(batch.values())).shape[0]
    per, mb = B // n, B // (n * accum)
    order = [r * per + i * mb + j for i in range(accum) for r in range(n)
             for j in range(mb)]
    return {k: v[order] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the ranks (no JAX is imported here)


def _global_scales(mesh):
    """Q_A and Q_E of a rank's rows under the data-parallel mesh against
    the whole tensor's: row block r of the global tensor is scaled by
    2^(10 r), so every rank's own absmax differs; Q_log under a
    power-of-two scale moves only where the grid's range clips, so a
    rank's own scale keeps small values the whole tensor's range flushes.
    Also the routed GEMM (K1's plain version with the given scale)."""
    from repro_torch.core.lns import LNSFormat, lns_weight_encode
    from repro_torch.core.quantizer import (QuantConfig, backward_quantize,
                                            global_stat, qeinsum,
                                            ste_quantize)
    from repro_torch.distributed.sharding import batch_group, shard_ctx
    fmt = LNSFormat(8, 8)
    n, r = mesh.shape["data"], mesh.coords["data"]
    g = torch.Generator().manual_seed(11)

    def make(shape):
        x = torch.exp2(-10 * torch.rand(shape, generator=g))
        x = torch.where(torch.rand(shape, generator=g) < 0.5, -x, x)
        for i in range(n):
            x[i * shape[0] // n:(i + 1) * shape[0] // n] *= 2.0 ** (10 * i)
        return x

    x, dy = make((2 * n, 3, 16)), make((2 * n, 3, 16))
    rows = slice(2 * r, 2 * r + 2)
    xl, dyl = x[rows].clone(), dy[rows].clone()
    group = batch_group()
    qa = ste_quantize(xl, fmt, None, global_stat(xl, fmt, None, group))
    leaf = xl.clone().requires_grad_(True)
    backward_quantize(leaf, fmt, None, None, group).backward(dyl)
    qe = leaf.grad
    whole_qa, whole_qe = (ste_quantize(x, fmt, None)[rows],
                          ste_quantize(dy, fmt, None)[rows])
    # the routed GEMM: K1 (plain version) on the rank's rows with the
    # global scale, against the whole batch's call
    w = lns_weight_encode(torch.randn((16, 8), generator=g), fmt, -1)
    qcfg = QuantConfig(weight=fmt, act=fmt)
    routed = qeinsum("bsd,de->bse", xl, w, qcfg)
    with shard_ctx(None):
        whole_routed = qeinsum("bsd,de->bse", x, w, qcfg)[rows]
    return dict(
        qa=torch.equal(qa, whole_qa), qe=torch.equal(qe, whole_qe),
        qa_local_apart=not torch.equal(ste_quantize(xl, fmt, None),
                                       whole_qa),
        qe_local_apart=not torch.equal(ste_quantize(dyl, fmt, None),
                                       whole_qe),
        routed=float((routed - whole_routed).abs().max()),
        routed_scale=float(routed.abs().max()))


def _thread_backward(flat, mesh):
    """A remat step's backward run on a thread that never entered the
    mesh context (as autograd's device thread on a card) gives the
    gradients of a backward run in the forward's thread."""
    import threading
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import train_state_from_flat
    from repro_torch.distributed import collectives
    from repro_torch.distributed.params_sharding import batch_rows
    from repro_torch.models.model import lm_loss
    from repro_torch.optim.madam import (MadamConfig, attach_proxies,
                                         grad_proxies)
    from repro_torch.training.steps import batch_to_device
    from repro_torch.tree import leaves
    cfg = get_smoke_config("smollm-135m")
    ts = train_state_from_flat(flat, MadamConfig(), device="cpu")
    b = batch_rows(batch_to_device(_smollm_batches(1)[0], "cpu"), mesh)
    grads, maxes = [], []
    for threaded in (False, True):
        proxies = grad_proxies(ts.params, cfg.compute_dtype)
        loss = lm_loss(attach_proxies(ts.params, proxies), b, cfg,
                       _qcfg("lns8"), remat=True)
        collectives.reset_counts()
        if threaded:
            t = threading.Thread(target=loss.backward)
            t.start()
            t.join()
        else:
            loss.backward()
        maxes.append(collectives.counts()["max_reduce"])
        grads.append([d.grad for _, d in leaves(proxies)])
    same = all(torch.equal(a, b) for a, b in zip(*grads))
    return dict(same=same, max_reduces=maxes)


def _supervised(flat, mesh, out_dir):
    """``run_supervised`` with a failure injected on the last rank alone
    at step 1: every rank retries it (one joint flag), rank 0 alone
    writes the checkpoints, every rank restores, and the words end equal
    to an uninjected run's."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import train_state_from_flat
    from repro_torch.distributed.sharding import batch_group
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.loop import SupervisorConfig, run_supervised
    from repro_torch.training.steps import build_train_step
    cfg = get_smoke_config("smollm-135m")
    last = mesh.size - 1
    fired = []

    def inject(step):
        if step == 1 and mesh.rank == last and not fired:
            fired.append(step)
            raise RuntimeError("injected")

    res = {}
    for name, injector in (("clean", None), ("injected", inject)):
        d = os.path.join(out_dir, name)
        ckpt = CheckpointManager(d, keep=3, group=batch_group())
        state = train_state_from_flat(flat, MadamConfig(), device="cpu")
        step = build_train_step(cfg, _qcfg("lns8"), MadamConfig())
        rep = run_supervised(step, state,
                             SyntheticLM(cfg, batch=BATCH, seq=SEQ), ckpt,
                             SupervisorConfig(max_steps=3, save_every=1),
                             failure_injector=injector)
        _, final = ckpt.restore_latest(state)
        res[name] = dict(recovered=rep.failures_recovered,
                         losses=rep.losses, words=_words(final.params),
                         writer=ckpt.writer)
    return res


def _stochastic_seeds(flat, mesh):
    """A stochastic Q_U under data parallelism: generators seeded alike on
    every rank step (the words stay equal), a seed that differs on one
    rank raises."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import train_state_from_flat
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.steps import build_train_step
    cfg, mcfg = get_smoke_config("smollm-135m"), MadamConfig(stochastic=True)
    b = _smollm_batches(1)[0]
    out = {}
    for name, seed in (("same", 5), ("differs", 5 + (mesh.rank == 1))):
        ts = train_state_from_flat(flat, mcfg, device="cpu")
        step = build_train_step(cfg, _qcfg("fp32"), mcfg)
        try:
            ts, _ = step(ts, b, torch.Generator().manual_seed(seed))
            out[name] = _words(ts.params)
        except ValueError as e:
            out[name] = str(e)
    return out


def _cli(n):
    """``launch.train --smoke --device cpu --mesh N,1`` in this world (the
    process group already runs, as torchrun's would), and ``--mesh N,2``'s
    refusal."""
    from repro_torch.launch import train as train_cli
    out = train_cli.main(["--smoke", "--device", "cpu", "--steps", "2",
                          "--batch", str(2 * n), "--seq", "16",
                          "--mesh", f"{n},1"])
    try:
        train_cli.main(["--smoke", "--device", "cpu", "--steps", "1",
                        "--mesh", f"{n},2"])
        refused = None
    except SystemExit as e:
        refused = str(e)
    return dict(losses=out["losses"], mesh=out["mesh"], refused=refused)


def _rank(r, n, store, shape, flats, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=r,
                            world_size=n)
    from repro_torch.configs import get_rules, get_smoke_config
    from repro_torch.distributed.sharding import shard_ctx
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(*shape, device="cpu")
    out = {}
    cfg = get_smoke_config("smollm-135m")
    batches = _smollm_batches()
    with shard_ctx(mesh, get_rules("smollm-135m")):
        for name, q, accum in SCENARIOS:
            out[name] = _run_port(flats["smollm-135m"], cfg, _qcfg(q),
                                  batches, accum)
        out["lns8-a2-rank-split"] = _run_port(
            flats["smollm-135m"], cfg, _qcfg("lns8"),
            [_rank_split(b, shape[0], 2) for b in batches], 2)
        out["global_scales"] = _global_scales(mesh)
        out["thread_backward"] = _thread_backward(flats["smollm-135m"], mesh)
        out["supervised"] = _supervised(flats["smollm-135m"], mesh, out_dir)
        out["stochastic"] = _stochastic_seeds(flats["smollm-135m"], mesh)
    if shape == (2, 1):
        with shard_ctx(mesh, get_rules(MOE_ARCH)):
            out["moe"] = _run_port(flats[MOE_ARCH], _moe_cfg(),
                                   _qcfg("lns8"), _moe_batches(), 1)
            out["moe_aux"] = _moe_aux(flats[MOE_ARCH], mesh)
    out["cli"] = _cli(n)
    with open(Path(out_dir) / f"rank{r}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _moe_aux(flat, mesh=None):
    """deepseek-smoke's balance loss on the first batch: under a mesh this
    rank's share of it, summed over the ranks."""
    from repro_torch.convert import train_state_from_flat
    from repro_torch.distributed import collectives
    from repro_torch.distributed.params_sharding import batch_rows
    from repro_torch.distributed.sharding import batch_group
    from repro_torch.models.model import forward
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.steps import batch_to_device
    cfg = _moe_cfg()
    ts = train_state_from_flat(flat, MadamConfig(), device="cpu")
    b = batch_to_device(_moe_batches()[0], "cpu")
    if mesh is not None:
        b = batch_rows(b, mesh)
    with torch.no_grad():
        aux = forward(ts.params, b["tokens"], cfg, _qcfg("lns8"),
                      full=True).aux
    return float(collectives.sum_reduce(aux, batch_group()))


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


@contextlib.contextmanager
def _groups(n):
    """JAX's and the port's MoE dispatch groups set to ``n`` on one
    device (the reference of an ``(n, 1)`` data-parallel mesh)."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    real = jmoe._dp_groups, tmoe._dp_groups
    jmoe._dp_groups = tmoe._dp_groups = lambda: n
    try:
        yield
    finally:
        jmoe._dp_groups, tmoe._dp_groups = real


def _jax_steps(state, cfg, jq, mcfg, batches, accum):
    import jax
    import jax.numpy as jnp
    from repro.kernels import dispatch as jd
    from repro.training import build_train_step as j_build
    with jd.configured(backend="reference"):
        jstep = jax.jit(j_build(cfg, jq, mcfg, accum_steps=accum))
        out = []
        for b in batches:
            state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
            words = {k: v for k, v in _flat(state.params).items()
                     if k.endswith("packed")}
            out.append((float(m["loss"]), float(m["grad_norm"]), words))
    return out


@pytest.fixture(scope="module")
def dp_run():
    import jax
    import torch.multiprocessing as mp
    from repro.configs import get_smoke_config as j_smoke_config
    from repro.core.quantizer import QuantConfig as JQuantConfig
    from repro.optim.madam import MadamConfig as JMadamConfig
    from repro.training import init_train_state as j_init
    from repro_torch.configs import get_smoke_config
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jq = {"fp32": JQuantConfig.full_precision(),
          "lns8": JQuantConfig.lns_madam()}
    mcfg = JMadamConfig()
    jcfg = j_smoke_config("smollm-135m")
    jmoe = dataclasses.replace(j_smoke_config(MOE_ARCH), dtype="float32")
    states = {a: jax.jit(lambda k, c=c: j_init(k, c, mcfg))(
        jax.random.PRNGKey(0)) for a, c in (("smollm-135m", jcfg),
                                            (MOE_ARCH, jmoe))}
    flats = {a: _flat(s) for a, s in states.items()}
    with tempfile.TemporaryDirectory() as d:
        procs = {}
        for shape in MESHES:
            n = shape[0] * shape[1]
            sub = Path(d) / f"{shape[0]}x{shape[1]}"
            sub.mkdir()
            procs[shape] = (n, sub, mp.start_processes(
                _rank, args=(n, f"{sub}/store", shape, flats, str(sub)),
                nprocs=n, join=False, start_method="spawn"))
        want, one = {}, {}
        batches = _smollm_batches()
        tcfg = get_smoke_config("smollm-135m")
        for name, q, accum in SCENARIOS:
            want[name] = _jax_steps(states["smollm-135m"], jcfg, jq[q], mcfg,
                                    batches, accum)
            one[name] = _run_port(flats["smollm-135m"], tcfg, _qcfg(q),
                                  batches, accum)
        with _groups(2):
            want["moe"] = _jax_steps(states[MOE_ARCH], jmoe, jq["lns8"],
                                     mcfg, _moe_batches(), 1)
            one["moe"] = _run_port(flats[MOE_ARCH], _moe_cfg(),
                                   _qcfg("lns8"), _moe_batches(), 1)
            one["moe_aux"] = _moe_aux(flats[MOE_ARCH])
        out = {}
        for shape, (n, sub, ctx) in procs.items():
            while not ctx.join():
                pass
            out[shape] = [pickle.loads((sub / f"rank{r}.pkl").read_bytes())
                          for r in range(n)]
    torch.set_num_threads(threads)
    return want, one, out


def _word_diffs(a, b):
    n = tot = 0
    codes = []
    for k in a:
        x, y = a[k].astype(np.int64), b[k].astype(np.int64)
        d = x != y
        n += int(d.sum())
        tot += x.size
        codes.append(np.abs(x - y)[d])
    return n, tot, np.concatenate(codes)


def _hold(got, ref, q, step0_rtol):
    """``test_torch_train.py``'s rule for quantizers ``q``."""
    exact = q == "fp32"
    for i, ((gl, gn, gw), (rl, rn, rw)) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(gl, rl, rtol=step0_rtol if i == 0 else
                                   (1e-5 if exact else 1e-3),
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(gn, rn, rtol=1e-5 if exact else 0.1,
                                   err_msg=f"grad norm, step {i}")
    n, tot, codes = _word_diffs(got[0][2], ref[0][2])
    if exact:
        assert n <= 0.005 * tot and np.all(codes == 1), (n, tot)
    else:
        assert n <= 0.02 * tot, (n, tot)


def _hold_one_process(got, ref):
    """The DP step against the port's one-process step: the scales are
    exact, only the cross-rank sums reorder (measured on the CPU: losses
    within 1.6e-7, grad norms equal, every word equal over 3 steps in
    every scenario). Held to rtol 1e-6 and at most 0.1% of the words
    apart after any step, each by one code (a reordered sum on a
    rounding tie), for fp32 and lns8 alike."""
    for i, ((gl, gn, gw), (rl, rn, rw)) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(gl, rl, rtol=1e-6, err_msg=f"step {i}")
        np.testing.assert_allclose(gn, rn, rtol=1e-6, err_msg=f"step {i}")
        n, tot, codes = _word_diffs(gw, rw)
        assert n <= 1e-3 * tot and np.all(codes == 1), (i, n, tot)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name,q,accum", SCENARIOS)
def test_dp_step_ranks_agree_and_match_one_process(dp_run, shape, name, q,
                                                   accum):
    """Every rank's words are rank 0's after every step; the DP step
    tracks the port's one-process step on the global batch."""
    _, one, out = dp_run
    ranks = out[shape]
    for r, res in enumerate(ranks):
        for i, (l, g, w) in enumerate(res[name]):
            l0, g0, w0 = ranks[0][name][i]
            assert (l, g) == (l0, g0), (shape, name, r, i)
            assert all(np.array_equal(w[k], w0[k]) for k in w0), (
                f"{shape} {name}: rank {r}'s words left rank 0's at step {i}")
    _hold_one_process(ranks[0][name], one[name])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name,q,accum", SCENARIOS)
def test_dp_step_tracks_jax_one_device(dp_run, shape, name, q, accum):
    """The DP step against JAX's one-device step on the global batch
    (accum 2: JAX's microbatches are global rows [i·B/2, (i+1)·B/2))."""
    want, _, out = dp_run
    _hold(out[shape][0][name], want[name], q, 1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_microbatches_are_cut_from_the_global_batch(dp_run, shape):
    """Cutting each rank's microbatches out of its own rows (the wrong
    order) gives another step: more words apart from the one-process
    step than the DP step's, which stays inside its bound."""
    _, one, out = dp_run
    dp = _word_diffs(out[shape][0]["lns8-a2"][0][2], one["lns8-a2"][0][2])
    wrong = _word_diffs(out[shape][0]["lns8-a2-rank-split"][0][2],
                        one["lns8-a2"][0][2])
    assert dp[0] <= 0.02 * dp[1], dp[:2]
    assert wrong[0] > max(10 * dp[0], 0.001 * wrong[1]), (wrong[:2], dp[:2])


@pytest.mark.parametrize("shape", MESHES)
def test_global_scales_not_rank_local(dp_run, shape):
    """A rank's Q_A and Q_E codes are the whole tensor's, where its own
    scale would give others; the routed GEMM on a rank's rows (K1 with
    the given scale) equals the whole call's rows."""
    for r, res in enumerate(dp_run[2][shape]):
        gs = res["global_scales"]
        assert gs["qa"] and gs["qe"], (shape, r, gs)
        if r == 0:      # rank 0 holds the smallest rows: its own scale
            assert gs["qa_local_apart"] and gs["qe_local_apart"], gs
        assert gs["routed"] <= 1e-6 * gs["routed_scale"], gs


@pytest.mark.parametrize("shape", MESHES)
def test_recompute_off_the_forward_thread(dp_run, shape):
    """remat's recompute reissues the forward's MAX reduces in the
    backward, and on a thread with no mesh context it still takes the
    global scales: the gradients equal a same-thread backward's."""
    for res in dp_run[2][shape]:
        tb = res["thread_backward"]
        assert tb["same"], tb
        assert tb["max_reduces"][0] == tb["max_reduces"][1] > 0, tb


@pytest.mark.parametrize("shape", MESHES)
def test_supervisor_retries_jointly(dp_run, shape):
    """A failure on one rank retries the step on every rank, rank 0 alone
    writes, every rank restores, and the result is the clean run's."""
    ranks = dp_run[2][shape]
    for r, res in enumerate(ranks):
        sv = res["supervised"]
        assert sv["clean"]["recovered"] == 0
        assert sv["injected"]["recovered"] == 1, (shape, r)
        assert sv["injected"]["writer"] == (r == 0)
        assert sv["injected"]["losses"] == sv["clean"]["losses"]
        for k, w in sv["clean"]["words"].items():
            assert np.array_equal(sv["injected"]["words"][k], w), k
            assert np.array_equal(ranks[0]["supervised"]["clean"]["words"][k],
                                  w), k


@pytest.mark.parametrize("shape", MESHES)
def test_stochastic_q_u_needs_one_seed(dp_run, shape):
    """A stochastic Q_U steps to the same words on every rank when the
    generators share a seed, and raises on every rank when one differs."""
    ranks = dp_run[2][shape]
    for res in ranks:
        st = res["stochastic"]
        assert isinstance(st["same"], dict), st["same"]
        for k, w in ranks[0]["stochastic"]["same"].items():
            assert np.array_equal(st["same"][k], w), k
        assert isinstance(st["differs"], str)
        assert "same generator seed" in st["differs"]


def test_moe_dp_step_matches_jax_groups(dp_run):
    """deepseek-smoke (MLA, MTP, the balance loss; lns8 at f32) on (2, 1)
    against JAX and the port's one-process step with two dispatch
    groups; the balance loss's shares sum to one process's."""
    want, one, out = dp_run
    ranks = out[(2, 1)]
    for res in ranks:
        for (l, g, w), (l0, g0, w0) in zip(res["moe"], ranks[0]["moe"]):
            assert (l, g) == (l0, g0)
            assert all(np.array_equal(w[k], w0[k]) for k in w0)
        np.testing.assert_allclose(res["moe_aux"], one["moe_aux"], rtol=1e-6)
    got = ranks[0]["moe"]
    for ref in (one["moe"], want["moe"]):
        for i, ((gl, gn, _), (rl, rn, _)) in enumerate(zip(got, ref)):
            np.testing.assert_allclose(gl, rl, rtol=1e-3, err_msg=f"step {i}")
            np.testing.assert_allclose(gn, rn, rtol=0.1, err_msg=f"step {i}")
        n, tot, _ = _word_diffs(got[0][2], ref[0][2])
        assert n <= 0.05 * tot, (n, tot)
    assert any("w_down::packed" in k for k in got[0][2])


@pytest.mark.parametrize("shape", MESHES)
def test_train_cli_mesh(dp_run, shape):
    """``launch.train --mesh N,1`` trains in the ranks' world (every rank
    reports the same losses) and ``--mesh N,2`` is refused."""
    ranks = dp_run[2][shape]
    for res in ranks:
        cli = res["cli"]
        assert cli["mesh"] == {"data": shape[0], "model": 1}
        assert cli["losses"] == ranks[0]["cli"]["losses"]
        assert len(cli["losses"]) == 2 and all(np.isfinite(cli["losses"]))
        assert cli["refused"] and "MODEL must be 1" in cli["refused"]


def test_train_cli_mesh_needs_torchrun(monkeypatch):
    """``--mesh 2,1`` with no torchrun environment raises (a mesh that
    silently ran on one rank would pass a parity check vacuously)."""
    from repro_torch.launch import train as train_cli
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        train_cli.main(["--smoke", "--device", "cpu", "--steps", "1",
                        "--mesh", "2,1"])


def test_supervisor_maps_each_batch():
    """``run_supervised(device_put_batch=)`` maps every batch before the
    step sees it, once a step; a map that keeps the values (numpy to
    tensors) leaves the losses and words of the unmapped run."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.loop import SupervisorConfig, run_supervised
    from repro_torch.training.steps import (build_train_step,
                                            init_train_state)
    cfg = get_smoke_config("smollm-135m")
    step = build_train_step(cfg, _qcfg("lns8"), MadamConfig())
    seen, res = [], {}

    def put(b):
        seen.append(sorted(b))
        return {k: torch.as_tensor(v) for k, v in b.items()}

    for name, hook in (("plain", None), ("mapped", put)):
        with tempfile.TemporaryDirectory() as d:
            state = init_train_state(cfg, MadamConfig(), seed=0,
                                     device="cpu")
            ckpt = CheckpointManager(d, keep=2)
            rep = run_supervised(step, state,
                                 SyntheticLM(cfg, batch=4, seq=16), ckpt,
                                 SupervisorConfig(max_steps=2, save_every=1),
                                 device_put_batch=hook)
            _, final = ckpt.restore_latest(state)
            res[name] = (rep.losses, _words(final.params))
    assert len(seen) == 2 and all(k == seen[0] for k in seen)
    assert res["mapped"][0] == res["plain"][0]
    for k, w in res["plain"][1].items():
        assert np.array_equal(res["mapped"][1][k], w), k
