"""The port's train step against the JAX package's, on the smollm smoke
config (3 layers, d 48, f32), from one JAX ``TrainState`` carried across
with ``convert.train_state_from_flat`` and the same ``SyntheticLM``
batches.

Tolerances and why:

* ``fp32`` quantizers (LNS weights in the 16-bit store, Madam on packed
  words, no Q_A/Q_W/Q_E/Q_G): the gradients agree to ~1e-6, so step 1's
  words are equal; over 5 steps losses and grad norms agree to rtol 1e-5,
  and after step 5 at most 0.5% of words differ, each by one code (an
  ulp of g* moved a target across a rounding tie).
* ``lns8`` quantizers: the forward agrees to rtol 1e-5 at step 0, but the
  8-bit backward is chaotic under ulp-level differences. exp2 and log2
  differ by ulps across the frameworks (ROADMAP H1), an ulp flips a Q_E
  code near a tie, a flipped code moves that gradient element by
  2^(1/8) = 9%, and the flips compound down the layers: measured grad
  norms differ by up to 4% and 0.7% of the step-1 gradients change sign.
  So the losses are held to rtol 1e-3, grad norms to 10%, and step-1
  words may differ on at most 2%.
* ``fp8`` quantizers (e4m3 Q_W/Q_A/Q_E/Q_G on the fake-quant leg, the
  weights in the 16-bit LNS store that Madam steps): the e4m3 grid is
  built exactly on both sides (its ulps are powers of two JAX's exp2
  hits exactly), but the decoded weights and Q_E's inputs differ by
  ulps (H1), which flip e4m3 roundings near ties and compound as in
  lns8. Measured: step-0 loss 1.5e-7 apart, later losses 2.5e-4, grad
  norms 4%, step-1 words 0.02%; held to the lns8 limits.
* ``numerics=True`` (with Q_G only, so gradients agree): the same stat
  keys; at step 1 the counts agree to f32 rounding of the
  normalization, ``qerr_rel`` and ``code_mean`` to rtol 1e-5.
* ``approx_lut=2`` (every GEMM simulates the hybrid conversion): the
  approximate leg re-encodes each decoded 16-bit weight in f32, and those
  decodes differ by up to 5 ulp across the frameworks (H1), so ~0.1% of
  the 8-bit weight codes land the other way at a tie (the routed GEMM
  re-grids with integers and has none). Measured at step 0 on LUT
  1/2/4/8: losses within 1.6e-4 relative; held to 5e-4. JAX's
  approximate GEMM passes back zero gradients (ROADMAP H9), so beyond
  the forward the port is held to JAX with the straight-through backward
  that JAX's docstring states, patched in for that comparison only:
  losses and grad norms under the ``lns8`` tolerances; step-1 words may
  differ on at most 5%. The flipped weight codes reach the gradients
  too: the port alone, with only its weight decodes swapped for JAX's
  exp2, changed 3.1% of the step-1 words (measured); against JAX 3.7%.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core import quant_training as jqt  # noqa: E402
from repro.core.lns import LNSFormat as JFormat  # noqa: E402
from repro.core.quantizer import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels import dispatch as jd  # noqa: E402
from repro.models.model import lm_loss as j_lm_loss  # noqa: E402
from repro.optim import madam as jmadam  # noqa: E402
from repro.training import build_train_step as j_build  # noqa: E402
from repro.training import init_train_state as j_init  # noqa: E402
from repro.training.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import flatten_state  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import train_state_from_flat  # noqa: E402
from repro_torch.core.lns import LNSFormat  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.model import lm_loss  # noqa: E402
from repro_torch.optim.madam import (MadamConfig, attach_proxies,  # noqa: E402
                                     grad_proxies)
from repro_torch.training.data import SyntheticLM  # noqa: E402
from repro_torch.training.steps import build_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

STEPS, BATCH, SEQ = 5, 4, 32
QCFGS = {
    "fp32": (JQuantConfig.full_precision(), QuantConfig.full_precision()),
    "lns8": (JQuantConfig.lns_madam(), QuantConfig.lns_madam()),
    # Q_G only: the update and encode stats see the same gradients
    "qg": (JQuantConfig(grad=JFormat(8, 8)), QuantConfig(grad=LNSFormat(8, 8))),
    "approx2": (JQuantConfig.lns_madam(approx_lut=2),
                QuantConfig.lns_madam(approx_lut=2)),
    "fp8": (JQuantConfig.fp8(), QuantConfig.fp8()),
}


@pytest.fixture(autouse=True)
def _one_thread_no_launch():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ops.reset_launch_counts()
    yield
    torch.set_num_threads(n)
    assert all(c == 0 for c in ops.launch_counts().values())


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["::".join(str(getattr(k, "key", getattr(k, "idx",
                                                     getattr(k, "name", k))))
                      for k in path)] = np.array(leaf)
    return out


@pytest.fixture(scope="module")
def jax_state():
    cfg = j_smoke_config("smollm-135m")
    mcfg = jmadam.MadamConfig()
    state = jax.jit(lambda k: j_init(k, cfg, mcfg))(jax.random.PRNGKey(0))
    return cfg, mcfg, state


def _run_both(jax_state, qname, *, accum=1, numerics=False, steps=STEPS):
    """Carry one JAX state across and take ``steps`` steps on both sides;
    returns per-step (JAX metrics, port metrics, JAX words, port words)."""
    cfg, mcfg, js = jax_state
    jq, tq = QCFGS[qname]
    with jd.configured(backend="reference"):
        jstep = jax.jit(j_build(cfg, jq, mcfg, accum_steps=accum,
                                numerics=numerics))
    ts = train_state_from_flat(_flat(js), MadamConfig(), device="cpu")
    tstep = build_train_step(get_smoke_config("smollm-135m"), tq,
                             MadamConfig(), accum_steps=accum,
                             numerics=numerics)
    data = JSyntheticLM(cfg, batch=BATCH, seq=SEQ)
    out = []
    for i in range(steps):
        b = data.batch_at(i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, b)
        out.append((jm, tm, _flat(js.params), flatten_state(ts.params)))
    assert ts.step == int(js.step) == steps
    assert ts.opt.count == int(js.opt.count) == steps
    return out


def _word_diffs(jf, tf):
    n = tot = 0
    codes = []
    for k in jf:
        if k.endswith("packed"):
            a, b = jf[k].astype(np.int64), tf[k].astype(np.int64)
            d = a != b
            n += int(d.sum())
            tot += a.size
            codes.append(np.abs(a - b)[d])
    return n, tot, np.concatenate(codes)


def test_synthetic_lm_batches_byte_equal():
    cfg = j_smoke_config("smollm-135m")
    jdata = JSyntheticLM(cfg, batch=3, seq=17, seed=5)
    tdata = SyntheticLM(get_smoke_config("smollm-135m"), batch=3, seq=17,
                        seed=5)
    for cursor in (0, 1, 12345):
        a, b = jdata.batch_at(cursor), tdata.batch_at(cursor)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(jax_state, accum):
    out = _run_both(jax_state, "fp32", accum=accum)
    for i, (jm, tm, jf, tf) in enumerate(out):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5,
                                   err_msg=f"grad norm, step {i}")
        n, tot, codes = _word_diffs(jf, tf)
        if i == 0:
            assert n == 0, f"step-1 words differ on {n}"
    assert n <= 0.005 * tot, (n, tot)
    assert np.all(codes == 1)


def test_train_step_lns8_tracks_jax(jax_state):
    out = _run_both(jax_state, "lns8")
    np.testing.assert_allclose(float(out[0][1]["loss"]),
                               float(out[0][0]["loss"]), rtol=1e-5)
    for i, (jm, tm, jf, tf) in enumerate(out):
        assert math.isfinite(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=0.1,
                                   err_msg=f"grad norm, step {i}")
    n, tot, _ = _word_diffs(out[0][2], out[0][3])
    assert n <= 0.02 * tot, (n, tot)


def test_train_step_fp8_tracks_jax(jax_state):
    out = _run_both(jax_state, "fp8")
    np.testing.assert_allclose(float(out[0][1]["loss"]),
                               float(out[0][0]["loss"]), rtol=1e-5)
    for i, (jm, tm, jf, tf) in enumerate(out):
        assert math.isfinite(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=0.1,
                                   err_msg=f"grad norm, step {i}")
    n, tot, _ = _word_diffs(out[0][2], out[0][3])
    assert n <= 0.02 * tot, (n, tot)


def test_fp8_step_never_reaches_k1_k2(monkeypatch):
    """Under ``QuantConfig.fp8()`` no GEMM routes: ``dispatch.encode_pack``
    and ``dispatch.qmatmul`` (K1, K2) are never called, while the Madam
    step (K3's dispatch) still steps every packed leaf of rank >= 2 once,
    as on the lns8 path."""
    from repro_torch.kernels import dispatch
    from repro_torch.training.steps import init_train_state

    def refuse(*a, **k):
        raise AssertionError("a GEMM routed under the fp8 config")

    monkeypatch.setattr(dispatch, "encode_pack", refuse)
    monkeypatch.setattr(dispatch, "qmatmul", refuse)
    calls = []
    step_fn = dispatch.madam_step
    monkeypatch.setattr(dispatch, "madam_step", lambda *a, **k: (
        calls.append(a[0].shape), step_fn(*a, **k))[1])
    cfg, mcfg = get_smoke_config("smollm-135m"), MadamConfig()
    state = init_train_state(cfg, mcfg, device="cpu")
    step = build_train_step(cfg, QuantConfig.fp8(), mcfg)
    state, m = step(state, SyntheticLM(cfg, batch=2, seq=8).batch_at(0))
    assert math.isfinite(float(m["loss"]))
    packed = [p for _, p in leaves(state.params) if hasattr(p, "packed")]
    assert len(calls) == len(packed) == 8


def _jax_ste_approx(approx):
    """JAX's ``approx_qeinsum`` with the straight-through backward its
    docstring states: its own forward value, and the gradient of
    ``einsum(Q_A(x), Q_W(w))`` through JAX's ``ste_quantize``."""
    from repro.core.quantizer import ste_quantize

    def fn(eq, x, w, cfg):
        y_approx = approx(eq, x, w, cfg).astype(jnp.float32)
        xs = ste_quantize(x, cfg.act or cfg.weight, cfg.act_scale_axis)
        ws = ste_quantize(w, cfg.weight, cfg.weight_scale_axis)
        y_exact = jnp.einsum(eq, xs.astype(jnp.float32),
                             ws.astype(jnp.float32))
        return (y_exact + jax.lax.stop_gradient(y_approx - y_exact)
                ).astype(x.dtype)
    return fn


APPROX_LOSS_RTOL = 5e-4
APPROX_WORD_SHARE = 0.05


def test_train_step_approx_tracks_jax(jax_state, monkeypatch):
    (jm, tm, _, _), = _run_both(jax_state, "approx2", steps=1)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=APPROX_LOSS_RTOL)
    assert float(jm["grad_norm"]) == 0.0 < float(tm["grad_norm"])   # H9
    monkeypatch.setattr(jqt, "approx_qeinsum",
                        _jax_ste_approx(jqt.approx_qeinsum))
    out = _run_both(jax_state, "approx2", steps=3)
    np.testing.assert_allclose(float(out[0][1]["loss"]),
                               float(out[0][0]["loss"]),
                               rtol=APPROX_LOSS_RTOL)
    for i, (jm, tm, jf, tf) in enumerate(out):
        assert math.isfinite(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3, err_msg=f"loss, step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=0.1,
                                   err_msg=f"grad norm, step {i}")
    n, tot, _ = _word_diffs(out[0][2], out[0][3])
    assert n <= APPROX_WORD_SHARE * tot, (n, tot)


def test_train_step_numerics_matches_jax(jax_state):
    (jm, tm, _, _), = _run_both(jax_state, "qg", numerics=True, steps=1)
    jn, tn = jm["numerics"], tm["numerics"]
    assert set(tn) == set(jn) == {"update", "grad_encode"}
    for site in jn:
        assert set(tn[site]) == set(jn[site]), site
        for layer, stats in jn[site].items():
            assert set(tn[site][layer]) == set(stats), (site, layer)
            for k, v in stats.items():
                rtol = 1e-5 if k in ("qerr_rel", "qerr_gap_ratio",
                                     "code_mean") else 1e-6
                np.testing.assert_allclose(
                    float(tn[site][layer][k]), float(v), rtol=rtol,
                    atol=1e-12, err_msg=f"{site}.{layer}.{k}")


def test_stacked_leaf_grads_match_jax_in_every_layer(jax_state):
    """The gradient of each stacked leaf accumulates all three layers'
    dW through the per-layer slices of its ``delta``."""
    cfg, mcfg, js = jax_state
    jq, tq = QCFGS["fp32"]
    b = JSyntheticLM(cfg, batch=BATCH, seq=SEQ).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    @jax.jit
    def jgrad(diff):
        return jax.grad(lambda d: j_lm_loss(
            jmadam.attach_proxies(js.params, d), jb, cfg, jq,
            remat=False))(diff)

    jg = _flat(jgrad(jmadam.grad_proxies(js.params, jnp.float32)))
    ts = train_state_from_flat(_flat(js), MadamConfig(), device="cpu")
    prox = grad_proxies(ts.params, torch.float32)
    lm_loss(attach_proxies(ts.params, prox),
            {k: torch.from_numpy(v) for k, v in b.items()},
            get_smoke_config("smollm-135m"), tq).backward()
    for path, d in leaves(prox):
        want = jg["::".join(path)]
        got = d.grad.numpy()
        assert got.shape == want.shape
        layers = range(want.shape[0]) if "period" in path else [None]
        for li in layers:
            a = got if li is None else got[li]
            w = want if li is None else want[li]
            np.testing.assert_allclose(a, w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{path} layer {li}")


def test_checkpoints_round_trip_both_ways(jax_state, tmp_path):
    cfg, mcfg, js = jax_state
    ts = train_state_from_flat(_flat(js), MadamConfig(), device="cpu")
    # the port writes, JAX reads
    CheckpointManager(str(tmp_path / "port")).save(3, ts, data_cursor=7,
                                                   async_=False)
    jm = JCheckpointManager(str(tmp_path / "port"))
    assert jm.latest_step() == 3 and jm.manifest(3)["data_cursor"] == 7
    back = _flat(jm.restore(3, js))
    want = _flat(js)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    # JAX writes, the port reads
    jw = JCheckpointManager(str(tmp_path / "jax"))
    jw.save(5, js, data_cursor=2, async_=False)
    pm = CheckpointManager(str(tmp_path / "jax"))
    step, restored = pm.restore_latest(ts)
    assert step == 5 and pm.manifest(5)["data_cursor"] == 2
    got, exp = flatten_state(restored), flatten_state(ts)
    assert got.keys() == exp.keys() == want.keys()
    for k in exp:
        np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
    packed = restored.params["embed"]["tok"].packed
    assert packed.dtype == torch.int32


def test_train_cli_runs_on_cpu(capsys, tmp_path):
    """The CLI trains; with the observer's flags it also writes a trace
    and a step log that ``repro_torch.obs.validate`` accepts, prints a
    progress line a step and the kernel attribution rows, and writes a
    ``torch.profiler`` trace."""
    from repro_torch.launch.train import main
    from repro_torch.obs import validate
    out = main(["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
                "--seq", "16"])
    assert out["steps"] == 3 and len(out["losses"]) == 3
    assert all(math.isfinite(x) for x in out["losses"])
    text = capsys.readouterr().out
    assert "arch=smollm-smoke params=" in text and "done: 3 steps" in text
    log = tmp_path / "steps.jsonl"
    obs = main(["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
                "--seq", "16", "--trace-dir", str(tmp_path),
                "--numerics-log", str(log), "--kernel-stats",
                "--quiet=false", "--progress-every", "1",
                "--torch-profile", str(tmp_path / "prof")])
    text = capsys.readouterr().out
    assert "[train] step 1  loss" in text and "[train] step 2  loss" in text
    assert "kernel madam_step|plain|b16: calls=16" in text
    assert obs["losses"][0] == out["losses"][0]  # the same first forward
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert set(rows[0]["numerics"]) == {"update", "grad_encode"}
    assert validate.main([obs["trace"]["trace"], "--train"]) == 0
    assert obs["kernel_stats"]["madam_step|plain|b16"]["traces"] == 0
    assert len(list((tmp_path / "prof").glob("torch_profile-*.json"))) == 1


def test_train_cli_runs_fp8_on_cpu(capsys):
    """``--format fp8`` trains: Madam's default 16-bit LNS store (Q_U's
    FP16 is not read), e4m3 quantizers, finite losses."""
    from repro_torch.launch.train import main
    out = main(["--smoke", "--device", "cpu", "--format", "fp8", "--steps",
                "3", "--batch", "4", "--seq", "16"])
    assert out["steps"] == 3 and out["failures_recovered"] == 0
    assert all(math.isfinite(x) for x in out["losses"])
    assert "format=fp8" in capsys.readouterr().out


def test_train_cli_matches_jax_param_count():
    """The CLI's parameter count counts the packed words and the scales,
    as the JAX CLI counts its tree's leaves."""
    cfg = j_smoke_config("smollm-135m")
    js = jax.eval_shape(lambda k: j_init(k, cfg, jmadam.MadamConfig()),
                        jax.random.PRNGKey(0))
    n = sum(math.prod(x.shape) for x in jax.tree.leaves(js.params))
    from repro_torch.training.steps import init_train_state
    ts = init_train_state(get_smoke_config("smollm-135m"), MadamConfig(),
                          device="cpu")
    got = sum(p.packed.numel() + p.scale.numel() if hasattr(p, "packed")
              else p.numel() for _, p in leaves(ts.params))
    assert got == n


def test_q_u_is_the_optimizer_store(monkeypatch):
    """Q_U and ``MadamConfig.update_format`` name one store: the paper's
    setting agrees with Madam's default, the train step refuses a pair
    that disagrees, and the CLI takes its store from Q_U (an 8-bit Q_U
    trains, where Madam's 16-bit default would be refused)."""
    from repro_torch.launch import train as cli
    cfg = get_smoke_config("smollm-135m")
    q8 = QuantConfig.lns_madam(update_bits=8)
    assert QuantConfig.lns_madam().update == MadamConfig().update_format
    with pytest.raises(ValueError, match="Q_U"):
        build_train_step(cfg, q8, MadamConfig())
    build_train_step(cfg, q8, MadamConfig(update_format=LNSFormat(8, 8)))
    monkeypatch.setattr(cli, "_quant_config", lambda fmt: q8)
    out = cli.main(["--smoke", "--device", "cpu", "--steps", "1",
                    "--batch", "2", "--seq", "8"])
    assert out["steps"] == 1 and math.isfinite(out["losses"][0])


def test_supervisor_restarts_from_checkpoint(tmp_path):
    """An injected failure restores the last checkpoint and re-seeks the
    data; the run still ends with every step committed and saved."""
    from repro_torch.training.loop import SupervisorConfig, run_supervised
    from repro_torch.training.steps import init_train_state
    cfg, mcfg = get_smoke_config("smollm-135m"), MadamConfig()
    state = init_train_state(cfg, mcfg, device="cpu")
    step = build_train_step(cfg, QuantConfig.lns_madam(), mcfg)
    failed = []

    def inject(i):
        if i == 3 and not failed:
            failed.append(i)
            raise RuntimeError("injected device loss")

    ckpt = CheckpointManager(str(tmp_path), keep=2)
    data = SyntheticLM(cfg, batch=2, seq=8)
    report = run_supervised(step, state, data, ckpt,
                            SupervisorConfig(max_steps=5, save_every=2),
                            failure_injector=inject)
    assert report.failures_recovered == 1 and report.steps_done == 6
    assert ckpt.latest_step() == 5 and ckpt.manifest(5)["step"] == 5
    assert len([d for d in (tmp_path).iterdir()
                if d.name.startswith("step_")]) == 2
    _, restored = ckpt.restore_latest(state)
    assert restored.step == 5 and restored.opt.count == 5
