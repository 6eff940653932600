"""The port's baseline optimizers (``optim/baselines.py``,
``optim/madam.py`` ``madam_fp``) and schedules (``optim/schedule.py``)
against the JAX package's, on the same numpy trees and gradients.

Tolerances and why:

* ``sgd``: the same f32 ops in the same order on both sides: bit-equal.
* ``adamw``, ``madam_fp``: the bias corrections (f32 pow), ``sqrt``/
  ``rsqrt`` and ``exp`` may round an ulp apart across the frameworks
  (H1, H6); over 3 steps f32 leaves stay within 8 f32 ulps, and bf16
  leaves, cast once a step, within one bf16 ulp.
* ``quantized_update``: the updated weights go through Q_log, whose
  ``log2`` may round an ulp apart (H1), so a weight near a rounding tie
  takes the neighbouring code: such flips are one code and at most 1% of
  the elements; every other weight is on the same code, its value within
  16 f32 ulps (``exp2``'s difference, H1).
* Schedules: within 1 f32 ulp of JAX's value, plus one ulp of ``cos``
  (2^-24) times the cosine's amplitude: near the end of the decay
  ``1 + cos`` cancels, so the ulp by which the two ``cos`` differ is no
  longer small beside the value (4 ulps of it at step 17 of 20).
* The Fig.-7 loop on ``TINY_LM`` (dense weights, ``QuantConfig.lns_madam()``,
  3 steps of sgd_q / adamw_q at Q_U = 10 bits, as
  ``benchmarks/common.py`` runs them): the first loss is the forward
  alone, where a per-tensor Q_A code that ``log2`` rounds the other way
  (H1) moves an activation by 2^(1/8): measured 1.3e-5, held to 5e-5.
  The 8-bit backward is chaotic under such flips (as in
  ``test_torch_train.py``'s lns8 test), and AdamW moves every weight by
  about lr whatever its gradient's size, so a gradient element whose
  sign flips moves its weight 2·lr the other way: later losses measured
  within 8.4e-4, held to 2e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.paper_models import TINY_LM as J_TINY_LM  # noqa: E402
from repro.core.lns import LNSFormat as JFormat  # noqa: E402
from repro.core.quantizer import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.quantizer import \
    quantize_grads as j_quantize_grads  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import madam_fp as j_madam_fp  # noqa: E402
from repro.optim import quantized_update as j_quantized_update  # noqa: E402
from repro.optim import schedule as j_schedule  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro.training.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro_torch.configs.paper_models import TINY_LM  # noqa: E402
from repro_torch.core.lns import LNSFormat  # noqa: E402
from repro_torch.core.quantizer import (QuantConfig,  # noqa: E402
                                        quantize_grads)
from repro_torch.models.model import lm_loss  # noqa: E402
from repro_torch.optim import (adamw, madam_fp, quantized_update,  # noqa: E402
                               sgd)
from repro_torch.optim import schedule  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

STEPS = 3
OPTS = {
    "sgd": (lambda: j_sgd(lr=0.3, weight_decay=1e-4),
            lambda: sgd(lr=0.3, weight_decay=1e-4)),
    "adamw": (lambda: j_adamw(lr=3e-3), lambda: adamw(lr=3e-3)),
    "madam_fp": (lambda: j_madam_fp(lr=2.0 ** -6),
                 lambda: madam_fp(lr=2.0 ** -6)),
}
F32_ULPS, QUANT_F32_ULPS, FLIP_SHARE = 8, 16, 0.01
FIG7_RTOL = (5e-5, 2e-3)      # the first loss, the later ones


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, scale=1.0):
    """A small tree: f32 and bf16 leaves, 1-D, 2-D and a stacked 3-D."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"w": f(6, 5), "b": f(5),
            "blk": {"u": f(3, 4, 8), "g": f(8)}}


BF16 = {("blk", "u"), ("blk", "g")}


def _both(np_tree):
    """The same numpy tree as JAX arrays and torch tensors (the ``blk``
    leaves in bf16, rounded once in torch and carried to JAX as f32)."""
    t = tree_map(torch.from_numpy, np_tree)
    for path, x in list(leaves(t)):
        if path in BF16:
            t[path[0]][path[1]] = x.to(torch.bfloat16)
    j = jax.tree.map(jnp.asarray, np_tree)
    for a, b in BF16:
        j[a][b] = jnp.asarray(t[a][b].to(torch.float32).numpy()).astype(
            jnp.bfloat16)
    return j, t


def _ulps(a: torch.Tensor, b: np.ndarray) -> np.ndarray:
    """Distance in units in the last place of ``a``'s dtype."""
    if a.dtype == torch.bfloat16:
        ia = a.view(torch.int16).numpy().astype(np.int64)
        ib = torch.from_numpy(np.asarray(b, np.float32)).to(
            torch.bfloat16).view(torch.int16).numpy().astype(np.int64)
    else:
        ia = a.numpy().view(np.int32).astype(np.int64)
        ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _run(jopt, topt):
    """``STEPS`` updates on both sides from the same params and the same
    per-step gradients; returns the (JAX, port) params after each."""
    jp, tp = _both(_tree(0))
    jinit, jupd = jopt
    tinit, tupd = topt
    js, ts = jinit(jp), tinit(tp)
    out = []
    for i in range(STEPS):
        jg, tg = _both(_tree(10 + i, scale=0.1))
        jp, js = jupd(jg, js, jp)
        tp, ts = tupd(tg, ts, tp)
        out.append((jp, tp))
    assert ts.count == int(js.count) == STEPS
    return out


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_matches_jax(name):
    jopt, topt = OPTS[name]
    for i, (jp, tp) in enumerate(_run(jopt(), topt())):
        for path, t in leaves(tp):
            j = np.asarray(jp[path[0]] if len(path) == 1
                           else jp[path[0]][path[1]]).astype(np.float32)
            assert t.dtype == (torch.bfloat16 if path in BF16
                               else torch.float32)
            d = _ulps(t, j)
            lim = 0 if name == "sgd" else (1 if path in BF16 else F32_ULPS)
            assert d.max() <= lim, (name, i, path, d.max())


@pytest.mark.parametrize("bits", [16, 10])
@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_quantized_update_matches_jax(name, bits):
    jfmt = JFormat(8, 8).with_bits(bits)
    tfmt = LNSFormat(8, 8).with_bits(bits)
    assert (tfmt.bits, tfmt.gamma) == (jfmt.bits, jfmt.gamma)
    jopt, topt = OPTS[name]
    out = _run(j_quantized_update(jopt(), jfmt),
               quantized_update(topt(), tfmt))
    flips = total = 0
    for jp, tp in out:
        for path, t in leaves(tp):
            j = np.asarray(jp[path[0]] if len(path) == 1
                           else jp[path[0]][path[1]]).astype(np.float32)
            tf = t.to(torch.float32).numpy()
            if t.dim() < 2:          # left alone: the optimizer's output
                continue
            # the same code: a few ulps of exp2; a flip: one code apart
            same = _ulps(t.to(torch.float32), j) <= QUANT_F32_ULPS
            if t.dtype == torch.bfloat16:
                same |= _ulps(t, j) <= 1
            step = np.abs(np.log2(np.abs(tf[~same]) / np.abs(j[~same])))
            np.testing.assert_allclose(step * tfmt.gamma, 1.0, atol=0.02)
            flips += int((~same).sum())
            total += t.numel()
    assert flips <= FLIP_SHARE * total, (flips, total)


def _tiny_lm_params():
    params = jax.jit(lambda k: j_init_params(k, J_TINY_LM))(
        jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    return params, tree_map(lambda a: torch.from_numpy(np.array(a)),
                            np_params)


@pytest.mark.parametrize("name", ["sgd_q", "adamw_q"])
def test_fig7_tiny_lm_loop_tracks_jax(name):
    """Three steps of ``benchmarks/common.py``'s Fig.-7 baseline loop on
    both sides, from the same params and batches."""
    fmt_bits = 10
    jbase = {"sgd_q": j_sgd(lr=0.3, weight_decay=0.0),
             "adamw_q": j_adamw(lr=3e-3)}[name]
    tbase = {"sgd_q": sgd(lr=0.3, weight_decay=0.0),
             "adamw_q": adamw(lr=3e-3)}[name]
    jinit, jupd = j_quantized_update(jbase, JFormat(8, 8).with_bits(fmt_bits))
    tinit, tupd = quantized_update(tbase, LNSFormat(8, 8).with_bits(fmt_bits))
    jq, tq = JQuantConfig.lns_madam(), QuantConfig.lns_madam()
    jp, tp = _tiny_lm_params()
    js, ts = jinit(jp), tinit(tp)

    @jax.jit
    def jstep(p, s, b):
        loss, g = jax.value_and_grad(
            lambda p: j_lm_loss(p, b, J_TINY_LM, jq, remat=False))(p)
        p, s = jupd(j_quantize_grads(g, jq), s, p)
        return p, s, loss

    data = JSyntheticLM(J_TINY_LM, batch=16, seq=32, seed=0)
    for i in range(STEPS):
        b = data.batch_at(i)
        jp, js, jl = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        proxies = tree_map(lambda x: x.detach().requires_grad_(True), tp)
        tl = lm_loss(proxies, {k: torch.from_numpy(v) for k, v in b.items()},
                     TINY_LM, tq)
        tl.backward()
        grads = quantize_grads(tree_map(lambda x: x.grad, proxies), tq)
        tp, ts = tupd(grads, ts, tp)
        assert np.isfinite(float(tl.detach()))
        np.testing.assert_allclose(float(tl.detach()), float(jl),
                                   rtol=FIG7_RTOL[min(i, 1)],
                                   err_msg=f"{name} step {i}")


def test_schedules_match_jax():
    total = 20
    pairs = [
        (j_schedule.constant(3e-4), schedule.constant(3e-4)),
        (j_schedule.warmup_cosine(1e-3, 5, total, floor=1e-5),
         schedule.warmup_cosine(1e-3, 5, total, floor=1e-5)),
        (j_schedule.warmup_stable_decay(2e-3, 4, 6, 8),
         schedule.warmup_stable_decay(2e-3, 4, 6, 8)),
    ]
    amps = [0.0, 0.5 * (1e-3 - 1e-5), 0.0]
    for (jfn, tfn), amp in zip(pairs, amps):
        for step in range(total + 6):
            want = np.asarray(jfn(step))
            for s in (step, torch.tensor(step, dtype=torch.int32)):
                got = tfn(s)
                assert got.dtype == torch.float32 and got.dim() == 0
                lim = np.spacing(np.abs(want)) + amp * 2.0 ** -24
                assert abs(float(got) - float(want)) <= lim, step
