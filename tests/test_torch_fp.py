"""The port's miniature-float fake-quantization (``numerics/fp.py``) and
the quantizer's FP formats against the JAX package, on the same numpy
inputs.

Tolerances and why:

* ``fp_quantize`` vs JAX: JAX builds the unit in the last place with
  ``exp2``, which on XLA-CPU is inexact at some integer arguments
  (ROADMAP H12); the port builds it exactly. So JAX's result can sit
  off the port's by the relative error δ of JAX's ``exp2`` over the
  arguments the format uses (δ is measured here, from JAX itself: 0 for
  e4m3, 5.4e-7 for e5m10), plus the rounding of the final product,
  2^-22 of the value. Where that error moved v/ulp across a rounding tie,
  the two differ by one step of the grid: such flips must be rare (at
  most 0.1% of the elements; one of 6,144 measured).
* The port's normalized values (before the scale is applied) are the
  round trip through ``torch.float8_e4m3fn`` (e4m3) or ``float16``
  (e5m10) bit for bit: both round half to even onto the same grid, and
  the absmax scaling keeps |v| <= max_value, below where the two
  formats' largest values differ (240 here, 448 in e4m3fn).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.quantizer import QuantConfig as JQuantConfig  # noqa: E402
from repro.numerics.fp import FPFormat as JFPFormat  # noqa: E402
from repro.numerics.fp import fp_quantize as j_fp_quantize  # noqa: E402
from repro_torch.core import quantizer as tq  # noqa: E402
from repro_torch.core.lns import LNSFormat, lns_quantize  # noqa: E402
from repro_torch.numerics import FPFormat, fp_quantize, fp_round  # noqa: E402

FORMATS = [(4, 3), (5, 10)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
CASTS = {(4, 3): torch.float8_e4m3fn, (5, 10): torch.float16}
FLIP_SHARE = 1e-3


def _inputs(fmt, seed=0):
    """Values spanning 2^-20..2^20 of both signs, a row of zeros, a row at
    exactly ±max_value, and a row in the subnormal range of the grid."""
    rng = np.random.default_rng(seed)
    x = (np.exp2(rng.uniform(-20, 20, (64, 96)))
         * rng.choice([-1, 1], (64, 96))).astype(np.float32)
    x[0] = 0.0
    x[1] = fmt.max_value
    x[1, 1::2] = -fmt.max_value
    x[2] = (np.float32(fmt.max_value) * np.exp2(
        -fmt.bias - fmt.man_bits - rng.uniform(-2, 6, 96))).astype(np.float32)
    return x


def _jax_exp2_error(fmt):
    """The largest relative error of JAX's exp2 at the integer arguments
    ``fp_quantize`` takes for ``fmt`` (e - man_bits)."""
    args = np.arange(1 - fmt.bias - fmt.man_bits, fmt.bias - fmt.man_bits + 1)
    got = np.asarray(jnp.exp2(jnp.asarray(args, jnp.float32)), np.float64)
    return float(np.max(np.abs(got / np.exp2(args) - 1.0)))


@pytest.mark.parametrize("bits", FORMATS)
def test_fp_format_fields_match_jax(bits):
    a, b = FPFormat(*bits), JFPFormat(*bits)
    for f in ("bits", "bias", "max_value", "min_normal"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("axis", [None, -1])
@pytest.mark.parametrize("bits", FORMATS)
def test_fp_quantize_matches_jax(bits, axis, dt):
    fmt = FPFormat(*bits)
    tdt, jdt = DTYPES[dt]
    x = torch.from_numpy(_inputs(fmt)).to(tdt)
    got = fp_quantize(x, fmt, scale_axis=axis)
    assert got.dtype == tdt and got.shape == x.shape
    a = got.to(torch.float32).numpy()
    b = np.asarray(j_fp_quantize(jnp.asarray(x.to(torch.float32).numpy())
                                 .astype(jdt), JFPFormat(*bits), axis)
                   .astype(jnp.float32))
    delta = _jax_exp2_error(fmt)
    if delta == 0.0:
        np.testing.assert_array_equal(a, b)
        return
    near = np.abs(a - b) <= (delta + 2.0 ** -22) * np.abs(a)
    flips = ~near
    assert flips.sum() <= FLIP_SHARE * a.size, flips.sum()
    if flips.any():
        # one grid step: 2^(e - man_bits) of the normalized value, scaled
        xf = x.to(torch.float32)
        amax = (xf.abs().amax() if axis is None
                else xf.abs().amax(dim=0, keepdim=True))
        scale = (torch.clamp_min(amax, torch.finfo(torch.float32).tiny)
                 / fmt.max_value).numpy()
        v = np.broadcast_to(np.abs(a) / scale, a.shape)[flips]
        e = np.clip(np.floor(np.log2(np.maximum(v, 1e-38))), 1 - fmt.bias,
                    fmt.bias)
        step = np.exp2(e - fmt.man_bits) * np.broadcast_to(
            scale, a.shape)[flips]
        assert np.all(np.abs(a - b)[flips] <= 1.001 * step)


@pytest.mark.parametrize("axis", [None, -1])
@pytest.mark.parametrize("bits", FORMATS)
def test_normalized_values_equal_the_cast_round_trip(bits, axis):
    fmt = FPFormat(*bits)
    x = torch.from_numpy(_inputs(fmt, seed=1))
    amax = (x.abs().amax() if axis is None
            else x.abs().amax(dim=0, keepdim=True))
    v = x / (torch.clamp_min(amax, torch.finfo(torch.float32).tiny)
             / fmt.max_value)
    assert float(v.abs().max()) <= fmt.max_value * (1 + 2 ** -20)
    q = fp_round(v, fmt)
    want = v.to(CASTS[bits]).to(torch.float32)
    assert torch.equal(q.view(torch.int32), want.view(torch.int32))


def test_fp8_quantize_known_values():
    """``tests/test_quantizer.py``'s known values: points already on the
    e4m3 grid survive (the scale is absmax / max_value = 1)."""
    fmt = FPFormat(exp_bits=4, man_bits=3)
    x = torch.tensor([fmt.max_value, fmt.max_value / 2, 0.0])
    np.testing.assert_allclose(fp_quantize(x, fmt).numpy(), x.numpy(),
                               rtol=1e-6)


def test_fp8_config_matches_jax_and_never_routes():
    """``QuantConfig.fp8()`` field for field as JAX's, and a packed weight
    under it takes the fake-quant leg: ``_routable`` refuses any operand
    format that is not LNS."""
    j, t = JQuantConfig.fp8(), tq.QuantConfig.fp8()
    for f in ("weight", "act", "err", "grad", "update"):
        jf, tf = getattr(j, f), getattr(t, f)
        assert (tf.exp_bits, tf.man_bits) == (jf.exp_bits, jf.man_bits), f
    assert t.weight == t.act and t.is_quantized
    w = tq.LNSWeight(torch.zeros(4, 3, dtype=torch.uint8),
                     torch.ones(1, 3), LNSFormat(8, 8))
    assert not tq._routable("bsd,df->bsf", w, t)
    lns = tq.QuantConfig.lns_madam()
    assert tq._routable("bsd,df->bsf", w, lns)
    mixed = tq.QuantConfig(weight=LNSFormat(8, 8), act=FPFormat())
    assert not tq._routable("bsd,df->bsf", w, mixed)


@pytest.mark.parametrize("fmt", [FPFormat(4, 3), LNSFormat(8, 8)],
                         ids=["e4m3", "lns8"])
def test_every_quantizer_applies_the_format(fmt):
    """Q_W/Q_A (``ste_quantize``), Q_E (``backward_quantize``) and Q_G
    (``quantize_grads``) all put values on ``fmt``'s grid."""
    fq = (fp_quantize if isinstance(fmt, FPFormat) else
          lambda x, f, scale_axis=None: lns_quantize(x, f, scale_axis))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (5, 7)).astype(np.float32)).requires_grad_(True)
    assert torch.equal(tq.ste_quantize(x, fmt, -1), fq(x.detach(), fmt, -1))
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, 7)).astype(np.float32))
    tq.backward_quantize(x, fmt, None, torch.float32).backward(g)
    assert torch.equal(x.grad, fq(g, fmt))
    cfg = tq.QuantConfig(grad=fmt)
    out = tq.quantize_grads({"a": {"b": g}}, cfg)
    assert torch.equal(out["a"]["b"], fq(g, fmt))
