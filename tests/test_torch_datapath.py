"""The paper's hardware datapath in the port against the JAX package, on the
same numpy inputs: the conversion functions, the plain K8 (the bit-exact
Fig.-6 integer matmul), the end-to-end ``kernels.lns_matmul``, the
approximation-aware GEMM (Table 10), the plain K9 (the unpacked Madam
step) and the energy model.

Tolerances and why:

* The LUT constructors are the same numpy code, and every integer function is
  integer arithmetic on the same tables: exact equality.
* ``exp2_exact``/``exp2_hybrid`` multiply an f32 ``exp2(q)`` by a LUT
  entry. XLA's CPU ``exp2`` is exact on the integers -12..12 only
  (ROADMAP H1), so for q <= 12 the two agree bit for bit; beyond it the
  port's value is exactly ``2**q · LUT`` (checked against f64) and JAX's
  is off by up to 19 ulp, so JAX is held to 24 ulp there.
  ``approx_decode_factor`` divides by ``exp2(r/γ)`` at a fractional
  exponent: within 2 ulp.
* The plain K8 and ``kernels.lns_matmul`` are integer datapaths with exact
  pow2 rescales: exact equality with ``lns_matmul_pallas`` (interpret mode,
  as the JAX tests run it) and ``repro.kernels.lns_matmul``.
* ``approx_qeinsum``: the bucket factors differ by <= 2 ulp and the γ f32
  einsums sum in another order, so y agrees to 1e-5 of max |y|.
* Its gradient is the straight-through gradient of the exact fake-quant
  einsum. JAX's function returns zeros there (ROADMAP H9: its ``y_exact``
  is built from decoded codes, through which no gradient flows); the port
  is held to JAX's exact fake-quant GEMM's gradient, to 2e-5 (f32 decodes
  differ by up to 9 ulp, H1; sums reorder).
* K9: ``rsqrt`` differs across frameworks (H6), so codes may round the
  other way within 4 ulp of a half-integer, by one code; the Pallas kernel
  in interpret mode fuses the EMA's last multiply-add, so v' is within 1
  ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import conversion as jconv  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import quant_training as jqt  # noqa: E402
from repro.core import quantizer as jq  # noqa: E402
from repro.core.lns import LNSFormat as JFormat  # noqa: E402
from repro.core.lns import compute_scale as jscale  # noqa: E402
from repro.core.lns import lns_encode as jencode  # noqa: E402
from repro.core.lns import lns_pack as jpack  # noqa: E402
from repro.kernels import lns_matmul as j_lns_matmul  # noqa: E402
from repro.kernels import madam_step as j_madam_step  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.lns_matmul import lns_matmul_pallas  # noqa: E402
from repro_torch.core import conversion, energy, quant_training  # noqa: E402
from repro_torch.core.lns import LNSFormat  # noqa: E402
from repro_torch.core.quantizer import QuantConfig, qeinsum  # noqa: E402
from repro_torch.kernels import dispatch, lns_matmul, ops, ref  # noqa: E402

GAMMAS = [1, 2, 4, 8, 16]
FLOAT_ULPS_SMALL_Q = 0     # q <= 12: XLA's exp2 is exact there
FLOAT_ULPS_JAX = 24        # q up to 39: XLA's exp2(q) is off by <= 19 ulp
DECODE_FACTOR_ULPS = 2
APPROX_RTOL = 1e-5
GRAD_RTOL = 2e-5
TIE_ULPS = 4


@pytest.fixture(autouse=True)
def _one_thread_no_launch():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ops.reset_launch_counts()
    yield
    torch.set_num_threads(n)
    assert all(c == 0 for c in ops.launch_counts().values())


def _luts(gamma):
    return [2 ** i for i in range(gamma.bit_length())]


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32)).max())


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# core.conversion


@pytest.mark.parametrize("gamma", GAMMAS)
def test_conversion_luts_equal_jax(gamma):
    for n in [None] + _luts(gamma):
        np.testing.assert_array_equal(conversion.remainder_lut(gamma, n),
                                      jconv.remainder_lut(gamma, n))
        np.testing.assert_array_equal(conversion.remainder_lut_neg(gamma, n),
                                      jconv.remainder_lut_neg(gamma, n))
        for fb in (8, 16):
            for name in ("remainder_lut_int", "remainder_lut_neg_int"):
                got = getattr(conversion, name)(gamma, fb, n)
                want = getattr(jconv, name)(gamma, fb, n)
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want, err_msg=name)
            if n is not None:
                np.testing.assert_array_equal(
                    conversion.remainder_lut_neg_shifted_int(gamma, fb, n),
                    jconv.remainder_lut_neg_shifted_int(gamma, fb, n))
    with pytest.raises(ValueError):
        conversion.remainder_lut(gamma, 2 * gamma)
    with pytest.raises(ValueError):
        conversion.remainder_lut(3)


@pytest.mark.parametrize("gamma", GAMMAS)
def test_conversion_fixed_point_equal_jax(gamma):
    """Every integer function, bit for bit: the positive convention over
    the range its docstring allows (q <= 13 at frac_bits 16), the negative
    one over every product exponent of 8-bit words and past q = 31."""
    p = np.arange(0, 14 * gamma, dtype=np.int32)
    m = np.arange(0, max(300, 33 * gamma), dtype=np.int32)
    cases = [("exp2_exact_fixed", p, ()), ("exp2_neg_exact_fixed", m, ())]
    for n in _luts(gamma):
        cases += [("exp2_hybrid_fixed", p, (n,)),
                  ("exp2_neg_hybrid_fixed", m, (n,))]
    for name, x, extra in cases:
        for fb in (8, 16):
            got = getattr(conversion, name)(_t(x), gamma, *extra,
                                            frac_bits=fb)
            want = np.asarray(getattr(jconv, name)(jnp.asarray(x), gamma,
                                                   *extra, frac_bits=fb))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{name} {extra} fb={fb}")


@pytest.mark.parametrize("gamma", GAMMAS)
def test_conversion_float_within_ulps(gamma):
    small = np.arange(0, 13 * gamma, dtype=np.int32)       # q <= 12
    full = np.arange(0, 40 * gamma, dtype=np.int32)        # q <= 39
    exact_f64 = (np.exp2(full // gamma).astype(np.float64)
                 * jconv.remainder_lut(gamma)[full % gamma]).astype(np.float32)
    t_full = conversion.exp2_exact(_t(full), gamma).numpy()
    assert _ulps(t_full, exact_f64) == 0
    assert _ulps(t_full, jconv.exp2_exact(jnp.asarray(full), gamma)) \
        <= FLOAT_ULPS_JAX
    assert _ulps(conversion.exp2_exact(_t(small), gamma),
                 jconv.exp2_exact(jnp.asarray(small), gamma)) \
        <= FLOAT_ULPS_SMALL_Q
    r = np.arange(gamma, dtype=np.int32)
    for n in _luts(gamma):
        assert _ulps(conversion.exp2_hybrid(_t(small), gamma, n),
                     jconv.exp2_hybrid(jnp.asarray(small), gamma, n)) \
            <= FLOAT_ULPS_SMALL_Q, n
        assert _ulps(conversion.exp2_hybrid(_t(full), gamma, n),
                     jconv.exp2_hybrid(jnp.asarray(full), gamma, n)) \
            <= FLOAT_ULPS_JAX, n
        assert _ulps(conversion.approx_decode_factor(_t(r), gamma, n),
                     jconv.approx_decode_factor(jnp.asarray(r), gamma, n)) \
            <= DECODE_FACTOR_ULPS, n
    # the full LUT is the exact conversion: every factor is 1 within ulps
    f = conversion.approx_decode_factor(_t(r), gamma, gamma).numpy()
    assert _ulps(f, np.ones_like(f)) <= DECODE_FACTOR_ULPS


# ---------------------------------------------------------------------------
# K8: the plain datapath against lns_matmul_pallas (interpret mode)


def _packed(seed, shape, fmt: JFormat):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(x)
    s = jscale(xj)
    return np.asarray(jpack(*jencode(xj, fmt, s), fmt))


def _both_k8(pa, pb, bits, gamma, **kw):
    jfmt, fmt = JFormat(bits, gamma), LNSFormat(bits, gamma)
    want = np.asarray(lns_matmul_pallas(jnp.asarray(pa), jnp.asarray(pb),
                                        jfmt, interpret=True, **kw))
    got = dispatch.lns_matmul_packed(_t(pa), _t(pb), fmt, **kw)
    assert got.dtype == torch.int32
    return got.numpy(), want


@pytest.mark.parametrize("m,k,n", [(128, 16, 128), (128, 32, 256),
                                   (256, 64, 128)])
@pytest.mark.parametrize("gamma", [2, 8])
def test_k8_plain_equals_pallas(m, k, n, gamma):
    fmt = JFormat(8, gamma)
    pa = _packed(1, (m, k), fmt)
    pb = _packed(2, (k, n), fmt)
    got, want = _both_k8(pa, pb, 8, gamma, block_k=16)
    np.testing.assert_array_equal(got, want)
    oracle = np.asarray(jref.lns_matmul_ref(jnp.asarray(pa), jnp.asarray(pb),
                                            fmt, block_k=16))
    np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("lut_entries", [1, 2, 4, 8])
def test_k8_plain_hybrid_equals_pallas(lut_entries):
    fmt = JFormat(8, 8)
    pa = _packed(3, (128, 32), fmt)
    pb = _packed(4, (32, 128), fmt)
    got, want = _both_k8(pa, pb, 8, 8, lut_entries=lut_entries, block_k=16)
    np.testing.assert_array_equal(got, want)


def test_k8_plain_saturates_like_pallas():
    """All-zero words: every product is 1.0 = 2**16 in Q7.16, so K=256
    would sum to 2**24 without the 24-bit collector's clamp."""
    pa = np.zeros((128, 256), np.uint8)
    pb = np.zeros((256, 128), np.uint8)
    got, want = _both_k8(pa, pb, 8, 8, block_k=16)
    assert (got == ref.SAT24).all() and ref.SAT24 == jref.SAT24
    np.testing.assert_array_equal(got, want)


def test_k8_plain_partial_last_block_equals_jax_oracle():
    """A K that is not a multiple of block_k: the last slice is one slice,
    as in ``lns_matmul_ref`` (the Pallas kernel needs whole blocks)."""
    fmt = JFormat(8, 8)
    pa = _packed(5, (33, 50), fmt)
    pb = _packed(6, (50, 17), fmt)
    got = dispatch.lns_matmul_packed(_t(pa), _t(pb), LNSFormat(8, 8),
                                     lut_entries=2, block_k=16).numpy()
    want = np.asarray(jref.lns_matmul_ref(jnp.asarray(pa), jnp.asarray(pb),
                                          fmt, lut_entries=2, block_k=16))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,k,n,lut", [(64, 48, 40, None), (64, 48, 40, 2),
                                       (33, 50, 17, None), (33, 50, 17, 1)])
def test_lns_matmul_equals_jax(m, k, n, lut):
    rng = np.random.default_rng(m * k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(j_lns_matmul(jnp.asarray(a), jnp.asarray(b),
                                   JFormat(8, 8), lut_entries=lut))
    got = lns_matmul(_t(a), _t(b), LNSFormat(8, 8), lut_entries=lut)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    exact = a @ b
    assert np.abs(got.numpy() - exact).max() < 0.12 * np.abs(exact).max()


def test_lns_matmul_pads_narrow_formats_like_jax():
    """At B=4, γ=4 a pad pair (both words max_code) is not zero: m = 14
    gives 46341 >> 3 = 5792. ``lns_matmul`` pads K with max_code words as
    the JAX function does, so it stays equal to JAX; the unpadded words
    through K8 give another result."""
    assert int(conversion.exp2_neg_exact_fixed(torch.tensor([14]), 4)[0]) \
        == 5792
    fmt, jfmt = LNSFormat(4, 4), JFormat(4, 4)
    rng = np.random.default_rng(7)
    a = rng.standard_normal((20, 50)).astype(np.float32)
    b = rng.standard_normal((50, 24)).astype(np.float32)
    want = np.asarray(j_lns_matmul(jnp.asarray(a), jnp.asarray(b), jfmt))
    got = lns_matmul(_t(a), _t(b), fmt).numpy()
    np.testing.assert_array_equal(got, want)
    pa = _packed_torch(a, fmt)
    pb = _packed_torch(b, fmt)
    unpadded = dispatch.lns_matmul_packed(pa, pb, fmt, block_k=16)
    padded = dispatch.lns_matmul_packed(
        torch.nn.functional.pad(pa, (0, 14), value=fmt.max_code),
        torch.nn.functional.pad(pb, (0, 0, 0, 14), value=fmt.max_code), fmt,
        block_k=16)
    assert not torch.equal(unpadded, padded)
    # each output gains 14 pad pairs of 5792 in its last block
    diff = (padded - unpadded).numpy()
    assert (diff[np.abs(padded.numpy()) < ref.SAT24] == 14 * 5792).all()


def _packed_torch(x, fmt):
    from repro_torch.core.lns import compute_scale, lns_encode, lns_pack
    xt = _t(x)
    return lns_pack(*lns_encode(xt, fmt, compute_scale(xt)), fmt)


# ---------------------------------------------------------------------------
# approximation-aware GEMMs (Table 10)


def _approx_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 16)) * 0.2).astype(np.float32)
    dy = rng.standard_normal((2, 5, 16)).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("lut", [1, 2, 4, 8])
def test_approx_qeinsum_matches_jax(lut):
    x, w, _ = _approx_inputs(lut)
    eq = "bsd,df->bsf"
    want = np.asarray(jq.qeinsum(eq, jnp.asarray(x), jnp.asarray(w),
                                 jq.QuantConfig.lns_madam(approx_lut=lut)))
    got = qeinsum(eq, _t(x), _t(w), QuantConfig.lns_madam(approx_lut=lut))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=APPROX_RTOL * np.abs(want).max())
    # a LUT smaller than γ changes the product: not the exact GEMM
    exact = np.asarray(jq.qeinsum(eq, jnp.asarray(x), jnp.asarray(w),
                                  jq.QuantConfig.lns_madam()))
    if lut < 8:
        assert np.abs(want - exact).max() > 1e-3 * np.abs(exact).max()


def test_approx_product_values_match_jax():
    rng = np.random.default_rng(9)
    ex = rng.integers(0, 128, 500).astype(np.int32)
    ew = rng.integers(0, 128, 500).astype(np.int32)
    fmt = LNSFormat(8, 8)
    for lut in _luts(8):
        got = quant_training.approx_product_values(_t(ex), _t(ew), fmt, lut)
        want = jqt.approx_product_values(jnp.asarray(ex), jnp.asarray(ew),
                                         JFormat(8, 8), lut)
        assert _ulps(got, want) <= FLOAT_ULPS_JAX


def test_approx_qeinsum_grad_is_the_exact_fake_quant_grad():
    """dx and dW of the approximate GEMM equal those of the exact
    fake-quant GEMM: the port's own, and JAX's (``jax.vjp`` of its qeinsum
    without approximation). JAX's approximate GEMM itself passes back
    zeros (H9)."""
    x, w, dy = _approx_inputs(1)
    eq = "bsd,df->bsf"

    def port_grads(cfg):
        xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
        qeinsum(eq, xt, wt, cfg).backward(_t(dy))
        return xt.grad.numpy(), wt.grad.numpy()

    def jax_grads(cfg):
        _, vjp = jax.vjp(lambda a, b: jq.qeinsum(eq, a, b, cfg),
                         jnp.asarray(x), jnp.asarray(w))
        return [np.asarray(g) for g in vjp(jnp.asarray(dy))]

    exact_cfg = QuantConfig(weight=LNSFormat(8, 8), act=LNSFormat(8, 8))
    jexact = jq.QuantConfig(weight=JFormat(8, 8), act=JFormat(8, 8))
    want = port_grads(exact_cfg)
    jwant = jax_grads(jexact)
    for lut in (1, 2, 8):
        got = port_grads(QuantConfig(weight=LNSFormat(8, 8),
                                     act=LNSFormat(8, 8), approx_lut=lut))
        for g, e, je in zip(got, want, jwant):
            assert np.abs(g).max() > 0
            np.testing.assert_array_equal(g, e)
            np.testing.assert_allclose(g, je, rtol=GRAD_RTOL,
                                       atol=GRAD_RTOL * np.abs(je).max())
        jgot = jax_grads(jq.QuantConfig(weight=JFormat(8, 8),
                                        act=JFormat(8, 8), approx_lut=lut))
        assert all(np.abs(g).max() == 0 for g in jgot)   # H9


def test_approx_leg_builds_no_graph():
    """The γ bucketed einsums run under no_grad: their sum has no
    ``grad_fn``, and the approximate GEMM saves no more tensors for the
    backward than the exact fake-quant GEMM."""
    x, w, _ = _approx_inputs(2)
    cfg = QuantConfig.lns_madam(approx_lut=2)
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    y_approx, xq, wq = quant_training.approx_value("bsd,df->bsf", xt, wt, cfg)
    assert y_approx.grad_fn is None and not y_approx.requires_grad
    assert xq.grad_fn is None and wq.grad_fn is None

    def saved(cfg):
        n = [0]

        def pack(t):
            n[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            qeinsum("bsd,df->bsf", _t(x).requires_grad_(),
                    _t(w).requires_grad_(), cfg)
        return n[0]

    assert saved(cfg) <= saved(QuantConfig.lns_madam())


def test_approx_disables_routing():
    """A packed 2-D weight under approximation decodes per leaf: the
    routed GEMM (K1, K2) is never reached, as JAX's ``_routable``."""
    from repro_torch.core import quantizer
    from repro_torch.core.lns import lns_weight_encode
    _, w, _ = _approx_inputs(3)
    pw = lns_weight_encode(_t(w), LNSFormat(8, 8), scale_axis=-1)
    assert quantizer._routable("bsd,df->bsf", pw, QuantConfig.lns_madam())
    assert not quantizer._routable("bsd,df->bsf", pw,
                                   QuantConfig.lns_madam(approx_lut=4))
    assert QuantConfig.lns_madam(approx_lut=4).approx_lut == 4
    assert QuantConfig.lns_madam().approx_lut is None


# ---------------------------------------------------------------------------
# K9: the unpacked Madam step


@pytest.mark.parametrize("r,c", [(256, 256), (100, 70), (512, 10)])
@pytest.mark.parametrize("bits", [16, 8])
def test_k9_plain_matches_jax_madam_step(r, c, bits):
    """The shapes of the JAX package's own K9 test: int16 codes at
    B=16/γ=2048, uint8 codes (int8 in JAX) at B=8/γ=8."""
    gamma = 2048 if bits == 16 else 8
    fmt, jfmt = LNSFormat(bits, gamma), JFormat(bits, gamma)
    rng = np.random.default_rng(r + c + bits)
    code = rng.integers(0, fmt.max_code, (r, c))
    sign = np.where(rng.random((r, c)) < 0.5, 1, -1).astype(np.int8)
    g = (rng.standard_normal((r, c))
         * np.exp2(rng.uniform(-10, 2, (r, c)))).astype(np.float32)
    v = np.abs(rng.standard_normal((r, c))).astype(np.float32)
    tdt, jdt = (np.int16, np.int16) if bits == 16 else (np.uint8, np.int8)
    count, lr = 7, 2.0 ** -7
    nc, nv = dispatch.madam_step_unpacked(_t(code.astype(tdt)), _t(sign),
                                          _t(g), _t(v), count, fmt, lr=lr)
    assert nc.dtype == (torch.int16 if bits == 16 else torch.uint8)
    jc, jv = j_madam_step(jnp.asarray(code.astype(jdt)), jnp.asarray(sign),
                          jnp.asarray(g), jnp.asarray(v), jnp.asarray(count),
                          jfmt, lr=lr, interpret=True)
    _, _, target = ref.step_math(_t(code), _t(sign), _t(g), _t(v),
                                 ref.bias_correction(0.999, count), lr=lr,
                                 beta=0.999, eps=1e-30, gamma=gamma,
                                 max_code=fmt.max_code)
    t = target.numpy()
    band = np.abs(t - np.floor(t) - 0.5) <= TIE_ULPS * np.spacing(np.abs(t))
    got, want = nc.numpy().astype(np.int64), np.asarray(jc).astype(np.int64)
    diff = got != want
    assert not np.any(diff & ~band), int(diff.sum())
    assert np.all(np.abs(got - want)[diff] == 1)
    assert _ulps(nv.numpy(), jv) <= 1
    # K9's arithmetic is K3's: the packed plain step gives the same codes
    words = ((sign < 0).astype(np.int64) << (bits - 1)) | code
    wdt = np.int32 if bits > 8 else np.uint8
    pw, pv = dispatch.madam_step(_t(words.astype(wdt)), _t(g), _t(v), count,
                                 fmt, lr=lr)
    np.testing.assert_array_equal(pw.numpy().astype(np.int64)
                                  & fmt.max_code, got)
    assert torch.equal(pv, nv)


# ---------------------------------------------------------------------------
# the energy model


def test_energy_model_equals_jax():
    assert energy.DATAPATH_FJ_PER_OP == jenergy.DATAPATH_FJ_PER_OP
    assert energy.SYSTEM_OVERHEAD == jenergy.SYSTEM_OVERHEAD
    assert energy.PAPER_MODEL_MACS == jenergy.PAPER_MODEL_MACS
    assert energy.PAPER_TABLE8_MJ == jenergy.PAPER_TABLE8_MJ
    assert energy.paper_table8() == jenergy.paper_table8()
    assert energy.gpt_scaling() == jenergy.gpt_scaling()
    assert energy.gpt_scaling(512.0) == jenergy.gpt_scaling(512.0)
    for fmt in energy.DATAPATH_FJ_PER_OP:
        assert energy.per_iteration_energy_mj(1e9, fmt) == \
            jenergy.per_iteration_energy_mj(1e9, fmt)
    with pytest.raises(KeyError):
        energy.per_iteration_energy_mj(1e9, "int4")
