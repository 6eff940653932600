"""The port's LNS core against the JAX package's, on the same numpy inputs.

Integer results (signs, codes, packed words, scales) must be equal at
B=8 (γ=8) and B=6 (γ=2). At B=16, γ=2048 one f32 log2 ULP is 2^-10 of a
code step, so a code sits near enough to a rounding boundary to flip by
one about once in a thousand: held to |Δcode| <= 1 on under 1% of the
values. f32
decodes of the same words are held to 9 ULP: torch's and XLA's f32 exp2
differ by up to 8 ULP at γ=8 and 9 ULP at γ=2048 on the CPU (torch 2.13,
jax 0.9, every word measured); rounded to bf16 they agree exactly.

Scales: the port's ``pow2_scale`` is an exact power of two. XLA's CPU
``exp2`` is exact on the integers -12..12 (and a few more) but off by an
ULP or more outside them, so the JAX reference's scales are too; the
random inputs here keep their absmax inside 2^±10, where both agree.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import lns as J  # noqa: E402
from repro_torch.core import lns as T  # noqa: E402

DECODE_ULP = 9
FORMATS = [(8, 8), (16, 2048), (6, 2)]


def _fmts(bits, gamma):
    return J.LNSFormat(bits=bits, gamma=gamma), T.LNSFormat(bits=bits,
                                                           gamma=gamma)


def _words(bits):
    w = np.arange(1 << bits, dtype=np.uint32)
    return w.astype(np.uint8 if bits <= 8 else np.uint16)


def _inputs(seed, shape=(8, 64)):
    rng = np.random.default_rng(seed)
    # magnitudes over ~20 octaves, both signs, exact zeros
    x = rng.standard_normal(shape) * np.exp2(rng.uniform(-16, 6, shape))
    x.flat[::17] = 0.0
    x.flat[5::23] = -x.flat[5::23]
    return x.astype(np.float32)


def _ulp(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def _pow2(k):
    return np.ldexp(np.float32(1.0), k).astype(np.float32)


def test_pow2_scale_exact():
    k = np.arange(-126, 128)
    t = T.pow2_scale(torch.from_numpy(_pow2(k) * np.float32(0.75)))
    np.testing.assert_array_equal(t.numpy(), _pow2(k))
    inner = np.arange(-12, 13)
    j = J.pow2_scale(jnp.asarray(_pow2(inner) * np.float32(0.75)))
    np.testing.assert_array_equal(np.asarray(j), _pow2(inner))


@pytest.mark.parametrize("bits,gamma", FORMATS)
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_encode_words_equal_random(bits, gamma, axis):
    jf, tf = _fmts(bits, gamma)
    x = _inputs(bits * 100 + gamma)
    js = J.compute_scale(jnp.asarray(x), axis=axis)
    ts = T.compute_scale(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    jsign, jcode = J.lns_encode(jnp.asarray(x), jf, js)
    tsign, tcode = T.lns_encode(torch.from_numpy(x), tf, ts)
    np.testing.assert_array_equal(np.asarray(jsign), tsign.numpy())
    jc = np.asarray(jcode).astype(np.int64)
    if bits == 16:
        diff = np.abs(jc - tcode.numpy())
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
        return
    np.testing.assert_array_equal(jc, tcode.numpy())
    jw = np.asarray(J.lns_pack(jsign, jcode, jf)).astype(np.int64)
    tw = T.lns_pack(tsign, tcode, tf).numpy().astype(np.int64)
    np.testing.assert_array_equal(jw, tw)


@pytest.mark.parametrize("bits,gamma", FORMATS)
def test_full_code_range(bits, gamma):
    jf, tf = _fmts(bits, gamma)
    w = _words(bits)
    tw = torch.from_numpy(w.astype(np.int32))
    jsign, jcode = J.lns_unpack(jnp.asarray(w), jf)
    tsign, tcode = T.lns_unpack(tw, tf)
    np.testing.assert_array_equal(np.asarray(jsign), tsign.numpy())
    np.testing.assert_array_equal(np.asarray(jcode).astype(np.int64),
                                  tcode.numpy())
    jd = np.asarray(J.lns_decode_packed(jnp.asarray(w), jf))
    td = T.lns_decode_packed(tw, tf).numpy()
    assert _ulp(jd, td).max() <= DECODE_ULP
    jb = np.asarray(J.lns_decode_packed(jnp.asarray(w), jf, jnp.bfloat16))
    tb = T.lns_decode_packed(tw, tf, torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(jb.astype(np.float32), tb)
    # the words re-encode to themselves from either framework's decode
    sign, code = T.lns_encode(torch.from_numpy(td), tf,
                              torch.tensor(1.0))
    np.testing.assert_array_equal(T.lns_pack(sign, code, tf).numpy()
                                  .astype(np.int64), w.astype(np.int64))


@pytest.mark.parametrize("src,dst", [((8, 8), (6, 2)), ((8, 8), (7, 4)),
                                     ((16, 2048), (8, 8)), ((6, 2), (8, 8))])
def test_requant_equal(src, dst):
    jsrc, tsrc = _fmts(*src)
    jdst, tdst = _fmts(*dst)
    w = _words(src[0])
    jw = np.asarray(J.lns_requant_packed(jnp.asarray(w), jsrc, jdst))
    tw = T.lns_requant_packed(torch.from_numpy(w.astype(np.int32)), tsrc,
                              tdst)
    np.testing.assert_array_equal(jw.astype(np.int64),
                                  tw.numpy().astype(np.int64))


def test_weight_encode_stacked_equal():
    """A stacked (layers, in, out) weight with per-layer, per-output
    scales, as ``init_lns_params`` packs it."""
    jf, tf = _fmts(8, 8)
    x = _inputs(7, (3, 24, 40))
    ax = (0, 2)
    jw = J.lns_weight_encode(jnp.asarray(x), jf, scale_axis=ax)
    tw = T.lns_weight_encode(torch.from_numpy(x), tf, scale_axis=ax)
    np.testing.assert_array_equal(np.asarray(jw.packed), tw.packed.numpy())
    np.testing.assert_array_equal(np.asarray(jw.scale), tw.scale.numpy())
    assert _ulp(np.asarray(jw.decode()), tw.decode().numpy()).max() \
        <= DECODE_ULP
    assert tw[1].packed.shape == (24, 40) and tw[1].scale.shape == (1, 40)


def test_quantize_bf16_equal():
    jf, tf = _fmts(8, 8)
    x = _inputs(11, (4, 32))
    jq = J.lns_quantize(jnp.asarray(x).astype(jnp.bfloat16), jf)
    tq = T.lns_quantize(torch.from_numpy(x).to(torch.bfloat16), tf)
    np.testing.assert_array_equal(np.asarray(jq).astype(np.float32),
                                  tq.float().numpy())
