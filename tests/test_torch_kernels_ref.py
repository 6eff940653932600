"""Each plain version in ``repro_torch.kernels.ref`` against the JAX
package's reference branch (the oracle its Pallas kernel is pinned to), on
the same numpy inputs, through ``repro_torch.kernels.dispatch`` with CPU
tensors.

Tolerances:
* K1 packed words, K6 tokens: equal.
* K2 (f32 out): bf16 decodes are bit-equal across the frameworks, so only
  the f32 summation order differs; f32 decodes differ by up to 9 ULP
  (test_torch_lns). rtol 2e-5 and atol 2e-5 of the output's max cover
  both at K <= 256.
* K5 (f32 out): exp, the softmax sum and the einsum order differ; rtol
  and atol 2e-5 (outputs are O(1) averages of O(1) values).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.lns import LNSFormat as JFormat  # noqa: E402
from repro.kernels import dispatch as jd  # noqa: E402
from repro_torch.core.lns import LNSFormat  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402

FMT, JFMT = LNSFormat(8, 8), JFormat(8, 8)
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.fixture(autouse=True)
def _no_counts():
    """The plain path never counts a kernel launch."""
    ops.reset_launch_counts()
    yield
    assert all(n == 0 for n in ops.launch_counts().values())


def _both(x, dt):
    return jnp.asarray(x).astype(JDT[dt]), torch.from_numpy(x).to(TDT[dt])


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      np.asarray(t).astype(np.float32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape,axis", [((4, 576), None), ((32, 96), None),
                                        ((5, 40), 0)])
def test_k1_encode_pack_words_equal(dt, shape, axis):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * np.exp2(rng.uniform(-8, 4, shape))
         ).astype(np.float32)
    jx, tx = _both(x, dt)
    with jd.configured(backend="reference"):
        jp, js = jd.encode_pack(jx, JFMT, scale_axis=axis)
    tp, ts = dispatch.encode_pack(tx, FMT, scale_axis=axis)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("mkn", [(4, 64, 48), (32, 96, 40), (3, 256, 17)])
def test_k2_qmatmul_close(dt, mkn):
    M, K, N = mkn
    rng = np.random.default_rng(2)
    pa = rng.integers(0, 256, (M, K), dtype=np.uint8)
    pb = rng.integers(0, 256, (K, N), dtype=np.uint8)
    sa = np.exp2(rng.integers(-4, 4, (M, 1))).astype(np.float32)
    sb = np.exp2(rng.integers(-4, 4, (1, N))).astype(np.float32)
    with jd.configured(backend="reference"):
        ref = np.asarray(jd.qmatmul(jnp.asarray(pa), jnp.asarray(pb), JFMT,
                                    jnp.asarray(sa), jnp.asarray(sb),
                                    compute_dtype=JDT[dt]))
    out = dispatch.qmatmul(torch.from_numpy(pa), torch.from_numpy(pb), FMT,
                           torch.from_numpy(sa), torch.from_numpy(sb),
                           compute_dtype=TDT[dt]).numpy()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=2e-5,
                               atol=2e-5 * np.abs(ref).max())


def _paged_inputs(B, S, h, kv, hd, page, mp, packed, dt, seed):
    rng = np.random.default_rng(seed)
    P = B * mp + 1
    q = rng.standard_normal((B, S, h, hd)).astype(np.float32)
    # each row a random permutation of distinct pages; unused -> null page
    perm = rng.permutation(P - 1).reshape(B, mp).astype(np.int32)
    lengths = rng.integers(S, mp * page + 1, (B,)).astype(np.int32)
    bt = np.where(np.arange(mp)[None] * page < lengths[:, None], perm,
                  P - 1).astype(np.int32)
    if packed:
        kp = rng.integers(0, 256, (P, page, kv, hd), dtype=np.uint8)
        vp = rng.integers(0, 256, (P, page, kv, hd), dtype=np.uint8)
        ks = np.exp2(rng.integers(-2, 3, (P, page, kv, 1))).astype(np.float32)
        vs = np.exp2(rng.integers(-2, 3, (P, page, kv, 1))).astype(np.float32)
        jargs = (jnp.asarray(kp), jnp.asarray(vp),
                 jnp.asarray(ks).astype(jnp.bfloat16),
                 jnp.asarray(vs).astype(jnp.bfloat16))
        targs = (torch.from_numpy(kp), torch.from_numpy(vp),
                 torch.from_numpy(ks).to(torch.bfloat16),
                 torch.from_numpy(vs).to(torch.bfloat16))
    else:
        kp = rng.standard_normal((P, page, kv, hd)).astype(np.float32)
        vp = rng.standard_normal((P, page, kv, hd)).astype(np.float32)
        jargs = (*_both(kp, "bf16")[:1], *_both(vp, "bf16")[:1], None, None)
        targs = (_both(kp, "bf16")[1], _both(vp, "bf16")[1], None, None)
    jq, tq = _both(q, dt)
    return ((jq, *jargs, jnp.asarray(bt), jnp.asarray(lengths)),
            (tq, *targs, torch.from_numpy(bt), torch.from_numpy(lengths)))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("S", [1, 8])
def test_k5_paged_attend_close(dt, packed, softcap, S):
    # decode (S=1, 4 rows) and suffix prefill (S=8, 1 row); GQA rep 3
    B = 4 if S == 1 else 1
    jargs, targs = _paged_inputs(B, S, 6, 2, 32, 4, 5, packed, dt, seed=S)
    kw = dict(softcap=softcap, sm_scale=1 / np.sqrt(32))
    with jd.configured(backend="reference"):
        ref = np.asarray(jd.paged_attend(*jargs, fmt=JFMT if packed else None,
                                         **kw))
    out = dispatch.paged_attend(*targs, fmt=FMT if packed else None,
                                **kw).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("noise", [False, True])
def test_k6_fused_sample_tokens_equal(noise):
    rng = np.random.default_rng(6)
    B, V = 6, 1000
    lg = rng.standard_normal((B, V)).astype(np.float32)
    lg[0, [7, 300, 901]] = 9.0        # ties: the first maximum wins
    lg[1, :] = -3.0                   # a constant row
    g = rng.gumbel(size=(B, V)).astype(np.float32) if noise else None
    t = np.array([0.0, 0.7, 1.0, 0.0, 2.5, 1e-9], np.float32) \
        if noise else None
    with jd.configured(backend="reference"):
        ref = np.asarray(jd.fused_sample(
            jnp.asarray(lg), None if g is None else jnp.asarray(g),
            None if t is None else jnp.asarray(t)))
    out = dispatch.fused_sample(
        torch.from_numpy(lg), None if g is None else torch.from_numpy(g),
        None if t is None else torch.from_numpy(t))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    if not noise:
        assert out[0] == 7 and out[1] == 0
