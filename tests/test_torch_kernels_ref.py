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
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402

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
@pytest.mark.parametrize("S", [1, 8, 4])
def test_k5_paged_attend_close(dt, packed, softcap, S):
    # decode (S=1, 4 rows), suffix prefill (S=8, 1 row) and the
    # speculative verify (S=k=4 query rows over 4 rows); GQA rep 3
    B = 1 if S == 8 else 4
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


def test_k6_noise_in_equals_jax_pallas_interpret():
    """The noise-in K6 plain version against JAX's Pallas kernel itself
    (interpret mode) on fed noise; and the seeded plain version equals
    that kernel fed the port's own counter noise, so the seeded mode is
    the TPU kernel's function on ``ref.gumbel_noise``."""
    from repro.kernels import ops as jops
    rng = np.random.default_rng(16)
    B, V = 5, 700
    lg = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    lg[0, [11, 650]] = 40.0               # greedy row 0: a tie
    t = np.array([0.0, 0.6, 1.0, 1.7, 1e-9], np.float32)
    seed = np.array([1, 2, 3, 4, 0xFFFFFFFF], np.uint32)
    step = np.array([0, 1, 7, 2 ** 31 - 1, 5], np.int32)
    own = ref.gumbel_noise(seed, step, V).numpy()
    for g in (rng.gumbel(size=(B, V)).astype(np.float32), own):
        want = np.asarray(jops.fused_sample(jnp.asarray(lg), jnp.asarray(g),
                                            jnp.asarray(t), interpret=True))
        got = dispatch.fused_sample(torch.from_numpy(lg), torch.from_numpy(g),
                                    torch.from_numpy(t))
        np.testing.assert_array_equal(got.numpy(), want)
        assert want[0] == 11
    toks, noise = dispatch.fused_sample_seeded(torch.from_numpy(lg), t, seed,
                                               step, noise_out=True)
    np.testing.assert_array_equal(noise.numpy(), own)
    np.testing.assert_array_equal(toks.numpy(), want)


# ---------------------------------------------------------------------------
# K6's counter noise (ref.gumbel_noise) against an independent numpy
# version of the hash. Tolerance: u bit for bit (integer hash, exact
# conversion); g = -log(-log(u)) within 2^-21 max(1, |g|) of numpy's f64
# logs (two f32 roundings of log, as chip_smoke.K6_NOISE_ATOL states).


def _np_mix32(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _np_uniform(seed, step, V):
    key = _np_mix32(_np_mix32(np.asarray(seed, np.uint32))
                    ^ np.asarray(step).astype(np.int64).astype(np.uint32))
    tok = np.arange(V, dtype=np.uint32)
    h = _np_mix32(_np_mix32(key[:, None] ^ tok[None]) + key[:, None])
    return (((h >> np.uint32(9)).astype(np.float32) + np.float32(0.5))
            * np.float32(2.0 ** -23))


_ROWS = (np.array([0, 1, 1, 123456789, 0xFFFFFFFF], np.uint32),
         np.array([0, 0, 1, 41, 2 ** 31 - 1], np.int64))


def test_gumbel_noise_is_a_function_of_seed_step_token():
    seed, step = _ROWS
    a = ref.gumbel_noise(seed, step, 300)
    b = ref.gumbel_noise(seed[::-1].copy(), step[::-1].copy(), 300)
    torch.testing.assert_close(a, b.flip(0), rtol=0, atol=0)
    # a row's noise does not depend on the vocabulary it is cut to
    torch.testing.assert_close(ref.gumbel_noise(seed, step, 40), a[:, :40],
                               rtol=0, atol=0)
    assert a.dtype == torch.float32 and torch.isfinite(a).all()
    assert len({tuple(r) for r in a.numpy().round(6)}) == len(seed)


def test_gumbel_uniform_exact_and_strictly_inside_the_unit_interval():
    rng = np.random.default_rng(0)
    seed = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    u = ref.gumbel_uniform(seed, rng.integers(0, 1000, 64), 4096).double()
    assert bool((u > 0).all()) and bool((u < 1).all())
    k = u * 2 ** 23 - 0.5                  # (h >> 9): an integer < 2^23
    assert bool((k == torch.round(k)).all())
    assert float(k.min()) >= 0 and float(k.max()) <= 2 ** 23 - 1


def test_gumbel_hash_bit_equal_to_numpy():
    seed, step = _ROWS
    u = ref.gumbel_uniform(seed, step, 5000).numpy()
    np.testing.assert_array_equal(u.view(np.uint32),
                                  _np_uniform(seed, step, 5000).view(np.uint32))
    g = ref.gumbel_noise(seed, step, 5000).numpy().astype(np.float64)
    want = -np.log(-np.log(u.astype(np.float64)))
    assert np.all(np.abs(g - want) <= 2.0 ** -21 * np.maximum(1, np.abs(want)))


def test_gumbel_noise_is_gumbel_distributed():
    """10^5 draws (100 sample events x 1000 tokens): Kolmogorov-Smirnov
    distance to Gumbel(0, 1) below 1.95/sqrt(n), its 0.1% critical value;
    mean and variance (0.5772, pi^2/6) within 5 standard errors."""
    n_rows, V = 100, 1000
    seed = np.full(n_rows, 77, np.uint32)
    g = np.sort(ref.gumbel_noise(seed, np.arange(n_rows), V).numpy()
                .astype(np.float64).ravel())
    n = g.size
    cdf = np.exp(-np.exp(-g))
    ks = max(np.max(np.arange(1, n + 1) / n - cdf),
             np.max(cdf - np.arange(n) / n))
    assert ks < 1.95 / np.sqrt(n)
    mean, var = np.euler_gamma, np.pi ** 2 / 6
    assert abs(g.mean() - mean) < 5 * np.sqrt(var / n)
    # Var of the sample variance: (mu4 - var^2)/n, mu4 = 12/5 var^2 + 3var^2
    assert abs(g.var() - var) < 5 * np.sqrt((5.4 - 1) * var ** 2 / n)


def test_gumbel_keys_distinct_for_adjacent_steps():
    """Adjacent steps (and adjacent seeds) give distinct row keys and
    uncorrelated noise rows (|r| < 5/sqrt(V))."""
    steps = np.arange(2000)
    # token 0's 23 bits under each step's key: equal keys would repeat them
    u = ref.gumbel_uniform(np.full(2000, 9, np.uint32), steps, 1)
    bits = (u.numpy()[:, 0] * 2 ** 23).astype(np.int64)
    assert len(set(bits.tolist())) > 1990
    V = 4096
    g = ref.gumbel_noise(np.array([9, 9, 10], np.uint32),
                         np.array([5, 6, 5]), V).numpy()
    for a, b in ((0, 1), (0, 2)):
        assert abs(np.corrcoef(g[a], g[b])[0, 1]) < 5 / np.sqrt(V)
    # and neighbouring tokens of one row
    assert abs(np.corrcoef(g[0, :-1], g[0, 1:])[0, 1]) < 5 / np.sqrt(V)


def test_k6_seeded_equals_noise_in_on_its_noise():
    """The seeded plain version is the noise-in one fed
    ``ref.gumbel_noise``; greedy rows (temp 0) take the argmax."""
    rng = np.random.default_rng(5)
    B, V = 4, 333
    lg = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32))
    t = np.array([0.0, 0.5, 1.0, 3.0], np.float32)
    seed = np.array([5, 6, 7, 8], np.uint32)
    step = np.array([0, 3, 3, 9], np.int32)
    toks, noise = dispatch.fused_sample_seeded(lg, t, seed, step,
                                               noise_out=True)
    assert toks.dtype == torch.int32 and noise.shape == (B, V)
    torch.testing.assert_close(noise, ref.gumbel_noise(seed, step, V),
                               rtol=0, atol=0)
    want = dispatch.fused_sample(lg, noise, torch.from_numpy(t))
    torch.testing.assert_close(toks, want, rtol=0, atol=0)
    assert toks[0] == torch.argmax(lg[0])
    assert torch.equal(dispatch.fused_sample_seeded(lg, t, seed, step), toks)
