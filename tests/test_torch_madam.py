"""The port's Madam update and quantizers against the JAX package, on the
same numpy inputs.

* ``dispatch.madam_step`` (the plain K3/K4 on CPU tensors) against the JAX
  ``dispatch.madam_step`` on both its backends (``reference``, and
  ``pallas`` in interpret mode, as the JAX tests run it), at B=8 (uint8
  words) and B=16/γ=2048 (int32 words in the port, uint16 in JAX), with
  and without stats, on a ragged 300×70 leaf at counts 1, 2, 7 and 1000.
  - v' is bit-equal to the reference backend: the EMA has no
    transcendental and both sides round the same f32 ops in the same
    order. The Pallas kernel in interpret mode fuses the EMA's last
    multiply and add into one FMA, so against it v' is within 1 ulp.
  - Words are equal outside the tie band: ``rsqrt`` is not correctly
    rounded in either framework and the two differ (ROADMAP H6), so g*
    may differ by an ulp, and a word may round the other way where
    ``target`` lies within 4 ulp of a half-integer.
  - Stats: every count here is below 2^24, so the JAX f32 counts are
    exact and the fractions agree to f32 rounding of the normalization
    (rtol 1e-6); ``qerr_rel`` sums exp2 values that differ by ulps across
    the frameworks (H1) and ``code_mean`` is an f32 sum in JAX, so both
    are held to rtol 1e-5.
* ``madam_lns`` over a whole smoke tree (packed and f32 leaves), plain
  and factored, against JAX's ``madam_lns`` update from the same grads.
* The stochastic variant holds to the port's own contract.
* The routed GEMM's y, dx and dW against ``jax.vjp`` of the JAX routed
  GEMM with Q_E at its output; the decode fallback's gradient through
  ``delta``; Q_E and Q_G against JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import quantizer as jq  # noqa: E402
from repro.core.lns import LNSFormat as JFormat  # noqa: E402
from repro.core.lns import LNSWeight as JWeight  # noqa: E402
from repro.kernels import dispatch as jd  # noqa: E402
from repro.optim import madam as jmadam  # noqa: E402
from repro_torch.core.lns import LNSFormat, LNSWeight  # noqa: E402
from repro_torch.core.quantizer import (QuantConfig, backward_quantize,  # noqa: E402
                                        qeinsum, quantize_grads)
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402
from repro_torch.numerics.rounding import stochastic_round  # noqa: E402
from repro_torch.optim import madam  # noqa: E402

FORMATS = {"b8": (8, 8), "b16": (16, 2048)}
STAT_RTOL = 1e-6          # counts: f32 normalization of an exact count
STAT_FLOAT_RTOL = 1e-5    # qerr_rel, code_mean: exp2 ulps, f32 sums
TIE_ULPS = 4


@pytest.fixture(autouse=True)
def _one_thread_no_launch():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ops.reset_launch_counts()
    yield
    torch.set_num_threads(n)
    assert all(c == 0 for c in ops.launch_counts().values())


def _leaf(bits, shape, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << bits, shape)
    g = (rng.standard_normal(shape)
         * np.exp2(rng.uniform(-10, 2, shape))).astype(np.float32)
    v = (np.abs(rng.standard_normal(shape)) * 1e-3).astype(np.float32)
    return words, g, v


def _jwords(words, bits):
    return jnp.asarray(words.astype(np.uint16 if bits > 8 else np.uint8))


def _twords(words, bits):
    return torch.from_numpy(words.astype(np.int32 if bits > 8 else np.uint8))


def _tie_band(words, g, v, count, fmt):
    """Elements whose target lies within TIE_ULPS ulp of a half-integer."""
    w = torch.from_numpy(words.astype(np.int32))
    sign = 1 - 2 * ((w >> (fmt.bits - 1)) & 1)
    _, _, target = ref.step_math(
        w & fmt.max_code, sign, torch.from_numpy(g), torch.from_numpy(v),
        ref.bias_correction(0.999, count), lr=2.0 ** -7, beta=0.999,
        eps=1e-30, gamma=fmt.gamma, max_code=fmt.max_code)
    t = target.numpy()
    frac = t - np.floor(t)
    return np.abs(frac - 0.5) <= TIE_ULPS * np.spacing(np.abs(t))


def _check_stats(js, ts):
    assert set(ts) == set(js) == set(jmadam_keys())
    for k in js:
        rtol = STAT_FLOAT_RTOL if k in ("qerr_rel", "qerr_gap_ratio",
                                        "code_mean") else STAT_RTOL
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=rtol,
                                   atol=1e-12, err_msg=k)


def jmadam_keys():
    from repro.kernels.madam_update import MADAM_STAT_KEYS
    return MADAM_STAT_KEYS


@pytest.mark.parametrize("count", [1, 2, 7, 1000])
@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("name", ["b8", "b16"])
def test_madam_step_matches_jax(name, with_stats, count):
    bits, gamma = FORMATS[name]
    fmt, jfmt = LNSFormat(bits, gamma), JFormat(bits, gamma)
    words, g, v = _leaf(bits, (300, 70), seed=count)
    kw = dict(lr=2.0 ** -7, with_stats=with_stats,
              requant_fmt=JFormat(8, 8) if with_stats else None)
    out = dispatch.madam_step(
        _twords(words, bits), torch.from_numpy(g), torch.from_numpy(v),
        count, fmt, lr=2.0 ** -7, with_stats=with_stats,
        requant_fmt=LNSFormat(8, 8) if with_stats else None)
    assert out[0].dtype == (torch.int32 if bits > 8 else torch.uint8)
    band = _tie_band(words, g, v, count, fmt)
    for backend in ("reference", "pallas"):
        jout = jd.madam_step(_jwords(words, bits), jnp.asarray(g),
                             jnp.asarray(v), jnp.asarray(count, jnp.int32),
                             jfmt, backend=backend, interpret=True, **kw)
        ulps = np.abs(out[1].numpy().view(np.int32).astype(np.int64)
                      - np.asarray(jout[1]).view(np.int32))
        assert ulps.max() <= (0 if backend == "reference" else 1), backend
        jw = np.asarray(jout[0]).astype(np.int64)
        tw = out[0].numpy().astype(np.int64)
        diff = jw != tw
        assert not np.any(diff & ~band), (backend, int(diff.sum()))
        assert np.all(np.abs(jw - tw)[diff] == 1)
        if with_stats:
            _check_stats(jout[2], out[2])


def test_madam_step_takes_bf16_grads():
    """A bf16 gradient gives the words of its f32 value (the kernels read
    Q_G's bf16 output without a cast pass)."""
    words, g, v = _leaf(16, (64, 40), seed=3)
    fmt = LNSFormat(16, 2048)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    a = dispatch.madam_step(_twords(words, 16), gb, torch.from_numpy(v), 5,
                            fmt, lr=2.0 ** -7)
    b = dispatch.madam_step(_twords(words, 16), gb.float(),
                            torch.from_numpy(v), 5, fmt, lr=2.0 ** -7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _jax_state(bits=16, gamma=2048, factored=False, seed=0):
    from repro.configs import get_smoke_config
    from repro.training import init_train_state
    cfg = get_smoke_config("smollm-135m")
    mcfg = jmadam.MadamConfig(update_format=JFormat(bits, gamma),
                              factored=factored)
    return jax.jit(lambda k: init_train_state(k, cfg, mcfg))(
        jax.random.PRNGKey(seed)), mcfg


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["::".join(str(getattr(k, "key", getattr(k, "idx",
                                                     getattr(k, "name", k))))
                      for k in path)] = np.array(leaf)
    return out


@pytest.mark.parametrize("factored", [False, True])
def test_madam_lns_update_matches_jax(factored):
    from repro_torch.convert import train_state_from_flat
    from repro_torch.checkpoint.manager import flatten_state
    from repro_torch.tree import tree_map
    js, jm = _jax_state(factored=factored)
    tmc = madam.MadamConfig(factored=factored)
    ts = train_state_from_flat(_flat(js), tmc, device="cpu")
    rng = np.random.default_rng(7)
    np_grads = tree_map(
        lambda p: (rng.standard_normal(tuple(p.shape)) * 1e-2
                   ).astype(np.float32), ts.params)
    jgrads = _unflatten_like(js.params, np_grads)
    with jd.configured(backend="reference"):
        jupdate = jax.jit(jmadam.madam_lns(jm)[1])
    _, tupdate = madam.madam_lns(tmc)
    jparams, jopt = js.params, js.opt
    tparams, topt = ts.params, ts.opt
    for _ in range(2):
        jparams, jopt = jupdate(jgrads, jopt, jparams)
        tparams, topt = tupdate(
            tree_map(torch.from_numpy, np_grads), topt, tparams)
    assert topt.count == int(jopt.count) == 2
    jf, tf = _flat(jparams), flatten_state(tparams)
    for k in jf:
        a, b = jf[k].astype(np.float64), tf[k].astype(np.float64)
        if k.endswith("packed"):
            diff = a != b
            assert diff.mean() <= 1e-3, (k, int(diff.sum()))
            assert np.all(np.abs(a - b)[diff] == 1), k
        else:   # f32 leaves: exp differs by ulps across frameworks
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-12,
                                       err_msg=k)
    # v: jit contracts the EMA's last multiply-add into an FMA (1 ulp);
    # factored means also sum in an order of their own
    jv, tv = _flat(jopt.g2), flatten_state(topt.g2)
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], rtol=2.4e-7 if not factored
                                   else 1e-6, atol=0, err_msg=k)


def _unflatten_like(jparams, np_grads):
    """The port-shaped numpy grads as a JAX tree shaped like the params
    (packed leaves become one dense gradient)."""
    def get(path):
        node = np_grads
        for k in path:
            node = node[str(getattr(k, "key", k))]
        return jnp.asarray(node)
    return jax.tree_util.tree_map_with_path(
        lambda p, _: get(p), jparams, is_leaf=jmadam.is_lns_weight)


def test_madam_lns_stats_have_the_jax_keys():
    """``with_stats`` gives, per packed leaf, JAX's stat keys plus
    ``scale_log2``, keyed by the same dotted layer names."""
    from repro_torch.convert import train_state_from_flat
    from repro_torch.tree import tree_map
    js, jm = _jax_state()
    tmc = madam.MadamConfig()
    ts = train_state_from_flat(_flat(js), tmc, device="cpu")
    grads = tree_map(lambda p: torch.full(tuple(p.shape), 1e-3), ts.params)
    _, update = madam.madam_lns(tmc)
    _, _, stats = update(grads, ts.opt, ts.params, with_stats=True,
                         requant_fmt=LNSFormat(8, 8))
    _, jupdate = jmadam.madam_lns(jm)
    jgrads = jax.tree.map(lambda p: jnp.full(p.shape, 1e-3, jnp.float32),
                          js.params, is_leaf=jmadam.is_lns_weight)
    with jd.configured(backend="reference"):
        _, _, jstats = jax.jit(lambda g, o, p: jupdate(
            g, o, p, with_stats=True, requant_fmt=JFormat(8, 8)))(
                jgrads, js.opt, js.params)
    assert set(stats) == set(jstats)
    for layer in jstats:
        assert set(stats[layer]) == set(jstats[layer])
        for k, v in jstats[layer].items():
            np.testing.assert_allclose(float(stats[layer][k]), float(v),
                                       rtol=STAT_FLOAT_RTOL, atol=1e-12,
                                       err_msg=f"{layer}.{k}")


def test_stochastic_update_contract():
    """Signs kept, codes in range, seeded replay, and the rounding
    unbiased: the mean of SR(t) - t within 3σ of 0."""
    js, _ = _jax_state()
    from repro_torch.convert import train_state_from_flat
    from repro_torch.tree import leaves, tree_map
    tmc = madam.MadamConfig(stochastic=True)
    ts = train_state_from_flat(_flat(js), tmc, device="cpu")
    # a warm second moment, so that g* is no longer +-1 and the targets
    # fall between codes
    opt = madam.MadamState(g2=tree_map(lambda v: torch.full_like(v, 1e-6),
                                       ts.opt.g2), count=10)
    ts = ts._replace(opt=opt)
    rng = np.random.default_rng(2)
    grads = tree_map(lambda p: torch.from_numpy(
        rng.standard_normal(tuple(p.shape)).astype(np.float32) * 1e-3),
        ts.params)
    _, update = madam.madam_lns(tmc)
    with pytest.raises(ValueError, match="torch.Generator"):
        update(grads, ts.opt, ts.params)
    runs = [update(grads, ts.opt, ts.params,
                   torch.Generator().manual_seed(s))[0] for s in (5, 5, 6)]
    fmt = tmc.update_format
    differ = 0
    for (path, p0), (_, p1), (_, p2), (_, old) in zip(
            leaves(runs[0]), leaves(runs[1]), leaves(runs[2]),
            leaves(ts.params)):
        if not isinstance(p0, LNSWeight):
            continue
        assert torch.equal(p0.packed, p1.packed), path
        differ += int((p0.packed != p2.packed).sum())
        sign_bit = lambda w: (w >> (fmt.bits - 1)) & 1
        assert torch.equal(sign_bit(p0.packed), sign_bit(old.packed)), path
        code = p0.packed & fmt.max_code
        assert int(code.min()) >= 0 and int(code.max()) <= fmt.max_code
    assert differ > 0
    t = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 100, 200_000).astype(np.float32))
    r = stochastic_round(t, torch.Generator().manual_seed(0))
    frac = (t - torch.floor(t)).double()
    sigma = float(torch.sqrt((frac * (1 - frac)).sum())) / t.numel()
    assert abs(float((r - t).double().mean())) <= 3 * sigma


# --- quantizers and the routed GEMM ---------------------------------------

JF8, F8 = JFormat(8, 8), LNSFormat(8, 8)
GRAD_RTOL = 2e-5   # f32 decodes differ by up to 9 ulp (H1); sums reorder


def _routed_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = rng.integers(0, 256, (48, 32)).astype(np.uint8)
    s = np.exp2(rng.integers(-4, 0, (1, 32))).astype(np.float32)
    dy = rng.standard_normal((2, 5, 32)).astype(np.float32)
    return x, w, s, dy


def _port_grads(x, w, s, dy, qcfg):
    tx = torch.from_numpy(x).requires_grad_(True)
    delta = torch.zeros(w.shape, requires_grad=True)
    tw = LNSWeight(torch.from_numpy(w), torch.from_numpy(s), F8, delta)
    y = qeinsum("bsd,df->bsf", tx, tw, qcfg)
    y.backward(torch.from_numpy(dy))
    return y.detach().numpy(), tx.grad.numpy(), delta.grad.numpy()


def _jax_vjp(fn, x, w, dy):
    @jax.jit
    def run(x_, d_, dy_):
        y, vjp = jax.vjp(fn, x_, d_)
        return (y,) + vjp(dy_)
    return run(jnp.asarray(x), jnp.zeros(w.shape, jnp.float32),
               jnp.asarray(dy))


def test_routed_gemm_grads_match_jax_vjp():
    x, w, s, dy = _routed_inputs()

    def jfn(x_, d_):
        y = jq._routed_matmul(JF8, "reference", x_, d_, jnp.asarray(w),
                              jnp.asarray(s))
        return jq.backward_quantize(y, JF8, None, x_.dtype)

    jy, jdx, jdw = _jax_vjp(jfn, x, w, dy)
    ty, tdx, tdw = _port_grads(x, w, s, dy, QuantConfig.lns_madam())
    for a, b in ((ty, jy), (tdx, jdx), (tdw, jdw)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(b).max())


def test_decode_fallback_grads_through_delta():
    """A scale that varies along the contraction axis cannot route: the
    weight decodes (plus ``delta``) and takes the fake-quant leg."""
    x, w, _, dy = _routed_inputs(1)
    s = np.exp2(np.random.default_rng(4).integers(-4, 0, (48, 1))
                ).astype(np.float32)
    qcfg = QuantConfig.lns_madam()
    jcfg = jq.QuantConfig.lns_madam()

    def jfn(x_, d_):
        jw = JWeight(jnp.asarray(w), jnp.asarray(s), d_, JF8)
        return jq.qeinsum("bsd,df->bsf", x_, jw, jcfg)

    with jd.configured(backend="reference"):
        jy, jdx, jdw = _jax_vjp(jfn, x, w, dy)
    ty, tdx, tdw = _port_grads(x, w, s, dy, qcfg)
    for a, b in ((ty, jy), (tdx, jdx), (tdw, jdw)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(b).max())


def test_qe_and_qg_codes_match_jax():
    """Q_E (the gradient of ``backward_quantize``) and Q_G: the same grid
    points as JAX. Neighbouring points differ by 2^(1/8) = 9%, so rtol
    1e-6 holds only where every code is equal."""
    rng = np.random.default_rng(5)
    g = (rng.standard_normal((6, 40)) * np.exp2(rng.uniform(-20, 0, (6, 40)))
         ).astype(np.float32)
    je = np.asarray(jax.jit(lambda g_: jax.vjp(
        lambda x_: jq.backward_quantize(x_, JF8, None, jnp.float32),
        jnp.zeros(g.shape, jnp.float32))[1](g_)[0])(jnp.asarray(g)))
    tx = torch.zeros(g.shape, requires_grad=True)
    backward_quantize(tx, F8, None, torch.float32).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), je, rtol=1e-6, atol=0)
    tree = {"a": g, "b": {"c": g[:3] * 1e-6}}
    jg = jax.jit(lambda t: jq.quantize_grads(t, jq.QuantConfig.lns_madam()))(
        jax.tree.map(jnp.asarray, tree))
    tg = quantize_grads({"a": torch.from_numpy(g),
                         "b": {"c": torch.from_numpy(g[:3] * 1e-6)}},
                        QuantConfig.lns_madam())
    np.testing.assert_allclose(tg["a"].numpy(), np.asarray(jg["a"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tg["b"]["c"].numpy(),
                               np.asarray(jg["b"]["c"]), rtol=1e-6, atol=0)


def test_bias_correction_is_the_jax_f32_pow():
    """``bc = 1 - beta**count`` as JAX computes it (an f32 pow), which a
    double pow cast to f32 is not (ROADMAP H6)."""
    for count in (1, 2, 7, 1000):
        want = float(np.asarray(
            1.0 - 0.999 ** jnp.asarray(count, jnp.int32).astype(jnp.float32)))
        assert ref.bias_correction(0.999, count) == want
        assert float(np.float32(1.0 - 0.999 ** count)) != want


def test_rsqrt_differs_across_frameworks():
    """Why Madam's g* cannot be bit-equal across frameworks (H6): over
    2^20 f32 inputs neither rsqrt is correctly rounded and the two
    disagree on about a third of them."""
    x = np.exp2(np.random.default_rng(0).uniform(-40, 40, 1 << 20)
                ).astype(np.float32)
    exact = (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    j = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    t = torch.rsqrt(torch.from_numpy(x)).numpy()
    counts = (int((j != exact).sum()), int((t != exact).sum()),
              int((j != t).sum()))
    print("rsqrt != correctly rounded: jax %d, torch %d; jax != torch %d"
          % counts)
    assert all(c > 0 for c in counts)
    for a in (j, t):   # each within 2 ulp of the correctly rounded value
        ulps = np.abs(a.view(np.int32).astype(np.int64)
                      - exact.view(np.int32))
        assert ulps.max() <= 2


def test_cot_boundary_casts_the_gradient():
    """Forward identity, gradient cast to the input's dtype (a bf16 input
    reached by an f32 gradient gets a bf16 one), as ``jq.cot_boundary``."""
    from repro_torch.core.quantizer import cot_boundary
    x = torch.randn(3, 4).to(torch.bfloat16).requires_grad_(True)
    y = cot_boundary(x)
    assert torch.equal(y, x)
    (y.float() * torch.arange(12.).reshape(3, 4)).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  np.arange(12.).reshape(3, 4))


def test_materialize_matches_jax():
    """Packed leaves decode to JAX's dense values (f32 decodes differ by
    up to 9 ulp across the frameworks, H1); f32 leaves pass through."""
    from repro_torch.convert import train_state_from_flat
    from repro_torch.tree import leaves
    js, _ = _jax_state()
    ts = train_state_from_flat(_flat(js), madam.MadamConfig(), device="cpu")
    want = _flat(jax.jit(lambda p: jmadam.materialize(p, dtype=jnp.float32))(
        js.params))
    for path, got in leaves(madam.materialize(ts.params, torch.float32)):
        np.testing.assert_allclose(got.numpy(), want["::".join(path)],
                                   rtol=1e-6, atol=0, err_msg=str(path))
