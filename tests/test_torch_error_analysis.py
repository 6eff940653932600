"""The port's Fig.-4 error analysis (``core/error_analysis.py``) against
the JAX package's, and the seven claims of ``tests/test_theory.py`` run
on the port.

JAX's uniforms are drawn here, with JAX's own keys, and fed to the port
(``u=``), so both sides round the same draws. Tolerances and why:

* ``update_gd``: one f32 multiply and subtract: bit-equal.
* The multiplicative rules, ``snap_to_grid`` and ``simplified_qlog`` go
  through ``log2`` and ``exp2``, which round up to a few ulps apart across
  the frameworks (H1): values within 16 f32 ulps. Where the ulp moved
  γ·log2|x| across a rounding point (an integer + the uniform, or a
  half-integer for ``snap_to_grid``) the two land one grid step apart,
  2^(1/γ): at most 0.5% of the elements.
* ``quant_error`` (r_t), on the same inputs: an f32 sum of 2^20 or fewer
  squares in another order: rtol 1e-4. ``measure_all``'s r_t: the
  flips above change a few of the summed terms: rtol 2e-3. Where a rule
  lands on grid points (signMUL at γη = 16 moves every exponent by
  exactly 16 codes) r_t is nothing but the rounding noise of
  ``log2``/``exp2`` (a term flips where γ·log2|w'| lands an ulp below an
  integer): measured 3.5e-11 (port) and 1.1e-10 (JAX) at d = 2^14, so
  the bound has an absolute floor of d·2^-40 (1.5e-8: a hundred times
  that noise, a millionth of MUL's r_t).
* ``theoretical_bounds``: an f32 norm in another order: rtol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import error_analysis as jea  # noqa: E402
from repro_torch.core import error_analysis as ea  # noqa: E402
from repro_torch.numerics.rounding import stochastic_round  # noqa: E402

ULPS, FLIP_SHARE = 16, 5e-3
GAMMA, ETA = 1024.0, 2.0 ** -6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fig4_inputs(d=4096, seed=0):
    """``benchmarks/quant_error.py``'s distributions: w = 2^(2·N(0,1)),
    g = 0.003·N(0,1), g2 = 0.003²."""
    rng = np.random.default_rng(seed)
    w = np.exp2(2.0 * rng.standard_normal(d)).astype(np.float32)
    w *= rng.choice([-1.0, 1.0], d).astype(np.float32)
    g = (0.003 * rng.standard_normal(d)).astype(np.float32)
    g2 = np.full(d, 0.003 ** 2, np.float32)
    return w, g, g2


def _uniforms(key, n, shape):
    return [np.array(jax.random.uniform(k, shape, dtype=jnp.float32))
            for k in jax.random.split(key, n)]


def _close_or_one_step(a, b, gamma):
    """Each element within ``ULPS`` f32 ulps, or one grid step 2^(1/γ)
    apart (a flip); flips at most ``FLIP_SHARE``."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.sign(a), np.sign(b))
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(
        np.int64)
    near = np.abs(ia - ib) <= ULPS
    steps = np.abs(np.log2(np.abs(a[~near]) / np.abs(b[~near]))) * gamma
    np.testing.assert_allclose(steps, 1.0, atol=1e-2)
    assert (~near).sum() <= FLIP_SHARE * a.size, (~near).sum()


def test_updates_match_jax():
    w, g, g2 = _fig4_inputs()
    tw, tg, tg2 = map(torch.from_numpy, (w, g, g2))
    jw, jg, jg2 = map(jnp.asarray, (w, g, g2))
    np.testing.assert_array_equal(ea.update_gd(tw, tg, ETA).numpy(),
                                  np.asarray(jea.update_gd(jw, jg, ETA)))
    for name in ("update_mul", "update_signmul"):
        _close_or_one_step(getattr(ea, name)(tw, tg, ETA).numpy(),
                           np.asarray(getattr(jea, name)(jw, jg, ETA)),
                           GAMMA)
    tm, tv = ea.update_madam(tw, tg, tg2, ETA)
    jm, jv = jea.update_madam(jw, jg, jg2, ETA)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close_or_one_step(tm.numpy(), np.asarray(jm), GAMMA)


@pytest.mark.parametrize("gamma", [64.0, GAMMA])
def test_grid_and_qlog_match_jax(key, gamma):
    w, g, _ = _fig4_inputs(seed=1)
    _close_or_one_step(ea.snap_to_grid(torch.from_numpy(w), gamma).numpy(),
                       np.asarray(jea.snap_to_grid(jnp.asarray(w), gamma)),
                       gamma)
    x = (w - ETA * g).astype(np.float32)
    u = np.array(jax.random.uniform(key, x.shape, dtype=jnp.float32))
    tq = ea.simplified_qlog(None, torch.from_numpy(x), gamma,
                            u=torch.from_numpy(u))
    jq = jea.simplified_qlog(key, jnp.asarray(x), gamma)
    _close_or_one_step(tq.numpy(), np.asarray(jq), gamma)
    # the same r_t on the same pair of tensors
    np.testing.assert_allclose(
        float(ea.quant_error(torch.from_numpy(x), tq)),
        float(jea.quant_error(jnp.asarray(x), jnp.asarray(tq.numpy()))),
        rtol=1e-4)


def test_bounds_match_jax():
    w, g, _ = _fig4_inputs(seed=2)
    tb = ea.theoretical_bounds(torch.from_numpy(w), torch.from_numpy(g),
                               ETA, GAMMA)
    jb = jea.theoretical_bounds(jnp.asarray(w), jnp.asarray(g), ETA, GAMMA)
    assert tb.keys() == jb.keys()
    for k in jb:
        np.testing.assert_allclose(float(tb[k]), float(jb[k]), rtol=1e-5,
                                   err_msg=k)


def test_measure_all_matches_jax(key):
    w, g, g2 = _fig4_inputs(d=1 << 14, seed=3)
    u = [torch.from_numpy(x) for x in _uniforms(key, 4, w.shape)]
    got = ea.measure_all(None, torch.from_numpy(w), torch.from_numpy(g),
                         ETA, GAMMA, torch.from_numpy(g2), u=u)
    want = jea.measure_all(key, jnp.asarray(w), jnp.asarray(g), ETA, GAMMA,
                           jnp.asarray(g2))
    assert list(got) == list(want) == list(ea.RULES)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-3,
                                   atol=w.size * 2.0 ** -40, err_msg=k)
    # with a generator the port draws its own uniforms, in rule order
    gen = torch.Generator().manual_seed(0)
    again = ea.measure_all(gen, torch.from_numpy(w), torch.from_numpy(g),
                           ETA, GAMMA, torch.from_numpy(g2))
    assert float(again["signmul"]) < float(again["gd"])


# ---------------------------------------------------------------------------
# the seven claims of tests/test_theory.py, on the port's own draws


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _normal(seed, *shape):
    return torch.randn(shape, generator=_gen(seed))


def _mean_error(seed, rule, w, g, eta, gamma, trials=48):
    w = ea.snap_to_grid(w, gamma)
    upd = {"gd": ea.update_gd, "mul": ea.update_mul,
           "signmul": ea.update_signmul}[rule]
    gen = _gen(seed)
    errs = []
    for _ in range(trials):
        w_new = upd(w, g, eta)
        errs.append(float(ea.quant_error(
            w_new, ea.simplified_qlog(gen, w_new, gamma))))
    return float(np.mean(errs))


@pytest.mark.parametrize("gamma", [64.0, 256.0])
def test_theorem_bounds_hold(gamma):
    d, eta = 256, 2.0 ** -6
    w = _normal(0, d) * 0.5 + 1.0
    g = _normal(1, d) * 0.1
    bounds = ea.theoretical_bounds(w, g, eta, gamma)
    for rule in ("gd", "mul", "signmul"):
        assert _mean_error(0, rule, w, g, eta, gamma) <= float(
            bounds[rule]) + 1e-3, rule


def test_multiplicative_below_gd():
    """Fig. 4's headline, in the paper's regime (γη|g| < 1)."""
    d, gamma, eta = 512, 1024.0, 2.0 ** -7
    w = torch.exp2(_normal(0, d) * 2.0)
    g = _normal(1, d) * 0.003
    e_gd = _mean_error(0, "gd", w, g, eta, gamma)
    assert _mean_error(0, "mul", w, g, eta, gamma) < 0.5 * e_gd
    assert _mean_error(0, "signmul", w, g, eta, gamma) < 0.01 * e_gd


def test_gd_updates_disregarded_at_large_weights():
    """Fig. 1: with deterministic rounding GD's additive step is rounded
    away once the gap exceeds it; signMUL always moves the exponent."""
    gamma, eta = 64.0, 2.0 ** -6
    for mag in (64.0, 256.0):
        w = torch.full((128,), mag)
        g = torch.full((128,), 0.05)
        snapped = ea.snap_to_grid(w, gamma)
        assert torch.equal(ea.snap_to_grid(ea.update_gd(w, g, eta), gamma),
                           snapped)
        moved = ea.snap_to_grid(ea.update_signmul(w, g, eta), gamma)
        assert bool(torch.all(moved != snapped))


def test_signmul_bound_independent_of_w_and_g():
    """Lemma 1: E r <= d·η/γ regardless of weights and gradients."""
    d, gamma, eta = 256, 512.0, 2.0 ** -5
    for i, (wmag, gmag) in enumerate([(0.1, 0.1), (10.0, 5.0),
                                      (100.0, 0.01)]):
        w = _normal(i, d) * wmag + wmag
        g = _normal(i + 10, d) * gmag
        assert _mean_error(0, "signmul", w, g, eta, gamma) <= d * eta / gamma


def test_error_decreases_with_gamma():
    """Both Fig.-4 panels: r_t shrinks as γ grows (a finer grid)."""
    d, eta = 256, 2.0 ** -6
    w = _normal(0, d) + 2.0
    g = _normal(1, d) * 0.1
    errs = [_mean_error(0, "gd", w, g, eta, gamma, trials=32)
            for gamma in (64.0, 256.0, 1024.0)]
    assert errs[0] > errs[1] > errs[2]


def test_mul_error_grows_with_eta():
    """Fig. 4's left panel: the multiplicative error scales with η."""
    d, gamma = 256, 1024.0
    w = torch.exp2(_normal(0, d))
    g = _normal(1, d) * 0.003
    errs = [_mean_error(0, "mul", w, g, eta, gamma, trials=32)
            for eta in (2.0 ** -9, 2.0 ** -7, 2.0 ** -5)]
    assert errs[0] < errs[1] < errs[2]


def test_sr_unbiased():
    r = stochastic_round(torch.full((50000,), 0.3), _gen(0))
    assert float(r.mean()) == pytest.approx(0.3, abs=0.01)
