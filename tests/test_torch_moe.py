"""The port's mixture-of-experts layer (``repro_torch.models.moe``)
against the JAX package's ``repro.models.moe`` on the CPU, at the smoke
configs' widths, on JAX parameters carried across by
``convert.params_from_flat`` and inputs drawn from numpy seeds.

Tolerances:
* Routes (``top_i``), the five routing maps, the slots a route takes:
  equal, exactly. The gates ``top_p`` and the balance loss: 2e-6
  absolute and 1e-6 relative at f32 (the softmax's exp and the mean's
  summation order differ by ULPs).
* ``moe_apply`` (sort and dense_ref) against JAX's at f32: 1e-5 absolute
  (the expert GEMMs' and the combine's sum orders); at bf16 2^-4 of max
  |out| (8 significant bits, sums in another order, as
  ``test_torch_recurrent.py``). sort against dense_ref where no
  assignment drops: 1e-5 absolute at f32.
* The gathers' gradients against JAX's custom VJPs: 1e-6 absolute at
  f32 (sums over k of two to four products).
* The chunked no-grad expert path against the whole stack: equal, bit
  for bit (the quantizers are elementwise under scales taken over the
  whole buffer and stack; each expert's product is its own).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core.lns import LNSFormat as JFormat  # noqa: E402
from repro.core.quantizer import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim.madam import MadamConfig as JMadamConfig  # noqa: E402
from repro.optim.madam import init_lns_params as j_init_lns  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.core.lns import LNSFormat  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim.madam import MadamConfig, init_lns_params  # noqa: E402

from test_torch_model import flat_params  # noqa: E402

MOE = ["deepseek-v3-671b", "kimi-k2-1t-a32b"]
DTYPES = ["float32", "bfloat16"]
BF16_REL = 2.0 ** -4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(j_smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw))


def _layer(jcfg, packed, seed=3):
    """One MoE layer's JAX parameters (dense f32 compute-dtype draws, or
    encoded by JAX's Madam into 8-bit words) and the port's copy."""
    p = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    fmt = LNSFormat(8, 8)
    if packed:
        p = j_init_lns(p, JMadamConfig(update_format=JFormat(bits=8,
                                                             gamma=8)))
    return p, params_from_flat(flat_params(p), fmt, device="cpu")


def _x(cfg, B=2, S=6, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _both(x, jcfg, tcfg):
    return (jnp.asarray(x).astype(jcfg.compute_dtype),
            torch.from_numpy(x).to(tcfg.compute_dtype))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().detach().numpy()


# ---------------------------------------------------------------------------
# the router


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE)
def test_router_matches_jax(arch, dtype, packed):
    """``top_i`` equal, ``top_p`` and aux within the f32 bound, on dense
    and 8-bit packed routers (decoded to the compute dtype, promoted)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _layer(jcfg, packed)
    jx, tx = _both(_x(jcfg, 3, 8), jcfg, tcfg)
    jq = JQuantConfig.lns_madam() if packed else None
    j_p, j_i, j_aux = jax.jit(lambda p, x: jmoe._router(p, x, jcfg, jq))(
        jp, jx)
    t_p, t_i, t_aux = moe._router(tp, tx, tcfg)
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(j_p), rtol=1e-6,
                               atol=2e-6)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-6,
                               atol=2e-6)
    assert t_p.dtype == torch.float32
    np.testing.assert_allclose(t_p.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_router_ties_take_the_lower_expert_first():
    """Equal probabilities (duplicated router columns, a zero router):
    the lower expert id first, as ``lax.top_k`` orders them."""
    jcfg, tcfg = _cfgs("kimi-k2-1t-a32b")
    rng = np.random.default_rng(7)
    cols = rng.standard_normal((jcfg.d_model, 4)).astype(np.float32)
    for w in (np.repeat(cols, 2, axis=1)[:, [0, 2, 4, 6, 1, 3, 5, 7]],
              np.zeros((jcfg.d_model, 8), np.float32)):
        jp = {"router": jnp.asarray(w)}
        tp = {"router": torch.from_numpy(w)}
        jx, tx = _both(_x(jcfg, 2, 5, seed=2), jcfg, tcfg)
        _, j_i, _ = jmoe._router(jp, jx, jcfg, None)
        _, t_i, _ = moe._router(tp, tx, tcfg)
        np.testing.assert_array_equal(t_i.numpy(), np.asarray(j_i))


# ---------------------------------------------------------------------------
# the routing maps


MAP_CASES = [  # (T, K, E, C): drops at C = 1, ragged, none dropped
    (8, 2, 8, 1), (16, 2, 8, 2), (32, 8, 16, 1), (12, 3, 5, 4),
    (5, 3, 4, 15)]


@pytest.mark.parametrize("gdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,K,E,C", MAP_CASES)
def test_group_routing_maps_equal_jax(T, K, E, C, gdt):
    """The five maps equal JAX's exactly, on expert ids drawn with
    repeats (the same expert twice for one token included)."""
    rng = np.random.default_rng(T * 1000 + K * 100 + E + C)
    flat_e = rng.integers(0, E, T * K).astype(np.int32)
    flat_e[:K] = flat_e[0]          # token 0: one expert K times
    gates = rng.random(T * K).astype(np.float32)
    jg = jnp.asarray(gates).astype(gdt)
    tg = torch.from_numpy(gates).to(getattr(torch, gdt))
    want = jax.jit(lambda e, g: jmoe._group_routing_maps(e, g, E, C, K))(
        jnp.asarray(flat_e), jg)
    got = moe._group_routing_maps(torch.from_numpy(flat_e), tg, E, C, K)
    for name, g, w in zip(("slot_src", "slot_fill", "inv", "gate_inv",
                           "slot_gate"), got, want):
        np.testing.assert_array_equal(_f32(g) if g.is_floating_point()
                                      else g.numpy(),
                                      _f32(w) if jnp.issubdtype(
                                          w.dtype, jnp.floating)
                                      else np.asarray(w), err_msg=name)
    counts = np.bincount(flat_e, minlength=E)
    assert int(got[1].sum()) == int(np.minimum(counts, C).sum())


@pytest.mark.parametrize("arch", MOE)
def test_capacity_is_one_at_decode_and_drops_are_counted(arch):
    """C = max(int(1.25 T K / E), 1): 1 at a 4-slot decode step and at a
    32-token prefill at full width (so rows of a call share capacity),
    and ``dropped`` counts what the maps drop."""
    from repro_torch.configs import get_config
    full = get_config(arch)
    assert moe._capacity(full, 4) == 1
    assert moe._capacity(full, 32) == 1
    _, tcfg = _cfgs(arch)
    top_i = torch.tensor([[0, 1], [0, 1], [0, 2], [3, 0]])
    C = moe._capacity(tcfg, 4)
    assert C == 1
    maps = moe.routing(top_i, torch.full((4, 2), 0.5), tcfg)
    kept = int(maps[2].sum())
    assert kept == 4                      # experts 0, 1, 2, 3 once each
    assert moe.dropped(top_i, tcfg) == 8 - kept


# ---------------------------------------------------------------------------
# the layer


@pytest.mark.parametrize("qname", ["none", "lns8"])
@pytest.mark.parametrize("dispatch", ["sort", "dense_ref"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_matches_jax(arch, dtype, dispatch, qname):
    """The layer's output and aux on JAX's 8-bit packed weights, without
    a quantizer and under ``lns_madam`` (the shared expert's GEMMs
    routed, the stacks on the fake-quant leg)."""
    jcfg, tcfg = _cfgs(arch, dtype, moe_dispatch=dispatch)
    jp, tp = _layer(jcfg, True)
    jq, tq = ((None, None) if qname == "none"
              else (JQuantConfig.lns_madam(), QuantConfig.lns_madam()))
    jx, tx = _both(_x(jcfg), jcfg, tcfg)
    jout, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg, jq))(jp, jx)
    tout, taux = moe.moe_apply(tp, tx, tcfg, tq)
    assert tout.dtype == tcfg.compute_dtype and tout.shape == tx.shape
    want = _f32(jout)
    atol = 1e-5 if dtype == "float32" else BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(_f32(tout), want, rtol=0, atol=atol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_sort_equals_dense_ref_where_nothing_drops(arch):
    """With a capacity that holds every route (capacity factor E, so
    C = T K) the sort dispatch equals the O(E) oracle; at the default
    factor the same tokens drop some routes and the two part."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=8.0)
    _, tp = _layer(jcfg, False)
    x = torch.from_numpy(_x(jcfg))
    ref = moe.moe_apply(tp, x, dataclasses.replace(
        tcfg, moe_dispatch="dense_ref"), None)[0]
    srt = moe.moe_apply(tp, x, tcfg, None)[0]
    np.testing.assert_allclose(srt.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    tight = dataclasses.replace(tcfg, capacity_factor=1.25)
    top_p, top_i, _ = moe._router(tp, x, tight)
    assert moe.dropped(top_i, tight) > 0
    part = moe.moe_apply(tp, x, tight, None)[0]
    assert float((part - ref).abs().max()) > 1e-3


@pytest.mark.parametrize("K", [2, 4])
def test_gather_gradients_match_jax_custom_vjps(K):
    """``_DispatchGather`` and ``_CombineGather``'s gradients (the dual
    maps' gathers) against JAX's ``_dispatch_gather``/``_combine_gather``
    VJPs, with drops (C = 2 over 12 tokens and 6 experts)."""
    T, E, C, D = 12, 6, 2, 5
    rng = np.random.default_rng(K)
    flat_e = rng.integers(0, E, T * K).astype(np.int32)
    gates = rng.random(T * K).astype(np.float32)
    maps_t = moe._group_routing_maps(torch.from_numpy(flat_e),
                                     torch.from_numpy(gates), E, C, K)
    maps_j = jmoe._group_routing_maps(jnp.asarray(flat_e),
                                      jnp.asarray(gates), E, C, K)
    s_src, s_fill, inv, g_inv, s_gate = (t[None] for t in maps_t)
    js_src, js_fill, jinv, jg_inv, js_gate = (a[None] for a in maps_j)
    xg = rng.standard_normal((1, T, D)).astype(np.float32)
    dxe = rng.standard_normal((1, E * C, D)).astype(np.float32)
    keep = g_inv != 0
    tx = torch.from_numpy(xg).requires_grad_(True)
    xe = moe._DispatchGather.apply(tx, s_src, s_fill, inv, keep)
    xe.backward(torch.from_numpy(dxe))
    jxe, vjp = jax.vjp(lambda a: jmoe._dispatch_gather(
        a, js_src, js_fill, jinv, jg_inv != 0), jnp.asarray(xg))
    np.testing.assert_array_equal(xe.detach().numpy(), np.asarray(jxe))
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(dxe))[0]),
                               rtol=0, atol=1e-6)
    ye = rng.standard_normal((1, E * C, D)).astype(np.float32)
    dout = rng.standard_normal((1, T, D)).astype(np.float32)
    tye = torch.from_numpy(ye).requires_grad_(True)
    tg = g_inv.clone().requires_grad_(True)
    out = moe._CombineGather.apply(tye, inv, tg, s_src, s_gate)
    out.backward(torch.from_numpy(dout))
    jout, vjp = jax.vjp(lambda a, g: jmoe._combine_gather(
        a, jinv, g, js_src, js_gate), jnp.asarray(ye), jg_inv)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-6)
    dye, dgate = vjp(jnp.asarray(dout))
    np.testing.assert_allclose(tye.grad.numpy(), np.asarray(dye), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(dgate), rtol=0,
                               atol=1e-6)


def test_moe_grads_reach_router_experts_and_shared():
    """The train path (a graph recorded: the whole stacks) gives every
    leaf a gradient, as JAX's ``test_moe_grads_reach_experts``; the
    routed experts' and the router's through the custom gathers."""
    _, tcfg = _cfgs("deepseek-v3-671b")
    _, tp = _layer(j_smoke_config("deepseek-v3-671b"), False)
    tp = {k: (v.requires_grad_(True) if isinstance(v, torch.Tensor) else
              {kk: vv.requires_grad_(True) for kk, vv in v.items()})
          for k, v in tp.items()}
    x = torch.from_numpy(_x(tcfg)).requires_grad_(True)
    out, aux = moe.moe_apply(tp, x, tcfg, QuantConfig.lns_madam())
    (out.square().mean() + 0.01 * aux).backward()
    for k in ("router", "w_up", "w_gate", "w_down"):
        assert float(tp[k].grad.abs().sum()) > 0, k
    for k in ("up", "gate", "down"):
        assert float(tp["shared"][k].grad.abs().sum()) > 0, k
    assert float(x.grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# the chunked no-grad expert path


@pytest.mark.parametrize("store", ["dense", "lns8", "lns16"])
@pytest.mark.parametrize("qname", ["none", "lns8"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per", [1, 3])
def test_chunked_expert_path_equals_whole_stack(per, dtype, qname, store,
                                                monkeypatch):
    """1 and 3 experts a chunk (the last chunk ragged: 8 experts), the
    grouped ``(1, E, C, D)`` buffer and the ``(E, T, D)`` of dense_ref,
    dense, 8-bit (serving) and 16-bit (the update store) stacks: the
    chunked path's output equals the whole stack's bit for bit. The
    8-bit stacks under ``lns_madam`` take Q_W on their words
    (``_regrid_chunk``), the others decode and quantize."""
    jcfg, tcfg = _cfgs("kimi-k2-1t-a32b", dtype)
    _, dense = _layer(jcfg, False)
    p = dense if store == "dense" else init_lns_params(dense, MadamConfig(
        update_format=LNSFormat(8, 8) if store == "lns8"
        else MadamConfig().update_format))
    qcfg = None if qname == "none" else QuantConfig.lns_madam()
    d, f = tcfg.d_model, tcfg.moe_d_ff
    monkeypatch.setattr(moe, "_EXPERT_CHUNK_ELEMS", per * d * f)
    regrids = []
    real = moe._regrid_chunk
    monkeypatch.setattr(moe, "_regrid_chunk",
                        lambda *a: regrids.append(1) or real(*a))
    rng = np.random.default_rng(per)
    for shape in ((1, tcfg.num_experts, 3, d), (tcfg.num_experts, 5, d)):
        xe = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(tcfg.compute_dtype)
        xe[..., -1, :] = 0                   # unfilled slots are zero rows
        with torch.no_grad():
            got = moe._expert_ffn(p, xe, tcfg, qcfg)
            want = moe._expert_ffn_whole(p, xe, tcfg, qcfg)
        assert got.dtype == want.dtype == tcfg.compute_dtype
        assert torch.equal(got, want), float((got - want).abs().max())
    assert bool(regrids) == (store == "lns8" and qname == "lns8")


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("qname", ["none", "lns8"])
def test_experts_given_no_token_are_skipped_exactly(qname, fallback,
                                                    monkeypatch):
    """Experts with no nonzero input row are not computed: their rows of
    the chunked output are zero, every other row equals the whole stack's
    bit for bit, and so does ``moe_apply``'s output through the sort
    dispatch (3 of 8 experts given no token). Where the computed rows'
    largest |act(gate)·up| does not pass the bound on the skipped rows'
    (forced here), every expert is computed."""
    jcfg, tcfg = _cfgs("kimi-k2-1t-a32b", "bfloat16")
    _, dense = _layer(jcfg, False)
    p = init_lns_params(dense, MadamConfig(update_format=LNSFormat(8, 8)))
    qcfg = None if qname == "none" else QuantConfig.lns_madam()
    if fallback:
        monkeypatch.setattr(moe, "_skipped_bound", lambda *a: float("inf"))
    rng = np.random.default_rng(11)
    xe = torch.from_numpy(rng.standard_normal(
        (1, tcfg.num_experts, 3, tcfg.d_model)).astype(np.float32)).to(
        torch.bfloat16)
    idle = [1, 4, 7]
    xe[:, idle] = 0
    with torch.no_grad():
        got = moe._expert_ffn(p, xe, tcfg, qcfg)
        want = moe._expert_ffn_whole(p, xe, tcfg, qcfg)
    busy = [e for e in range(tcfg.num_experts) if e not in idle]
    assert torch.equal(got[:, busy], want[:, busy])
    if qname == "lns8" and not fallback:
        assert not bool(got[:, idle].any())
    # through the dispatch: three tokens routed to experts 0, 2, 3, 5, 6
    x = torch.from_numpy(rng.standard_normal((1, 3, tcfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    top_i = torch.tensor([[0, 2], [3, 5], [6, 0]])
    top_p = torch.tensor([[0.6, 0.4], [0.5, 0.5], [0.7, 0.3]])
    cf = dataclasses.replace(tcfg, capacity_factor=4.0)
    with torch.no_grad():
        a = moe._sorted_dispatch(p, x, top_p, top_i, cf, qcfg)
        monkeypatch.setattr(moe, "_chunkable", lambda q: False)
        b = moe._sorted_dispatch(p, x, top_p, top_i, cf, qcfg)
    assert torch.equal(a, b)


def test_regrid_on_words_refuses_inexact_scales():
    """Q_W on the words needs exact power-of-two scales (a JAX tree
    carried from XLA-CPU may hold scales an ulp off, H12) and normal
    decodes; else the stack is decoded and quantized, equal to the whole
    stack all the same."""
    _, tcfg = _cfgs("kimi-k2-1t-a32b", "bfloat16")
    _, dense = _layer(_cfgs("kimi-k2-1t-a32b", "bfloat16")[0], False)
    p = init_lns_params(dense, MadamConfig(update_format=LNSFormat(8, 8)))
    fmt = QuantConfig.lns_madam().weight
    w = p["w_up"]
    assert moe._regrid_exact(w, fmt, torch.bfloat16)
    off = w.replace(scale=torch.nextafter(w.scale, torch.zeros(())))
    assert not moe._regrid_exact(off, fmt, torch.bfloat16)
    tiny = w.replace(scale=torch.full_like(w.scale, 2.0 ** -126))
    assert not moe._regrid_exact(tiny, fmt, torch.bfloat16)
    assert not moe._regrid_exact(w, LNSFormat(8, 16), torch.bfloat16)
    xe = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, tcfg.num_experts, 2, tcfg.d_model)).astype(np.float32)).to(
        torch.bfloat16)
    q = dict(p, w_up=off)
    with torch.no_grad():
        got = moe._expert_ffn(q, xe, tcfg, QuantConfig.lns_madam())
        want = moe._expert_ffn_whole(q, xe, tcfg, QuantConfig.lns_madam())
    assert torch.equal(got, want)


def test_chunked_path_is_taken_only_without_a_graph(monkeypatch):
    """The serving call (no ``delta``, no input needing a gradient)
    takes the chunked path; a weight carrier or an input with
    ``requires_grad`` takes the whole stack."""
    _, tcfg = _cfgs("kimi-k2-1t-a32b")
    _, p = _layer(j_smoke_config("kimi-k2-1t-a32b"), False)
    calls = []
    real = moe._expert_ffn_chunked
    monkeypatch.setattr(moe, "_expert_ffn_chunked",
                        lambda *a: calls.append(1) or real(*a))
    xe = torch.zeros((1, tcfg.num_experts, 2, tcfg.d_model))
    moe._expert_ffn(p, xe, tcfg, None)
    assert calls == [1]
    moe._expert_ffn(p, xe.requires_grad_(True), tcfg, None)
    with torch.no_grad():
        moe._expert_ffn(p, xe, tcfg, None)
    assert calls == [1, 1]
    assert not moe._chunkable(QuantConfig.fp8())
    assert not moe._chunkable(QuantConfig.lns_madam(approx_lut=8))
