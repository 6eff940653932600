"""The mixture-of-experts models of the port (deepseek-v3-671b: MLA,
routed and shared experts, MTP; kimi-k2-1t-a32b: GQA at 8 query heads a
KV head, 384 experts) against the JAX package at each config's
``SMOKE`` shape, on the CPU, with JAX parameters carried across by
``convert.params_from_flat`` and inputs drawn from numpy seeds. The
layers' own tests are ``test_torch_moe.py`` and ``test_torch_mla.py``.

Tolerances:
* Configs, ``params_count()`` (the full configs' 671.7e9 and 1027.9e9,
  the drawn SMOKE trees'), the carried leaves (4-D expert stacks and
  their ``(n, E, 1, F)`` scales included), the LNS leaf counts: equal.
* Forward logits, the summed balance loss and the final hidden state
  with no quantizer, on JAX's 16-bit packed tree of perturbed weights:
  2e-5 absolute at f32 (exp, rsqrt and sum orders), every layer's routes
  equal to JAX's exactly. At bf16 a route flips where two experts'
  probabilities tie within the frameworks' rounding (H17); the flip is
  held to such a tie and the positions before it to 2^-4 of max |logit|,
  as ``test_torch_recurrent.py``.
* ``lm_loss`` (cross entropy + 0.01 aux + 0.3 MTP) at f32: 1e-5
  relative without a quantizer, 1e-3 under ``lns_madam`` (a Q_A code
  may flip where an ulp of log2 sits on a rounding tie, H1); at bf16
  2e-2 relative.
* Decode (the MLA latent cache, or kimi's dense and paged KV) against
  the training forward, with a capacity that drops nothing (capacity
  couples a call's rows, so a decode step's C = 1 would drop routes a
  whole-sequence forward keeps): 2e-4 absolute at f32 (the absorbed
  form's product order, the JAX package's MLA bound).
The engine's side is in ``test_torch_moe_serving.py``, a train step's
in ``test_torch_moe_train.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke_config  # noqa: E402
from repro.core.lns import LNSFormat as JFormat  # noqa: E402
from repro.core.quantizer import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels import dispatch as jd  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.common import ArchConfig as JArchConfig  # noqa: E402
from repro.optim.madam import MadamConfig as JMadamConfig  # noqa: E402
from repro.optim.madam import init_lns_params as j_init_lns  # noqa: E402
from repro.training import init_train_state as j_init_train_state  # noqa: E402
from repro_torch.checkpoint.manager import flatten_state  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.core.lns import LNSFormat, is_lns_weight  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim.madam import MadamConfig, init_lns_params  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

from test_torch_dense_variants import _perturbed_dense, _unflat  # noqa: E402
from test_torch_model import flat_params  # noqa: E402

MOE = ["deepseek-v3-671b", "kimi-k2-1t-a32b"]
DTYPES = ["float32", "bfloat16"]
FULL_COUNTS = {"deepseek-v3-671b": 671_712_655_360,
               "kimi-k2-1t-a32b": 1_027_946_673_152}
LNS_LEAVES = {"deepseek-v3-671b": 47, "kimi-k2-1t-a32b": 20}
BF16_REL = 2.0 ** -4
FMT8 = LNSFormat(8, 8)
JMCFG8 = JMadamConfig(update_format=JFormat(bits=8, gamma=8))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(j_smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw))


def _close(got, want, dtype, f32_atol=2e-5):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    atol = f32_atol if dtype == "float32" else BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().detach().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _packed_perturbed(jcfg, seed=11):
    """JAX's parameters of ``jcfg`` with every zero leaf perturbed,
    encoded by JAX's Madam (16-bit store): JAX's tree and the port's."""
    flat = _perturbed_dense(jcfg, seed=seed)
    dense = _unflat(flat, jax.eval_shape(
        lambda: jm.init_params(jax.random.PRNGKey(0), jcfg)))
    jp = jax.jit(lambda p: j_init_lns(p, JMadamConfig()))(dense)
    return jp, params_from_flat(flat_params(jp), MadamConfig().update_format,
                                device="cpu")


# ---------------------------------------------------------------------------
# configs, counts, conversion


@pytest.mark.parametrize("arch", MOE)
def test_configs_and_params_count_match_jax(arch):
    """Field for field as JAX's, the same layer pattern and parameter
    count at full width and at the smoke shape, the drawn tree's count
    and leaf shapes JAX's."""
    assert arch in ARCHS
    for t, j in ((get_config(arch), j_config(arch)),
                 (get_smoke_config(arch), j_smoke_config(arch))):
        for f in dataclasses.fields(JArchConfig):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.layer_pattern() == j.layer_pattern()
        assert t.params_count() == j.params_count()
    assert get_config(arch).params_count() == FULL_COUNTS[arch]
    cfg = get_smoke_config(arch)
    tree = tm.init_params(cfg, seed=0, device="cpu")
    assert sum(x.numel() for _, x in leaves(tree)) == cfg.params_count()
    jtree = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                  j_smoke_config(arch)))
    want = {k: tuple(v.shape) for k, v in flat_params(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jtree)).items()}
    assert {k: tuple(v.shape) for k, v in flatten_state(tree).items()} \
        == want
    dts = {k: str(v.dtype) for k, v in flat_params(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jtree)).items()}
    for k, v in flatten_state(tree).items():
        assert str(v.dtype).split(".")[-1] == dts[k], k


@pytest.mark.parametrize("arch", MOE)
def test_lns_leaf_counts_at_full_structure(arch):
    """Madam encodes 47 (deepseek: 3 dense MLA layers, the MoE stack,
    the MTP block and projection, embed and head) and 20 (kimi) leaves of
    the full config's tree in both packages (the port's at the full
    layer pattern and narrow widths; JAX's by ``eval_shape`` at full
    width)."""
    full = get_config(arch)
    narrow = dataclasses.replace(
        full, d_model=32, d_ff=48, moe_d_ff=16, vocab_size=64, num_heads=2,
        num_kv_heads=1 if full.num_kv_heads < full.num_heads else 2,
        head_dim=8, q_lora_rank=min(full.q_lora_rank, 8),
        kv_lora_rank=min(full.kv_lora_rank, 8),
        qk_nope_dim=min(full.qk_nope_dim, 8),
        qk_rope_dim=min(full.qk_rope_dim, 4),
        v_head_dim=min(full.v_head_dim, 8), num_experts=4,
        experts_per_token=2)
    tree = init_lns_params(tm.init_params(narrow, seed=0, device="cpu"),
                           MadamConfig())
    n = sum(is_lns_weight(x) for _, x in leaves(tree))
    jstate = jax.eval_shape(lambda: j_init_train_state(
        jax.random.PRNGKey(0), j_config(arch), JMadamConfig()))
    jn = sum(1 for x in jax.tree.leaves(
        jstate.params, is_leaf=lambda x: hasattr(x, "packed")) if
        hasattr(x, "packed"))
    assert n == jn == LNS_LEAVES[arch]


@pytest.mark.parametrize("arch", MOE)
def test_convert_carries_every_leaf(arch):
    """JAX's dense tree and its packed 8-bit train-state tree carried
    across: the same leaves, shapes and values, the stacked expert
    leaves ``(n, E, D, F)`` with their ``(n, E, 1, F)`` scales, the
    ``moe/shared`` and ``mtp`` subtrees."""
    jcfg = j_smoke_config(arch)
    flat = _perturbed_dense(jcfg, seed=11)
    back = flatten_state(params_from_flat(flat, FMT8, device="cpu"))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    packed = flat_params(jax.jit(lambda k: j_init_train_state(
        k, jcfg, JMCFG8).params)(jax.random.PRNGKey(0)))
    tp = params_from_flat(packed, FMT8, device="cpu")
    back = flatten_state(tp)
    assert sorted(back) == sorted(packed)
    for k in packed:
        np.testing.assert_array_equal(back[k].astype(np.float64),
                                      packed[k].astype(np.float64),
                                      err_msg=k)
    n, E, d, f = (jcfg.num_layers - jcfg.num_dense_layers, jcfg.num_experts,
                  jcfg.d_model, jcfg.moe_d_ff)
    w = tp["period"]["pos0"]["moe"]["w_up"]
    assert is_lns_weight(w) and w.shape == (n, E, d, f)
    assert tuple(w.scale.shape) == (n, E, 1, f)
    assert "moe::shared::up::packed" in "".join(
        k + " " for k in packed).replace("period::pos0::", "")
    assert ("mtp" in tp) == bool(jcfg.mtp_depth)


# ---------------------------------------------------------------------------
# the model


def _routes(monkeypatch):
    """Record every ``moe._router`` call's ``top_i`` (the port's)."""
    seen = []
    real = moe._router

    def spy(*a):
        out = real(*a)
        seen.append(out[1].clone())
        return out

    monkeypatch.setattr(moe, "_router", spy)
    return seen


def _jax_routes(jcfg, jp, tokens):
    """JAX's ``top_i`` of every MoE layer of a forward, from its own
    router on each layer's input (replayed layer by layer)."""
    from repro.models import moe as jmoe
    seen = []
    real = jmoe._router

    def spy(p, x, cfg, qcfg):
        out = real(p, x, cfg, qcfg)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), out[1])
        return out

    jmoe._router = spy
    try:
        out = jm.forward(jp, jnp.asarray(tokens), jcfg, None)
        jax.block_until_ready(out.logits)
    finally:
        jmoe._router = real
    return out, seen


@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_jax(arch, monkeypatch):
    """f32: the training forward (deepseek's MLA in every layer, the sort
    dispatch with its capacity drops) on the same packed weights and
    tokens: every MoE layer's routes equal JAX's, and the logits, the
    summed aux and the final hidden state within the f32 bound."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _packed_perturbed(jcfg)
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jout, jroutes = _jax_routes(jcfg, jp, tokens)
    troutes = _routes(monkeypatch)
    out = tm.forward(tp, torch.from_numpy(tokens), tcfg, None, full=True)
    assert out.logits.dtype == tcfg.compute_dtype
    assert out.logits.shape == (2, 16, jcfg.vocab_size)
    assert len(troutes) == len(jroutes) == (jcfg.num_layers
                                           - jcfg.num_dense_layers)
    for a, b in zip(troutes, jroutes):
        np.testing.assert_array_equal(a.numpy(), b)
    _close(_f32(out.logits), _f32(jout.logits), "float32")
    _close(_f32(out.hidden), _f32(jout.hidden), "float32")
    np.testing.assert_allclose(float(out.aux), float(jout.aux), rtol=1e-5)
    assert float(out.aux) > 0


@pytest.mark.parametrize("arch", MOE)
def test_bf16_forward_parts_from_jax_only_at_a_route_tie(arch,
                                                         monkeypatch):
    """bf16, at a capacity that drops nothing (E / K: no route takes
    another's slot): the two frameworks round the trunk's bf16 ops in
    another order, so a route can flip where two experts' probabilities
    lie within that rounding (ROADMAP Queue 3, H17). The earliest
    flipped (token, layer) must sit at such a tie (the
    port's k-th and (k+1)-th probabilities within 2^-6 of each other);
    causal attention keeps every earlier position of its row unaffected,
    so the routes there (the experts a token takes) are equal in every
    layer and the logits within
    2^-4 of max |logit|; at least half the positions are compared."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    cf = jcfg.num_experts / jcfg.experts_per_token
    jcfg, tcfg = _cfgs(arch, "bfloat16", capacity_factor=cf)
    jp, tp = _packed_perturbed(jcfg)
    B, S, K = 2, 16, jcfg.experts_per_token
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jout, jroutes = _jax_routes(jcfg, jp, tokens)
    seen, probs = [], []
    real = moe._router

    def spy(p, x, cfg):
        w = p["router"]
        w = (w.decode(cfg.compute_dtype) if is_lns_weight(w) else w).float()
        probs.append(torch.softmax(torch.einsum(
            "bsd,de->bse", x.float(), w), -1).reshape(B * S, -1))
        out = real(p, x, cfg)
        seen.append(out[1])
        return out

    monkeypatch.setattr(moe, "_router", spy)
    out = tm.forward(tp, torch.from_numpy(tokens), tcfg, None, full=True)
    first = np.full(B, S)                    # each row's first flip
    flips = []
    for li, (a, b) in enumerate(zip(seen, jroutes)):
        for t in np.where((np.sort(a.numpy(), -1)
                           != np.sort(b, -1)).any(-1))[0]:
            flips.append((t % S, li, t))
            first[t // S] = min(first[t // S], t % S)
    if flips:
        pos, li, t = min(flips)
        top = torch.sort(probs[li][t], descending=True).values
        assert float(top[K - 1] - top[K]) <= 2.0 ** -6 * float(top[K - 1])
    for a, b in zip(seen, jroutes):
        for r in range(B):
            rows = slice(r * S, r * S + first[r])
            np.testing.assert_array_equal(np.sort(a.numpy()[rows], -1),
                                          np.sort(b[rows], -1))
    assert first.sum() >= B * S // 2, first
    for r in range(B):
        want = _f32(jout.logits)[r, :first[r]]
        np.testing.assert_allclose(
            _f32(out.logits)[r, :first[r]], want, rtol=0,
            atol=BF16_REL * np.abs(_f32(jout.logits)).max())


@pytest.mark.parametrize("dtype,qname", [("float32", "none"),
                                         ("float32", "lns8"),
                                         ("bfloat16", "lns8")])
@pytest.mark.parametrize("arch", MOE)
def test_lm_loss_matches_jax(arch, dtype, qname):
    """Cross entropy + 0.01 aux (+ 0.3 MTP for deepseek: one dense MLA
    block over the hidden state and the next token's embedding, the
    shared head, labels shifted once more) against JAX's ``lm_loss``;
    without ``params["mtp"]`` the MTP term is absent in both."""
    from repro.training.data import SyntheticLM as JSyntheticLM
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _packed_perturbed(jcfg)
    b = JSyntheticLM(jcfg, batch=2, seq=16).batch_at(0)
    jq, tq = ((None, None) if qname == "none"
              else (JQuantConfig.lns_madam(), QuantConfig.lns_madam()))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    rtol = {"none": 1e-5, "lns8": 1e-3}[qname] if dtype == "float32" \
        else 2e-2
    for drop_mtp in (False, True):
        jpp = {k: v for k, v in jp.items() if not (drop_mtp and k == "mtp")}
        tpp = {k: v for k, v in tp.items() if not (drop_mtp and k == "mtp")}
        with jd.configured(backend="reference"):
            want = float(jax.jit(lambda p, bb: jm.lm_loss(
                p, bb, jcfg, jq, remat=False))(
                jpp, {k: jnp.asarray(v) for k, v in b.items()}))
        got = float(tm.lm_loss(tpp, tb, tcfg, tq))
        np.testing.assert_allclose(got, want, rtol=rtol)
    if jcfg.mtp_depth:
        assert "mtp" in tp
        with_mtp = float(tm.lm_loss(tp, tb, tcfg, tq))
        without = float(tm.lm_loss({k: v for k, v in tp.items()
                                    if k != "mtp"}, tb, tcfg, tq))
        assert with_mtp > without


@pytest.mark.parametrize("arch", MOE)
def test_decode_equals_forward(arch):
    """12 tokens appended 1, 3 and 12 at a time through the caches
    (deepseek: the MLA latent cache, also under ``page_size``, which it
    ignores; kimi: dense and paged KV) equal the training forward, at a
    capacity factor of E / K (C = T: nothing drops); JAX's decode_step
    gives the same last logits."""
    jcfg, tcfg = _cfgs(arch)
    cf = jcfg.num_experts / jcfg.experts_per_token
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _packed_perturbed(jcfg)
    tokens = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    tt = torch.from_numpy(tokens)
    want = tm.forward(tp, tt, tcfg, None).float().numpy()
    for page in (None, 4):
        for chunk in (1, 3, 12):
            caches = tm.init_caches(2, 16, tcfg, page_size=page,
                                    device="cpu")
            mla = "c_kv" in caches["prefix"][0]
            assert mla == tcfg.use_mla
            bt = (torch.arange(8, dtype=torch.int32).reshape(2, 4)
                  if page and not mla else None)
            got = [tm.forward(tp, tt[:, t:t + chunk], tcfg, None,
                              caches=caches, pos_offset=t, block_tables=bt)
                   for t in range(0, 12, chunk)]
            np.testing.assert_allclose(torch.cat(got, 1).float().numpy(),
                                       want, rtol=0, atol=2e-4)
    jlast, _ = jax.jit(lambda p, c, t: jm.decode_step(
        p, c, t, jcfg, None, pos_offset=0))(
        jp, jm.init_caches(2, 16, jcfg), jnp.asarray(tokens))
    np.testing.assert_allclose(want[:, -1], np.asarray(jlast), rtol=0,
                               atol=2e-4)
