"""The recurrent families of the port (rwkv6-1.6b's RWKV6 blocks,
zamba2-7b's Mamba2 trunk with its shared attention block and LoRA)
against the JAX package at each config's ``SMOKE`` shape, on the CPU,
with JAX parameters carried across by ``convert.params_from_flat`` and
inputs drawn from numpy seeds. The engine's side is in
``test_torch_recurrent_serving.py``.

Tolerances:
* Configs, ``params_count()`` (JAX's count and the drawn tree's), the
  carried leaves, the LNS leaf counts, the packed codes of the port's
  encoder: equal.
* The chunked WKV/SSD scans against JAX's and against a sequential scan
  at JAX's ``(S, Q)`` cases: 2e-4 (WKV) and 1e-4 (SSD), JAX's own test
  tolerances (f32; the chunked form's exp products against one step at
  a time).
* Forward logits with no quantizer (``qcfg=None``) on JAX's 16-bit
  packed tree of perturbed weights (every zero leaf replaced by small
  random values): 2e-5 absolute at f32 (ULPs of exp, rsqrt and sum
  orders, as ``test_torch_dense_variants.py``); at bf16 2^-4 of max
  |logit|: bf16 keeps 8 significant bits and the two frameworks round
  the same ops of a GEMM or a reduction in another order (one RWKV or
  Mamba block: within one bf16 ulp of its largest output; 3 layers of
  logits: 4.5 ulps measured).
* ``decode`` (the sequential form a position at a time through a dense
  or paged cache) against the training forward (the chunked form):
  2e-5 absolute at f32, 2^-4 of max |logit| at bf16.
* One train step from JAX's state: at step 1 Madam moves each 16-bit
  word by sign(g)·lr·γ = 16 codes (g/sqrt(v̂) = sign(g)). Under
  ``full_precision`` at f32 the loss and grad norm within 1e-5 relative,
  and a word differs from JAX's only by one code (a rounding tie, H6) or
  by 32 (a gradient whose sign the frameworks' rounding decides), at
  most 1e-4 of them (1 of 226,816 measured); under ``lns8`` loss within
  1e-3 relative and grad
  norm 10% (``test_torch_train.py``'s rule), at most 5% of the words
  apart at f32 and 15% at bf16 (measured 0.5–2.3% and 4.8–11.0%: a Q_A
  code flips where an ulp of log2 sits on a rounding tie, H1, and every
  gradient near zero downstream may change sign).
* H16: the port's encoder gives an all-zero leaf the scale 2^-126 and
  the largest code where JAX on XLA-CPU gives what its ``exp2(-126)``
  gives in that program (0 and code 0, or 1.1754907e-38 inside the
  jitted train-state init; H12's cause); the 8-bit codes of every other
  leaf are equal, and every decoded value within 1e-37.
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
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
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
from repro_torch.models import rwkv  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.optim.madam import MadamConfig, init_lns_params  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

from test_torch_dense_variants import _perturbed_dense, _unflat  # noqa: E402
from test_torch_model import flat_params  # noqa: E402

RECURRENT = ["rwkv6-1.6b", "zamba2-7b"]
DTYPES = ["float32", "bfloat16"]
FULL_COUNTS = {"rwkv6-1.6b": 1_583_941_632, "zamba2-7b": 5_761_357_120}
LNS_LEAVES = {"rwkv6-1.6b": 15, "zamba2-7b": 83}
BF16_REL = 2.0 ** -4
# packed words of one train step that may differ from JAX's (see the
# module docstring): f32 full precision, f32 lns8, bf16 lns8
WORD_SHARE = {"exact": 1e-4, "float32": 0.05, "bfloat16": 0.15}
FMT8 = LNSFormat(8, 8)
MCFG8 = MadamConfig(update_format=FMT8)
JMCFG8 = JMadamConfig(update_format=JFormat(bits=8, gamma=8))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(j_smoke_config(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


def _close(got, want, dtype):
    """2e-5 absolute at f32; 2^-4 of max |want| at bf16."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    atol = 2e-5 if dtype == "float32" else BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# configs, counts, conversion


@pytest.mark.parametrize("arch", RECURRENT)
def test_configs_and_params_count_match_jax(arch):
    """Field for field as JAX's (a JAX field the port does not carry sits
    at JAX's default), the same layer pattern and parameter count at full
    width and at the smoke shape, the count the port's drawn tree's
    too."""
    assert arch in ARCHS
    tf = {f.name for f in dataclasses.fields(get_config(arch))}
    for t, j in ((get_config(arch), j_config(arch)),
                 (get_smoke_config(arch), j_smoke_config(arch))):
        for f in dataclasses.fields(JArchConfig):
            if f.name in tf:
                assert getattr(t, f.name) == getattr(j, f.name), f.name
            else:
                assert getattr(j, f.name) == f.default, f.name
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


@pytest.mark.parametrize("arch", RECURRENT)
def test_lns_leaf_counts_at_full_structure(arch):
    """Madam encodes 15 (rwkv6) and 83 (zamba2: 3 prefix mamba layers, 5
    stacked positions, the shared block, the occurrences' LoRA) leaves of
    the full config's tree, in both packages (the port's tree at the full
    layer pattern and narrow widths; JAX's by ``eval_shape`` at full
    width)."""
    full = get_config(arch)
    narrow = dataclasses.replace(
        full, d_model=64, d_ff=96, vocab_size=64, num_heads=4,
        num_kv_heads=4, head_dim=16, ssm_head_dim=16,
        ssm_state_dim=min(full.ssm_state_dim, 16),
        shared_block_lora_rank=min(full.shared_block_lora_rank, 8))
    tree = init_lns_params(tm.init_params(narrow, seed=0, device="cpu"),
                           MadamConfig())
    n = sum(is_lns_weight(x) for _, x in leaves(tree))
    jstate = jax.eval_shape(lambda: j_init_train_state(
        jax.random.PRNGKey(0), j_config(arch), JMadamConfig()))
    jn = sum(1 for x in jax.tree.leaves(
        jstate.params, is_leaf=lambda x: hasattr(x, "packed")) if
        hasattr(x, "packed"))
    assert n == jn == LNS_LEAVES[arch]


@pytest.mark.parametrize("arch", RECURRENT)
def test_convert_carries_every_leaf(arch):
    """JAX's dense tree (the top-level ``shared`` subtree and a prefix
    list included) and its packed 8-bit serving tree carried across: the
    same leaves, shapes and values; zamba2's zero ``lora_b`` arrives with
    JAX's scale (H16: not 2^-126)."""
    jcfg = j_smoke_config(arch)
    flat = _perturbed_dense(jcfg, seed=11)
    back = flatten_state(params_from_flat(flat, LNSFormat(8, 8),
                                          device="cpu"))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    jmcfg = JMadamConfig(update_format=JFormat(bits=8, gamma=8))
    packed = flat_params(jax.jit(lambda k: j_init_train_state(
        k, jcfg, jmcfg).params)(jax.random.PRNGKey(0)))
    tp = params_from_flat(packed, LNSFormat(8, 8), device="cpu")
    back = flatten_state(tp)
    assert sorted(back) == sorted(packed)
    for k in packed:
        np.testing.assert_array_equal(back[k].astype(np.float64),
                                      packed[k].astype(np.float64),
                                      err_msg=k)
    if arch == "zamba2-7b":
        assert "shared::attn::wq::packed" in packed
        scale = packed["period::pos2::lora_b::scale"]
        assert np.all(scale < 2.0 ** -125) and np.all(scale != 2.0 ** -126)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", RECURRENT)
def test_h16_zero_leaves_codes_equal(arch, dtype):
    """H16: JAX's and the port's encoders on the same dense tree give the
    same 8-bit codes for every leaf but the all-zero ones (rwkv6's
    ``w_lora_b`` and ``ln_x``, zamba2's ``lora_b``). Those get 2^-126 and
    the largest code in the port; in JAX what XLA-CPU's ``exp2(-126)``
    gives in that program (0 here, whose 0/0 encodes as code 0;
    1.1754907e-38 inside the jitted train-state init). Every leaf decodes
    within 1e-37 of JAX's."""
    jcfg, _ = _cfgs(arch, dtype)
    jparams = jax.jit(lambda k: jm.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    dense = params_from_flat(flat_params(jparams), FMT8, device="cpu")
    mine = flatten_state(init_lns_params(dense, MCFG8))
    theirs = flat_params(jax.jit(lambda p: j_init_lns(p, JMCFG8))(jparams))
    assert sorted(mine) == sorted(theirs)
    dense_flat = flat_params(jparams)
    zero = [k[:-len("::scale")] for k in theirs if k.endswith("::scale")
            and not np.any(dense_flat[k[:-len("::scale")]])]
    names = {"rwkv6-1.6b": {"w_lora_b", "ln_x"}, "zamba2-7b": {"lora_b"}}
    assert {k.split("::")[-1] for k in zero} == names[arch]
    for k in theirs:
        if k.endswith("::packed") and k[:-len("::packed")] not in zero:
            np.testing.assert_array_equal(mine[k].astype(np.int64),
                                          theirs[k].astype(np.int64),
                                          err_msg=k)
    for k in zero:   # the port: 0 / 2^-126 -> the largest code
        assert np.all(mine[k + "::scale"] == np.float32(2.0 ** -126))
        assert np.all(mine[k + "::packed"] == FMT8.max_code)
        assert np.all(theirs[k + "::scale"] != np.float32(2.0 ** -126))
    tparams = params_from_flat(theirs, FMT8, device="cpu")
    ours = init_lns_params(dense, MCFG8)
    for (path, a), (_, b) in zip(leaves(ours), leaves(tparams)):
        if is_lns_weight(a):
            np.testing.assert_allclose(a.decode().numpy(), b.decode().numpy(),
                                       rtol=0, atol=1e-37, err_msg=str(path))


# ---------------------------------------------------------------------------
# the chunked scans


def _wkv_sequential(r, k, v, logw, u):
    B, S, H, P = r.shape
    s = torch.zeros((B, H, P, P))
    ys = []
    for t in range(S):
        att = s + u[None, :, :, None] * k[:, t, :, :, None] \
            * v[:, t, :, None, :]
        ys.append(torch.einsum("bhp,bhpq->bhq", r[:, t], att))
        s = torch.exp(logw[:, t])[..., None] * s \
            + k[:, t, :, :, None] * v[:, t, :, None, :]
    return torch.stack(ys, dim=1), s


@pytest.mark.parametrize("S,Q", [(16, 4), (32, 8), (16, 16), (20, 8)])
def test_wkv_chunked_equals_sequential_and_jax(S, Q):
    """JAX's cases, and S = 20 over chunks of 8 (padded to 24)."""
    rng = np.random.default_rng(S * 100 + Q)
    B, H, P = 2, 2, 8
    r, k, v = (rng.standard_normal((B, S, H, P)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, S, H, P)) * 0.5).astype(
        np.float32)
    u = (rng.standard_normal((H, P)) * 0.1).astype(np.float32)
    t = [torch.from_numpy(a) for a in (r, k, v, logw, u)]
    y, s = rwkv._wkv_chunked(*t, Q)
    y_seq, s_seq = _wkv_sequential(*t)
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(s.numpy(), s_seq.numpy(), rtol=2e-4,
                               atol=2e-4)
    jy, js = jrwkv._wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw,
                                                           u)), Q)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2e-4,
                               atol=2e-4)


def _ssd_sequential(xs, dt, dA, Bv, Cv):
    B, S, H, P = xs.shape
    h = torch.zeros((B, H, P, Bv.shape[-1]))
    ys = []
    for t in range(S):
        h = torch.exp(dA[:, t])[:, :, None, None] * h + torch.einsum(
            "bhp,bn,bh->bhpn", xs[:, t], Bv[:, t], dt[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cv[:, t]))
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("S,Q", [(16, 4), (32, 8), (24, 24), (20, 8)])
def test_ssd_chunked_equals_sequential_and_jax(S, Q):
    """JAX's cases, and S = 20 over chunks of 8 (padded to 24)."""
    rng = np.random.default_rng(S * 100 + Q)
    B, H, P, N = 2, 3, 8, 4
    xs = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    dA = (-dt * np.exp(rng.standard_normal((H,)) * 0.2)).astype(np.float32)
    Bv, Cv = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    t = [torch.from_numpy(a) for a in (xs, dt, dA, Bv, Cv)]
    y, h = ssm._ssd_chunked(*t, Q)
    y_seq, h_seq = _ssd_sequential(*t)
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h.numpy(), h_seq.numpy(), rtol=1e-4,
                               atol=1e-4)
    jy, jh = jssm._ssd_chunked(*(jnp.asarray(a) for a in (xs, dt, dA, Bv,
                                                          Cv)), Q)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)


def test_softplus_is_jax_logaddexp():
    """``jax.nn.softplus`` within two ulps (the frameworks' exp and log1p
    differ by ULPs), with no threshold: past 20, where torch's
    ``F.softplus`` returns x, the same values as JAX's."""
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        [0.0, 1e-8, -1e-8, 20.0, 20.5, 88.0]]).astype(
        np.float32)
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(x))
    assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want)))
    big = x > 20
    np.testing.assert_array_equal(got[big], want[big])


# ---------------------------------------------------------------------------
# blocks: decode continuation, data-dependent decay


def _block_params(arch, jcfg, seed=3):
    """One block's JAX parameters with the zero leaves perturbed, encoded
    by JAX's Madam (16-bit store), and the port's copy."""
    init = jrwkv.rwkv_init if arch == "rwkv6-1.6b" else jssm.mamba_init
    p = init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    p = {k: v if np.any(np.asarray(v)) else jnp.asarray(
        0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        for k, v in p.items()}
    jp = j_init_lns(p, JMadamConfig())
    return jp, params_from_flat(flat_params(jp), MadamConfig().update_format,
                                device="cpu")


def _apply(arch, mod, p, x, cfg, state=None):
    if arch == "rwkv6-1.6b":
        out = mod.rwkv_apply(p, x, x * 0.5, cfg, None, state=state)
        if mod is jrwkv:
            (tm_out, cm_out), new = out
            return tm_out + cm_out, new
        return out[0] + out[1], state
    out = mod.mamba_apply(p, x, cfg, None, state=state)
    return out if mod is jssm else (out, state)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", RECURRENT)
def test_block_matches_jax_and_decode_continues(arch, dtype):
    """One block (a whole sequence chunked, and from a zero state
    sequentially) against JAX's on the same packed weights and input,
    then the sequence a position at a time from the state, which is
    updated in place: the outputs equal the chunked form's, the final
    state JAX's sequential one's."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _block_params(arch, jcfg)
    x = np.random.default_rng(1).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.compute_dtype)
    tx = torch.from_numpy(x).to(tcfg.compute_dtype)
    jmod, tmod = (jrwkv, rwkv) if arch == "rwkv6-1.6b" else (jssm, ssm)
    init_j = (jrwkv.init_rwkv_state if arch == "rwkv6-1.6b"
              else jssm.init_mamba_state)
    init_t = (rwkv.init_rwkv_state if arch == "rwkv6-1.6b"
              else ssm.init_mamba_state)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    j_full, _ = jax.jit(lambda p, x: _apply(arch, jmod, p, x, jcfg))(jp, jx)
    t_full, _ = _apply(arch, tmod, tp, tx, tcfg)
    _close(t_full.float().numpy(), f32(j_full), dtype)
    j_seq, j_state = jax.jit(lambda p, x: _apply(
        arch, jmod, p, x, jcfg, init_j(2, jcfg)))(jp, jx)
    state = init_t(2, tcfg, "cpu")
    steps = [_apply(arch, tmod, tp, tx[:, t:t + 1], tcfg, state)[0]
             for t in range(12)]
    _close(torch.cat(steps, 1).float().numpy(), f32(j_seq), dtype)
    _close(torch.cat(steps, 1).float().numpy(), t_full.float().numpy(),
           dtype)
    for k, v in state.items():      # f32 state from compute-dtype inputs
        want = f32(j_state[k])
        atol = 1e-5 if dtype == "float32" else BF16_REL * np.abs(want).max()
        np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=atol,
                                   err_msg=k)


def test_rwkv_decay_is_data_dependent():
    """Finch's feature: two inputs, two decays, two states."""
    cfg = get_smoke_config("rwkv6-1.6b")
    jp, tp = _block_params("rwkv6-1.6b", j_smoke_config("rwkv6-1.6b"))
    states = []
    for sign in (1.0, -1.0):
        x = torch.full((1, 4, cfg.d_model), sign)
        st = rwkv.init_rwkv_state(1, cfg, "cpu")
        rwkv.rwkv_apply(tp, x, x, cfg, None, state=st)
        states.append(st["S"])
    assert not torch.allclose(states[0], states[1])


# ---------------------------------------------------------------------------
# the model: logits, decode == forward, a train step


def _packed_perturbed(jcfg, seed=11):
    """JAX's parameters of ``jcfg`` with every zero leaf perturbed,
    encoded by JAX's Madam (16-bit store): JAX's tree and the port's."""
    flat = _perturbed_dense(jcfg, seed=seed)
    dense = _unflat(flat, jax.eval_shape(
        lambda: jm.init_params(jax.random.PRNGKey(0), jcfg)))
    jp = jax.jit(lambda p: j_init_lns(p, JMadamConfig()))(dense)
    return jp, params_from_flat(flat_params(jp), MadamConfig().update_format,
                                device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", RECURRENT)
def test_forward_logits_match_jax(arch, dtype):
    """The training forward (chunked scans; zamba2's shared block with
    each occurrence's LoRA) on the same packed weights and tokens."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _packed_perturbed(jcfg)
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jl = np.asarray(jax.jit(lambda p, t: jm.forward(p, t, jcfg, None).logits)(
        jp, jnp.asarray(tokens)).astype(jnp.float32))
    tl = tm.forward(tp, torch.from_numpy(tokens), tcfg, None)
    assert tl.dtype == tcfg.compute_dtype
    assert tl.shape == (2, 16, jcfg.vocab_size)
    _close(tl.float().numpy(), jl, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_equals_forward(arch, dtype):
    """12 tokens appended 1, 3 and 12 at a time (the sequential form)
    through a dense and a paged cache (zamba2's shared attention pages;
    rwkv6 has no pageable layer) equal the training forward (the chunked
    form); JAX's decode_step gives the same last logits."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _packed_perturbed(jcfg)
    tokens = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    tt = torch.from_numpy(tokens)
    want = tm.forward(tp, tt, tcfg, None).float().numpy()
    for page in (None, 4):
        for chunk in (1, 3, 12):
            caches = tm.init_caches(2, 16, tcfg, page_size=page,
                                    device="cpu")
            bt = (torch.arange(8, dtype=torch.int32).reshape(2, 4)
                  if page else None)
            got = [tm.forward(tp, tt[:, t:t + chunk], tcfg, None,
                              caches=caches, pos_offset=t, block_tables=bt)
                   for t in range(0, 12, chunk)]
            _close(torch.cat(got, 1).float().numpy(), want, dtype)
    jlast, _ = jax.jit(lambda p, c, t: jm.decode_step(
        p, c, t, jcfg, None, pos_offset=0))(
        jp, jm.init_caches(2, 16, jcfg), jnp.asarray(tokens))
    _close(want[:, -1], np.asarray(jlast.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype,qname", [("float32", "fp32"),
                                         ("float32", "lns8"),
                                         ("bfloat16", "lns8")])
@pytest.mark.parametrize("arch", RECURRENT)
def test_train_step_matches_jax(arch, dtype, qname):
    """One step from JAX's train state (the zero leaves carried with
    JAX's scale, H16): loss, grad norm and the new packed words; at f32
    under ``full_precision`` a word may differ only by one code in H6's
    tie band (1 of 226,816 measured for rwkv6)."""
    from repro.training import build_train_step as j_build
    from repro.training.data import SyntheticLM as JSyntheticLM
    from repro_torch.convert import train_state_from_flat
    from repro_torch.training.steps import build_train_step
    jq, tq = {"fp32": (JQuantConfig.full_precision(),
                       QuantConfig.full_precision()),
              "lns8": (JQuantConfig.lns_madam(),
                       QuantConfig.lns_madam())}[qname]
    jcfg, tcfg = _cfgs(arch, dtype)
    jmcfg = JMadamConfig()
    js = jax.jit(lambda k: j_init_train_state(k, jcfg, jmcfg))(
        jax.random.PRNGKey(0))
    ts = train_state_from_flat(flat_params(js), MadamConfig(), device="cpu")
    b = JSyntheticLM(jcfg, batch=2, seq=16).batch_at(0)
    with jd.configured(backend="reference"):
        jstep = jax.jit(j_build(jcfg, jq, jmcfg))
    js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, tmet = build_train_step(tcfg, tq, MadamConfig())(ts, b)
    exact = qname == "fp32" and dtype == "float32"
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5 if exact else 1e-3)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]),
                               rtol=1e-5 if exact else 0.1)
    jf, tf = flat_params(js.params), flatten_state(ts.params)
    assert set(jf) == set(tf)
    n = tot = 0
    for k in jf:
        if k.endswith("packed"):
            jw, tw = jf[k].astype(np.int64), tf[k].astype(np.int64)
            diff = jw != tw
            n += int(diff.sum())
            tot += jw.size
            if exact:
                # a rounding tie (one code), or at step 1, where Madam
                # moves a word by sign(g) lr gamma = 16 codes, a gradient
                # whose sign the frameworks' rounding decides (32 codes)
                assert set(np.abs(jw - tw)[diff].tolist()) <= {1, 32}, k
    assert n <= WORD_SHARE[dtype if not exact else "exact"] * tot, (n, tot)
