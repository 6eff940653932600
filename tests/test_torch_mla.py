"""The port's multi-head latent attention (``repro_torch.models.attention``:
``mla_apply``, ``init_mla_cache``, the absorbed decode) and
``flash_attention`` with a v narrower than q and k, against the JAX
package's on the CPU, on JAX parameters carried across by
``convert.params_from_flat`` and inputs drawn from numpy seeds.

Tolerances:
* The training path (``kv_up`` expanded, flash attention over qk width
  nope + rope and v width ``v_head_dim``) against JAX's: 2e-5 absolute
  at f32 (the projections' and softmax's ULPs); at bf16 2^-4 of max
  |out|, as ``test_torch_recurrent.py``.
* The absorbed decode (prefill and single steps, f32 einsums) against
  JAX's ``_mla_decode``: 2e-5 absolute at f32, 2^-4 of max |out| at
  bf16; the latent cache's contents equal JAX's (compute dtype) within
  the same bounds, its cursors exactly.
* Decode continuing the training forward: 2e-4, the JAX package's own
  bound in ``test_mla_absorbed_decode_matches_train`` (the absorbed
  order of products against the expanded one, f32).
* ``flash_attention`` with v width 16 against qk width 24, blocks of 4
  over 12 positions: 2e-6 absolute (f32).
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
from repro.models import attention as jattn  # noqa: E402
from repro.optim.madam import MadamConfig as JMadamConfig  # noqa: E402
from repro.optim.madam import init_lns_params as j_init_lns  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.core.lns import LNSFormat  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

from test_torch_model import flat_params  # noqa: E402

DTYPES = ["float32", "bfloat16"]
BF16_REL = 2.0 ** -4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32"):
    arch = "deepseek-v3-671b"
    return (dataclasses.replace(j_smoke_config(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


def _params(jcfg, packed, seed=4):
    """``mla_init``'s leaves with the zero norm gains perturbed, dense or
    encoded by JAX's Madam into 8-bit words; JAX's and the port's."""
    p = jattn.mla_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    p = {k: v if np.any(np.asarray(v)) else jnp.asarray(
        0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        for k, v in p.items()}
    if packed:
        p = j_init_lns(p, JMadamConfig(update_format=JFormat(bits=8,
                                                             gamma=8)))
    return p, params_from_flat(flat_params(p), LNSFormat(8, 8), device="cpu")


def _close(got, want, dtype, f32_atol=2e-5):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    atol = f32_atol if dtype == "float32" else BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().detach().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _x(jcfg, tcfg, B=2, S=10, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return (jnp.asarray(x).astype(jcfg.compute_dtype),
            torch.from_numpy(x).to(tcfg.compute_dtype))


@pytest.mark.parametrize("qname", ["none", "lns8"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_training_path_matches_jax(dtype, qname):
    """No cache: the latent expanded by ``kv_up``, every head's key the
    nope part beside the one rope key, flash attention (scale
    1/sqrt(nope + rope)), ``wo``; on JAX's 8-bit packed weights (every
    2-D projection routed under ``lns_madam``)."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, True)
    jq, tq = ((None, None) if qname == "none"
              else (JQuantConfig.lns_madam(), QuantConfig.lns_madam()))
    jx, tx = _x(jcfg, tcfg)
    pos = np.arange(10, dtype=np.int32)
    jout, jc = jax.jit(lambda p, x: jattn.mla_apply(
        p, x, jcfg, jq, positions=jnp.asarray(pos)))(jp, jx)
    assert jc is None
    tout = attn.mla_apply(tp, tx, tcfg, tq, positions=torch.from_numpy(pos))
    assert tout.dtype == tcfg.compute_dtype and tout.shape == tx.shape
    _close(_f32(tout), _f32(jout), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_absorbed_decode_matches_jax(dtype):
    """A 6-token prefill into an empty latent cache, then 4 single steps
    at per-row cursors (row 1 starts 2 positions later), through both
    packages' absorbed forms: each call's output, and at the end the
    cache's latents, rope keys and cursors."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, True)
    B, cap = 2, 16
    jx, tx = _x(jcfg, tcfg, S=10, seed=2)
    jc = jattn.init_mla_cache(B, cap, jcfg)
    jc["idx"] = jnp.asarray([0, 2], jnp.int32)
    tc = attn.init_mla_cache(B, cap, tcfg, "cpu")
    tc["idx"][:] = torch.tensor([0, 2], dtype=torch.int32)
    step = jax.jit(lambda p, x, c, pos: jattn.mla_apply(
        p, x, jcfg, None, positions=pos, cache=c))
    for start, n in ((0, 6), (6, 1), (7, 1), (8, 1), (9, 1)):
        pos = np.asarray([0, 2], np.int32)[:, None] + start + np.arange(n)
        jout, jc = step(jp, jx[:, start:start + n], jc, jnp.asarray(pos))
        tout = attn.mla_apply(tp, tx[:, start:start + n], tcfg, None,
                              positions=torch.from_numpy(pos), cache=tc)
        _close(_f32(tout), _f32(jout), dtype)
    np.testing.assert_array_equal(tc["idx"].numpy(), np.asarray(jc["idx"]))
    assert tc["idx"].tolist() == [10, 12]
    for key in ("c_kv", "k_rope"):
        assert tc[key].dtype == tcfg.compute_dtype
        _close(_f32(tc[key]), _f32(jc[key]), dtype)


@pytest.mark.parametrize("chunk", [1, 4])
def test_decode_continues_the_training_forward(chunk):
    """JAX's ``test_mla_absorbed_decode_matches_train`` in the port: 12
    positions appended ``chunk`` at a time through the absorbed form
    equal the training path's outputs (JAX's config: d 48, 3 heads, q
    rank 24, kv rank 16, nope 16, rope 8, v 16)."""
    kw = dict(name="t", family="dense", num_layers=1, d_model=48,
              num_heads=3, num_kv_heads=3, head_dim=16, d_ff=64,
              vocab_size=64, use_mla=True, q_lora_rank=24, kv_lora_rank=16,
              qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, dtype="float32")
    from repro.models import ArchConfig as JArchConfig
    from repro_torch.models.common import ArchConfig
    jcfg, tcfg = JArchConfig(**kw), ArchConfig(**kw)
    _, tp = _params(jcfg, False, seed=0)
    S = 12
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, S, 48)).astype(np.float32))
    pos = torch.arange(S, dtype=torch.int32)
    full = attn.mla_apply(tp, x, tcfg, None, positions=pos)
    cache = attn.init_mla_cache(2, S, tcfg, "cpu")
    outs = [attn.mla_apply(tp, x[:, t:t + chunk], tcfg, None,
                           positions=pos[t:t + chunk], cache=cache)
            for t in range(0, S, chunk)]
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_flash_attention_v_narrower_than_qk():
    """q and k of width 24 (nope 16 + rope 8), v of width 16: the port's
    flash attention (scale 1/sqrt(24), its default) against JAX's with
    that scale given, over three blocks of 4."""
    rng = np.random.default_rng(9)
    q, k = (rng.standard_normal((2, 12, 3, 24)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), scale=1.0 / np.sqrt(24),
                                 block_k=4)
    got = attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), block_k=4)
    assert got.shape == (2, 12, 3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


def test_mla_cache_layout_and_clamped_insert():
    """``init_mla_cache``: latents and rope keys in the compute dtype, one
    cursor a row; an append past the buffer's end lands clamped (as a
    dynamic slice update clamps), as JAX's does."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _params(jcfg, False)
    tc = attn.init_mla_cache(2, 4, tcfg, "cpu")
    assert tc["c_kv"].shape == (2, 4, tcfg.kv_lora_rank)
    assert tc["k_rope"].shape == (2, 4, tcfg.qk_rope_dim)
    assert tc["c_kv"].dtype == torch.bfloat16 and tc["idx"].dtype == \
        torch.int32
    jc = jattn.init_mla_cache(2, 4, jcfg)
    tc["idx"][:] = torch.tensor([3, 1], dtype=torch.int32)
    jc["idx"] = jnp.asarray([3, 1], jnp.int32)
    jx, tx = _x(jcfg, tcfg, S=2, seed=5)
    pos = np.asarray([[3, 4], [1, 2]], np.int32)
    _, jc = jattn.mla_apply(jp, jx, jcfg, None, positions=jnp.asarray(pos),
                            cache=jc)
    attn.mla_apply(tp, tx, tcfg, None, positions=torch.from_numpy(pos),
                   cache=tc)
    _close(_f32(tc["c_kv"]), _f32(jc["c_kv"]), "bfloat16")
    assert tc["idx"].tolist() == [5, 3] == np.asarray(jc["idx"]).tolist()
