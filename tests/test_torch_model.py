"""The port's smollm smoke model against the JAX package's, on the same
packed weights (JAX ``init_train_state`` params carried across with
``repro_torch.convert``): one batch prefill plus greedy decode steps, on
the dense and on the paged cache, each holding the compute dtype or
packed 8-bit LNS words (``kv_cache_bits=8``). Both sides are driven with the JAX
side's greedy tokens, so they see the same inputs at every step.

Tolerance on the f32 logits (O(1) here): 1e-5 absolute when no
activation code flipped. A flip is a Q_log code that rounds the other way
because f32 log2 differs by an ULP between the frameworks (hazard H1);
one flip moves one activation by 2^(1/8)-1 = 9%, so with flips the bound
widens to 5e-3 of the largest logit. The flips are counted by encoding
every routed GEMM input the port saw with the JAX reference too. Greedy
tokens must agree wherever the JAX top-2 margin exceeds the tolerance.
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
from repro.kernels import dispatch as jd  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim.madam import MadamConfig  # noqa: E402
from repro.training import init_train_state  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.core.lns import LNSFormat  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

DECODE_STEPS = 3


def jax_smoke():
    """The JAX smollm smoke config and its packed 8-bit serving params
    (``init_train_state`` under jit: the same params as eager, 5x faster
    to build)."""
    cfg = j_smoke_config("smollm-135m")
    mcfg = MadamConfig(update_format=JFormat(bits=8, gamma=8))
    params = jax.jit(lambda k: init_train_state(k, cfg, mcfg).params)(
        jax.random.PRNGKey(0))
    return cfg, JQuantConfig.lns_madam(), mcfg, params


@pytest.fixture(scope="module")
def smoke():
    return jax_smoke()


def flat_params(params):
    """JAX params -> ``::``-keyed numpy leaves (the checkpoint layout)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "::".join(str(getattr(k, "key", getattr(k, "idx",
                                                      getattr(k, "name", k))))
                        for k in path)
        out[key] = np.array(leaf)
    return out


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kv_bits", [None, 8])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_logits_and_greedy_tokens_match(smoke, layout, kv_bits,
                                        monkeypatch):
    cfg, qcfg, _, params = smoke
    cfg = dataclasses.replace(cfg, kv_cache_bits=kv_bits)
    tcfg = dataclasses.replace(get_smoke_config("smollm-135m"),
                               kv_cache_bits=kv_bits)
    tq = QuantConfig.lns_madam()
    tp = params_from_flat(flat_params(params), LNSFormat(8, 8), device="cpu")

    seen = []
    real = dispatch.encode_pack

    def recording(x, fmt, scale_axis=None):
        out = real(x, fmt, scale_axis)
        seen.append((x.numpy().copy(), out[0].numpy().copy()))
        return out

    monkeypatch.setattr(dispatch, "encode_pack", recording)

    B, S, max_len = 2, 8, 16
    paged = dict(page_size=4) if layout == "paged" else {}
    bt = np.arange(B * 4, dtype=np.int32).reshape(B, 4)[:, ::-1].copy() \
        if paged else None
    jbt = None if bt is None else jnp.asarray(bt)
    tbt = None if bt is None else torch.from_numpy(bt)
    jc = jm.init_caches(B, max_len, cfg, **paged)
    tc = tm.init_caches(B, max_len, tcfg, device="cpu", **paged)

    @jax.jit
    def jstep(jc, tokens, pos):
        with jd.configured(backend="reference"):
            out = jm.forward(params, tokens, cfg, qcfg, caches=jc,
                             pos_offset=pos, block_tables=jbt)
        return out.logits[:, -1], out.caches

    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.zeros((B,), np.int32)
    steps = []
    for _ in range(1 + DECODE_STEPS):
        jl, jc = jstep(jc, jnp.asarray(tokens), jnp.asarray(pos))
        tl = tm.forward(tp, torch.from_numpy(tokens), tcfg, tq, caches=tc,
                        pos_offset=torch.from_numpy(pos),
                        block_tables=tbt)[:, -1]
        jl = np.asarray(jl)
        steps.append((jl, tl.numpy()))
        pos = pos + tokens.shape[1]
        tokens = np.argmax(jl, axis=-1).astype(np.int32)[:, None]

    flips = 0
    with jd.configured(backend="reference"):
        for x, words in seen:
            jw = np.asarray(jd.encode_pack(jnp.asarray(x), JFormat(8, 8))[0])
            flips += int(np.sum(jw != words))
    print(f"{layout} kv_bits={kv_bits}: {len(seen)} routed GEMM inputs, activation code "
          f"flips vs JAX: {flips}")
    top = max(np.abs(jl).max() for jl, _ in steps)
    tol = 1e-5 if flips == 0 else 5e-3 * top
    for jl, tl in steps:
        np.testing.assert_allclose(tl, jl, rtol=0, atol=tol)
        srt = np.sort(jl, axis=-1)
        clear = (srt[:, -1] - srt[:, -2]) > tol
        np.testing.assert_array_equal(np.argmax(tl, -1)[clear],
                                      np.argmax(jl, -1)[clear])
