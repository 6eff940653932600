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


# ---------------------------------------------------------------------------
# the paper's model shapes: an ungated GELU MLP and an untied LM head

def _narrow_bert(base):
    """BERT-base's wiring (ungated GELU MLP, untied head, MHA) at 2
    layers and d 64, f32; vocab 1026 keeps the head's N ragged (2·513) as
    BERT's 30522 is (2·15261)."""
    return dataclasses.replace(base, name="bert_narrow", num_layers=2,
                               d_model=64, num_heads=4, num_kv_heads=4,
                               head_dim=16, d_ff=256, vocab_size=1026,
                               dtype="float32")


PAPER = ["BERT_BASE", "BERT_LARGE", "TINY_LM"]


@pytest.mark.parametrize("name", PAPER)
def test_paper_models_match_jax(name):
    """Field for field as JAX's, and every JAX field the port does not
    carry sits at JAX's default, so both packages build the same model."""
    from repro.configs import paper_models as jpm
    from repro.models.common import ArchConfig as JArchConfig
    from repro_torch.configs import paper_models as tpm
    j, t = getattr(jpm, name), getattr(tpm, name)
    tf = {f.name for f in dataclasses.fields(t)}
    for f in dataclasses.fields(JArchConfig):
        if f.name in tf:
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        else:
            assert getattr(j, f.name) == f.default, f.name


def test_smollm_configs_stay_tied():
    from repro.configs import get_config as j_config
    from repro_torch.configs import get_config
    for t, j in ((get_config("smollm-135m"), j_config("smollm-135m")),
                 (get_smoke_config("smollm-135m"),
                  j_smoke_config("smollm-135m"))):
        assert t.tie_embeddings and j.tie_embeddings
        assert t.mlp_gated and t.act_fn == "silu"


def _paper_cfgs(name):
    from repro.configs import paper_models as jpm
    from repro_torch.configs import paper_models as tpm
    if name == "bert_narrow":
        return _narrow_bert(jpm.BERT_BASE), _narrow_bert(tpm.BERT_BASE)
    return jpm.TINY_LM, tpm.TINY_LM


def test_untied_ungated_params_layout():
    """No ``gate`` in an ungated MLP; ``embed.head (d, V)`` when untied,
    drawn after every other leaf, so tied configs keep their draws."""
    _, cfg = _paper_cfgs("bert_narrow")
    p = tm.init_params(cfg, seed=0, device="cpu")
    assert set(p["period"]["pos0"]["mlp"]) == {"up", "down"}
    assert tuple(p["embed"]["head"].shape) == (64, 1026)
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    q = tm.init_params(tied, seed=0, device="cpu")
    assert "head" not in q["embed"]
    assert torch.equal(p["embed"]["tok"], q["embed"]["tok"])
    assert tm.lm_head(p, cfg) is p["embed"]["head"]


@pytest.mark.parametrize("name", ["bert_narrow", "tiny_lm"])
def test_paper_model_logits_match_jax(name, monkeypatch):
    """The forward of the narrowed BERT (its untied head a routed K1+K2
    GEMM at a ragged N) and of ``TINY_LM`` on the same packed 8-bit
    weights, under the tolerance rule of this file's docstring."""
    jcfg, tcfg = _paper_cfgs(name)
    mcfg = MadamConfig(update_format=JFormat(bits=8, gamma=8))
    params = jax.jit(lambda k: init_train_state(k, jcfg, mcfg).params)(
        jax.random.PRNGKey(0))
    tp = params_from_flat(flat_params(params), LNSFormat(8, 8), device="cpu")
    routed = []
    real = dispatch.qmatmul
    monkeypatch.setattr(dispatch, "qmatmul", lambda *a, **k: (
        routed.append(tuple(a[1].shape)), real(*a, **k))[1])
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    with jd.configured(backend="reference"):
        jl = np.asarray(jax.jit(lambda t: jm.forward(
            params, t, jcfg, JQuantConfig.lns_madam()).logits)(
                jnp.asarray(tokens)))
    tl = tm.forward(tp, torch.from_numpy(tokens), tcfg,
                    QuantConfig.lns_madam()).numpy()
    head_routed = (tcfg.d_model, tcfg.vocab_size) in routed
    assert head_routed == (not tcfg.tie_embeddings)
    assert len(routed) == tcfg.num_layers * (6 + tcfg.mlp_gated) + head_routed
    top = float(np.abs(jl).max())
    ok_exact = np.abs(tl - jl).max() <= 1e-5
    assert ok_exact or np.abs(tl - jl).max() <= 5e-3 * top


@pytest.mark.parametrize("name", ["bert_narrow", "tiny_lm"])
def test_paper_model_lns8_train_step_matches_jax(name):
    """One lns8 train step from one JAX train state carried across: the
    grad norm within 10% and at most 2% of the words differing after the
    update, as ``test_torch_train.py`` holds the smollm smoke config. The
    loss is the forward alone: within 5e-5, as a per-tensor Q_A code that
    log2 rounds the other way (H1) moves an activation by 2^(1/8)
    (measured: 1.0e-5 on TINY_LM, none on the narrowed BERT)."""
    from repro.training import build_train_step as j_build
    from repro.training.data import SyntheticLM as JSyntheticLM
    from repro_torch.checkpoint.manager import flatten_state
    from repro_torch.convert import train_state_from_flat
    from repro_torch.optim.madam import MadamConfig as TMadamConfig
    from repro_torch.training.steps import build_train_step
    jcfg, tcfg = _paper_cfgs(name)
    jmcfg = MadamConfig()
    js = jax.jit(lambda k: init_train_state(k, jcfg, jmcfg))(
        jax.random.PRNGKey(0))
    ts = train_state_from_flat(flat_params(js), TMadamConfig(), device="cpu")
    b = JSyntheticLM(jcfg, batch=2, seq=16).batch_at(0)
    with jd.configured(backend="reference"):
        jstep = jax.jit(j_build(jcfg, JQuantConfig.lns_madam(), jmcfg))
    js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, tmet = build_train_step(tcfg, QuantConfig.lns_madam(),
                                TMadamConfig())(ts, b)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=5e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=0.1)
    jf, tf = flat_params(js.params), flatten_state(ts.params)
    n = tot = 0
    for k in jf:
        if k.endswith("packed"):
            n += int(np.sum(jf[k].astype(np.int64) != tf[k].astype(np.int64)))
            tot += jf[k].size
    assert ("embed::head::packed" in jf) == (not tcfg.tie_embeddings)
    assert n <= 0.02 * tot, (n, tot)


def test_engine_refuses_an_untied_head():
    """The engine no longer refuses an untied head: it serves the
    narrowed BERT, whose packed ``embed.head`` stays the engine's head
    (routed through K1+K2 every step). It still refuses ``mesh=``, and
    attaches an ``observer=``, which sees the run. Serving parity with JAX on an untied config is in
    ``test_torch_serving_hooks.py``."""
    from repro_torch.optim.madam import MadamConfig as TMadamConfig
    from repro_torch.optim.madam import init_lns_params
    from repro_torch.serving import Engine, Request
    _, cfg = _paper_cfgs("bert_narrow")
    params = init_lns_params(tm.init_params(cfg, seed=0, device="cpu"),
                             TMadamConfig(update_format=LNSFormat(8, 8)))
    eng = Engine(cfg, QuantConfig.lns_madam(), params, num_slots=2,
                 max_len=16, page_size=4, device="cpu")
    assert eng._head is eng.params["embed"]["head"]
    eng.run([Request(rid=i, prompt=[3 + i, 7, 9], max_new_tokens=3)
             for i in range(2)])
    assert sorted(len(rs.generated) for rs in eng.finished) == [3, 3]
    with pytest.raises(NotImplementedError):
        Engine(cfg, QuantConfig.lns_madam(), params, device="cpu",
               mesh=object())
    from repro_torch.obs import EngineObserver
    obs = EngineObserver()
    eng = Engine(cfg, QuantConfig.lns_madam(), params, num_slots=2,
                 max_len=16, page_size=4, device="cpu", observer=obs)
    assert eng.observer is obs
    eng.run([Request(rid=0, prompt=[3, 7, 9], max_new_tokens=3)])
    assert obs.summary()["prefill_steps"] == 1
