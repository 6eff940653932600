"""The port's engine on the recurrent families (rwkv6-1.6b,
zamba2-7b) against the JAX package's engine at each config's ``SMOKE``
shape, on the CPU, with JAX's packed 8-bit parameters carried across by
``convert.params_from_flat``. The modules' side is in
``test_torch_recurrent.py``.

Tolerances: token streams, prefill lengths, page counts and the
engines' refusals are compared exactly. At f32 the greedy streams equal
JAX's engine's. At bf16 the port's engine is held to the port's own
cache-free greedy decode of the same requests (``forward`` over the
whole sequence, the chunked form, argmax of each next position): the
engine's state rows, exact-length prefills and slot recycling must not
change a token; JAX's bf16 engine is compared too, and its streams may
part from the port's only where the two frameworks' bf16 logits tie
within their rounding (``test_torch_recurrent.py``: within 2^-4 of max
|logit|), which the test checks at the first token that parts.
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
from repro.optim.madam import MadamConfig as JMadamConfig  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.training import init_train_state as j_init_train_state  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.core.lns import LNSFormat  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

from test_torch_model import flat_params  # noqa: E402

RECURRENT = ["rwkv6-1.6b", "zamba2-7b"]
FMT8 = LNSFormat(8, 8)
JMCFG8 = JMadamConfig(update_format=JFormat(bits=8, gamma=8))
SPEC_REFUSAL = "recurrent layers cannot rewind rejected draft state"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def draws():
    """Each model's JAX draw at 8 bits, f32 and bf16, as JAX's tree and
    the port's."""
    out = {}
    for arch in RECURRENT:
        for dtype in ("float32", "bfloat16"):
            jcfg = dataclasses.replace(j_smoke_config(arch), dtype=dtype)
            jp = jax.jit(lambda k: j_init_train_state(k, jcfg, JMCFG8)
                         .params)(jax.random.PRNGKey(0))
            out[arch, dtype] = (jcfg, jp, params_from_flat(
                flat_params(jp), FMT8, device="cpu"))
    return out


def _trace(cfg, n=5, seed=3):
    """``n`` requests of two prompt lengths (5 and 9: JAX compiles a
    prefill a length) and 5-6 new tokens: more requests than slots, so
    slots recycle."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab_size, (5 + 4 * (i % 2),)).tolist(),
             6 - i % 2) for i in range(n)]


def _port(tcfg, tp, reqs, **kw):
    eng = Engine(tcfg, QuantConfig.lns_madam(), tp, device="cpu", **kw)
    eng.run([Request(rid=i, prompt=p, max_new_tokens=n) for i, p, n in reqs])
    return eng


def _jax(jcfg, jp, reqs, **kw):
    with jd.configured(backend="reference"):
        eng = JEngine(jcfg, JQuantConfig.lns_madam(), JMCFG8, jp, **kw)
        eng.run([JRequest(rid=i, prompt=p, max_new_tokens=n)
                 for i, p, n in reqs])
    return eng


def _streams(e):
    return {rs.request.rid: rs.generated for rs in e.finished}


def _greedy(tcfg, tp, prompt, n):
    """The port's cache-free greedy decode: the whole sequence through
    the training forward (chunked scans), one token at a time."""
    seq = list(prompt)
    for _ in range(n):
        with torch.no_grad():
            lg = tm.forward(tp, torch.tensor([seq]), tcfg,
                            QuantConfig.lns_madam())[0, -1]
        seq.append(int(torch.argmax(lg.float())))
    return seq[len(prompt):]


_KW = {"dense": dict(num_slots=2, max_len=32),
       "paged": dict(num_slots=2, max_len=32, page_size=4, num_pages=16)}


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_engine_streams_match_jax(arch, layout, draws):
    """5 requests over 2 slots (recycled), greedy, f32: the streams equal
    JAX's engine's; every prefill runs at the exact prompt length in
    both engines; zamba2's shared attention pages (and returns every
    page), rwkv6 stays dense under ``page_size``."""
    jcfg, jp, tp = draws[arch, "float32"]
    tcfg = get_smoke_config(arch)
    reqs = _trace(tcfg)
    eng = _port(tcfg, tp, reqs, **_KW[layout])
    jeng = _jax(jcfg, jp, reqs, **_KW[layout])
    assert len(_streams(eng)) == 5
    assert _streams(eng) == _streams(jeng)
    assert eng.prefill_tokens == jeng.prefill_tokens \
        == sum(len(p) for _, p, _ in reqs)
    assert eng.page_size == jeng.page_size
    if eng.page_size:
        assert eng.allocator.in_use == 0
        assert not eng._prefix_ok and not jeng._prefix_ok


@pytest.mark.parametrize("arch", RECURRENT)
def test_engine_bf16_streams_equal_greedy_decode(arch, draws):
    """At bf16 (paged): the engine's streams equal the port's cache-free
    greedy decode of each request; JAX's bf16 engine gives the same
    streams, or parts from them only where the port's own top-2 logits
    at that token lie within the frameworks' bf16 rounding."""
    jcfg, jp, tp = draws[arch, "bfloat16"]
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    reqs = _trace(tcfg, n=4)
    eng = _port(tcfg, tp, reqs, **_KW["paged"])
    got = _streams(eng)
    for i, p, n in reqs:
        assert got[i] == _greedy(tcfg, tp, p, n), i
    theirs = _streams(_jax(jcfg, jp, reqs, **_KW["paged"]))
    for i, p, n in reqs:
        a, b = got[i], theirs[i]
        if a == b:
            continue
        t = next(j for j in range(n) if a[j] != b[j])
        with torch.no_grad():
            lg = tm.forward(tp, torch.tensor([p + a[:t]]), tcfg,
                            QuantConfig.lns_madam())[0, -1].float()
        top2 = torch.topk(lg, 2).values
        assert float(top2[0] - top2[1]) <= 2.0 ** -4 * float(lg.abs().max())


def test_rwkv_page_size_keeps_the_dense_layout(draws):
    """The repaired fault: with ``page_size`` the JAX engine pages only
    where a layer kind can be paged, and rwkv6 has none, so it builds no
    allocator and no block tables and admits every request however few
    pages ``num_pages`` names. The port now does the same (it used to
    build an allocator and count pages it would never use)."""
    jcfg, jp, tp = draws["rwkv6-1.6b", "float32"]
    tcfg = get_smoke_config("rwkv6-1.6b")
    reqs = _trace(tcfg, n=3)
    kw = dict(num_slots=2, max_len=32, page_size=4, num_pages=2,
              alloc_policy="ondemand")
    eng = _port(tcfg, tp, reqs, **kw)
    jeng = _jax(jcfg, jp, reqs, **kw)
    for e in (eng, jeng):
        assert e.page_size is None and e.allocator is None
        assert e.alloc_policy is None and e.num_pages == 0
        assert len(e.finished) == 3 and e.preemptions == 0
    assert not any("kp" in c for c in eng.caches["period"].values())
    assert _streams(eng) == _streams(jeng)
    assert _streams(eng) == _streams(_port(tcfg, tp, reqs, num_slots=2,
                                           max_len=32))


def test_zamba2_preemption_reprefills_from_zero_state(draws):
    """zamba2 paged on demand over a pool too small for both slots'
    growth: the youngest request is preempted and re-prefilled (prompt +
    generated tokens, at the exact length) from a zero state; the
    streams and the prefilled tokens equal JAX's engine's under the same
    pressure. (They need not equal an unpressured run's: the re-prefill
    quantizes its activations with one per-tensor scale where decode
    steps had one each, H7, in both packages.)"""
    jcfg, jp, tp = draws["zamba2-7b", "float32"]
    tcfg = get_smoke_config("zamba2-7b")
    reqs = [(i, p, 10) for i, p, _ in _trace(tcfg, n=3, seed=8)]
    kw = dict(num_slots=2, max_len=32, page_size=4, num_pages=6,
              alloc_policy="ondemand")
    eng = _port(tcfg, tp, reqs, **kw)
    jeng = _jax(jcfg, jp, reqs, **kw)
    assert eng.preemptions == jeng.preemptions > 0
    assert _streams(eng) == _streams(jeng)
    assert eng.prefill_tokens == jeng.prefill_tokens \
        > sum(len(p) for _, p, _ in reqs)
    assert eng.allocator.in_use == 0


@pytest.mark.parametrize("arch", RECURRENT)
def test_exact_length_prefill_buckets(arch, draws):
    """Recurrent prefills never pad: ``_bucket`` is the prompt length in
    both engines, where a dense model takes the next bucket."""
    jcfg, jp, tp = draws[arch, "float32"]
    eng = Engine(get_smoke_config(arch), QuantConfig.lns_madam(), tp,
                 device="cpu", num_slots=2, max_len=64)
    with jd.configured(backend="reference"):
        jeng = JEngine(jcfg, JQuantConfig.lns_madam(), JMCFG8, jp,
                       num_slots=2, max_len=64)
    for n in (1, 5, 16, 17, 40):
        assert eng._bucket(n) == jeng._bucket(n) == n
    dense = Engine(get_smoke_config("smollm-135m"), QuantConfig.lns_madam(),
                   tm.init_params(get_smoke_config("smollm-135m"),
                                  device="cpu"), device="cpu", max_len=64)
    assert dense._bucket(5) == 16


@pytest.mark.parametrize("arch", RECURRENT)
def test_spec_refused_by_engine_and_cli(arch, draws):
    """``speculate_k`` raises ``spec_supported``'s refusal in the port's
    engine, as in JAX's, and ``launch.serve --speculate-k`` raises it."""
    from repro_torch.launch import serve
    jcfg, jp, tp = draws[arch, "float32"]
    with pytest.raises(ValueError, match=SPEC_REFUSAL) as theirs:
        JEngine(jcfg, JQuantConfig.lns_madam(), JMCFG8, jp, speculate_k=2)
    with pytest.raises(ValueError, match=SPEC_REFUSAL) as ours:
        Engine(get_smoke_config(arch), QuantConfig.lns_madam(), tp,
               device="cpu", speculate_k=2)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match=SPEC_REFUSAL):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--requests", "1", "--speculate-k", "2"])
