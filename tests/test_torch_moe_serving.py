"""The port's engine on the mixture-of-experts models (deepseek-v3-671b
with its MLA latent cache, kimi-k2-1t-a32b paged) against the JAX
package's engine at each config's ``SMOKE`` shape, on the CPU, with
JAX's packed 8-bit parameters carried across by
``convert.params_from_flat``; and both CLIs on the smoke configs. The
models' side is in ``test_torch_moe_models.py``.

Capacity couples the rows of a call (a decode step's C is 1 at these
sizes): bucket padding and idle slots are routed and take capacity, so a
stream depends on its batch; the port pads, routes and ranks as JAX's
engine does. Tolerances: token streams, prefill tokens, prefix counters,
preemptions, speculative cycles and accepted drafts equal JAX's
engine's, exactly, at f32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

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
from repro_torch.serving import Engine, Request  # noqa: E402

from test_torch_model import flat_params  # noqa: E402

MOE = ["deepseek-v3-671b", "kimi-k2-1t-a32b"]
FMT8 = LNSFormat(8, 8)
JMCFG8 = JMadamConfig(update_format=JFormat(bits=8, gamma=8))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def draws():
    """Each model's JAX draw at 8 bits (f32), JAX's tree and the
    port's."""
    out = {}
    for arch in MOE:
        jcfg = j_smoke_config(arch)
        jp = jax.jit(lambda k: j_init_train_state(k, jcfg, JMCFG8)
                     .params)(jax.random.PRNGKey(0))
        out[arch] = (jcfg, jp, params_from_flat(flat_params(jp), FMT8,
                                                device="cpu"))
    return out


def _trace(cfg, n=5, seed=3, prefix=()):
    """``n`` requests of prompt lengths 5 and 9 (after a shared
    ``prefix``) and 5-6 new tokens: more requests than slots."""
    rng = np.random.default_rng(seed)
    return [(i, list(prefix) + rng.integers(
        0, cfg.vocab_size, (5 + 4 * (i % 2),)).tolist(), 6 - i % 2)
        for i in range(n)]


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
    return {rs.request.rid: list(rs.generated) for rs in e.finished}


@pytest.mark.parametrize("page", [None, 4])
def test_deepseek_engine_keeps_the_dense_mla_cache(draws, page):
    """deepseek-smoke: 5 requests over 2 slots, with and without
    ``page_size``: both engines keep the dense latent cache and build no
    allocator (MLA is never paged), and the streams equal JAX's, the
    bucket padding and the idle row routed as JAX routes them."""
    jcfg, jp, tp = draws["deepseek-v3-671b"]
    tcfg = get_smoke_config("deepseek-v3-671b")
    reqs = _trace(tcfg)
    kw = dict(num_slots=2, max_len=32, page_size=page, num_pages=16 if page
              else None)
    eng = _port(tcfg, tp, reqs, **kw)
    jeng = _jax(jcfg, jp, reqs, **kw)
    for e in (eng, jeng):
        assert e.page_size is None and e.allocator is None
        assert len(e.finished) == 5
    assert all("c_kv" in c for c in eng.caches["prefix"])
    assert "c_kv" in eng.caches["period"]["pos0"]
    assert _streams(eng) == _streams(jeng)
    assert eng.prefill_tokens == jeng.prefill_tokens


def test_kimi_engine_paged_prefix_preemption_match_jax(draws):
    """kimi-smoke paged at page 4: requests sharing an 8-token prefix
    with the prefix cache on (hits, copy-on-write), then on demand over
    a pool too small for both slots' growth (preemption): the streams,
    prefix counters and preemptions equal JAX's engine's, and every page
    comes back."""
    jcfg, jp, tp = draws["kimi-k2-1t-a32b"]
    tcfg = get_smoke_config("kimi-k2-1t-a32b")
    prefix = np.random.default_rng(1).integers(0, 512, 8).tolist()
    reqs = _trace(tcfg, n=4, prefix=prefix)
    kw = dict(num_slots=2, max_len=32, page_size=4, num_pages=16)
    eng, jeng = _port(tcfg, tp, reqs, **kw), _jax(jcfg, jp, reqs, **kw)
    assert eng._prefix_ok and jeng._prefix_ok
    assert eng.prefix_hits == jeng.prefix_hits > 0
    assert eng.prefix_reused_tokens == jeng.prefix_reused_tokens
    assert _streams(eng) == _streams(jeng)
    assert eng.allocator.in_use == 0
    reqs = [(i, p, 10) for i, p, _ in _trace(tcfg, n=3, seed=8)]
    kw = dict(num_slots=2, max_len=32, page_size=4, num_pages=6,
              alloc_policy="ondemand")
    eng, jeng = _port(tcfg, tp, reqs, **kw), _jax(jcfg, jp, reqs, **kw)
    assert eng.preemptions == jeng.preemptions > 0
    assert _streams(eng) == _streams(jeng)
    assert eng.prefill_tokens == jeng.prefill_tokens
    assert eng.allocator.in_use == 0


@pytest.mark.parametrize("arch", MOE)
def test_spec_k3_streams_match_jax(arch, draws):
    """Speculating k = 3 from a 6-bit draft view (kimi paged, deepseek
    on its latent cache, rewound through ``idx``): the streams, the
    accepted drafts and the cycles equal JAX's engine's."""
    jcfg, jp, tp = draws[arch]
    tcfg = get_smoke_config(arch)
    reqs = _trace(tcfg, n=4)
    kw = dict(num_slots=2, max_len=32, page_size=4, num_pages=16,
              speculate_k=3, draft_bitwidth=6)
    eng, jeng = _port(tcfg, tp, reqs, **kw), _jax(jcfg, jp, reqs, **kw)
    assert eng.spec_cycles == jeng.spec_cycles > 0
    assert eng.spec_accepted == jeng.spec_accepted
    assert _streams(eng) == _streams(jeng)


@pytest.mark.parametrize("arch", MOE)
def test_clis_run_the_smoke_configs(arch, capsys):
    """``launch.serve`` and ``launch.train`` take both archs with
    ``--smoke --device cpu``: every request completes, the losses are
    finite."""
    from repro_torch.launch import serve, train
    agg = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "3", "--slots", "2", "--prompt-len",
                      "6", "--gen-len", "4", "--page-size", "4"])
    assert int(agg["completed"]) == 3
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16"])
    losses = [float(x) for x in out["losses"]]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    text = capsys.readouterr().out
    assert get_smoke_config(arch).name in text
