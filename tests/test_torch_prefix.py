"""The port's prefix cache against the JAX package's.

* ``BlockAllocator``: one recorded sequence of ``alloc``/``register``/
  ``match``/``retain``/``release`` (and evictions under pressure) through
  both allocators gives the same page ids and the same counts after every
  call; ``chain_keys`` gives the same bytes.
* The engine: each of JAX's prefix-cache cases (``tests/test_paged.py``),
  plus on-demand preemption and speculation (k = 3) with the cache on,
  runs through both engines at the smoke config, page 4, on the same
  packed weights (``repro_torch.convert``) and the same prompts from
  ``np.random.default_rng``. Each case's own claims are checked on each
  engine (``test_case_holds``), and the port's token streams and counters
  equal JAX's (``test_port_equals_jax``). Every compared quantity is an
  integer, so the bound is equality.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.kernels import dispatch as jd  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving.scheduler import BlockAllocator as JAllocator  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.core.lns import LNSFormat  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.serving.scheduler import BlockAllocator  # noqa: E402

from test_torch_model import flat_params, jax_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the allocator

def _alloc_trace(A):
    """One recorded call sequence; returns every call's result and the
    counts after it."""
    a = A(num_pages=6, page_size=2)
    k1 = A.chain_keys([1, 2, 3, 4, 5, 6], 2)
    k2 = A.chain_keys([1, 2, 3, 4, 9, 9, 8, 8], 2)
    log = []

    def rec(what, out=None):
        log.append((what, out, a.available, a.cached, a.free, a.in_use))

    p = a.alloc(3)
    rec("alloc3", p)
    for key, page in zip(k1, p):
        a.register(key, page)
    a.register(k1[0], p[1])            # first writer wins
    rec("register")
    a.release(p)
    rec("release", None)
    m = a.match(k2)
    rec("match k2", m)
    a.retain(m)
    rec("retain", m)
    q = a.alloc(2)
    rec("alloc2", q)
    for key, page in zip(k2[2:], q):
        a.register(key, page)
    rec("alloc4 (evicts)", a.alloc(4))
    rec("match k1", a.match(k1))
    rec("match k2", a.match(k2))
    a.release(m + q)
    rec("release all", None)
    rec("alloc6 (evicts the rest)", a.alloc(6))
    rec("match after eviction", a.match(k2))
    return log


def test_allocator_page_ids_equal_jax():
    assert _alloc_trace(BlockAllocator) == _alloc_trace(JAllocator)


@pytest.mark.parametrize("n,page", [(13, 4), (12, 4), (16, 2), (3, 4)])
def test_chain_keys_equal_jax(n, page):
    prompt = np.random.default_rng(n).integers(0, 1000, (n,)).tolist()
    assert (BlockAllocator.chain_keys(prompt, page)
            == JAllocator.chain_keys(prompt, page))


# ---------------------------------------------------------------------------
# the engine: JAX's cases on both engines

@pytest.fixture(scope="module")
def smoke():
    cfg, qcfg, mcfg, params = jax_smoke()
    tp = params_from_flat(flat_params(params), LNSFormat(8, 8), device="cpu")
    return cfg, qcfg, mcfg, params, tp


def _by_rid(engine):
    return {rs.request.rid: list(rs.generated) for rs in engine.finished}


def _counters(e):
    return {k: getattr(e, k) for k in (
        "prefix_hits", "prefix_reused_tokens", "prefill_tokens", "prefills",
        "decode_steps", "preemptions", "decode_page_allocs")}


def case_hit(mk, R, vocab):
    """test_paged.py:127: a shared-prefix trace reuses resident pages:
    fewer prefill tokens, the same tokens generated."""
    prompt = np.random.default_rng(5).integers(0, vocab, (13,)).tolist()
    reqs = lambda: [R(rid=i, prompt=list(prompt), max_new_tokens=5)
                    for i in range(3)]
    kw = dict(num_slots=1, max_len=32, page_size=4, buckets=(4, 8, 16, 32))
    hit, miss = mk(**kw), mk(prefix_cache=False, **kw)
    hit.run(reqs())
    miss.run(reqs())
    return {"hit": _by_rid(hit), "miss": _by_rid(miss),
            "hit_counters": _counters(hit), "miss_counters": _counters(miss)}


def check_hit(r):
    assert r["hit"] == r["miss"]
    assert r["hit_counters"]["prefix_hits"] == 2
    assert r["hit_counters"]["prefix_reused_tokens"] == 2 * 12
    assert (r["hit_counters"]["prefill_tokens"]
            < r["miss_counters"]["prefill_tokens"])


def case_cow(mk, R, vocab):
    """test_paged.py:148: a page-aligned duplicate prompt reuses all but
    its last token, whose page is copied on write; two slots share the
    chain concurrently."""
    prompt = np.random.default_rng(11).integers(0, vocab, (12,)).tolist()
    e = mk(num_slots=2, max_len=32, page_size=4)
    e.run([R(rid=0, prompt=list(prompt), max_new_tokens=6),
           R(rid=1, prompt=list(prompt), max_new_tokens=6)])
    ref = mk(num_slots=1, max_len=32, page_size=4, prefix_cache=False)
    ref.run([R(rid=0, prompt=list(prompt), max_new_tokens=6)])
    return {"got": _by_rid(e), "want": list(ref.finished[0].generated),
            "counters": _counters(e), "available": e.allocator.available,
            "num_pages": e.num_pages}


def check_cow(r):
    assert r["got"][0] == r["want"] and r["got"][1] == r["want"]
    assert r["counters"]["prefix_hits"] == 1
    assert r["counters"]["prefix_reused_tokens"] == 11
    assert r["available"] == r["num_pages"]


def case_divergent(mk, R, vocab):
    """test_paged.py:167: only the shared aligned prefix is reused when
    prompts diverge."""
    rng = np.random.default_rng(13)
    p1 = rng.integers(0, vocab, (12,)).tolist()
    p2 = p1[:8] + rng.integers(0, vocab, (7,)).tolist()
    e = mk(num_slots=1, max_len=32, page_size=4)
    e.run([R(rid=0, prompt=p1, max_new_tokens=4),
           R(rid=1, prompt=p2, max_new_tokens=4)])
    ref = mk(num_slots=1, max_len=32, page_size=4, prefix_cache=False)
    ref.run([R(rid=1, prompt=list(p2), max_new_tokens=4)])
    return {"got": _by_rid(e), "want": list(ref.finished[0].generated),
            "counters": _counters(e)}


def check_divergent(r):
    assert r["got"][1] == r["want"]
    assert r["counters"]["prefix_reused_tokens"] == 8


def case_exact_pool(mk, R, vocab):
    """test_paged.py:206: on a pool sized exactly to the demand, a
    prefix re-hit forfeits the boundary reuse instead of requeueing the
    same reservation forever."""
    prompt = np.random.default_rng(19).integers(0, vocab, (8,)).tolist()
    e = mk(num_slots=1, max_len=16, page_size=4, num_pages=4)
    e.run([R(rid=0, prompt=list(prompt), max_new_tokens=9)])
    e.run([R(rid=1, prompt=list(prompt), max_new_tokens=9)])
    return {"got": _by_rid(e), "counters": _counters(e),
            "available": e.allocator.available}


def check_exact_pool(r):
    assert r["got"][0] == r["got"][1] and len(r["got"][1]) == 9
    assert r["counters"]["prefix_reused_tokens"] <= 4
    assert r["available"] == 4


def _shared_prefix(vocab, seed, n, prefix, suffix):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, (prefix,)).tolist()
    return [head + rng.integers(0, vocab, (suffix,)).tolist()
            for _ in range(n)]


def case_ondemand(mk, R, vocab):
    """On-demand paging under pressure with the cache on: two requests
    share a one-page prefix and grow to 4 pages each on a 6-page pool, so
    the younger is preempted and resumes by recompute (its prefix match
    taken again); the sinks see each token once."""
    prompts = _shared_prefix(vocab, 23, 2, 4, 4)
    e = mk(num_slots=2, max_len=16, page_size=4, num_pages=6,
           alloc_policy="ondemand")
    emitted = {}
    e.token_sink = lambda rid, tok: emitted.setdefault(rid, []).append(
        int(tok))
    e.run([R(rid=i, prompt=p, max_new_tokens=8)
           for i, p in enumerate(prompts)])
    return {"got": _by_rid(e), "emitted": emitted, "counters": _counters(e),
            "available": e.allocator.available, "in_use": e.allocator.in_use}


def check_ondemand(r):
    assert sorted(r["got"]) == [0, 1]
    assert all(len(v) == 8 for v in r["got"].values())
    assert r["emitted"] == r["got"]
    assert r["counters"]["preemptions"] > 0
    assert r["counters"]["prefix_hits"] > 0
    assert r["available"] == 6 and r["in_use"] == 0


def case_spec(mk, R, vocab):
    """Speculation (k = 3, draft bitwidth 6) with the cache on: four
    requests share a two-page prefix; the speculating engine's streams
    equal its own non-speculating engine's."""
    prompts = _shared_prefix(vocab, 29, 4, 8, 3)
    reqs = lambda: [R(rid=i, prompt=list(p), max_new_tokens=7 - i % 2)
                    for i, p in enumerate(prompts)]
    kw = dict(num_slots=3, max_len=40, page_size=4)
    base, spec = mk(**kw), mk(speculate_k=3, **kw)
    base.run(reqs())
    spec.run(reqs())
    return {"base": _by_rid(base), "spec": _by_rid(spec),
            "counters": _counters(spec), "spec_snapshot": {
                k: v for k, v in spec.spec_snapshot().items()
                if k != "spec_accept_rate"},
            "available": spec.allocator.available}


def check_spec(r):
    assert r["spec"] == r["base"]
    assert r["counters"]["prefix_hits"] == 3
    assert r["counters"]["prefix_reused_tokens"] == 3 * 8
    assert r["spec_snapshot"]["spec_cycles"] > 0
    assert r["available"] == 40 // 4 * 3


CASES = {"hit": (case_hit, check_hit), "cow": (case_cow, check_cow),
         "divergent": (case_divergent, check_divergent),
         "exact_pool": (case_exact_pool, check_exact_pool),
         "ondemand": (case_ondemand, check_ondemand),
         "spec": (case_spec, check_spec)}


@pytest.fixture(scope="module")
def results(smoke):
    """Each case's results by (case, engine), run once; an engine of the
    same settings is reset and reused across cases (JAX's compiles once)."""
    cfg, qcfg, mcfg, jparams, tp = smoke
    tcfg = get_smoke_config("smollm-135m")
    build = {"jax": lambda **kw: JEngine(cfg, qcfg, mcfg, jparams, **kw),
             "torch": lambda **kw: Engine(tcfg, QuantConfig.lns_madam(), tp,
                                          device="cpu", **kw)}
    memo, engines = {}, {}

    def mk(impl, **kw):
        key = (impl, tuple(sorted(kw.items())))
        if key in engines:
            engines[key].reset()
        else:
            engines[key] = build[impl](**kw)
        return engines[key]

    def get(case, impl):
        if (case, impl) not in memo:
            run = CASES[case][0]
            with jd.configured(backend="reference"):
                memo[case, impl] = run(
                    lambda **kw: mk(impl, **kw),
                    JRequest if impl == "jax" else Request, cfg.vocab_size)
        return memo[case, impl]

    return get


@pytest.mark.parametrize("impl", ["jax", "torch"])
@pytest.mark.parametrize("case", list(CASES))
def test_case_holds(results, case, impl):
    CASES[case][1](results(case, impl))


@pytest.mark.parametrize("case", list(CASES))
def test_port_equals_jax(results, case):
    assert results(case, "torch") == results(case, "jax")
