"""The port's serving observability against the JAX package's.

* ``SpanRing`` and ``StepTimeline``: one recorded sequence of events and
  rows through both packages' classes gives equal ``to_chrome()``,
  ``summary()``, ``samples()`` and ``to_chrome_counters()``; JAX's
  bounded-ring, wrap, round-trip and rejection cases hold on the port.
* The engine: JAX's ``obs_run`` configuration (smoke config, 2 slots,
  page 4, ondemand, spec k=2, 3 uniform requests arriving at 0) through
  both engines on the same packed weights: equal span counts per
  request, equal integer timeline columns row for row, equal instant
  names per tid, and each export valid under the other package's
  validator (and its CLI). JAX's preemption and queued-abort cases give
  the same events on both.
* ``kernel_stats`` on the CPU: rows keyed ``op|plain|bN`` with JAX's
  schema (``traces`` 0), blocked sampling, keyword forwarding past
  ``observe``'s positional-only parameters, ``disable``; over an engine
  run its calls equal the plain versions' calls; with a collector on, a
  CUDA tensor still reaches the kernel wrapper and never the plain path.
* ``launch.serve --trace-dir --kernel-stats --device cpu`` and
  ``profiler_trace`` write what they promise.

Every compared quantity is an integer, a string or a float copied from
the same input, so the bound is equality.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.obs import EngineObserver as JObserver  # noqa: E402
from repro.obs import SpanRing as JRing  # noqa: E402
from repro.obs import StepTimeline as JTimeline  # noqa: E402
from repro.obs import spans as jspans  # noqa: E402
from repro.obs import timeline as jtimeline  # noqa: E402
from repro.obs import validate as jvalidate  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import synthetic_trace as j_trace  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.core.lns import LNSFormat  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402
from repro_torch.obs import (EngineObserver, SpanRing,  # noqa: E402
                             StepTimeline, kernel_stats,
                             validate_chrome_trace)
from repro_torch.obs import spans as tspans  # noqa: E402
from repro_torch.obs import timeline as ttimeline  # noqa: E402
from repro_torch.obs import validate as tvalidate  # noqa: E402
from repro_torch.serving import Engine, Request, synthetic_trace  # noqa: E402

from test_torch_model import flat_params, jax_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread_no_collector():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    kernel_stats.disable()


# ---------------------------------------------------------------------------
# the span ring and the timeline, one recorded sequence through both


def test_schema_constants_equal_jax():
    for name in ("ENGINE_TID", "CAT_REQUEST", "CAT_ENGINE",
                 "REQUEST_PHASES"):
        assert getattr(tspans, name) == getattr(jspans, name), name
    assert [tspans.request_tid(r) for r in range(4)] == \
        [jspans.request_tid(r) for r in range(4)]
    assert ttimeline.STEP_KINDS == jtimeline.STEP_KINDS
    assert ttimeline._DTYPE == jtimeline._DTYPE


def _span_events(ring, cat_req, cat_eng, tid_of):
    """One sequence of span calls: named lanes, spans and instants with
    and without args, timestamps out of order, a tie."""
    for rid in (0, 2):
        ring.name_tid(tid_of(rid), f"req {rid}")
    ring.name_tid(tid_of(0), "renamed")          # first name wins
    ring.complete("queue", cat_req, tid_of(0), 0.0, 0.125)
    ring.complete("prefill", cat_req, tid_of(0), 0.125, 0.25,
                  {"prompt_len": 6})
    ring.complete("decode_step", cat_eng, 0, 0.5, 0.375)   # dur clamps
    ring.instant("preempt", cat_req, tid_of(2), 0.25, {"generated": 3})
    ring.complete("spec", cat_req, tid_of(2), 0.0625, 0.5,
                  {"k": 2, "accepted": 1, "emitted": 2})
    ring.instant("finish", cat_req, tid_of(0), 0.75,
                 {"reason": "length", "tokens": 4})
    ring.instant("finish", cat_req, tid_of(2), 0.75, {})


def _timeline_rows(tl):
    tl.record("prefill", 0.0, 0.25, running=1, queued=2, emitted=1,
              pages_free=10, pages_cached=0, preempts=0)
    tl.record("decode", 0.25, 0.375, running=2, emitted=2)       # dense
    tl.record("spec", 0.375, 0.625, running=2, queued=1, drafted=4,
              accepted=3, emitted=5, pages_free=7, pages_cached=1,
              preempts=2)
    tl.record("decode", 0.75, 0.5, running=1, emitted=1)          # dur 0


@pytest.mark.parametrize("capacity", [64, 4])
def test_span_ring_equals_jax(capacity):
    """The same calls, with room and in a ring that drops events."""
    rings = []
    for Ring, mod in ((JRing, jspans), (SpanRing, tspans)):
        ring = Ring(capacity)
        _span_events(ring, mod.CAT_REQUEST, mod.CAT_ENGINE, mod.request_tid)
        rings.append(ring)
    extra = [{"ph": "C", "name": "x", "pid": 0, "tid": 0, "ts": 1.0,
              "args": {"v": 1}}]
    j, t = rings
    assert t.to_chrome(extra) == j.to_chrome(extra)
    assert (len(t), t.dropped) == (len(j), j.dropped)
    assert t.snapshot() == j.snapshot()


def test_span_ring_bounded():
    """JAX's case (tests/test_obs.py) on the port."""
    ring = SpanRing(4)
    for i in range(10):
        ring.complete("s", tspans.CAT_ENGINE, 0, float(i), float(i) + 0.5)
    assert len(ring) == 4
    assert ring.dropped == 6
    assert ring.to_chrome()["otherData"]["dropped_events"] == 6
    ring.clear()
    assert len(ring) == 0 and ring.dropped == 0
    with pytest.raises(ValueError, match="capacity"):
        SpanRing(0)


@pytest.mark.parametrize("capacity", [64, 3])
def test_timeline_equals_jax(capacity):
    j, t = JTimeline(capacity), StepTimeline(capacity)
    _timeline_rows(j)
    _timeline_rows(t)
    assert t.summary() == j.summary()
    np.testing.assert_array_equal(t.samples(), j.samples())
    for stride in (1, 2):
        assert (t.to_chrome_counters(stride=stride)
                == j.to_chrome_counters(stride=stride))
    assert (t.total, t.dropped, len(t)) == (j.total, j.dropped, len(j))


def test_timeline_wraps_without_allocation():
    """JAX's wrap case on the port: the newest rows, oldest first, in a
    buffer that is never reallocated."""
    tl = StepTimeline(8)
    buf = tl._buf
    for i in range(20):
        tl.record("decode", float(i), float(i) + 0.5, emitted=1)
    assert len(tl) == 8 and tl.total == 20 and tl.dropped == 12
    assert list(tl.samples()["t0"]) == [float(i) for i in range(12, 20)]
    assert tl._buf is buf
    s = tl.summary()
    assert s["decode_steps"] == 8 and s["emitted_tokens"] == 8
    tl.clear()
    assert len(tl) == 0 and tl.summary()["steps"] == 0


def _finished_ring(Ring, mod, rid=0):
    ring = Ring(64)
    tid = mod.request_tid(rid)
    ring.name_tid(tid, f"req {rid}")
    ring.complete("queue", mod.CAT_REQUEST, tid, 0.0, 0.1)
    ring.complete("prefill", mod.CAT_REQUEST, tid, 0.1, 0.2)
    ring.complete("decode", mod.CAT_REQUEST, tid, 0.2, 0.9)
    ring.instant("finish", mod.CAT_REQUEST, tid, 0.9,
                 {"reason": "length", "tokens": 8})
    return ring


def test_chrome_trace_round_trip(tmp_path):
    """JAX's round-trip case on the port, and through JAX's validator."""
    ring = _finished_ring(SpanRing, tspans)
    path = tmp_path / "t.trace.json"
    ring.export(str(path))
    doc = json.loads(path.read_text())
    want = {0: {"queue": 1, "prefill": 1, "decode": 1}}
    assert validate_chrome_trace(doc) == want
    assert jspans.validate_chrome_trace(doc) == want
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    assert [e["ts"] for e in evs] == sorted(e["ts"] for e in evs)
    decode = next(e for e in evs if e["name"] == "decode")
    assert decode["ts"] == pytest.approx(0.2e6)
    assert decode["dur"] == pytest.approx(0.7e6)
    meta = {e["name"]: e["args"]["name"] for e in doc["traceEvents"]
            if e["ph"] == "M" and e["tid"] == 0}
    assert meta["process_name"] == "repro serving engine"
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"engine", "req 0"} <= names


def _incomplete_docs():
    ring = SpanRing(16)
    ring.complete("queue", tspans.CAT_REQUEST, tspans.request_tid(0),
                  0.0, 0.1)
    ring2 = SpanRing(16)
    tid = tspans.request_tid(1)
    ring2.complete("queue", tspans.CAT_REQUEST, tid, 0.0, 0.1)
    ring2.complete("prefill", tspans.CAT_REQUEST, tid, 0.1, 0.2)
    ring2.instant("finish", tspans.CAT_REQUEST, tid, 0.3, {"reason": "stop"})
    good = _finished_ring(SpanRing, tspans).to_chrome()
    bad_dur = json.loads(json.dumps(good))
    next(e for e in bad_dur["traceEvents"] if e["ph"] == "X")["dur"] = -1
    bad_ph = json.loads(json.dumps(good))
    bad_ph["traceEvents"].append({"ph": "Q", "name": "q", "pid": 0,
                                  "tid": 0, "ts": 0.0})
    return [(ring.to_chrome(), {}, "no completed request"),
            (ring2.to_chrome(), {}, "decode"),
            (good, {"require_spec": True}, "spec"),
            ({"not": "a trace"}, {}, "traceEvents"),
            (bad_dur, {}, "bad dur"),
            (bad_ph, {}, "unknown phase")]


@pytest.mark.parametrize("case", range(6))
def test_validate_rejects_incomplete_traces(case):
    """JAX's rejection cases (and two schema faults) on the port's
    validator; JAX's validator rejects each the same way."""
    doc, kw, match = _incomplete_docs()[case]
    with pytest.raises(ValueError, match=match):
        validate_chrome_trace(doc, **kw)
    with pytest.raises(ValueError, match=match):
        jspans.validate_chrome_trace(doc, **kw)


# ---------------------------------------------------------------------------
# the engine: JAX's obs_run through both


@pytest.fixture(scope="module")
def smoke():
    """JAX's smoke config and weights, and the port's of both."""
    cfg, qcfg, mcfg, params = jax_smoke()
    tp = params_from_flat(flat_params(params), LNSFormat(8, 8), device="cpu")
    port = (get_smoke_config("smollm-135m"), QuantConfig.lns_madam(), tp)
    return cfg, qcfg, mcfg, params, port


def _obs_engines(smoke, **kw):
    """A JAX and a port engine over the same weights, each with an
    observer attached."""
    cfg, qcfg, mcfg, params, (tcfg, tq, tp) = smoke
    jo, to = JObserver(), EngineObserver()
    je = JEngine(cfg, qcfg, mcfg, params, observer=jo, **kw)
    te = Engine(tcfg, tq, tp, device="cpu", observer=to, **kw)
    return (je, jo), (te, to)


def _requests(R, reqs):
    return [R(rid=r.rid, prompt=list(r.prompt),
              max_new_tokens=r.max_new_tokens, arrival=r.arrival)
            for r in reqs]


@pytest.fixture(scope="module")
def obs_run(smoke):
    """JAX's obs_run (tests/test_obs.py) on both engines."""
    cfg = smoke[0]
    (je, jo), (te, to) = _obs_engines(
        smoke, num_slots=2, max_len=32, page_size=4, prefix_cache=False,
        alloc_policy="ondemand", speculate_k=2)
    reqs = j_trace(cfg, requests=3, prompt_len=6, gen_len=4,
                   lengths="uniform", seed=3)
    assert all(r.arrival == 0.0 for r in reqs)
    jagg = je.run(_requests(JRequest, reqs))
    tagg = te.run(_requests(Request, reqs))
    return (je, jo, jagg), (te, to, tagg)


def _streams(e):
    return {rs.request.rid: list(rs.generated) for rs in e.finished}


def test_obs_run_streams_equal(obs_run):
    (je, _, jagg), (te, _, tagg) = obs_run
    assert jagg["completed"] == tagg["completed"] == 3
    assert _streams(te) == _streams(je)
    assert te.spec_cycles == je.spec_cycles > 0


def test_span_counts_equal_jax(obs_run):
    (_, jo, _), (_, to, _) = obs_run
    want = jspans.validate_chrome_trace(jo.to_chrome(), require_spec=True)
    got = validate_chrome_trace(to.to_chrome(), require_spec=True)
    assert got == want
    assert sorted(got) == [0, 1, 2]
    assert all(c["queue"] == 1 and c["prefill"] >= 1 for c in got.values())


_INT_COLUMNS = ("kind", "running", "queued", "pages_free", "pages_cached",
                "preempts", "drafted", "accepted", "emitted")


def test_timeline_columns_equal_jax(obs_run):
    (je, jo, _), (te, to, _) = obs_run
    js, ts = jo.timeline.samples(), to.timeline.samples()
    assert len(ts) == len(js) > 0
    for col in _INT_COLUMNS:
        np.testing.assert_array_equal(ts[col], js[col], err_msg=col)
    s = to.summary()
    assert s["spec_steps"] == te.spec_cycles
    assert s["prefill_steps"] == te.prefills
    assert s["decode_steps"] == te.decode_steps
    assert s["emitted_tokens"] == sum(map(len, _streams(te).values()))


def _instants(doc):
    out = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "i":
            out.setdefault(e["tid"], []).append(
                (e["name"], (e.get("args") or {}).get("reason")))
    return out


def test_instant_names_equal_jax(obs_run):
    (_, jo, _), (_, to, _) = obs_run
    assert _instants(to.to_chrome()) == _instants(jo.to_chrome())
    assert {e[0] for v in _instants(to.to_chrome()).values()
            for e in v} >= {"finish"}


def test_exports_validate_across_packages(obs_run, tmp_path):
    """The port's export under JAX's validator (and its CLI), JAX's under
    the port's; the port's CLI fails a file it cannot accept."""
    (je, jo, jagg), (te, to, tagg) = obs_run
    tpath = to.export(str(tmp_path / "port"), tag="unit")
    jpath = jo.export(str(tmp_path / "jax"), tag="unit")
    assert tpath.endswith(".trace.json")
    for path in (tpath, jpath):
        doc = json.loads(open(path).read())
        assert (validate_chrome_trace(doc, require_spec=True)
                == jspans.validate_chrome_trace(doc, require_spec=True))
        assert tvalidate.main([path, "--require-spec"]) == 0
        assert jvalidate.main([path, "--require-spec"]) == 0
    summary = json.loads(open(tpath.replace(".trace.json",
                                            ".timeline.json")).read())
    assert summary["spec_steps"] == te.spec_cycles
    bad = tmp_path / "bad.trace.json"
    bad.write_text("{not json")
    assert tvalidate.main([str(bad)]) == 1
    assert tvalidate.main([tpath, "--train"]) == 1


def test_time_breakdown(obs_run):
    """JAX's breakdown case on the port: the shares of a run sum to 1."""
    (_, _, _), (_, to, tagg) = obs_run
    bd = to.time_breakdown(tagg["wall_s"])
    assert bd["wall_s"] == tagg["wall_s"]
    assert 0.0 <= bd["host_share"] <= 1.0
    shares = sum(bd[k] for k in ("prefill_share", "decode_share",
                                 "spec_share", "host_share"))
    assert shares == pytest.approx(1.0, abs=0.01)
    steps_only = to.time_breakdown()
    assert "host_s" not in steps_only and "wall_s" not in steps_only


def test_engine_observer_is_off_by_default(smoke):
    tcfg, tq, tp = smoke[4]
    eng = Engine(tcfg, tq, tp, num_slots=2, max_len=32, device="cpu")
    assert eng.observer is None
    obs = EngineObserver()
    eng.attach_observer(obs)
    assert eng.observer is obs
    eng.attach_observer(None)
    assert eng.observer is None


def _event_names(obs):
    out = {}
    for name, _, tid, _, _, args in obs.spans.snapshot():
        out.setdefault(tid, []).append(name)
    return out


def test_preemption_events_equal_jax(smoke):
    """JAX's preemption case (tests/test_obs.py): a pool too small for
    both requests' contexts, so ondemand growth preempts; both engines
    record the same events on every lane, preempt and resume among
    them."""
    cfg = smoke[0]
    (je, jo), (te, to) = _obs_engines(
        smoke, num_slots=2, max_len=32, page_size=4, num_pages=5,
        prefix_cache=False, alloc_policy="ondemand")
    reqs = j_trace(cfg, requests=2, prompt_len=8, gen_len=12,
                   lengths="fixed", seed=0)
    je.run(_requests(JRequest, reqs))
    te.run(_requests(Request, reqs))
    assert te.preemptions == je.preemptions > 0
    names = _event_names(to)
    assert names == _event_names(jo)
    flat = [n for v in names.values() for n in v]
    assert "preempt" in flat and "resume" in flat
    np.testing.assert_array_equal(to.timeline.samples()["preempts"],
                                  jo.timeline.samples()["preempts"])


def test_queued_abort_event_equal_jax(smoke):
    """JAX's queued-abort case: a terminal marker (reason aborted,
    queued) and no span on the aborted request's lane."""
    cfg, qcfg, mcfg, params, (tcfg, tq, tp) = smoke
    out = []
    for E, R, O, args, kw in (
            (JEngine, JRequest, JObserver, (cfg, qcfg, mcfg, params), {}),
            (Engine, Request, EngineObserver, (tcfg, tq, tp),
             {"device": "cpu"})):
        obs = O()
        eng = E(*args, num_slots=1, max_len=32, observer=obs, **kw)
        eng.submit(R(rid=0, prompt=[1, 2, 3], max_new_tokens=4))
        eng.submit(R(rid=1, prompt=[4, 5, 6], max_new_tokens=4))
        eng.step()
        assert eng.abort(1)
        out.append([(e[0], e[1], e[5]) for e in obs.spans.snapshot()
                    if e[2] == tspans.request_tid(1)])
    assert out[1] == out[0] == [("finish", "request",
                                 {"reason": "aborted", "queued": True})]


# ---------------------------------------------------------------------------
# kernel_stats


def test_kernel_stats_cpu_row():
    """The CPU half of JAX's ``test_kernel_stats_traces_vs_calls``: an
    eager call is one row keyed ``op|plain|bN``, JAX's columns, traces 0,
    and blocked at ``block_every=1``; after ``disable`` nothing is
    collected."""
    fmt = LNSFormat(8, 8)
    x = torch.linspace(-1, 1, 32).reshape(4, 8)
    stats = kernel_stats.enable(block_every=1)
    assert kernel_stats.active() is stats
    dispatch.encode_pack(x, fmt)
    snap = kernel_stats.get()
    assert list(snap) == ["encode_pack|plain|b8"]
    row = snap["encode_pack|plain|b8"]
    assert row == {"op": "encode_pack", "backend": "plain", "bits": 8,
                   "calls": 1, "traces": 0, "time_s": row["time_s"],
                   "blocked_calls": 1, "blocked_s": row["blocked_s"]}
    assert row["blocked_s"] >= row["time_s"] >= 0.0
    kernel_stats.disable()
    assert kernel_stats.active() is None
    assert kernel_stats.get() == {}
    dispatch.encode_pack(x, fmt)
    assert kernel_stats.get() == {}


def test_kernel_stats_blocks_every_nth_call():
    x = torch.linspace(-1, 1, 32).reshape(4, 8)
    kernel_stats.enable(block_every=2)
    for _ in range(5):
        dispatch.encode_pack(x, LNSFormat(8, 8))
    row = kernel_stats.get()["encode_pack|plain|b8"]
    assert (row["calls"], row["blocked_calls"]) == (5, 3)   # calls 0, 2, 4
    kernel_stats.enable()
    dispatch.encode_pack(x, LNSFormat(8, 8))
    assert "blocked_calls" not in kernel_stats.get()["encode_pack|plain|b8"]


def test_kernel_stats_forwards_keywords():
    """Keyword arguments named like ``observe``'s own parameters reach
    the wrapped function (they are positional-only in ``observe``)."""
    kernel_stats.enable()
    got = kernel_stats.observe(
        "op_x", "plain", 4, None,
        lambda *a, **k: (a, k), 1, op="o", backend="b", bits=3, probe="p",
        fn="f")
    assert got == ((1,), {"op": "o", "backend": "b", "bits": 3,
                          "probe": "p", "fn": "f"})
    assert kernel_stats.get()["op_x|plain|b4"]["calls"] == 1
    kernel_stats.disable()
    assert kernel_stats.observe("op_x", "plain", 4, None, int, "7") == 7


def _counting_plain(monkeypatch):
    """Count calls of every plain version the dispatch layer picks."""
    seen = {}
    for name in ("encode_pack", "qmatmul", "paged_attend", "fused_sample",
                 "fused_sample_seeded", "requant_pack_many"):
        real = getattr(ref, name)

        def wrap(*a, _n=name, _f=real, **k):
            seen[_n] = seen.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(ref, name, wrap)
    return seen


def test_kernel_stats_calls_equal_plain_calls(smoke, monkeypatch):
    """Over a speculative paged run on the CPU, each op's ``calls`` equal
    the calls of its plain version (on the card ``chip_smoke.py`` holds
    them to the kernels' launch counts the same way)."""
    tcfg, tq, tp = smoke[4]
    eng = Engine(tcfg, tq, tp, num_slots=2, max_len=32, page_size=4,
                 speculate_k=2, draft_bitwidth=6, device="cpu")
    seen = _counting_plain(monkeypatch)
    kernel_stats.enable()
    eng.run(synthetic_trace(tcfg, requests=3, prompt_len=6, gen_len=4,
                            seed=3))
    calls = {}
    for row in kernel_stats.get().values():
        assert row["backend"] == "plain" and row["traces"] == 0
        calls[row["op"]] = calls.get(row["op"], 0) + row["calls"]
    assert calls == seen
    assert {"encode_pack", "qmatmul", "paged_attend",
            "requant_pack_many"} <= set(calls)


class _CudaStandIn:
    device = torch.device("cuda")
    shape = (2, 4)

    def reshape(self, *shape):
        return self

    def numel(self):
        return 8


def test_collector_never_changes_the_route(monkeypatch):
    """With a collector on (no blocking: there is no stream to drain
    here), CUDA stand-ins still reach the kernel wrappers and never the
    plain versions, and each call is attributed to ``kernel``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cuda = _CudaStandIn()
    called = []

    def kernel(name):
        def fn(*a, **k):
            called.append(name)
            if name in ("lns_matmul_packed", "requant_pack", "qmatmul",
                        "fused_sample", "fused_sample_seeded",
                        "paged_attend"):
                return cuda
            if name in ("madam_step", "madam_step_unpacked"):
                return cuda, cuda
            if name == "requant_pack_many":
                return [cuda]
            return cuda, cuda, torch.zeros(8, dtype=torch.float64)
        return fn

    names = list(ops.KERNELS) + ["fused_sample_seeded", "requant_pack_many"]
    for name in names:
        monkeypatch.setattr(ref, name, lambda *a, _n=name, **k: pytest.fail(
            f"plain {_n} reached from a CUDA tensor"))
        monkeypatch.setattr(ops, name, kernel(name))
    kernel_stats.enable()
    fmt, wide = LNSFormat(8, 8), LNSFormat(16, 2048)
    dispatch.encode_pack(cuda, fmt)
    dispatch.qmatmul(cuda, cuda, fmt)
    dispatch.qmatmul_decode(cuda, cuda, fmt)
    dispatch.paged_attend(cuda, cuda, cuda, None, None, cuda, cuda,
                          sm_scale=1.0)
    dispatch.fused_sample(cuda, None, None)
    dispatch.madam_step(cuda, cuda, cuda, 1, wide, lr=0.01)
    dispatch.madam_step(cuda, cuda, cuda, 1, wide, lr=0.01, with_stats=True)
    dispatch.requant_pack(cuda, fmt, LNSFormat(6, 2))
    dispatch.lns_matmul_packed(cuda, cuda, fmt, lut_entries=4)
    dispatch.madam_step_unpacked(cuda, cuda, cuda, cuda, 1, wide, lr=0.01)
    dispatch.fused_sample_seeded(cuda, np.ones(2, np.float32),
                                 np.zeros(2, np.uint32),
                                 np.zeros(2, np.int32))
    dispatch.requant_pack_many([cuda], fmt, LNSFormat(6, 2))
    assert called == names
    rows = kernel_stats.get()
    assert {r["backend"] for r in rows.values()} == {"kernel"}
    assert rows["madam_step|kernel|b16"]["calls"] == 2
    assert set(rows) == {
        "encode_pack|kernel|b8", "qmatmul|kernel|b8",
        "qmatmul_decode|kernel|b8", "paged_attend|kernel|b0",
        "fused_sample|kernel|b0", "madam_step|kernel|b16",
        "requant_pack|kernel|b6", "lns_matmul_packed|kernel|b8",
        "madam_step_unpacked|kernel|b16", "fused_sample_seeded|kernel|b0",
        "requant_pack_many|kernel|b6"}


def test_lns_matmul_is_attributed_with_its_k8_call():
    a = torch.linspace(-1, 1, 64).reshape(4, 16)
    kernel_stats.enable()
    dispatch.lns_matmul(a, a.T.contiguous(), LNSFormat(8, 8))
    assert {r["op"]: r["calls"] for r in kernel_stats.get().values()} == \
        {"lns_matmul": 1, "lns_matmul_packed": 1}


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    x = torch.linspace(-1, 1, 32).reshape(4, 8)
    with kernel_stats.profiler_trace(str(tmp_path)) as prof:
        dispatch.encode_pack(x, LNSFormat(8, 8))
    assert prof.key_averages()
    files = list(tmp_path.glob("torch_profile-*.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])


# ---------------------------------------------------------------------------
# the serve CLI


def test_serve_cli_traces_on_cpu(tmp_path, capsys):
    from repro_torch.launch.serve import main
    agg = main(["--smoke", "--device", "cpu", "--requests", "3", "--slots",
                "2", "--prompt-len", "8", "--gen-len", "4", "--page-size",
                "4", "--speculate-k", "2", "--trace-dir", str(tmp_path),
                "--kernel-stats"])
    text = capsys.readouterr().out
    assert "time breakdown: prefill" in text and "host" in text
    assert "kernel qmatmul|plain|b8: calls=" in text
    assert tvalidate.main([agg["trace"], "--require-spec"]) == 0
    assert jvalidate.main([agg["trace"], "--require-spec"]) == 0
    assert agg["kernel_stats"]["qmatmul|plain|b8"]["traces"] == 0
    assert kernel_stats.active() is None
    shares = sum(v for k, v in agg["time_breakdown"].items()
                 if k.endswith("_share"))
    assert shares == pytest.approx(1.0, abs=0.01)
