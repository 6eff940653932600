"""The port's HTTP/SSE gateway (``repro_torch.server``) on loopback over
the CPU engine, and its wire formats against the JAX package's.

* Byte equality with JAX on the same inputs: request validation (status
  code and error body of every refused body), the completion and chunk
  bodies, the Prometheus text of one stats dict with histograms, and
  SSE frames and their incremental parse.
* A live ``Gateway`` over an ``EngineDriver`` (the smollm smoke config,
  2 slots, paged at page 4, the prefix cache on), as
  ``tests/test_gateway.py`` builds one: completions, SSE streaming,
  ``DELETE`` and disconnect cancellation (the cancelled request's slot
  and pages free mid-flight, its neighbour's stream is its solo stream),
  429 at the watermark, 400/413 on bad requests, ``/health``,
  ``/metrics`` and ``/metrics.json``, a stop token, and 503 once the
  driver stops.

The stop-token case takes its stop id from a probe run in the same cache
state as the run it stops: the prompt's full pages already registered,
so both prefill only the suffix (a miss prefills the whole prompt, whose
per-tensor activation scales differ, which may move a greedy token).
"""
import asyncio
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.lns import LNSFormat  # noqa: E402
from repro_torch.core.quantizer import QuantConfig  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.obs import prom  # noqa: E402
from repro_torch.optim.madam import MadamConfig, init_lns_params  # noqa: E402
from repro_torch.server import protocol, sse  # noqa: E402
from repro_torch.server.app import Gateway  # noqa: E402
from repro_torch.server.driver import EngineDriver  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

SLOTS, MAX_LEN, PAGE = 2, 48, 4


# ---------------------------------------------------------------------------
# wire formats against JAX's

BAD_BODIES = [b"", b"[]", b"{", b'{"prompt": []}', b'{"prompt": "hi"}',
              b'{"prompt": [1], "max_tokens": 0}',
              b'{"prompt": [1], "max_tokens": 1.5}',
              b'{"prompt": [1], "max_tokens": true}',
              b'{"prompt": [1], "temperature": -1}',
              b'{"prompt": [1], "temperature": "hot"}',
              b'{"prompt": [1], "top_p": 0}',
              b'{"prompt": [1], "top_k": -2}',
              b'{"prompt": [1], "stream": "yes"}',
              b'{"prompt": [1], "stop": ["x"]}',
              b'{"prompt": [[1,2],[3]]}', b'{"prompt": [true]}']


@pytest.mark.parametrize("body", BAD_BODIES)
def test_refusals_equal_jax(body):
    jp = pytest.importorskip("repro.server.protocol")
    with pytest.raises(jp.ProtocolError) as want:
        jp.parse_completion(body)
    with pytest.raises(protocol.ProtocolError) as got:
        protocol.parse_completion(body)
    assert (str(got.value), got.value.status) == (str(want.value),
                                                  want.value.status)
    assert (protocol.error_body(str(got.value), got.value.status)
            == jp.error_body(str(want.value), want.value.status))


@pytest.mark.parametrize("body", [
    b'{"prompt": [1,2,3], "max_tokens": 4, "temperature": 0.5,'
    b' "top_k": 10, "seed": 9, "stop": 7, "stream": true}',
    b'{"prompt": [[1,2],[3,4]], "top_p": 0.9, "seed": -1}',
    b'{"prompt": [5], "stop": null}'])
def test_parse_and_bodies_equal_jax(body):
    jp = pytest.importorskip("repro.server.protocol")
    j, t = jp.parse_completion(body), protocol.parse_completion(body)
    assert (t.prompt, t.max_tokens, t.stream) == (j.prompt, j.max_tokens,
                                                  j.stream)
    for f in ("temperature", "top_k", "top_p", "seed", "stop"):
        assert getattr(t.sampling, f) == getattr(j.sampling, f), f
    spec = {"cycles": 3, "drafted": 12, "accepted": 7}
    for args in ((7, "m", 3, [1, 2], "length", None),
                 (8, "m", 1, [], "aborted", spec)):
        assert (protocol.completion_body(*args[:5], spec=args[5])
                == jp.completion_body(*args[:5], spec=args[5]))
    assert (protocol.chunk_body(7, "m", [4]) == jp.chunk_body(7, "m", [4]))
    assert (protocol.chunk_body(7, "m", [], finish_reason="stop")
            == jp.chunk_body(7, "m", [], finish_reason="stop"))
    for status in (400, 404, 413, 429, 503):
        assert (protocol.error_body("x", status)
                == jp.error_body("x", status))


def _prom_inputs(P):
    hists = [P.Histogram("ttft_seconds", "TTFT."),
             P.Histogram("tpot_seconds", "TPOT.", buckets=(0.01, 0.1, 1))]
    for i, v in enumerate((0.0004, 0.003, 0.07, 0.3, 2.0, 40.0,
                           float("nan"), 0.1)):
        hists[i % 2].observe(v)
    stats = {"running": 2, "completed_total": 9, "prefix_hits": 7,
             "prefix_reused_tokens": 448, "tokens_per_s": 123.456,
             "ttft_p50_s": float("nan"), "flag": True, "mesh": {"a": 1},
             "arch": "smollm", "spec_accept_rate": 0.4375,
             "numerics_weights_code_mean": 41.000001}
    info = {"arch": "smollm-135m", "device": "cpu", "card": None,
            "checkpoint_id": 'a"b\\c'}
    labeled = {"sat_hi": [({"layer": "wq"}, 0.25), ({"layer": "wo"}, 1),
                          ({"layer": "x"}, float("nan"))]}
    return stats, hists, info, labeled


def _render(P):
    stats, hists, info, labeled = _prom_inputs(P)
    return P.render_prometheus(stats, hists, info, labeled=labeled)


def test_prometheus_text_equals_jax():
    jprom = pytest.importorskip("repro.obs.prom")
    want, got = _render(jprom), _render(prom)
    assert got == want
    assert prom.parse_prometheus_text(got) == jprom.parse_prometheus_text(
        want)
    assert prom.LATENCY_BUCKETS == jprom.LATENCY_BUCKETS
    for bad in ("x 1\n", "# TYPE h histogram\nh_sum 1\nh_count 1\n",
                "# TYPE g gauge\ng{a} 1\n", "# TYPE g gauge\ng nope\n"):
        with pytest.raises(ValueError) as e1:
            prom.parse_prometheus_text(bad)
        with pytest.raises(ValueError) as e2:
            jprom.parse_prometheus_text(bad)
        assert str(e1.value) == str(e2.value)


def test_sse_frames_equal_jax():
    jsse = pytest.importorskip("repro.server.sse")
    payloads = ['{"a": 1}', jsse.DONE, "multi\nline", "ünï"]
    assert [sse.encode_event(p) for p in payloads] == [
        jsse.encode_event(p) for p in payloads]
    assert sse.DONE == jsse.DONE
    stream = (b"data: a\r\n\r\ndata: b\n\n: ping\nevent: x\ndata: 1\n"
              b"data: 2\n\ndata: c\r\n\rdata: [DONE]\n\n")
    for step in (1, 3, 7, len(stream)):
        p, j = sse.SSEParser(), jsse.SSEParser()
        got, want = [], []
        for i in range(0, len(stream), step):
            got += p.feed(stream[i:i + step])
            want += j.feed(stream[i:i + step])
        assert got == want and want[-1] == "[DONE]"


# ---------------------------------------------------------------------------
# the live gateway

@pytest.fixture(scope="module")
def engine_factory():
    cfg = get_smoke_config("smollm-135m")
    mcfg = MadamConfig(update_format=LNSFormat(bits=8, gamma=8))
    params = init_lns_params(init_params(cfg, seed=0, device="cpu"), mcfg)
    return lambda: Engine(cfg, QuantConfig.lns_madam(), params,
                          num_slots=SLOTS, max_len=MAX_LEN, page_size=PAGE,
                          device="cpu")


def _start(driver, model):
    loop = asyncio.new_event_loop()
    started = {}

    def run_loop():
        asyncio.set_event_loop(loop)
        gw = loop.run_until_complete(
            Gateway(driver, port=0, model=model).start())
        started["gw"], started["addr"] = gw, gw.address
        loop.run_forever()

    t = threading.Thread(target=run_loop, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while "addr" not in started and time.monotonic() < deadline:
        time.sleep(0.01)
    assert "addr" in started, "gateway failed to start"

    def stop():
        asyncio.run_coroutine_threadsafe(started["gw"].stop(),
                                         loop).result(5)
        loop.call_soon_threadsafe(loop.stop)
        t.join(5)
    return started["addr"], stop


@pytest.fixture(scope="module")
def live(engine_factory):
    """(engine, driver, host, port): a gateway on its own event-loop
    thread for the whole module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    engine = engine_factory()
    driver = EngineDriver(engine, max_inflight=SLOTS + 2).start()
    (host, port), stop = _start(driver, engine.cfg.name)
    yield engine, driver, host, port
    stop()
    driver.shutdown()
    assert not driver.alive
    torch.set_num_threads(n)


def _client(coro):
    return asyncio.run(coro)


async def _raw(host, port, data: bytes) -> bytes:
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return raw


async def _http(host, port, method, path, body=None, raw_body=None):
    payload = (raw_body if raw_body is not None else
               json.dumps(body).encode() if body is not None else b"")
    raw = await _raw(host, port, (
        f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n").encode() + payload)
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), data


def _json(resp):
    status, data = resp
    return status, json.loads(data) if data else {}


async def _stream(host, port, body, *, cancel_after=None, delete_after=None):
    """(status, tokens, frame times, finish reason, raw frames)."""
    reader, writer = await asyncio.open_connection(host, port)
    payload = json.dumps({**body, "stream": True}).encode()
    writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(payload)}\r\n\r\n").encode()
                 + payload)
    await writer.drain()
    head = b""
    while b"\r\n\r\n" not in head:
        chunk = await reader.read(1)
        assert chunk, "connection closed before the response head"
        head += chunk
    status = int(head.split()[1])
    parser = sse.SSEParser()
    tokens, times, frames, reason, rid = [], [], [], None, None
    if status != 200:
        writer.close()
        return status, tokens, times, reason, frames
    while True:
        chunk = await reader.read(4096)
        if not chunk:
            break
        for ev in parser.feed(chunk):
            frames.append(ev)
            if ev == sse.DONE:
                continue
            obj = json.loads(ev)
            rid = rid or obj["id"]
            choice = obj["choices"][0]
            if choice["delta"]["token_ids"]:
                tokens.extend(choice["delta"]["token_ids"])
                times.append(time.monotonic())
            if choice["finish_reason"]:
                reason = choice["finish_reason"]
        if frames and frames[-1] == sse.DONE:
            break
        if cancel_after is not None and len(tokens) >= cancel_after:
            break  # close the socket mid-stream
        if delete_after is not None and len(tokens) >= delete_after:
            await _http(host, port, "DELETE", f"/v1/requests/{rid}")
            delete_after = None
    writer.close()
    return status, tokens, times, reason, frames


def _prompt(vocab, n, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (n,)).tolist()


def _wait_idle(engine, baseline, timeout=15):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not engine.scheduler.running \
                and engine.allocator.available >= baseline:
            return True
        time.sleep(0.02)
    return False


def test_health_and_metrics(live):
    engine, driver, host, port = live
    status, obj = _json(_client(_http(host, port, "GET", "/health")))
    assert status == 200 and obj["status"] == "ok"
    assert obj["device"] == "cpu" and "card" not in obj
    assert obj["paged"] and obj["page_size"] == PAGE
    assert obj["prefix_cache"] is True
    assert obj["numerics"]["weights"]["elements"] > 0
    _client(_http(host, port, "POST", "/v1/completions",
                  {"prompt": _prompt(engine.cfg.vocab_size, 6),
                   "max_tokens": 3}))
    status, obj = _json(_client(_http(host, port, "GET", "/metrics.json")))
    assert status == 200
    for key in ("running", "queued", "inflight", "decode_steps",
                "queued_p50_s", "tpot_p50_s", "kv_pages_available",
                "prefix_hits", "prefix_reused_tokens", "completed_total"):
        assert key in obj, key
    status, text = _client(_http(host, port, "GET", "/metrics"))
    assert status == 200
    parsed = prom.parse_prometheus_text(text.decode())
    assert parsed["repro_completed_total"]["type"] == "counter"
    assert parsed["repro_prefix_hits"]["type"] == "counter"
    assert "repro_prefix_reused_tokens" in parsed
    for h in ("repro_ttft_seconds", "repro_tpot_seconds"):
        assert parsed[h]["type"] == "histogram"
    count = [v for s, v in parsed["repro_ttft_seconds"]["samples"]
             if s["__name__"] == "repro_ttft_seconds_count"]
    assert count and count[0] >= 1
    info = parsed["repro_build_info"]["samples"][0][0]
    assert info["device"] == "cpu" and info["arch"] == engine.cfg.name


def test_unary_completion_and_prefix_hit(live):
    engine, driver, host, port = live
    prompt = _prompt(engine.cfg.vocab_size, 9, seed=1)
    outs = []
    for _ in range(2):
        status, obj = _json(_client(_http(
            host, port, "POST", "/v1/completions",
            {"prompt": prompt, "max_tokens": 4})))
        assert status == 200
        choice = obj["choices"][0]
        assert len(choice["token_ids"]) == 4
        assert choice["finish_reason"] == "length"
        assert obj["usage"] == {"prompt_tokens": 9, "completion_tokens": 4,
                                "total_tokens": 13}
        outs.append((driver.stats()["prefix_hits"], choice["token_ids"]))
    assert outs[1][0] == outs[0][0] + 1   # the second reused 2 full pages


def test_streaming_is_incremental_and_seed_reproducible(live):
    engine, _, host, port = live
    body = {"prompt": _prompt(engine.cfg.vocab_size, 8, seed=2),
            "max_tokens": 6, "temperature": 0.8, "top_k": 50, "seed": 77}
    status, a, times, reason, frames = _client(_stream(host, port, body))
    assert status == 200 and reason == "length"
    assert len(a) == 6 and len(times) == 6
    assert times[-1] > times[0], "frames did not arrive incrementally"
    assert frames[-1] == sse.DONE and len(frames) == 6 + 2
    _, b, _, _, _ = _client(_stream(host, port, body))
    _, c, _, _, _ = _client(_stream(host, port, {**body, "seed": 78}))
    assert a == b and a != c


def test_delete_cancels_and_neighbour_is_undisturbed(live):
    """A long stream is cancelled by ``DELETE`` after 2 tokens while a
    neighbour decodes beside it: the cancel frees its slot and pages
    mid-flight, and the neighbour's tokens are those it gets alone (its
    3-token prompt fills no page, so both of its runs prefill it
    whole)."""
    engine, driver, host, port = live
    vocab = engine.cfg.vocab_size
    baseline = engine.allocator.available
    nb = {"prompt": _prompt(vocab, 3, seed=3), "max_tokens": 12}
    _, solo = _json(_client(_http(host, port, "POST", "/v1/completions", nb)))
    aborted0 = driver.stats()["aborted_total"]

    async def both():
        long = asyncio.ensure_future(_stream(
            host, port, {"prompt": _prompt(vocab, 6, seed=4),
                         "max_tokens": 40}, delete_after=2))
        await asyncio.sleep(0.05)
        other = asyncio.ensure_future(_http(host, port, "POST",
                                            "/v1/completions", nb))
        return await long, await other

    (status, toks, _, reason, frames), other = _client(both())
    assert status == 200 and reason == "aborted"
    assert 2 <= len(toks) < 40 and frames[-1] == sse.DONE
    assert _json(other)[1]["choices"][0]["token_ids"] == \
        solo["choices"][0]["token_ids"]
    assert _wait_idle(engine, baseline), "the cancel leaked its slot/pages"
    assert driver.stats()["aborted_total"] == aborted0 + 1
    assert engine.allocator.in_use == 0


def test_client_disconnect_frees_slot_and_pages(live):
    engine, driver, host, port = live
    baseline = engine.allocator.available
    aborted0 = driver.stats()["aborted_total"]
    status, toks, _, _, _ = _client(_stream(
        host, port, {"prompt": _prompt(engine.cfg.vocab_size, 6, seed=5),
                     "max_tokens": 40}, cancel_after=2))
    assert status == 200 and len(toks) >= 2
    assert _wait_idle(engine, baseline), "KV pages or the slot leaked"
    deadline = time.monotonic() + 10
    while (driver.stats()["aborted_total"] == aborted0
           and time.monotonic() < deadline):
        time.sleep(0.02)
    assert driver.stats()["aborted_total"] == aborted0 + 1


def test_backpressure_429_then_drains(live):
    engine, driver, host, port = live
    vocab = engine.cfg.vocab_size

    async def scenario():
        n = driver._max_inflight
        streams = [asyncio.ensure_future(_stream(
            host, port, {"prompt": _prompt(vocab, 4, seed=10 + i),
                         "max_tokens": 24})) for i in range(n)]
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if driver.stats()["inflight"] >= n:
                break
            await asyncio.sleep(0.01)
        over = await _http(host, port, "POST", "/v1/completions",
                           {"prompt": _prompt(vocab, 4), "max_tokens": 2})
        return over, await asyncio.gather(*streams)

    over, results = _client(scenario())
    status, obj = _json(over)
    assert status == 429
    assert obj["error"]["type"] == "rate_limit_exceeded"
    assert all(r[3] == "length" and len(r[1]) == 24 for r in results)
    status, _ = _client(_http(host, port, "POST", "/v1/completions",
                              {"prompt": _prompt(vocab, 4),
                               "max_tokens": 2}))
    assert status == 200


@pytest.mark.parametrize("body", BAD_BODIES[:8])
def test_bad_bodies_get_jax_status_and_body(live, body):
    jp = pytest.importorskip("repro.server.protocol")
    _, _, host, port = live
    with pytest.raises(jp.ProtocolError) as want:
        jp.parse_completion(body)
    status, data = _client(_http(host, port, "POST", "/v1/completions",
                                 raw_body=body))
    assert status == want.value.status
    assert data.decode() == jp.error_body(str(want.value),
                                          want.value.status)


def test_engine_refusals_are_400_not_a_wedged_slot(live):
    engine, driver, host, port = live
    vocab = engine.cfg.vocab_size
    for prompt, msg in (([-1, 5], "token ids must be in"),
                        ([[1, 2], [3, 4]], "flat list"),
                        (_prompt(vocab, MAX_LEN + 1), "exceeds engine")):
        status, obj = _json(_client(_http(
            host, port, "POST", "/v1/completions",
            {"prompt": prompt, "max_tokens": 2})))
        assert status == 400 and msg in obj["error"]["message"]
    status, _ = _client(_http(host, port, "GET", "/nope"))
    assert status == 404
    assert driver.alive
    status, _ = _client(_http(host, port, "POST", "/v1/completions",
                              {"prompt": _prompt(vocab, 4),
                               "max_tokens": 2}))
    assert status == 200


def test_content_length_abuse_gets_400_and_413(live):
    _, _, host, port = live
    base = b"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
    status = lambda head: int(_client(_raw(host, port, head)).split()[1])
    assert status(base + b"Content-Length: banana\r\n\r\n") == 400
    assert status(base + b"Content-Length: 999999999999\r\n\r\n") == 413
    assert status(base + b"Content-Length: -5\r\n\r\n") == 400
    many = b"".join(b"X-H%d: v\r\n" % i for i in range(200))
    assert status(base + many + b"\r\n") == 400


def test_stop_token_finishes_stream_with_reason_stop(live):
    engine, _, host, port = live
    body = {"prompt": _prompt(engine.cfg.vocab_size, 7, seed=6),
            "max_tokens": 5}
    # the first probe registers the prompt's full page; the second runs
    # in the cache state the stopped run will see (a one-page hit)
    probes = [_json(_client(_http(host, port, "POST", "/v1/completions",
                                  body)))[1]["choices"][0]["token_ids"]
              for _ in range(2)]
    toks = probes[1]
    status, got, _, reason, frames = _client(_stream(
        host, port, {**body, "stop": [toks[1]]}))
    assert status == 200
    assert got == toks[:toks.index(toks[1]) + 1]
    assert reason == "stop" and frames[-1] == sse.DONE


def test_finish_is_counted_before_its_sink_fires(engine_factory):
    """A request's metrics reach the driver's counters and histograms
    before its terminal event reaches the client, so a scrape right
    after a response ends counts it."""
    engine = engine_factory()
    driver = EngineDriver(engine, max_inflight=2).start()
    seen, done = [], threading.Event()

    def sink(ev):
        if ev[0] == "finish":
            seen.append((driver.stats()["completed_total"],
                         driver._hists["ttft_seconds"].count))
            done.set()
    try:
        assert driver.submit([1, 2, 3], 2, sink=sink) is not None
        assert done.wait(30)
    finally:
        driver.shutdown()
    assert seen == [(1, 1)]


def test_shutdown_gives_503(engine_factory):
    engine = engine_factory()
    driver = EngineDriver(engine, max_inflight=2).start()
    (host, port), stop = _start(driver, "m")
    try:
        assert _client(_http(host, port, "GET", "/health"))[0] == 200
        driver.shutdown()
        status, obj = _json(_client(_http(host, port, "GET", "/health")))
        assert status == 503 and obj["status"] == "stopping"
        status, obj = _json(_client(_http(
            host, port, "POST", "/v1/completions",
            {"prompt": [1, 2, 3], "max_tokens": 2})))
        assert status == 503
        assert obj["error"]["type"] == "server_unavailable"
    finally:
        stop()
