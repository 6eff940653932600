"""Asyncio HTTP/SSE gateway over the engine driver (stdlib only; the
port's counterpart of ``repro.server.app``, with the same routes, status
codes, limits and disconnect handling).

A deliberately small HTTP/1.1 server (``asyncio.start_server`` + hand
parsing — the container bakes no web framework) exposing:

  POST   /v1/completions     token-id completions; ``"stream": true``
                             switches to SSE with one frame per token
                             flushed as it is produced (TTFT, not
                             completion time) and a ``data: [DONE]``
                             terminator
  DELETE /v1/requests/{id}   cancel a live request mid-flight
  GET    /health             readiness + serving context (device and
                             card, alloc policy, spec config, checkpoint
                             id; 503 once the driver stops)
  GET    /metrics            Prometheus text exposition (counters,
                             gauges, TTFT/TPOT/queue-wait histograms) —
                             scrapeable by stock Prometheus
  GET    /metrics.json       the JSON snapshot + rolling latency summary
                             (the pre-Prometheus /metrics payload)

Backpressure: the driver's inflight watermark maps to **429**, a dead
driver to **503**. A streaming client that disconnects (curl ^C, browser
tab close) is detected by EOF on its socket and the request is aborted —
its decode slot and KV pages free mid-flight without perturbing
co-batched requests. Responses close the connection (``Connection:
close``); per-request connections keep cancellation semantics trivial.
"""
from __future__ import annotations

import asyncio
import json
from typing import Optional, Tuple

from repro_torch.server import protocol, sse
from repro_torch.server.driver import EngineDriver

__all__ = ["Gateway"]

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            413: "Payload Too Large", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable"}

# request-parse hard limits: the prompt is token ids, so even generous
# bodies are small — anything bigger is a client bug or abuse, refused
# before it is buffered
_MAX_BODY_BYTES = 8 << 20
_MAX_HEADERS = 128
# response-phase bounds: a client that stops reading (zero TCP window)
# must not pin writer.drain() — and with it the handler task, socket,
# and request — forever; and the disconnect watcher must not sink an
# endless post-body byte stream at full socket speed
_DRAIN_TIMEOUT_S = 60.0
_MAX_TRAILING_BYTES = 64 << 10


async def _drain(writer) -> None:
    await asyncio.wait_for(writer.drain(), timeout=_DRAIN_TIMEOUT_S)


class _BadRequest(Exception):
    """Malformed request head/body -> an HTTP error, not a dropped task."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def _http_head(status: int, content_type: str,
               length: Optional[int] = None) -> bytes:
    head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}",
            f"Content-Type: {content_type}",
            "Connection: close"]
    if length is not None:
        head.append(f"Content-Length: {length}")
    return ("\r\n".join(head) + "\r\n\r\n").encode()


class _AsyncSink:
    """Thread-safe bridge: driver-thread events -> an asyncio queue."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self.queue: "asyncio.Queue[tuple]" = asyncio.Queue()
        self._loop = loop

    def __call__(self, event: tuple) -> None:
        try:
            self._loop.call_soon_threadsafe(self.queue.put_nowait, event)
        except RuntimeError:
            pass  # loop already closed (shutdown) — the client is gone


class Gateway:
    def __init__(self, driver: EngineDriver, *, host: str = "127.0.0.1",
                 port: int = 8000, model: str = "lns-madam"):
        self._driver = driver
        self._host, self._port = host, port
        self._model = model
        self._server: Optional[asyncio.AbstractServer] = None

    @property
    def address(self) -> Tuple[str, int]:
        """Actual (host, port) — resolves port 0 after ``start()``."""
        assert self._server is not None, "gateway not started"
        return self._server.sockets[0].getsockname()[:2]

    async def start(self) -> "Gateway":
        self._server = await asyncio.start_server(
            self._handle_conn, self._host, self._port)
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        async with self._server:
            await self._server.serve_forever()

    # ------------------------------------------------------------------
    # connection handling

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            try:
                # one deadline over the whole request parse — a half-sent
                # head or short body must not pin the connection forever
                method, path, body = await asyncio.wait_for(
                    self._read_request(reader), timeout=30.0)
            except _BadRequest as e:
                await self._error(writer, e.status, str(e))
                await self._discard(reader)
                return
            except ValueError:  # StreamReader limit: oversized line
                await self._error(writer, 400, "request line too long")
                await self._discard(reader)
                return
            if method is None:
                return
            await self._route(method, path, body, reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    @staticmethod
    async def _discard(reader) -> None:
        """Bounded drain of request bytes still in flight after a
        refusal: closing with unread bytes in the kernel buffer sends
        RST and can discard the queued 4xx before the client reads it.
        A short per-read grace plus one overall deadline — a headers-only
        refusal costs one idle read, an actively-streaming body drains up
        to the trailing budget, and a byte-at-a-time trickler cannot pin
        the handler task past the deadline."""
        async def drain() -> None:
            budget = _MAX_TRAILING_BYTES
            while budget > 0:
                chunk = await asyncio.wait_for(reader.read(4096),
                                               timeout=0.25)
                if not chunk:
                    return
                budget -= len(chunk)
        try:
            await asyncio.wait_for(drain(), timeout=2.0)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader):
        """Parse request line, headers, and Content-Length body; returns
        (None, None, None) on a malformed request line."""
        head = await reader.readline()
        parts = head.decode("latin-1").split()
        if len(parts) < 2:
            return None, None, None
        method, path = parts[0].upper(), parts[1]
        headers, header_lines = {}, 0
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            header_lines += 1  # count lines, not names: duplicate-name
            if header_lines > _MAX_HEADERS:  # headers must not bypass
                raise _BadRequest(400, "too many headers")
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b""
        raw_n = headers.get("content-length", "0") or "0"
        try:
            n = int(raw_n)
        except ValueError:
            raise _BadRequest(
                400, f"malformed Content-Length {raw_n!r}") from None
        if n < 0:
            raise _BadRequest(400, f"negative Content-Length {n}")
        if n > _MAX_BODY_BYTES:
            raise _BadRequest(413, f"body of {n} bytes exceeds the "
                                   f"{_MAX_BODY_BYTES}-byte limit")
        if n:
            body = await reader.readexactly(n)
        return method, path, body

    async def _route(self, method: str, path: str, body: bytes,
                     reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        path = path.split("?", 1)[0]
        if method == "GET" and path == "/health":
            ok = self._driver.alive
            await self._json(writer, 200 if ok else 503,
                             self._driver.health())
        elif method == "GET" and path == "/metrics":
            payload = self._driver.prom_text().encode()
            writer.write(_http_head(
                status=200,
                content_type="text/plain; version=0.0.4; charset=utf-8",
                length=len(payload)))
            writer.write(payload)
            await _drain(writer)
        elif method == "GET" and path == "/metrics.json":
            await self._json(writer, 200, self._driver.stats())
        elif method == "DELETE" and path.startswith("/v1/requests/"):
            tail = path.rsplit("/", 1)[-1].removeprefix("cmpl-")
            if not tail.isdigit():
                await self._error(writer, 404, f"unknown request id {tail!r}")
                return
            self._driver.abort(int(tail))
            await self._json(writer, 200, {"id": f"cmpl-{tail}",
                                           "aborting": True})
        elif method == "POST" and path == "/v1/completions":
            await self._completions(body, reader, writer)
        else:
            await self._error(writer, 404, f"no route for {method} {path}")

    async def _json(self, writer, status: int, obj) -> None:
        # percentiles are NaN until the first completion; bare NaN is not
        # RFC-8259 JSON and breaks strict parsers (jq, fetch().json())
        obj = {k: (None if isinstance(v, float) and v != v else v)
               for k, v in obj.items()} if isinstance(obj, dict) else obj
        payload = json.dumps(obj, allow_nan=False).encode()
        writer.write(_http_head(status, "application/json", len(payload)))
        writer.write(payload)
        await _drain(writer)

    async def _error(self, writer, status: int, message: str) -> None:
        payload = protocol.error_body(message, status).encode()
        writer.write(_http_head(status, "application/json", len(payload)))
        writer.write(payload)
        await _drain(writer)

    # ------------------------------------------------------------------
    # completions

    async def _completions(self, body: bytes, reader, writer) -> None:
        try:
            creq = protocol.parse_completion(body)
        except protocol.ProtocolError as e:
            await self._error(writer, e.status, str(e))
            return
        if not self._driver.alive:
            await self._error(writer, 503, "server is shutting down")
            return
        sink = _AsyncSink(asyncio.get_running_loop())
        try:
            rid = self._driver.submit(creq.prompt, creq.max_tokens,
                                      sampling=creq.sampling, sink=sink)
        except ValueError as e:
            await self._error(writer, 400, str(e))
            return
        if rid is None:
            await self._error(writer, 429,
                              "engine at capacity, retry with backoff")
            return
        if creq.stream:
            await self._stream(rid, creq, sink, reader, writer)
        else:
            await self._unary(rid, creq, sink, reader, writer)

    @staticmethod
    async def _watch_eof(reader) -> None:
        """Resolve only on EOF. Stray bytes after the body (a pipelined
        request, a trailing CRLF) are drained and ignored — treating any
        readable bytes as a disconnect would silently abort a healthy
        request. A client that floods more than ``_MAX_TRAILING_BYTES``
        is treated as gone instead: we will not sink an arbitrary byte
        stream for the lifetime of the request."""
        budget = _MAX_TRAILING_BYTES
        while budget > 0:
            chunk = await reader.read(4096)
            if not chunk:
                return
            budget -= len(chunk)

    async def _events(self, rid: int, sink: _AsyncSink, reader):
        """Yield the request's sink events; EOF on the request socket
        (client went away) aborts the request and ends the iteration —
        both response modes must free the slot and KV pages mid-flight."""
        disconnect = asyncio.ensure_future(self._watch_eof(reader))
        try:
            while True:
                getter = asyncio.ensure_future(sink.queue.get())
                done, _ = await asyncio.wait(
                    {getter, disconnect},
                    return_when=asyncio.FIRST_COMPLETED)
                if getter not in done:
                    getter.cancel()
                    self._driver.abort(rid)
                    return
                event = getter.result()
                yield event
                if event[0] != "token":
                    return
        finally:
            if not disconnect.done():
                disconnect.cancel()
            elif not disconnect.cancelled():
                # a hard reset (RST, not FIN) parks an exception on the
                # watch future; retrieve it or asyncio logs a warning
                disconnect.exception()

    async def _unary(self, rid: int, creq, sink: _AsyncSink,
                     reader, writer) -> None:
        tokens, reason, spec = [], None, None
        async for event in self._events(rid, sink, reader):
            if event[0] == "token":
                tokens.append(event[1])
            else:
                reason = event[1]
                if event[2] is not None:
                    tokens = event[2]
                # internal error paths still emit bare 3-tuples
                spec = event[3] if len(event) > 3 else None
        if reason is None:
            return  # client disconnected; request aborted, nothing to say
        status = 500 if reason == "error" else 200
        payload = protocol.completion_body(
            rid, self._model, len(creq.prompt), tokens, reason,
            spec=spec).encode()
        writer.write(_http_head(status, "application/json", len(payload)))
        writer.write(payload)
        await _drain(writer)

    async def _stream(self, rid: int, creq, sink: _AsyncSink,
                      reader, writer) -> None:
        try:
            # head write inside the guard: a client that resets before
            # the head flushes must abort the request, not leak it to
            # run its full token budget against a gone socket
            writer.write(_http_head(200, "text/event-stream"))
            await _drain(writer)
            async for event in self._events(rid, sink, reader):
                if event[0] == "token":
                    writer.write(sse.encode_event(protocol.chunk_body(
                        rid, self._model, [event[1]])))
                    await _drain(writer)
                else:
                    writer.write(sse.encode_event(protocol.chunk_body(
                        rid, self._model, [], finish_reason=event[1])))
                    writer.write(sse.encode_event(sse.DONE))
                    await _drain(writer)
        except (ConnectionError, OSError, asyncio.TimeoutError):
            # broken socket, or a reader that stalled past the drain
            # deadline — either way the client is gone
            self._driver.abort(rid)
