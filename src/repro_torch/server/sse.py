"""Server-sent-events framing: encode on the gateway side, incremental
parse on the client side (tests, ``chip_smoke.py``). The port's copy of
``repro.server.sse``, frame for frame.

Only the ``data:`` field is used — one JSON payload per event, terminated
by a blank line, with the OpenAI-style ``data: [DONE]`` sentinel closing a
completion stream.
"""
from __future__ import annotations

from typing import List, Optional

__all__ = ["DONE", "encode_event", "SSEParser"]

DONE = "[DONE]"


def encode_event(payload: str) -> bytes:
    """One SSE frame carrying ``payload`` as its data field."""
    return f"data: {payload}\n\n".encode("utf-8")


class SSEParser:
    """Incremental SSE decoder: feed raw socket bytes, get back the
    completed ``data:`` payloads (multi-line data fields joined per the
    spec; comment/id/event fields ignored).

    Line-based per the spec — a line ends at CRLF, LF, or CR, and a
    blank line dispatches the event — so mixed framing from a foreign
    server parses correctly; a naive double-newline
    search would merge adjacently-framed events or stall on LF + CRLF."""

    def __init__(self):
        self._buf = b""
        self._data: List[str] = []

    def feed(self, chunk: bytes) -> List[str]:
        self._buf += chunk
        out: List[str] = []
        while True:
            line = self._next_line()
            if line is None:
                return out
            if not line:                       # blank line: dispatch
                if self._data:
                    out.append("\n".join(self._data))
                    self._data = []
                continue
            text = line.decode("utf-8", "replace")
            if text.startswith("data:"):
                self._data.append(text[5:].lstrip(" "))

    def _next_line(self) -> Optional[bytes]:
        """Pop one complete line (terminator stripped); None if the
        buffer holds no full line yet."""
        i_n, i_r = self._buf.find(b"\n"), self._buf.find(b"\r")
        if i_r >= 0 and (i_n < 0 or i_r < i_n):
            if i_r == len(self._buf) - 1:
                return None  # CR at the edge: CRLF may be split mid-chunk
            end = i_r + 2 if self._buf[i_r + 1] == 0x0A else i_r + 1
            line, self._buf = self._buf[:i_r], self._buf[end:]
            return line
        if i_n >= 0:
            line, self._buf = self._buf[:i_n], self._buf[i_n + 1:]
            return line
        return None
