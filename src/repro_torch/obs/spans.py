"""Request span tracing: a bounded ring of span events exported as Chrome
trace-event JSON (opens in Perfetto or ``chrome://tracing``).

The counterpart of ``repro.obs.spans``, with the same document: the
engine records **complete** spans (a name, a start, a duration) and
**instant** events (preempt, resume, finish) into a :class:`SpanRing`.
Each request has its own trace thread (tid = rid + 1; tid 0 is the
engine), so Perfetto shows one lane a request with its queue, prefill,
decode and spec phases, and one lane for the engine's steps.

Timestamps are engine-clock seconds (``Engine.now()``); the export writes
the microsecond ``ts``/``dur`` fields of the trace-event format. The ring
is bounded (the oldest events drop first, counted in ``dropped``), so a
long-lived server does not grow without bound.

The engine's thread appends while an export may run on another thread
(the gateway's), so the ring guards its deque with a lock; the lock is
taken only when tracing is on, never on the untraced path.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["SpanRing", "ENGINE_TID", "CAT_REQUEST", "CAT_ENGINE",
           "REQUEST_PHASES", "request_tid", "validate_chrome_trace"]

ENGINE_TID = 0

# span and event categories; the validator keys off these
CAT_REQUEST = "request"
CAT_ENGINE = "engine"

# the spans every completed request must carry (and "spec" where
# speculation ran)
REQUEST_PHASES = ("queue", "prefill", "decode")

# the process name of the exported document, as the JAX package writes it
# (a trace from either package validates under the other's validator)
PROCESS_NAME = "repro serving engine"


def request_tid(rid: int) -> int:
    """Trace thread id of request ``rid`` (tid 0 is the engine)."""
    return rid + 1


class SpanRing:
    """Bounded ring of trace events; export with :meth:`to_chrome`."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events: "deque[tuple]" = deque(maxlen=capacity)
        self._tid_names: Dict[int, str] = {ENGINE_TID: "engine"}
        self._lock = threading.Lock()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._events)

    def _append(self, ev: tuple) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    def name_tid(self, tid: int, name: str) -> None:
        with self._lock:
            self._tid_names.setdefault(tid, name)

    def complete(self, name: str, cat: str, tid: int, t0: float,
                 t1: float, args: Optional[Dict[str, Any]] = None) -> None:
        """Record a complete span ``[t0, t1]`` (engine-clock seconds)."""
        self._append((name, cat, tid, t0, max(t1 - t0, 0.0), args))

    def instant(self, name: str, cat: str, tid: int, t: float,
                args: Optional[Dict[str, Any]] = None) -> None:
        self._append((name, cat, tid, t, None, args))

    def snapshot(self) -> List[tuple]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def to_chrome(self, extra_events: Optional[List[Dict[str, Any]]] = None
                  ) -> Dict[str, Any]:
        """The trace-event document (``{"traceEvents": [...]}``)."""
        with self._lock:
            events = list(self._events)
            tid_names = dict(self._tid_names)
        out: List[Dict[str, Any]] = []
        for tid, name in sorted(tid_names.items()):
            out.append({"ph": "M", "name": "thread_name", "pid": 0,
                        "tid": tid, "args": {"name": name}})
        out.append({"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
                    "args": {"name": PROCESS_NAME}})
        for name, cat, tid, t0, dur, args in sorted(events,
                                                    key=lambda e: e[3]):
            ev: Dict[str, Any] = {"name": name, "cat": cat, "pid": 0,
                                  "tid": tid, "ts": t0 * 1e6}
            if dur is None:
                ev["ph"] = "i"
                ev["s"] = "t"  # thread-scoped instant
            else:
                ev["ph"] = "X"
                ev["dur"] = dur * 1e6
            if args:
                ev["args"] = args
            out.append(ev)
        if extra_events:
            out.extend(extra_events)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path: str,
               extra_events: Optional[List[Dict[str, Any]]] = None) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(extra_events), f)
            f.write("\n")
        return path


# ---------------------------------------------------------------------------
# schema validation


def _check_event(ev: Any, i: int) -> None:
    if not isinstance(ev, dict):
        raise ValueError(f"traceEvents[{i}] is not an object")
    for field in ("ph", "pid", "tid", "name"):
        if field not in ev:
            raise ValueError(f"traceEvents[{i}] missing {field!r}")
    ph = ev["ph"]
    if ph == "M":
        return  # metadata events carry no timestamp
    if "ts" not in ev or not isinstance(ev["ts"], (int, float)):
        raise ValueError(f"traceEvents[{i}] ({ph!r}) has no numeric ts")
    if ph == "X":
        if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
            raise ValueError(f"traceEvents[{i}] complete span has bad dur")
    elif ph not in ("i", "I", "C", "B", "E"):
        raise ValueError(f"traceEvents[{i}] unknown phase {ph!r}")


def validate_chrome_trace(doc: Dict[str, Any], *,
                          require_spec: bool = False
                          ) -> Dict[int, Dict[str, int]]:
    """Check an exported trace against the trace-event schema and the
    span contract.

    Structure: ``traceEvents`` is a list of well-formed events (phase,
    pid/tid, numeric ``ts``, non-negative ``dur`` on complete spans).
    Contract: every request tid with a ``finish`` marker whose reason is
    stop/length/capacity also carries queue, prefill and decode spans,
    and a spec span with ``require_spec``. Returns ``{rid: {span: count}}``
    over the finished requests; raises ``ValueError`` on any violation.
    """
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("trace document must hold a traceEvents list")
    spans: Dict[int, Dict[str, int]] = {}
    finished: Dict[int, str] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        _check_event(ev, i)
        if ev.get("cat") != CAT_REQUEST:
            continue
        tid = ev["tid"]
        if ev["ph"] == "X":
            per = spans.setdefault(tid, {})
            per[ev["name"]] = per.get(ev["name"], 0) + 1
        elif ev["ph"] == "i" and ev["name"] == "finish":
            reason = (ev.get("args") or {}).get("reason", "")
            if reason in ("stop", "length", "capacity"):
                finished[tid] = reason
    if not finished:
        raise ValueError("trace holds no completed request (finish marker "
                         "with reason stop/length/capacity)")
    required = REQUEST_PHASES + (("spec",) if require_spec else ())
    out: Dict[int, Dict[str, int]] = {}
    for tid, reason in sorted(finished.items()):
        per = spans.get(tid, {})
        missing = [name for name in required if not per.get(name)]
        if missing:
            raise ValueError(
                f"request tid {tid} finished ({reason}) but lacks "
                f"span(s) {missing}; has {sorted(per)}")
        out[tid - 1] = per  # keyed by rid
    return out
