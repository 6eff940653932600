"""Engine step timeline: a preallocated numpy ring of one row a step.

The counterpart of ``repro.obs.timeline``, with the same row layout:
each ``Engine.step()`` that does work appends its kind (prefill, decode
or spec), start and wall time, the running slots, the queue depth, the
page pool's free and cached pages, the cumulative preemptions, and the
spec cycle's drafted, accepted and emitted counts. The ring is a
structured array with a write head that only grows, so a steady server
allocates nothing a step; ``samples()`` and ``summary()`` copy on demand.

The same rows become Chrome trace counter events (``ph: "C"``) on the
engine's lane, so Perfetto draws the occupancy and pool gauges under
the spans.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

__all__ = ["StepTimeline", "STEP_KINDS"]

STEP_KINDS = ("prefill", "decode", "spec")
_KIND_ID = {k: i for i, k in enumerate(STEP_KINDS)}

_DTYPE = np.dtype([
    ("t0", np.float64),        # engine-clock step start (s)
    ("dur", np.float64),       # step wall time (s)
    ("kind", np.int8),         # index into STEP_KINDS
    ("running", np.int32),     # occupied decode slots after the step
    ("queued", np.int32),      # queue depth after the step
    ("pages_free", np.int32),  # allocator free pages (-1 when dense)
    ("pages_cached", np.int32),  # prefix-cache (LRU) pages (-1 when dense)
    ("preempts", np.int64),    # cumulative preemptions
    ("drafted", np.int32),     # spec: draft tokens proposed this step
    ("accepted", np.int32),    # spec: draft tokens accepted this step
    ("emitted", np.int32),     # tokens emitted to streams this step
])


class StepTimeline:
    """Preallocated ring of per-step rows (one writer)."""

    def __init__(self, capacity: int = 16384):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf = np.zeros(capacity, dtype=_DTYPE)
        self._head = 0  # rows ever written

    def __len__(self) -> int:
        return min(self._head, self.capacity)

    @property
    def total(self) -> int:
        return self._head

    @property
    def dropped(self) -> int:
        return max(self._head - self.capacity, 0)

    def record(self, kind: str, t0: float, t1: float, *, running: int = 0,
               queued: int = 0, pages_free: int = -1, pages_cached: int = -1,
               preempts: int = 0, drafted: int = 0, accepted: int = 0,
               emitted: int = 0) -> None:
        row = self._buf[self._head % self.capacity]
        row["t0"] = t0
        row["dur"] = max(t1 - t0, 0.0)
        row["kind"] = _KIND_ID[kind]
        row["running"] = running
        row["queued"] = queued
        row["pages_free"] = pages_free
        row["pages_cached"] = pages_cached
        row["preempts"] = preempts
        row["drafted"] = drafted
        row["accepted"] = accepted
        row["emitted"] = emitted
        self._head += 1

    def clear(self) -> None:
        self._head = 0

    def samples(self) -> np.ndarray:
        """The retained rows, oldest first (a copy)."""
        n = len(self)
        if self._head <= self.capacity:
            return self._buf[:n].copy()
        cut = self._head % self.capacity
        return np.concatenate([self._buf[cut:], self._buf[:cut]])

    def summary(self) -> Dict[str, Any]:
        """Step counts and wall time by kind over the retained rows."""
        rows = self.samples()
        out: Dict[str, Any] = {
            "steps": int(self.total),
            "retained": int(len(rows)),
            "dropped": int(self.dropped),
        }
        for kind, kid in _KIND_ID.items():
            mask = rows["kind"] == kid
            out[f"{kind}_steps"] = int(mask.sum())
            out[f"{kind}_time_s"] = float(rows["dur"][mask].sum())
        if len(rows):
            out["emitted_tokens"] = int(rows["emitted"].sum())
            out["drafted_tokens"] = int(rows["drafted"].sum())
            out["accepted_tokens"] = int(rows["accepted"].sum())
            out["preempts"] = int(rows["preempts"].max())
            out["span_s"] = float(rows["t0"][-1] + rows["dur"][-1]
                                  - rows["t0"][0])
        return out

    def to_chrome_counters(self, *, stride: int = 1) -> List[Dict[str, Any]]:
        """Counter events (``ph: "C"``) for the engine lane of a trace."""
        rows = self.samples()[::max(stride, 1)]
        events: List[Dict[str, Any]] = []
        for row in rows:
            ts = float(row["t0"]) * 1e6
            events.append({"ph": "C", "name": "slots", "pid": 0, "tid": 0,
                           "ts": ts, "cat": "engine",
                           "args": {"running": int(row["running"]),
                                    "queued": int(row["queued"])}})
            if row["pages_free"] >= 0:
                events.append({"ph": "C", "name": "pages", "pid": 0,
                               "tid": 0, "ts": ts, "cat": "engine",
                               "args": {"free": int(row["pages_free"]),
                                        "cached": int(row["pages_cached"])}})
        return events
