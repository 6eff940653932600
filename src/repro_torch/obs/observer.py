"""The engine's observer: the span ring and the step timeline behind one
handle, the counterpart of ``repro.obs.observer.EngineObserver``.

``Engine`` holds ``self.observer`` (default ``None``), and every hook site
in its loop is a single ``if obs is not None``: without an observer a
site costs an attribute load and a branch, reads no clock and allocates
nothing. With one attached, the engine calls these methods at its
lifecycle edges and the observer turns them into spans (a lane a
request) and timeline rows (gauges a step).

Every timestamp is engine-clock seconds (``Engine.now()``). A replay with
simulated time (``step(now=...)``) stamps request events with the
caller's clock while step wall times come from the engine's, so attach
observers to real-time runs (``Engine.run()``, the online driver).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.spans import CAT_ENGINE, CAT_REQUEST, SpanRing, \
    request_tid
from repro_torch.obs.timeline import StepTimeline

__all__ = ["EngineObserver"]


class EngineObserver:
    """Collects request spans and the step timeline of one engine."""

    def __init__(self, *, span_capacity: int = 65536,
                 timeline_capacity: int = 16384):
        self.spans = SpanRing(span_capacity)
        self.timeline = StepTimeline(timeline_capacity)
        self.started_at = time.time()  # wall time, for export file names

    # -- request lifecycle (the engine's thread) ------------------------

    def admitted(self, rs, *, resumed: bool = False) -> None:
        req = rs.request
        tid = request_tid(req.rid)
        self.spans.name_tid(tid, f"req {req.rid}")
        if resumed:
            self.spans.instant("resume", CAT_REQUEST, tid, rs.t_admit,
                               {"generated": len(rs.generated)})
        else:
            self.spans.complete("queue", CAT_REQUEST, tid,
                                req.arrival, rs.t_admit)

    def prefill(self, rs, t0: float, t1: float, *,
                gauges: Optional[Dict[str, int]] = None) -> None:
        req = rs.request
        tid = request_tid(req.rid)
        self.spans.complete("prefill", CAT_REQUEST, tid, t0, t1,
                            {"prompt_len": req.prompt_len})
        self.timeline.record("prefill", t0, t1, emitted=1,
                             **(gauges or {}))

    def preempted(self, rs, t: float) -> None:
        self.spans.instant("preempt", CAT_REQUEST,
                           request_tid(rs.request.rid), t,
                           {"generated": len(rs.generated)})

    def aborted_queued(self, rid: int, t: float) -> None:
        tid = request_tid(rid)
        self.spans.name_tid(tid, f"req {rid}")
        self.spans.instant("finish", CAT_REQUEST, tid, t,
                           {"reason": "aborted", "queued": True})

    def finished(self, rs, reason: str) -> None:
        tid = request_tid(rs.request.rid)
        if rs.t_first_token is not None and rs.t_finish is not None:
            self.spans.complete("decode", CAT_REQUEST, tid,
                                rs.t_first_token, rs.t_finish)
        self.spans.instant("finish", CAT_REQUEST, tid,
                           rs.t_finish if rs.t_finish is not None else 0.0,
                           {"reason": reason, "tokens": len(rs.generated)})

    # -- steps ---------------------------------------------------------

    def decode_step(self, t0: float, t1: float, *, emitted: int,
                    gauges: Optional[Dict[str, int]] = None) -> None:
        self.spans.complete("decode_step", CAT_ENGINE, 0, t0, t1,
                            {"emitted": emitted})
        self.timeline.record("decode", t0, t1, emitted=emitted,
                             **(gauges or {}))

    def spec_cycle(self, t0: float, t1: float, *, k: int,
                   rows: List[Tuple[int, int, int]], emitted: int,
                   gauges: Optional[Dict[str, int]] = None) -> None:
        """``rows`` is ``[(rid, accepted, emitted_for_request), ...]`` over
        the live slots of the cycle."""
        accepted = 0
        for rid, acc, emit in rows:
            accepted += acc
            self.spans.complete("spec", CAT_REQUEST, request_tid(rid),
                                t0, t1, {"k": k, "accepted": acc,
                                         "emitted": emit})
        self.spans.complete("spec_cycle", CAT_ENGINE, 0, t0, t1,
                            {"k": k, "slots": len(rows)})
        self.timeline.record("spec", t0, t1, emitted=emitted,
                             drafted=k * len(rows), accepted=accepted,
                             **(gauges or {}))

    # -- reading -------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        out = self.timeline.summary()
        out["span_events"] = len(self.spans)
        out["span_dropped"] = self.spans.dropped
        return out

    def time_breakdown(self, wall_s: Optional[float] = None
                       ) -> Dict[str, float]:
        """Wall-time shares by step kind. With ``wall_s`` (the run's whole
        wall) the rest, outside every step, is the host's: scheduling and
        bookkeeping between steps."""
        s = self.timeline.summary()
        out = {
            "prefill_s": s.get("prefill_time_s", 0.0),
            "decode_s": s.get("decode_time_s", 0.0),
            "spec_s": s.get("spec_time_s", 0.0),
        }
        steps = sum(out.values())
        if wall_s is not None:
            out["wall_s"] = wall_s
            out["host_s"] = max(wall_s - steps, 0.0)
        total = wall_s if wall_s else steps
        if total > 0:
            for key in ("prefill", "decode", "spec", "host"):
                if f"{key}_s" in out:
                    out[f"{key}_share"] = round(out[f"{key}_s"] / total, 4)
        return out

    def to_chrome(self) -> Dict[str, Any]:
        return self.spans.to_chrome(
            extra_events=self.timeline.to_chrome_counters())

    def export(self, trace_dir: str, *, tag: str = "trace") -> str:
        """Write the Chrome trace and the timeline summary beside it;
        returns the trace's path."""
        os.makedirs(trace_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S",
                              time.localtime(self.started_at))
        path = os.path.join(trace_dir, f"{tag}-{stamp}.trace.json")
        self.spans.export(path,
                          extra_events=self.timeline.to_chrome_counters())
        with open(os.path.join(
                trace_dir, f"{tag}-{stamp}.timeline.json"), "w") as f:
            json.dump(self.summary(), f, indent=2, sort_keys=True)
            f.write("\n")
        return path

    def clear(self) -> None:
        self.spans.clear()
        self.timeline.clear()
