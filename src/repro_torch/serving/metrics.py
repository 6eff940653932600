"""Per-request latency accounting and aggregate serving statistics (from
``repro.serving.metrics``, without the speculative-decoding fields)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.serving.request import RequestState

__all__ = ["RequestMetrics", "summarize", "percentile"]


@dataclasses.dataclass(frozen=True)
class RequestMetrics:
    rid: int
    slot: int
    arrival: float
    t_admit: float
    t_first_token: float
    t_finish: float
    prompt_len: int
    new_tokens: int
    # the slot ran out of cache positions before a stop token or the
    # token budget
    truncated: bool = False

    @property
    def ttft(self) -> float:
        """Time to first token, from arrival (queueing included)."""
        return self.t_first_token - self.arrival

    @property
    def queued_s(self) -> float:
        return self.t_admit - self.arrival

    @property
    def latency(self) -> float:
        return self.t_finish - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token after the first; None for one token."""
        if self.new_tokens < 2 or self.t_finish <= self.t_first_token:
            return None
        return (self.t_finish - self.t_first_token) / (self.new_tokens - 1)

    @classmethod
    def from_state(cls, rs: RequestState,
                   truncated: bool = False) -> "RequestMetrics":
        if rs.t_first_token is None or rs.t_finish is None:
            raise ValueError(f"request {rs.request.rid} has not finished")
        return cls(rid=rs.request.rid, slot=rs.slot,
                   arrival=rs.request.arrival, t_admit=rs.t_admit,
                   t_first_token=rs.t_first_token, t_finish=rs.t_finish,
                   prompt_len=rs.request.prompt_len,
                   new_tokens=len(rs.generated), truncated=truncated)


def percentile(vals: List[float], q: float) -> float:
    """Nearest-rank percentile (NaN when empty), q clamped to [0, 1]."""
    if not vals:
        return float("nan")
    q = min(max(q, 0.0), 1.0)
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(q * (len(vals) - 1) + 0.5))]


def summarize(metrics: List[RequestMetrics], wall: float) -> Dict[str, float]:
    """Aggregate a finished run: goodput and latency percentiles."""
    total_new = sum(m.new_tokens for m in metrics)
    ttfts = [m.ttft for m in metrics]
    lats = [m.latency for m in metrics]
    queued = [m.queued_s for m in metrics]
    tpots = [m.tpot for m in metrics if m.tpot is not None]
    return {
        "completed": float(len(metrics)),
        "truncated": float(sum(m.truncated for m in metrics)),
        "wall_s": wall,
        "generated_tokens": float(total_new),
        "tokens_per_s": total_new / wall if wall > 0 else float("nan"),
        "ttft_mean_s": sum(ttfts) / len(ttfts) if ttfts else float("nan"),
        "ttft_p95_s": percentile(ttfts, 0.95),
        "latency_p50_s": percentile(lats, 0.50),
        "latency_p95_s": percentile(lats, 0.95),
        "queued_p50_s": percentile(queued, 0.50),
        "queued_p95_s": percentile(queued, 0.95),
        "tpot_p50_s": percentile(tpots, 0.50),
        "tpot_p95_s": percentile(tpots, 0.95),
    }
