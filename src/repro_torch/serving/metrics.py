"""Per-request latency accounting and aggregate serving statistics (from
``repro.serving.metrics``), with per-request preemption counts."""
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
    # speculative decoding: draft tokens scored for this request and how
    # many the verify pass accepted (0/0 when speculation was off)
    spec_drafted: int = 0
    spec_accepted: int = 0
    # times on-demand paging evicted this request
    preemptions: int = 0

    @property
    def spec_accept_rate(self) -> Optional[float]:
        """Fraction of this request's draft tokens the target model
        agreed with; None when no drafts were scored for it."""
        if not self.spec_drafted:
            return None
        return self.spec_accepted / self.spec_drafted

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

    @property
    def decode_tps(self) -> Optional[float]:
        """Tokens a second after the first; None for one token."""
        if self.new_tokens < 2 or self.t_finish <= self.t_first_token:
            return None
        return (self.new_tokens - 1) / (self.t_finish - self.t_first_token)

    @classmethod
    def from_state(cls, rs: RequestState,
                   truncated: bool = False) -> "RequestMetrics":
        if rs.t_first_token is None or rs.t_finish is None:
            raise ValueError(f"request {rs.request.rid} has not finished")
        return cls(rid=rs.request.rid, slot=rs.slot,
                   arrival=rs.request.arrival, t_admit=rs.t_admit,
                   t_first_token=rs.t_first_token, t_finish=rs.t_finish,
                   prompt_len=rs.request.prompt_len,
                   new_tokens=len(rs.generated), truncated=truncated,
                   spec_drafted=rs.spec_drafted,
                   spec_accepted=rs.spec_accepted,
                   preemptions=rs.preemptions)


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
    accepts = [m.spec_accept_rate for m in metrics
               if m.spec_accept_rate is not None]
    spec_drafted = sum(m.spec_drafted for m in metrics)
    spec_accepted = sum(m.spec_accepted for m in metrics)
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
        # speculative decoding: the request-level accept-rate distribution
        # (requests that rode at least one spec cycle) and run totals;
        # zero/NaN when speculation was off
        "spec_requests": float(len(accepts)),
        "spec_drafted_tokens": float(spec_drafted),
        "spec_accepted_tokens": float(spec_accepted),
        "spec_accept_rate": (spec_accepted / spec_drafted
                             if spec_drafted else float("nan")),
        "spec_accept_rate_p50": percentile(accepts, 0.50),
        "spec_accept_rate_p95": percentile(accepts, 0.95),
        # on-demand paging: evictions of the completed requests
        "preempted_requests": float(sum(m.preemptions > 0
                                        for m in metrics)),
        "preemptions": float(sum(m.preemptions for m in metrics)),
    }
