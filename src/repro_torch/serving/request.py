"""Request lifecycle for the continuous-batching serving engine (a copy of
``repro.serving.request``, which cannot be imported without JAX).

A ``Request`` is a prompt plus a generation budget; a ``RequestState`` is a
request bound to a decode slot, accumulating generated tokens and the
timestamps the metrics layer reads (arrival -> admit -> first token ->
finish). ``RequestQueue`` is the arrival-ordered waiting line the scheduler
drains into freed slots.

Stop handling: ``eos_id`` accepts a single token id **or any iterable of
ids** — instruct checkpoints routinely emit several terminators
(``<|eot|>`` + ``<|eos|>``), and codebook stacks stop when every codebook's
token is a stop id. The per-request ``sampling`` params (see
``repro_torch.server.sampling.SamplingParams``) may carry additional stop ids;
``stop_ids`` is the union the engine actually checks.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, FrozenSet, Iterable, List, Optional, Sequence, Union

__all__ = ["Request", "RequestState", "RequestQueue"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Sequence[int]            # token ids; rows may be per-codebook
    max_new_tokens: int
    arrival: float = 0.0             # seconds relative to engine start
    eos_id: Union[int, Iterable[int], None] = None
    sampling: Optional[Any] = None   # SamplingParams; None => greedy

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def stop_ids(self) -> FrozenSet[int]:
        """Every token id that terminates this request (eos + sampling).
        Memoized — it is consulted per generated token on the decode hot
        path, and neither input field mutates after construction."""
        memo = self.__dict__.get("_stop_ids")
        if memo is None:
            eos = self.eos_id
            if eos is None:
                memo = frozenset()
            elif isinstance(eos, int) or hasattr(eos, "item"):
                memo = frozenset({int(eos)})
            else:
                memo = frozenset(int(t) for t in eos)
            extra = getattr(self.sampling, "stop", None)
            if extra:
                memo |= frozenset(extra)
            self.__dict__["_stop_ids"] = memo
        return memo


@dataclasses.dataclass
class RequestState:
    request: Request
    slot: int
    t_admit: float
    generated: List = dataclasses.field(default_factory=list)
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    # terminal disposition: "stop" (stop token), "length" (budget),
    # "capacity" (cache full -> truncated), "aborted" (cancelled)
    finish_reason: Optional[str] = None
    # speculative decoding accounting (filled when a spec cycle covered
    # this request's slot): cycles seen, draft tokens scored for it, and
    # how many of those the verify pass accepted
    spec_cycles: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    # times on-demand paging evicted this request (it resumed by
    # recomputing its KV)
    preemptions: int = 0

    @property
    def aborted(self) -> bool:
        return self.finish_reason == "aborted"

    @property
    def hit_stop(self) -> bool:
        """Last generated token is in the request's stop set (all
        codebooks must agree on a multi-codebook stack)."""
        stops = self.request.stop_ids
        if not stops or not self.generated:
            return False
        last = self.generated[-1]
        if isinstance(last, (list, tuple)):  # multi-codebook step
            return all(t in stops for t in last)
        return last in stops

    @property
    def done(self) -> bool:
        return (len(self.generated) >= self.request.max_new_tokens
                or self.hit_stop)


class RequestQueue:
    """FIFO over arrival time: a request becomes admissible once the
    engine clock passes its ``arrival`` (open-loop trace replay)."""

    def __init__(self, requests: Iterable[Request] = ()):
        self._q: deque = deque(sorted(requests, key=lambda r: r.arrival))

    def push(self, req: Request) -> None:
        if self._q and req.arrival < self._q[-1].arrival:
            items = sorted([*self._q, req], key=lambda r: r.arrival)
            self._q = deque(items)
        else:
            self._q.append(req)

    def pop_ready(self, now: float) -> Optional[Request]:
        if self._q and self._q[0].arrival <= now:
            return self._q.popleft()
        return None

    def requeue(self, req: Request) -> None:
        """Put a just-popped request back at the head (admission failed —
        e.g. the KV-page pool can't host it yet). Arrival order holds
        because ``req`` was the head a moment ago."""
        self._q.appendleft(req)

    def remove(self, rid: int) -> Optional[Request]:
        """Cancel a still-queued request; returns it, or None if ``rid``
        is not waiting here (already admitted, finished, or unknown)."""
        for i, r in enumerate(self._q):
            if r.rid == rid:
                del self._q[i]
                return r
        return None

    def next_arrival(self) -> Optional[float]:
        return self._q[0].arrival if self._q else None

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
