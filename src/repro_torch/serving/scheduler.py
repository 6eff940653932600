"""Slot scheduler and KV-page allocator (from ``repro.serving.scheduler``).

The engine decodes a fixed batch of ``num_slots`` rows; the scheduler
hands a freed row to the next waiting request. ``BlockAllocator`` owns the
paged pool's free list and per-page reference counts. The prefix-cache
registry of the JAX package is not ported yet (it arrives with the
prefix cache).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.serving.request import Request, RequestState

__all__ = ["BlockAllocator", "Scheduler"]


class BlockAllocator:
    """Refcounted page allocator (host side)."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError(
                f"need num_pages/page_size >= 1, got {num_pages}/{page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: Dict[int, int] = {}

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Pages referenced by at least one slot."""
        return len(self._ref)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Reserve ``n`` pages (ref=1 each), or None if the pool can't;
        nothing is partially taken."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            r = self._ref.get(p, 0) - 1
            if r < 0:
                raise ValueError(f"page {p} released more than retained")
            if r == 0:
                del self._ref[p]
                self._free.append(p)
            else:
                self._ref[p] = r


class Scheduler:
    def __init__(self, num_slots: int,
                 allocator: Optional[BlockAllocator] = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self.allocator = allocator
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self.running: Dict[int, RequestState] = {}

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def has_free(self) -> bool:
        return bool(self._free)

    def admit(self, req: Request, now: float) -> RequestState:
        """Bind ``req`` to the lowest free slot."""
        slot = self._free.pop()
        rs = RequestState(request=req, slot=slot, t_admit=now)
        self.running[slot] = rs
        return rs

    def release(self, slot: int) -> Optional[RequestState]:
        rs = self.running.pop(slot, None)
        if rs is not None:
            self._free.append(slot)
            self._free.sort(reverse=True)
        return rs
