"""Slot scheduler and KV-page allocator (from ``repro.serving.scheduler``).

The engine decodes a fixed batch of ``num_slots`` rows; the scheduler
hands a freed row to the next waiting request. ``BlockAllocator`` owns the
paged pool's free list, per-page reference counts (a prefix-shared page
is held by every slot that mapped it) and the prefix-cache registry: a
chain hash over page-aligned prompt prefixes mapping to resident pages.
A page whose count drops to zero but that still backs a registered
prefix moves to an LRU of evictable cached pages; allocation takes free
pages first and evicts the oldest cached page only under pressure (its
registry entry dies with it). Free-list and eviction order are the JAX
package's, so the same calls give the same page ids.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.request import Request, RequestState

__all__ = ["BlockAllocator", "Scheduler"]


class BlockAllocator:
    """Refcounted page allocator and prefix-cache registry (host side)."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError(
                f"need num_pages/page_size >= 1, got {num_pages}/{page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        self._registry: Dict[bytes, int] = {}   # prefix chain key -> page
        self._page_key: Dict[int, bytes] = {}   # inverse, for eviction
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # ref 0, cached

    @property
    def available(self) -> int:
        """Pages allocatable right now (free and evictable cached)."""
        return len(self._free) + len(self._lru)

    @property
    def cached(self) -> int:
        """Unreferenced pages kept resident for prefix reuse."""
        return len(self._lru)

    @property
    def free(self) -> int:
        """Pages with no content and no registry entry."""
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Pages referenced by at least one slot."""
        return len(self._ref)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Reserve ``n`` pages (ref=1 each), or None if the pool can't;
        nothing is partially taken."""
        if n > self.available:
            return None
        out = []
        for _ in range(n):
            if self._free:
                p = self._free.pop()
            else:  # evict the oldest unreferenced cached page
                p, _ = self._lru.popitem(last=False)
                del self._registry[self._page_key.pop(p)]
            self._ref[p] = 1
            out.append(p)
        return out

    def retain(self, pages: Sequence[int]) -> None:
        """Take a reference on resident pages (prefix hits)."""
        for p in pages:
            if self._ref.get(p, 0) == 0:
                self._lru.pop(p, None)
            self._ref[p] = self._ref.get(p, 0) + 1

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            r = self._ref.get(p, 0) - 1
            if r < 0:
                raise ValueError(f"page {p} released more than retained")
            if r == 0:
                del self._ref[p]
                if p in self._page_key:
                    self._lru[p] = None   # stays resident, evictable
                else:
                    self._free.append(p)
            else:
                self._ref[p] = r

    # -- prefix registry ---------------------------------------------------

    @staticmethod
    def chain_keys(prompt, page_size: int) -> List[bytes]:
        """Rolling hash per full prompt page: key i commits to every
        token of pages 0..i, so one dict probe matches a whole chain."""
        arr = np.ascontiguousarray(np.asarray(prompt, np.int32))
        keys, h = [], b""
        for i in range(len(arr) // page_size):
            h = hashlib.sha1(
                h + arr[i * page_size:(i + 1) * page_size].tobytes()).digest()
            keys.append(h)
        return keys

    def match(self, keys: Sequence[bytes]) -> List[int]:
        """Longest resident chain of full prefix pages (no refs taken)."""
        out = []
        for k in keys:
            p = self._registry.get(k)
            if p is None:
                break
            out.append(p)
        return out

    def register(self, key: bytes, page: int) -> None:
        """Publish ``page`` as the cached copy of chain ``key`` (first
        writer wins; a page backs at most one key)."""
        if key not in self._registry and page not in self._page_key:
            self._registry[key] = page
            self._page_key[page] = key


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
