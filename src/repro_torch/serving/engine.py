"""Continuous-batching engine over the packed-LNS decode path.

The PyTorch counterpart of ``repro.serving.engine.Engine``, with the same
scheduling, so the same trace gives the same token streams:

- a fixed decode batch of ``num_slots`` rows; each row is a slot with its
  own cache cursor, so a freed slot restarts at position 0 while its
  neighbours keep decoding; idle rows keep decoding too (their tokens are
  dropped), exactly as in the JAX engine, because the per-tensor
  activation scales couple the rows of a batch;
- admission prefills the prompt at batch 1 through the decode path, right
  padded to a shape bucket, then binds the slot with the cursor at the
  true prompt length;
- **dense** KV layout (default): one ``(num_slots, max_len)`` buffer per
  layer; the prefill runs over a fresh batch-1 buffer that is copied into
  the slot's row;
- **paged** layout (``page_size=...``): one pool of pages per layer shared
  through per-slot block tables; admission reserves the request's
  worst-case pages up front (``alloc_policy="reserve"``) or waits in the
  queue, and the prefill writes through the slot's own block table.

Weights stay packed 8-bit LNS words: every projection runs K1 and K2,
paged attention K5 and every sampled token K6 (on CUDA tensors). Cache
tensors are updated in place.

Not in this slice, and raising ``NotImplementedError``: the prefix cache
and on-demand paging (with the prefix-cache slice), speculative decoding
(needs the requant kernel), serving across a device mesh, and the
observability hooks.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.quantizer import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import ArchConfig
from repro_torch.models.model import forward, init_caches, lm_head, to_device
from repro_torch.server.sampling import sample_logits, sampling_rows, set_row
from repro_torch.serving.metrics import RequestMetrics, summarize
from repro_torch.serving.request import Request, RequestQueue, RequestState
from repro_torch.serving.scheduler import BlockAllocator, Scheduler

__all__ = ["Engine", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


class Engine:
    """Continuous-batching serving engine. See module docstring."""

    def __init__(self, cfg: ArchConfig, qcfg: Optional[QuantConfig],
                 params: Any, *, num_slots: int = 4, max_len: int = 256,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache: bool = False, alloc_policy: str = "reserve",
                 speculate_k: int = 0, mesh=None, observer=None,
                 device=None):
        if alloc_policy not in ("reserve", "ondemand"):
            raise ValueError(f"alloc_policy must be 'reserve' or "
                             f"'ondemand', got {alloc_policy!r}")
        for flag, what in ((prefix_cache, "prefix_cache=True"),
                           (page_size and alloc_policy == "ondemand",
                            "alloc_policy='ondemand'")):
            if flag:
                raise NotImplementedError(
                    f"{what} comes with the prefix-cache slice of the port")
        if speculate_k:
            raise NotImplementedError(
                "speculative decoding comes with the slice that ports the "
                "requant kernel (K7)")
        if mesh is not None:
            raise NotImplementedError(
                "serving across a device mesh comes with the distributed "
                "slice")
        if observer is not None:
            raise NotImplementedError(
                "observability hooks come with the gateway/obs slice")
        self.device = resolve_device(device)
        self.cfg, self.qcfg = cfg, qcfg
        self.params = to_device(params, self.device)
        self._head = lm_head(self.params, cfg)
        self.num_slots, self.max_len = num_slots, max_len
        self.buckets = tuple(sorted(b for b in buckets if b <= max_len))
        self.page_size = page_size or None
        if self.page_size:
            self._max_pages = -(-max_len // page_size)
            self.num_pages = num_pages or num_slots * self._max_pages
            self._null_page = self.num_pages
        else:
            self.num_pages = 0
        self.alloc_policy = alloc_policy if self.page_size else None
        self._reset_state()

    def _reset_state(self) -> None:
        self.caches = init_caches(self.num_slots, self.max_len, self.cfg,
                                  page_size=self.page_size,
                                  num_pages=self.num_pages or None,
                                  device=self.device)
        allocator = None
        if self.page_size:
            allocator = BlockAllocator(self.num_pages, self.page_size)
            self._block_tables = np.full(
                (self.num_slots, self._max_pages), self._null_page, np.int32)
            self._slot_pages: List[Optional[List[int]]] = \
                [None] * self.num_slots
        self.scheduler = Scheduler(self.num_slots, allocator=allocator)
        self.queue = RequestQueue()
        self._slot_len = np.zeros((self.num_slots,), np.int64)
        self._last_tok = np.zeros((self.num_slots,), np.int32)
        self._samp = sampling_rows(self.num_slots)
        self.completed: List[RequestMetrics] = []
        self.finished: List[RequestState] = []
        self._run_sink: Optional[List[RequestMetrics]] = None
        self.decode_steps = 0
        self.prefills = 0
        self.prefill_tokens = 0
        self._t0 = time.monotonic()

    @property
    def allocator(self) -> Optional[BlockAllocator]:
        return self.scheduler.allocator

    def reset(self) -> None:
        """Clear all request and slot state (a warm engine re-runs)."""
        self._reset_state()

    # ------------------------------------------------------------------
    # admission checks

    def _bucket(self, plen: int) -> int:
        for b in self.buckets:
            if b >= plen:
                return b
        return plen

    def _pages_for(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case pages of a request: its prompt plus its budget's
        decode writes (the last token is returned, never cached)."""
        n_pos = min(prompt_len + max(max_new_tokens - 1, 0), self.max_len)
        return -(-n_pos // self.page_size)

    def validate(self, prompt: Sequence, max_new_tokens: int = 0) -> None:
        """Raise ValueError for a request that can never be hosted."""
        arr = np.asarray(prompt)
        if arr.size and not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"prompt must hold integer token ids, got "
                             f"dtype {arr.dtype}")
        if arr.ndim != 1:
            raise ValueError(f"model expects a flat list of token ids, got "
                             f"shape {arr.shape}")
        if arr.shape[0] < 1:
            raise ValueError("prompt must hold at least one token")
        lo, hi = int(arr.min()), int(arr.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            raise ValueError(f"prompt token ids must be in [0, "
                             f"{self.cfg.vocab_size}), got [{lo}, {hi}]")
        if arr.shape[0] > self.max_len:
            raise ValueError(f"prompt len {arr.shape[0]} exceeds engine "
                             f"max_len {self.max_len}")
        if self.page_size:
            need = self._pages_for(arr.shape[0], max_new_tokens)
            if need > self.num_pages:
                raise ValueError(f"needs {need} KV pages, pool holds "
                                 f"{self.num_pages}")

    def submit(self, req: Request) -> None:
        try:
            self.validate(req.prompt, req.max_new_tokens)
        except ValueError as e:
            raise ValueError(f"request {req.rid}: {e}") from None
        self.queue.push(req)

    def _now(self) -> float:
        return time.monotonic() - self._t0

    # ------------------------------------------------------------------
    # prefill

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _prefill_dense(self, tokens: np.ndarray, n: int, slot: int):
        """Batch-1 prefill over a fresh zero cache, copied into the slot's
        row with the cursor at the true prompt length ``n``."""
        mini = init_caches(1, self.max_len, self.cfg, device=self.device)
        logits = forward(self.params, self._tensor(tokens), self.cfg,
                         self.qcfg, caches=mini, pos_offset=0,
                         head=self._head)[:, n - 1]
        big, small = self.caches["period"]["pos0"], mini["period"]["pos0"]
        for key, buf in big.items():
            if key == "idx":
                buf[:, slot] = n
            else:
                buf[:, slot] = small[key][:, 0]
        return logits

    def _prefill_paged(self, tokens: np.ndarray, n: int, slot: int,
                       table: np.ndarray):
        """Batch-1 prefill that writes through the slot's block table into
        the shared pools; bucket padding past the table's span drops."""
        big = self.caches["period"]["pos0"]
        mini = {k: v for k, v in big.items() if k != "idx"}
        mini["idx"] = torch.zeros((self.cfg.num_layers, 1), dtype=torch.int32,
                                  device=self.device)
        logits = forward(self.params, self._tensor(tokens), self.cfg,
                         self.qcfg, caches={"period": {"pos0": mini}},
                         pos_offset=0,
                         block_tables=self._tensor(table[None]),
                         head=self._head)[:, n - 1]
        big["idx"][:, slot] = n
        return logits

    def _admit(self, rs: RequestState, clock,
               pages: Optional[List[int]]) -> None:
        req = rs.request
        prompt = np.asarray(req.prompt, np.int32)
        plen = len(prompt)
        bucket = self._bucket(plen)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :plen] = prompt
        if self.page_size:
            bt = np.full((self._max_pages,), self._null_page, np.int32)
            bt[:len(pages)] = pages
            logits = self._prefill_paged(tokens, plen, rs.slot, bt)
            self._block_tables[rs.slot] = bt
            self._slot_pages[rs.slot] = pages
        else:
            logits = self._prefill_dense(tokens, plen, rs.slot)
        set_row(self._samp, rs.slot, req.sampling)  # sample event 0
        row = {k: v[rs.slot:rs.slot + 1] for k, v in self._samp.items()}
        tok = int(sample_logits(logits, row).cpu()[0])
        self._samp["step"][rs.slot] = 1
        self.prefills += 1
        self.prefill_tokens += bucket
        self._slot_len[rs.slot] = plen
        self._last_tok[rs.slot] = tok
        rs.generated.append(tok)
        rs.t_first_token = clock()
        self._maybe_finish(rs, clock)

    # ------------------------------------------------------------------
    # finish / release

    def _maybe_finish(self, rs: RequestState, clock) -> None:
        full = self._slot_len[rs.slot] >= self.max_len
        if rs.done or full:
            budget = len(rs.generated) >= rs.request.max_new_tokens
            reason = ("stop" if rs.hit_stop else
                      "length" if budget else "capacity")
            self._finish(rs, clock, reason)

    def _release_slot(self, rs: RequestState) -> None:
        self.scheduler.release(rs.slot)
        set_row(self._samp, rs.slot, None)  # idle slots sample greedy
        if self.page_size:
            pages = self._slot_pages[rs.slot]
            if pages:
                self.allocator.release(pages)
            self._slot_pages[rs.slot] = None
            # stale decode writes of the idle row land in the null page
            self._block_tables[rs.slot] = self._null_page

    def _finish(self, rs: RequestState, clock, reason: str) -> None:
        rs.t_finish = clock()
        rs.finish_reason = reason
        self._release_slot(rs)
        self.finished.append(rs)
        m = RequestMetrics.from_state(rs, truncated=reason == "capacity")
        self.completed.append(m)
        if self._run_sink is not None:
            self._run_sink.append(m)

    # ------------------------------------------------------------------
    # the loop

    def step(self, now: Optional[float] = None) -> bool:
        """Admit ready requests, then advance every slot one token.
        Returns False when nothing ran."""
        clock = self._now if now is None else (lambda: now)
        while self.scheduler.has_free():
            req = self.queue.pop_ready(clock())
            if req is None:
                break
            pages = None
            if self.page_size:
                pages = self.allocator.alloc(
                    self._pages_for(req.prompt_len, req.max_new_tokens))
                if pages is None:  # pool exhausted: wait for a release
                    self.queue.requeue(req)
                    break
            rs = self.scheduler.admit(req, clock())
            self._admit(rs, clock, pages)
        if not self.scheduler.running:
            return False

        block_tables = (self._tensor(self._block_tables)
                        if self.page_size else None)
        logits = forward(self.params, self._tensor(self._last_tok[:, None]),
                         self.cfg, self.qcfg, caches=self.caches,
                         pos_offset=self._tensor(self._slot_len),
                         block_tables=block_tables, head=self._head)[:, -1]
        toks = sample_logits(logits, self._samp).cpu().numpy()
        self.decode_steps += 1
        self._slot_len += 1
        self._samp["step"] += 1
        self._last_tok = toks.astype(np.int32)
        for slot, rs in list(self.scheduler.running.items()):
            rs.generated.append(int(toks[slot]))
            self._maybe_finish(rs, clock)
        return True

    def run(self, requests: Sequence[Request] = ()) -> Dict[str, float]:
        """Drive the requests to completion; aggregate metrics of the
        requests this call completed."""
        for r in requests:
            self.submit(r)
        self._run_sink = sink = []
        self._t0 = time.monotonic()
        try:
            while self.queue or self.scheduler.running:
                if not self.step():
                    nxt = self.queue.next_arrival()
                    if nxt is not None:
                        time.sleep(min(max(nxt - self._now(), 0.0), 0.05))
        finally:
            self._run_sink = None
        return summarize(sink, self._now())
