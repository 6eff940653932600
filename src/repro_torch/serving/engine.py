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
  through per-slot block tables, and the prefill writes through the
  slot's own block table. ``alloc_policy="reserve"`` takes a request's
  worst-case pages at admission (or it waits in the queue);
  ``"ondemand"`` takes only the prefill's pages and maps decode pages as
  the cursor reaches them, preempting the youngest running request by
  recompute when the pool runs dry (its tokens are kept; re-admission
  re-prefills prompt + generated[:-1] and resumes the sampler at the same
  event counter, so no token is re-emitted or re-drawn);
- **self-speculative decoding** (``speculate_k=k``): each cycle runs k
  greedy S=1 draft decodes with a ``draft_bitwidth`` re-grid view of the
  weights (built once per bitwidth through K7), rewinds every cursor,
  scores the k positions in one S=k verify forward with the serving
  weights, samples each position with the baseline's sample counter, and
  emits the longest agreeing prefix plus the target's next token. Every
  emitted token is the target's own sample, so the stream is the
  baseline engine's (up to the per-tensor activation scales of the
  larger verify batch). A slot that cannot host k positions sends the
  whole batch down the one-token step for that step.

Weights stay packed 8-bit LNS words: every projection runs K1 and K2,
paged attention K5, every sampled token K6 and every draft view K7 (on
CUDA tensors). Cache tensors are updated in place. ``abort`` cancels a
queued or running request and returns its slot and pages.

Not in this slice, and raising ``NotImplementedError``: the prefix cache,
serving across a device mesh, and the observability hooks.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.quantizer import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models.common import ArchConfig
from repro_torch.models.model import forward, init_caches, lm_head, to_device
from repro_torch.server.sampling import sample_logits, sampling_rows, set_row
from repro_torch.serving.metrics import RequestMetrics, summarize
from repro_torch.serving.request import Request, RequestQueue, RequestState
from repro_torch.serving.scheduler import BlockAllocator, Scheduler
from repro_torch.serving.spec import (SpecAutotuner, SpecConfig,
                                      build_draft_params, request_class,
                                      spec_supported)

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
                 speculate_k: int = 0, draft_bitwidth: int = 6,
                 spec_autotune: bool = False, mesh=None, observer=None,
                 device=None):
        if alloc_policy not in ("reserve", "ondemand"):
            raise ValueError(f"alloc_policy must be 'reserve' or "
                             f"'ondemand', got {alloc_policy!r}")
        if prefix_cache:
            raise NotImplementedError(
                "prefix_cache=True comes with the prefix-cache slice of the "
                "port")
        if mesh is not None:
            raise NotImplementedError(
                "serving across a device mesh comes with the distributed "
                "slice")
        if observer is not None:
            raise NotImplementedError(
                "observability hooks come with the gateway/obs slice")
        if not cfg.tie_embeddings:
            raise NotImplementedError(
                "serving an untied LM head comes with a later slice (the "
                "engine decodes the tied head once)")
        self.spec: Optional[SpecConfig] = None
        if speculate_k:
            reason = spec_supported(cfg)
            if reason is not None:
                raise ValueError(
                    f"speculative decoding unsupported here: {reason}")
            self.spec = SpecConfig(k=int(speculate_k),
                                   draft_bits=int(draft_bitwidth),
                                   autotune=bool(spec_autotune))
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
        self._ondemand = self.alloc_policy == "ondemand"
        # draft views (params, decoded tied head) by bitwidth, built on
        # first use and kept across reset()
        self._draft_views: Dict[int, tuple] = {}
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
        self.aborted: List[RequestState] = []
        self._run_sink: Optional[List[RequestMetrics]] = None
        self.decode_steps = 0
        self.prefills = 0
        self.prefill_tokens = 0
        # on-demand paging: states parked by preemption (rid -> state; the
        # request itself waits at the queue head) and growth counters
        self._preempted: Dict[int, RequestState] = {}
        self.preemptions = 0
        self.decode_page_allocs = 0
        # speculative decoding counters (zero when spec is off)
        self.spec_cycles = 0             # draft+verify cycles
        self.spec_draft_steps = 0        # draft decodes (k per cycle)
        self.spec_verify_steps = 0       # S=k verify passes (1 per cycle)
        self.spec_drafted = 0            # draft tokens scored (live slots)
        self.spec_accepted = 0           # drafts the target agreed with
        self.spec_emitted = 0            # tokens delivered by spec cycles
        self.spec_fallbacks = 0          # steps sent down the 1-token path
        self.spec_pages_trimmed = 0      # overshoot pages returned
        self._tuner: Optional[SpecAutotuner] = None
        if self.spec is not None:
            self._spec_arm = (self.spec.draft_bits, self.spec.k)
            if self.spec.autotune:
                self._tuner = SpecAutotuner(self.spec)
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

    def _reserve_pages(self, req: Request,
                       n_tokens: int) -> Optional[List[int]]:
        """The pages admission takes for ``req``, or None (nothing held)
        if the pool cannot host it now. ``n_tokens`` is what the prefill
        writes: the prompt, plus the tokens generated before a
        preemption. ``reserve`` takes the whole budget up front,
        ``ondemand`` only the prefill's pages."""
        need = (-(-n_tokens // self.page_size) if self._ondemand
                else self._pages_for(req.prompt_len, req.max_new_tokens))
        return self.allocator.alloc(need)

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
        g = len(rs.generated)
        if g:
            # resuming a preempted request: recompute the evicted KV from
            # the prompt plus every delivered token but the last (which
            # seeds decoding and, like a fresh prefill's token, is never
            # cached)
            prompt = np.concatenate(
                [prompt, np.asarray(rs.generated[:-1], np.int32)])
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
        if g:
            # every generated token was delivered already; the sampler
            # resumes at event g, so no token is re-drawn
            tok = rs.generated[-1]
            self._samp["step"][rs.slot] = g
        else:
            row = {k: v[rs.slot:rs.slot + 1] for k, v in self._samp.items()}
            tok = int(sample_logits(logits, row).cpu()[0])
            self._samp["step"][rs.slot] = 1
        self.prefills += 1
        self.prefill_tokens += bucket
        self._slot_len[rs.slot] = plen
        self._last_tok[rs.slot] = tok
        if not g:
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
        if reason == "aborted":
            self.aborted.append(rs)
            return
        self.finished.append(rs)
        m = RequestMetrics.from_state(rs, truncated=reason == "capacity")
        self.completed.append(m)
        if self._run_sink is not None:
            self._run_sink.append(m)

    def abort(self, rid: int, now: Optional[float] = None) -> bool:
        """Cancel a queued or running request. A running one releases its
        slot and pages at once; the co-batched rows keep their cache rows,
        cursors and sampling chains. False if ``rid`` is not live here."""
        clock = self._now if now is None else (lambda: now)
        if self.queue.remove(rid) is not None:
            # a preempted request waits in the queue with its state
            # parked; its pages went back at eviction
            rs = self._preempted.pop(rid, None)
            if rs is not None:
                rs.t_finish = clock()
                rs.finish_reason = "aborted"
                self.aborted.append(rs)
            return True
        for rs in self.scheduler.running.values():
            if rs.request.rid == rid:
                self._finish(rs, clock, "aborted")
                return True
        return False

    # ------------------------------------------------------------------
    # on-demand paging: decode-time growth and preemption by recompute

    @staticmethod
    def _age(rs: RequestState):
        """Total order on running requests, oldest first (victim choice
        and growth priority must agree, or progress is not guaranteed)."""
        return (rs.t_admit, rs.request.arrival, rs.request.rid)

    def _preempt(self, rs: RequestState) -> None:
        """Evict a running request: its slot, sampler row and pages are
        released, its state parks in ``_preempted`` and the request goes
        back to the head of the queue."""
        self.preemptions += 1
        rs.preemptions += 1
        self._preempted[rs.request.rid] = rs
        self._release_slot(rs)
        self.queue.requeue(rs.request)

    def _write_span(self, rs: RequestState, lookahead: int) -> tuple:
        """Positions ``[n, last]`` the next ``lookahead`` decode writes of
        ``rs`` may touch, clamped to the request's own page demand (its
        final budgeted token is returned, never cached); the next write
        position is always in it."""
        n = int(self._slot_len[rs.slot])
        req = rs.request
        limit = min(req.prompt_len + max(req.max_new_tokens - 1, 0),
                    self.max_len)
        return n, min(n + lookahead, max(limit, n + 1)) - 1

    def _grow_decode_pages(self, lookahead: int = 1) -> None:
        """Map fresh pages under every running slot whose next
        ``lookahead`` writes reach unmapped pages, oldest request first.
        When the pool is dry the youngest running request yields
        (preemption by recompute) until the page is found; the oldest is
        never a victim, so progress is guaranteed."""
        page = self.page_size
        for rs in sorted(self.scheduler.running.values(), key=self._age):
            if self.scheduler.running.get(rs.slot) is not rs:
                continue  # evicted by an older slot's growth this step
            n, last = self._write_span(rs, lookahead)
            bt = self._block_tables[rs.slot]
            for pi in range(n // page,
                            min(last // page, self._max_pages - 1) + 1):
                if bt[pi] != self._null_page:
                    continue
                got = self.allocator.alloc(1)
                while got is None:
                    victim = max((v for v in self.scheduler.running.values()
                                  if v is not rs), key=self._age,
                                 default=None)
                    if victim is None:
                        victim = rs  # alone and still starved: yield
                    self._preempt(victim)
                    if victim is rs:
                        break
                    got = self.allocator.alloc(1)
                if got is None:
                    break  # rs evicted itself; its row idles this step
                bt[pi] = got[0]
                self._slot_pages[rs.slot].append(got[0])
                self.decode_page_allocs += 1

    def _trim_overshoot(self, rs: RequestState) -> None:
        """Return the pages mapped for a cycle's rejected drafts: every
        page wholly past the next write position (only decode growth
        maps pages out there)."""
        keep = int(self._slot_len[rs.slot]) // self.page_size
        bt = self._block_tables[rs.slot]
        pages = self._slot_pages[rs.slot]
        for pi in range(keep + 1, self._max_pages):
            pid = int(bt[pi])
            if pid == self._null_page:
                continue
            self.allocator.release([pid])
            pages.remove(pid)
            bt[pi] = self._null_page
            self.spec_pages_trimmed += 1

    # ------------------------------------------------------------------
    # speculative decoding

    def _draft_params(self, bits: int):
        """The cached draft view at ``bits`` and its decoded tied head;
        at the serving width, the serving weights and head themselves."""
        view = self._draft_views.get(bits)
        if view is None:
            dparams = build_draft_params(self.params, bits)
            head = (self._head if dparams is self.params
                    else lm_head(dparams, self.cfg))
            view = self._draft_views[bits] = (dparams, head)
        return view

    def _spec_ready(self, k: int) -> bool:
        """Every running slot can host a k-token span: the dense row write
        must not clamp at capacity, and (paged) every page a surviving
        write could land in is mapped."""
        for rs in self.scheduler.running.values():
            n = int(self._slot_len[rs.slot])
            if n + k > self.max_len:
                return False
            if self.page_size:
                _, last = self._write_span(rs, k)
                bt = self._block_tables[rs.slot]
                for pi in range(n // self.page_size,
                                last // self.page_size + 1):
                    if bt[pi] == self._null_page:
                        return False
        return True

    def _spec_cycle(self, bits: int, k: int):
        """One draft -> verify -> rewind cycle on the device, then one copy
        to the host. Returns ``(s, acc, m)``: the target's samples
        ``(B, k)``, the accepted-draft count and the emitted count
        ``m = min(acc + 1, k)`` per row.

        The drafts write their KV at ``pos..pos+k-1``; the verify rewinds
        every layer's cursor to ``pos`` and overwrites those positions
        with the serving weights' KV, so an accepted position holds what
        the baseline would have written. Writes past ``pos + m`` are
        masked once the cursors move back, and overwritten before they
        become visible."""
        dparams, dhead = self._draft_params(bits)
        idx = self.caches["period"]["pos0"]["idx"]
        bt = (self._tensor(self._block_tables) if self.page_size else None)
        pos = self._tensor(self._slot_len)
        last = self._tensor(self._last_tok)
        cur, drafts = last, []
        for j in range(k):
            logits = forward(dparams, cur[:, None], self.cfg, self.qcfg,
                             caches=self.caches, pos_offset=pos + j,
                             block_tables=bt, head=dhead)[:, -1]
            cur = dispatch.fused_sample(logits.to(torch.float32).contiguous(),
                                        None, None)
            drafts.append(cur)
        draft = torch.stack(drafts, dim=1)                      # (B, k)
        idx[:] = pos
        x = torch.cat([last[:, None], draft[:, :-1]], dim=1)
        logits = forward(self.params, x, self.cfg, self.qcfg,
                         caches=self.caches, pos_offset=pos,
                         block_tables=bt, head=self._head)      # (B, k, V)
        B = self.num_slots
        # position j of row b samples with the baseline's counter step + j
        rows = {n: np.repeat(v, k) for n, v in self._samp.items()}
        s = sample_logits(logits.reshape(B * k, -1), rows,
                          step_offset=np.tile(np.arange(k), B)).reshape(B, k)
        acc = torch.cumprod((draft == s).to(torch.int64), dim=1).sum(dim=1)
        m = torch.clamp(acc + 1, max=k)
        idx[:] = (pos + m).to(idx.dtype)
        out = torch.cat([s.to(torch.int64), acc[:, None], m[:, None]],
                        dim=1).cpu().numpy()
        return out[:, :k], out[:, k], out[:, k + 1]

    def _spec_step(self, clock, k: int) -> None:
        """Run one cycle and apply it on the host: emit each live row's
        accepted run plus the bonus token, stopping at a terminal token,
        advance the cursor and sampler mirrors of every row by its
        emitted count (idle rows too, as the baseline advances every row
        by one), and return overshoot pages."""
        bits, _ = self._spec_arm
        t0 = time.monotonic()
        pos0 = self._slot_len.copy()
        s, acc, m = self._spec_cycle(bits, k)
        self.spec_cycles += 1
        self.spec_draft_steps += k
        self.spec_verify_steps += 1
        self._slot_len = pos0 + m
        self._samp["step"] += m.astype(np.int32)
        self._last_tok = s[np.arange(self.num_slots), m - 1].astype(np.int32)
        emitted = 0
        per_class: Dict[str, Any] = {}
        for slot, rs in list(self.scheduler.running.items()):
            a = int(acc[slot])
            self.spec_drafted += k
            self.spec_accepted += a
            rs.spec_cycles += 1
            rs.spec_drafted += k
            rs.spec_accepted += a
            if self._tuner is not None:
                cls = request_class(rs.request)
                ca, cd = per_class.get(cls, (0, 0))
                per_class[cls] = (ca + a, cd + k)
            for j in range(int(m[slot])):
                rs.generated.append(int(s[slot, j]))
                emitted += 1
                if rs.done:
                    # the run's later tokens are not in the baseline's
                    # stream: drop them
                    break
            self._maybe_finish(rs, clock)
            if self._ondemand and self.scheduler.running.get(slot) is rs:
                self._trim_overshoot(rs)
        self.spec_emitted += emitted
        if self._tuner is not None:
            self._tuner.observe(self._spec_arm, emitted,
                                time.monotonic() - t0, per_class)
            self._spec_arm = self._tuner.propose()

    @property
    def spec_accept_rate(self) -> float:
        return (self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0)

    def spec_snapshot(self) -> Optional[Dict[str, Any]]:
        """Flat JSON-safe dict of the speculative-decoding state (None
        when speculation is off)."""
        if self.spec is None:
            return None
        snap: Dict[str, Any] = {
            "spec_cycles": self.spec_cycles,
            "spec_draft_steps": self.spec_draft_steps,
            "spec_verify_steps": self.spec_verify_steps,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_emitted": self.spec_emitted,
            "spec_fallbacks": self.spec_fallbacks,
            "spec_pages_trimmed": self.spec_pages_trimmed,
            "spec_accept_rate": round(self.spec_accept_rate, 4),
            "spec_draft_bits": self._spec_arm[0],
            "spec_k": self._spec_arm[1],
        }
        if self._tuner is not None:
            snap.update(self._tuner.snapshot())
        return snap

    # ------------------------------------------------------------------
    # the loop

    def step(self, now: Optional[float] = None) -> bool:
        """Admit ready requests, map on-demand pages, then advance every
        slot one token, or one speculative cycle (1..k tokens). Returns
        False when nothing ran."""
        clock = self._now if now is None else (lambda: now)
        while self.scheduler.has_free():
            req = self.queue.pop_ready(clock())
            if req is None:
                break
            pages = None
            resume = self._preempted.get(req.rid)
            if self.page_size:
                n_tok = req.prompt_len
                if resume is not None:
                    n_tok += len(resume.generated) - 1
                pages = self._reserve_pages(req, n_tok)
                if pages is None:  # pool exhausted: wait for a release
                    self.queue.requeue(req)
                    break
            rs = self.scheduler.admit(req, clock())
            if resume is not None:
                # continuity across preemption: the same token list (the
                # resume prefill keys off it), timestamps and counters
                del self._preempted[req.rid]
                for f in ("generated", "t_admit", "t_first_token",
                          "spec_cycles", "spec_drafted", "spec_accepted",
                          "preemptions"):
                    setattr(rs, f, getattr(resume, f))
            self._admit(rs, clock, pages)
        spec_k = self._spec_arm[1] if self.spec is not None else 0
        if self._ondemand:
            self._grow_decode_pages(lookahead=max(spec_k, 1))
        if not self.scheduler.running:
            return False
        if spec_k:
            if self._spec_ready(spec_k):
                self._spec_step(clock, spec_k)
                return True
            # a slot near capacity or an unmapped page under pool
            # pressure: every row advances one plain token this step
            self.spec_fallbacks += 1

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
