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
  the slot's row of every layer;
- sliding-window layers (gemma3's ``local`` kind) keep a per-slot ring of
  ``sliding_window`` positions in either layout, plus ``k`` with
  speculation so a rewind never lets the write head lap a position still
  in the window; a prefill bucket never exceeds the window (the exact
  prompt length is used instead), and the prefix cache is off, as the
  rings would miss the skipped tokens;
- **paged** layout (``page_size=...``): one pool of pages per layer shared
  through per-slot block tables, and the prefill writes through the
  slot's own block table. With ``prefix_cache`` (the default) the
  allocator keeps a chain hash over page-aligned prompt prefixes: a hit
  maps the resident pages into the new slot's block table and prefills
  only the suffix at ``pos_offset = n_cached`` (a partly reused boundary
  page is copied first, copy-on-write). ``alloc_policy="reserve"`` takes a
  request's worst-case pages at admission (or it waits in the queue);
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

Recurrent models (rwkv6's ``rwkv`` layers, zamba2's ``mamba`` layers):
each slot keeps an f32 state row a layer in place of KV, prefilled at the
exact prompt length from a zero state (a preempted request re-prefills
from zero); zamba2's shared attention layers page as usual, rwkv6 has no
pageable layer and stays dense whatever ``page_size`` says, as in the
JAX engine. Neither reuses prefixes, and speculation is refused
(``spec_supported``).

Codebook models (musicgen, ``cfg.num_codebooks`` = K): a prompt is
``(len, K)`` id rows, every prefill and decode carries a row of K ids a
position, the sampler reads the ``(B, K * V)`` logits as ``B * K`` rows,
and a generated token is a list of K ids; the prefix cache hashes the
rows as the JAX engine does; speculation is refused (``spec_supported``).

Weights stay packed 8-bit LNS words: every projection runs K1 and K2
(an untied LM head too; a tied head is decoded once), paged attention K5,
every sampled token K6 and every draft view K7 (on CUDA tensors). Cache
tensors are updated in place. ``abort`` cancels a queued or running
request and returns its slot and pages.

Online serving (``repro_torch.server``): each appended token fires
``token_sink`` and each terminal transition ``finish_sink``;
``drain_finished`` bounds the archives for long-lived callers; a request
whose admission raises finishes alone with reason ``"error"`` (its slot
and pages unwound), until ``ADMIT_FAIL_TRIP`` failures in a row say the
engine itself is broken and ``step`` re-raises.

Observability (``repro_torch.obs``): an attached ``EngineObserver``
(``observer=`` or ``attach_observer``) sees admission, prefill,
preemption, finish, a queued abort, every decode step and every spec
cycle, at the JAX engine's hook sites, stamped with ``now()``. Each site
is one ``if obs is not None``: without an observer no clock is read and
nothing is allocated.

Mesh serving (``mesh=``, a ``repro_torch.launch.mesh.Mesh``): one
engine a rank, one rank a card, every rank running the same host
scheduler, allocator and prefix registry over one logical block table.
The weights and KV are this rank's shard under ``serving_rules``
(``distributed.params_sharding``): query and KV heads split over the
``model`` axis where both head counts divide it (pools and rings hold
``KV/m`` heads a rank), the MLP's ``up``/``gate`` where ``d_ff`` does,
experts where their count does; embedding, head, ``wo`` and ``down``
stay replicated, so the logits and every K6 draw are the same on every
rank. The forward gathers activations before each replicated GEMM and
max-reduces each per-tensor scale of a sharded tensor; no sum crosses
ranks, so the streams are one device's. The ranks step in lockstep:
rank 0 alone takes ``submit`` and ``abort`` and its clock alone gates
arrivals; at the top of every step it broadcasts its clock, the
submissions and aborts since the last step, the speculation arm,
whether a numerics snapshot is wanted and whether the ranks stop.
Victims and growth order by admission order. ``run`` drives all ranks
(rank 0 with the requests); under the gateway rank 0's driver thread
calls ``step`` and the other ranks :meth:`Engine.follow`, until
:meth:`Engine.stop_followers`. The recurrent families serve too: their
time mix and Mamba2 mixer are replicated (``ssm_inner`` is whole under
the serving rules), so every rank computes them and holds the whole
state a slot; rwkv6's channel mix is column-parallel over ``ck``;
zamba2's shared block is head-parallel, its LoRA-merged QKV computed at
the whole width on every rank (``distributed.params_sharding``).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.quantizer import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import broadcast_object, sum_reduce
from repro_torch.distributed.params_sharding import shard_tree, split_axes
from repro_torch.distributed.sharding import serving_rules, shard_ctx
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import ArchConfig
from repro_torch.models.model import forward, init_caches, lm_head, to_device
from repro_torch.obs.numerics import tree_code_stats
from repro_torch.server.sampling import sample_logits, sampling_rows, set_row
from repro_torch.serving.metrics import RequestMetrics, summarize
from repro_torch.serving.request import Request, RequestQueue, RequestState
from repro_torch.serving.scheduler import BlockAllocator, Scheduler
from repro_torch.serving.spec import (SpecAutotuner, SpecConfig,
                                      build_draft_params,
                                      draft_requant_error, request_class,
                                      spec_supported)
from repro_torch.tree import tree_get

__all__ = ["Engine", "DEFAULT_BUCKETS", "ADMIT_FAIL_TRIP"]

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)

# consecutive admission failures after which step() re-raises instead of
# isolating them: one malformed request failing alone is serving as
# intended, every admission failing means the engine itself is broken
ADMIT_FAIL_TRIP = 8

# layer kinds whose KV can live in a paged pool; prefix reuse needs every
# stateful layer paged (others would never see the skipped tokens)
_PAGED_KINDS = frozenset({"dense", "global", "moe", "shared_attn"})
_POOL_KEYS = ("kp", "vp", "kp_scale", "vp_scale")


def _layer_caches(caches):
    """``(layer cache, stacked)`` of every cache group: each ``prefix``
    layer's, then each ``period`` position's stack (a leading layer
    axis)."""
    for c in caches.get("prefix", ()):
        yield c, False
    for c in caches.get("period", {}).values():
        yield c, True


def _map_layers(caches, fn):
    """The cache tree of ``fn(layer cache, stacked)``, shaped like
    ``caches``."""
    out: Dict[str, Any] = {}
    if "prefix" in caches:
        out["prefix"] = [fn(c, False) for c in caches["prefix"]]
    if "period" in caches:
        out["period"] = {k: fn(c, True) for k, c in caches["period"].items()}
    return out


def _set_cursors(caches, n) -> None:
    """Set every layer's cursor to ``n`` (a number or a ``(B,)`` row
    vector): ring layers and pools alike, so a speculative rewind moves
    them together. Recurrent state has no cursor."""
    for c, _ in _layer_caches(caches):
        if "idx" in c:
            c["idx"][...] = n


def _set_cursor_row(caches, slot: int, n: int) -> None:
    """Set row ``slot``'s cursor of every layer (that has one) to ``n``."""
    for c, _ in _layer_caches(caches):
        if "idx" in c:
            c["idx"][..., slot] = n


def _scatter_row(big, small, slot: int, stacked: bool) -> None:
    """Copy a batch-1 layer cache into row ``slot`` of ``big``."""
    for key, buf in big.items():
        if stacked:
            buf[:, slot] = small[key][:, 0]
        else:
            buf[slot] = small[key][0]


class Engine:
    """Continuous-batching serving engine. See module docstring."""

    def __init__(self, cfg: ArchConfig, qcfg: Optional[QuantConfig],
                 params: Any, *, num_slots: int = 4, max_len: int = 256,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefix_cache: bool = True, alloc_policy: str = "reserve",
                 speculate_k: int = 0, draft_bitwidth: int = 6,
                 spec_autotune: bool = False, mesh=None, observer=None,
                 checkpoint_id: Optional[str] = None, device=None,
                 sharded_params: bool = False):
        if alloc_policy not in ("reserve", "ondemand"):
            raise ValueError(f"alloc_policy must be 'reserve' or "
                             f"'ondemand', got {alloc_policy!r}")
        self._mesh = mesh
        self._mesh_rules = None
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a repro_torch.launch.mesh."
                                f"Mesh (make_host_mesh), got {type(mesh)}")
            if device is not None and torch.device(device).type != \
                    mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
            self._mesh_rules = serving_rules(cfg, mesh)
        self.spec: Optional[SpecConfig] = None
        if speculate_k:
            reason = spec_supported(cfg)
            if reason is not None:
                raise ValueError(
                    f"speculative decoding unsupported here: {reason}")
            self.spec = SpecConfig(k=int(speculate_k),
                                   draft_bits=int(draft_bitwidth),
                                   autotune=bool(spec_autotune))
        prefix, _, period = cfg.layer_pattern()
        kinds = set(prefix) | set(period)
        # recurrent state folds every position in: prefills run at the
        # exact prompt length (pads would enter the state)
        self._recurrent = bool(kinds & {"mamba", "rwkv"})
        self._window = cfg.sliding_window if "local" in kinds else None
        # ring layers over-allocate by the largest k a cycle drafts, so a
        # rewind never lets the write head lap a position still in the
        # window
        self._spec_slack = 0
        if self.spec is not None and self._window is not None:
            self._spec_slack = max(k for _, k in self.spec.arms()) \
                if self.spec.autotune else self.spec.k
        self.device = resolve_device(device)
        self.cfg, self.qcfg = cfg, qcfg
        # a token is one id, or one id a codebook
        self._tok_width = (cfg.num_codebooks,) if cfg.num_codebooks else ()
        self.params = self._place_params(params, sharded_params)
        # tied: the decoded embedding, once; untied: the packed embed.head,
        # which qeinsum routes through K1 and K2 every step
        self._head = lm_head(self.params, cfg)
        self.num_slots, self.max_len = num_slots, max_len
        self.buckets = tuple(sorted(b for b in buckets if b <= max_len))
        # pages only where some layer kind can be paged (rwkv6 has none:
        # its engine keeps the dense layout, with no allocator) and the
        # attention is not MLA (its latent cache stays dense)
        self.page_size = (page_size if page_size and not cfg.use_mla
                          and kinds & _PAGED_KINDS else None)
        if self.page_size:
            self._max_pages = -(-max_len // page_size)
            self.num_pages = num_pages or num_slots * self._max_pages
            self._null_page = self.num_pages
            # a skipped prefix is sound only when no layer keeps state
            # outside the pools (a ring would miss those tokens)
            self._prefix_ok = bool(prefix_cache) and kinds <= _PAGED_KINDS
        else:
            self.num_pages = 0
            self._prefix_ok = False
        self.alloc_policy = alloc_policy if self.page_size else None
        self._ondemand = self.alloc_policy == "ondemand"
        # draft views (params, head) by bitwidth, built on first use and
        # kept across reset()
        self._draft_views: Dict[int, tuple] = {}
        self._numerics_cache: Optional[Dict[str, Any]] = None
        # under a mesh: the last snapshot rank 0 handed out, and whether
        # the next step's broadcast asks every rank for a fresh one
        self._numerics_last: Dict[str, Any] = {}
        self._numerics_wanted = False
        # the gateway driver's taps, called from step()/_admit() with
        # (rid, token) and (rid, reason, RequestState | None)
        self.token_sink: Optional[Callable[[int, Any], None]] = None
        self.finish_sink: Optional[
            Callable[[int, str, Optional[RequestState]], None]] = None
        # identity of the loaded weights, for /health
        self.checkpoint_id = checkpoint_id
        # repro_torch.obs.EngineObserver, or None (every hook site checks)
        self.observer = observer
        self._reset_state()

    # ------------------------------------------------------------------
    # mesh plumbing

    def _ctx(self):
        """The serving mesh and rules for the model code in scope (a
        thread-local: every call site that runs the model enters it)."""
        if self._mesh is None:
            return contextlib.nullcontext()
        return shard_ctx(self._mesh, self._mesh_rules)

    @property
    def _root(self) -> bool:
        return self._mesh is None or self._mesh.rank == 0

    def _place_params(self, params, sharded: bool):
        """The rank's shard of a full tree (``sharded_params`` says the
        tree is the rank's already, as ``init_params(shard=)`` draws it),
        on the engine's device."""
        if self._mesh is not None and not sharded:
            with self._ctx():
                params = shard_tree(params, self._mesh, self._mesh_rules)
        return to_device(params, self.device)

    def _mesh_sync(self, stop: bool = False,
                   now: Optional[float] = None) -> Dict[str, Any]:
        """Rank 0 broadcasts its clock (or ``now``), the submissions and
        aborts it took since the last call, its speculation arm, whether
        it wants a numerics snapshot, and ``stop``; the other ranks apply
        the ops in rank 0's order and take the arm, and every rank takes
        the snapshot (its sums are collectives) if asked."""
        t0 = time.perf_counter()
        msg = None
        if self._root:
            msg = {"now": self._now() if now is None else now,
                   "ops": self._mesh_ops, "stop": stop,
                   "arm": self._spec_arm if self.spec is not None else None,
                   "numerics": self._numerics_wanted}
            self._mesh_ops = []
            self._numerics_wanted = False
        msg = broadcast_object(msg, src=0)
        self.mesh_syncs += 1
        self.mesh_sync_s += time.perf_counter() - t0
        if not self._root:
            for op, arg in msg["ops"]:
                if op == "submit":
                    self.queue.push(arg)
                else:
                    self._abort(arg, msg["now"])
            if msg["arm"] is not None:
                self._spec_arm = tuple(msg["arm"])
        if msg["numerics"]:
            self._numerics_cache = self._numerics_last = self._numerics()
        return msg

    def follow(self) -> None:
        """A follower's side of a mesh whose rank 0 steps from a loop of
        its own (the gateway's driver thread): take each step's broadcast,
        apply rank 0's submissions and aborts, step, until rank 0's
        :meth:`stop_followers`. A follower's sinks are None, so nothing
        streams from here."""
        if self._root:
            raise RuntimeError("follow() runs on the ranks other than 0 of "
                               "a mesh")
        while True:
            msg = self._mesh_sync()
            if msg["stop"]:
                return
            with self._ctx():
                self._step(None, msg["now"])

    def stop_followers(self) -> None:
        """Rank 0: broadcast ``stop`` with the submissions and aborts taken
        since the last step, so every follower applies them (its pages
        come back as rank 0's do) and leaves :meth:`follow`. Nothing
        without a mesh."""
        if self._mesh is None:
            return
        self._rank0_only("stop_followers")
        self._mesh_sync(stop=True)

    def _reset_state(self) -> None:
        with self._ctx():
            self.caches = init_caches(self.num_slots, self.max_len, self.cfg,
                                      page_size=self.page_size,
                                      num_pages=self.num_pages or None,
                                      window_slack=self._spec_slack,
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
        # rank 0's submissions and aborts since the last step, mirrored to
        # the other ranks at the top of the next one
        self._mesh_ops: List[tuple] = []
        self.mesh_syncs = 0              # step broadcasts taken
        self.mesh_sync_s = 0.0           # host seconds in them
        self._admit_seq = 0
        self._slot_len = np.zeros((self.num_slots,), np.int64)
        self._last_tok = np.zeros((self.num_slots,) + self._tok_width,
                                  np.int32)
        self._samp = sampling_rows(self.num_slots)
        self.completed: List[RequestMetrics] = []
        self.finished: List[RequestState] = []
        self.aborted: List[RequestState] = []
        self._run_sink: Optional[List[RequestMetrics]] = None
        self.decode_steps = 0
        self.prefills = 0
        self.admit_failures = 0          # requests that raised in admission
        self._admit_fail_streak = 0      # in a row; trips the engine
        self.prefill_tokens = 0          # padded tokens prefilled
        self.prefix_hits = 0             # admissions that reused pages
        self.prefix_reused_tokens = 0    # prompt tokens skipped by reuse
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
    # observability (touched only with an observer attached)

    def attach_observer(self, observer) -> None:
        """Attach a ``repro_torch.obs.EngineObserver`` (None detaches).
        Spans and timeline rows are stamped with the engine clock, which
        ``run`` restarts: attach before the run whose events you want."""
        self.observer = observer

    def _obs_gauges(self) -> Dict[str, int]:
        """The timeline's gauge row (the allocator's counts are O(1))."""
        alloc = self.allocator
        g = {"running": len(self.scheduler.running),
             "queued": len(self.queue),
             "preempts": self.preemptions}
        if alloc is not None:
            g["pages_free"] = alloc.free
            g["pages_cached"] = alloc.cached
        return g

    # ------------------------------------------------------------------
    # admission checks

    def _bucket(self, plen: int) -> int:
        """The prefill's padded length: the smallest bucket that holds the
        prompt and, with ring layers, no more than the window (pads past
        it would wrap onto live keys); else, and always with recurrent
        layers, the exact length."""
        if self._recurrent:
            return plen
        for b in self.buckets:
            if b >= plen and (self._window is None or b <= self._window):
                return b
        return plen

    def _pages_for(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case pages of a request: its prompt plus its budget's
        decode writes (the last token is returned, never cached)."""
        n_pos = min(prompt_len + max(max_new_tokens - 1, 0), self.max_len)
        return -(-n_pos // self.page_size)

    def _reserve_pages(self, req: Request,
                       n_tokens: int) -> Optional[Dict[str, Any]]:
        """Match the prompt's cached prefix and reserve the pages
        admission takes for ``req``; None (nothing held) if the pool
        cannot host it now. ``n_tokens`` is what the prefill covers: the
        prompt, plus the tokens generated before a preemption.
        ``reserve`` takes the whole budget up front, ``ondemand`` only
        the prefill's pages.

        Under pressure the match degrades before the reservation fails:
        first the copy-on-write hold goes (it pins one page beyond the
        request's own demand, which on a pool sized exactly to that
        demand would requeue the same reservation forever), then the
        whole match (its pages go back to the evictable set), so any
        request ``submit`` accepted is hosted with no reuse once slots
        drain."""
        alloc, page = self.allocator, self.page_size
        need = (-(-n_tokens // page) if self._ondemand
                else self._pages_for(req.prompt_len, req.max_new_tokens))
        keys: List[bytes] = []
        matched: List[int] = []
        if self._prefix_ok:
            # memoized on the request (a dry pool retries every step),
            # tagged with the page size
            memo = getattr(req, "_chain_keys", None)
            if memo is None or memo[0] != page:
                memo = (page, BlockAllocator.chain_keys(req.prompt, page))
                req._chain_keys = memo
            keys = memo[1]
            matched = alloc.match(keys)
        # the last prompt token is always recomputed (its logits seed
        # decoding), so reuse stops at n_tokens - 1
        n_cached = min(len(matched) * page, n_tokens - 1)
        n_full = n_cached // page
        cow = matched[n_full] if n_cached % page else None
        shared = matched[:n_full]
        alloc.retain(shared)
        if cow is not None:
            alloc.retain([cow])
        fresh = alloc.alloc(need - n_full)
        if fresh is None and cow is not None:
            alloc.release([cow])           # forfeit the boundary reuse
            cow = None
            n_cached = n_full * page
            fresh = alloc.alloc(need - n_full)
        if fresh is None and shared:
            alloc.release(shared)          # forfeit the prefix match
            shared, n_full, n_cached = [], 0, 0
            fresh = alloc.alloc(need)
        if fresh is None:                  # the pool is dry: nothing held
            return None
        return {"n_cached": n_cached, "n_full": n_full, "cow": cow,
                "shared": shared, "fresh": fresh, "keys": keys}

    def validate(self, prompt: Sequence, max_new_tokens: int = 0) -> None:
        """Raise ValueError for a request that can never be hosted (the
        one admission formula of ``submit`` and the gateway's pre-flight
        check, a 400 there)."""
        try:
            arr = np.asarray(prompt)
        except ValueError:
            raise ValueError("prompt rows must share one shape") from None
        if arr.size and not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(f"prompt must hold integer token ids, got "
                             f"dtype {arr.dtype}")
        k = self.cfg.num_codebooks
        if k:
            if arr.ndim != 2 or arr.shape[1] != k:
                raise ValueError(f"model expects prompt shape (len, {k}) — "
                                 f"one id row per codebook — got "
                                 f"{arr.shape}")
        elif arr.ndim != 1:
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

    def _rank0_only(self, what: str) -> None:
        if not self._root:
            raise RuntimeError(f"{what} on rank {self._mesh.rank}: under a "
                               f"mesh rank 0 takes them and mirrors them")

    def submit(self, req: Request) -> None:
        self._rank0_only("submit")
        # the online driver validates at its pre-flight and marks the
        # request, so the scan is not paid twice
        if not getattr(req, "_prevalidated", False):
            try:
                self.validate(req.prompt, req.max_new_tokens)
            except ValueError as e:
                raise ValueError(f"request {req.rid}: {e}") from None
        self.queue.push(req)
        if self._mesh is not None:
            self._mesh_ops.append(("submit", req))

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def now(self) -> float:
        """Engine-clock timestamp: online callers stamp
        ``Request.arrival`` with it, so queue wait and TTFT share the
        engine's timebase."""
        return self._now()

    # ------------------------------------------------------------------
    # prefill

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _sample(self, logits: torch.Tensor, rows) -> torch.Tensor:
        """Token ids of ``logits``: ``(B,)``, or ``(B, K)`` with K
        codebooks (``sample_logits`` reads the ``(B, K * V)`` logits as
        ``B * K`` rows)."""
        return sample_logits(logits, rows,
                             num_codebooks=self.cfg.num_codebooks,
                             vocab_size=self.cfg.vocab_size)

    @staticmethod
    def _token(t: np.ndarray):
        """A sampled token as a request stores it: an int, or a list of
        one id a codebook."""
        return t.tolist() if t.ndim else int(t)

    def _prefill_dense(self, tokens: np.ndarray, n: int, slot: int):
        """Batch-1 prefill over a fresh zero cache, copied into the slot's
        row of every layer with the cursor at the true prompt length
        ``n``."""
        mini = init_caches(1, self.max_len, self.cfg,
                           window_slack=self._spec_slack, device=self.device)
        logits = forward(self.params, self._tensor(tokens), self.cfg,
                         self.qcfg, caches=mini, pos_offset=0,
                         head=self._head)[:, n - 1]
        for (big, stacked), (small, _) in zip(_layer_caches(self.caches),
                                              _layer_caches(mini)):
            _scatter_row(big, small, slot, stacked)
        _set_cursor_row(self.caches, slot, n)
        return logits

    def _prefill_paged(self, tokens: np.ndarray, n_new: int, n_cached: int,
                       n_total: int, slot: int, table: np.ndarray,
                       cow_src: int, cow_dst: int):
        """Batch-1 suffix prefill in place over the shared pools, through
        the slot's real block table: cached prefix pages are read where
        they live and fresh pages are written once. The copy-on-write
        boundary page ``cow_src`` is copied onto its fresh twin
        ``cow_dst`` first, in every pool leaf, so the suffix lands on a
        page that already holds the shared tokens; without one both name
        the null page (a self-copy, skipped). The suffix runs at
        ``pos_offset = n_cached``; bucket padding past the table's span
        drops. A ring or a recurrent layer prefills over a zero batch-1
        ring or state that is then
        copied into the slot's row. Every cursor ends at ``n_total``."""

        def mini_layer(c, stacked):
            if "kp" not in c:     # a ring or a state: a zero batch-1 row
                ax = 1 if stacked else 0
                return {k: torch.zeros(v.shape[:ax] + (1,) + v.shape[ax + 1:],
                                       dtype=v.dtype, device=v.device)
                        for k, v in c.items()}
            if cow_src != cow_dst:
                for key in _POOL_KEYS:
                    if key in c:
                        if stacked:
                            c[key][:, cow_dst] = c[key][:, cow_src]
                        else:
                            c[key][cow_dst] = c[key][cow_src]
            m = {k: v for k, v in c.items() if k != "idx"}
            lead = (c["idx"].shape[0], 1) if stacked else (1,)
            m["idx"] = torch.full(lead, n_cached, dtype=torch.int32,
                                  device=self.device)
            return m

        mini = _map_layers(self.caches, mini_layer)
        logits = forward(self.params, self._tensor(tokens), self.cfg,
                         self.qcfg, caches=mini, pos_offset=n_cached,
                         block_tables=self._tensor(table[None]),
                         head=self._head)[:, n_new - 1]
        for (big, stacked), (small, _) in zip(_layer_caches(self.caches),
                                              _layer_caches(mini)):
            if "kp" not in big:
                _scatter_row(big, small, slot, stacked)
        _set_cursor_row(self.caches, slot, n_total)
        return logits

    def _admit(self, rs: RequestState, clock,
               resv: Optional[Dict[str, Any]]) -> None:
        req = rs.request
        prompt = np.asarray(req.prompt, np.int32)
        g = len(rs.generated)
        if g:
            # resuming a preempted request: recompute the evicted KV from
            # the prompt plus every delivered token but the last (which
            # seeds decoding and, like a fresh prefill's token, is never
            # cached)
            prompt = np.concatenate(
                [prompt, np.asarray(rs.generated[:-1], np.int32).reshape(
                    (-1,) + self._tok_width)])
        plen = len(prompt)
        if self.page_size:
            n_cached, n_full = resv["n_cached"], resv["n_full"]
            n_pages = n_full + len(resv["fresh"])
            bt = np.full((self._max_pages,), self._null_page, np.int32)
            bt[:n_full] = resv["shared"]
            bt[n_full:n_pages] = resv["fresh"]
            if resv["cow"] is not None:
                cow_src, cow_dst = resv["cow"], int(bt[n_full])
            else:
                cow_src = cow_dst = self._null_page
            n_new = plen - n_cached
            bucket = self._bucket(n_new)
            tokens = np.zeros((1, bucket) + self._tok_width, np.int32)
            tokens[0, :n_new] = prompt[n_cached:]
            logits = self._prefill_paged(tokens, n_new, n_cached, plen,
                                         rs.slot, bt, cow_src, cow_dst)
            if resv["cow"] is not None:  # content copied; drop the hold
                self.allocator.release([resv["cow"]])
                resv["cow"] = None  # an unwind must not release it again
            if self._prefix_ok:
                # publish the original prompt's full pages (tokens
                # generated before a preemption are never cache material)
                for i, key in enumerate(resv["keys"]):
                    self.allocator.register(key, int(bt[i]))
            self._block_tables[rs.slot] = bt
            self._slot_pages[rs.slot] = resv["shared"] + resv["fresh"]
            if n_cached:
                self.prefix_hits += 1
                self.prefix_reused_tokens += n_cached
        else:
            bucket = self._bucket(plen)
            tokens = np.zeros((1, bucket) + self._tok_width, np.int32)
            tokens[0, :plen] = prompt
            logits = self._prefill_dense(tokens, plen, rs.slot)
        set_row(self._samp, rs.slot, req.sampling)  # sample event 0
        if g:
            # every generated token was delivered already; the sampler
            # resumes at event g, so no token is re-drawn
            tok = rs.generated[-1]
            self._samp["step"][rs.slot] = g
        else:
            row = {k: v[rs.slot:rs.slot + 1] for k, v in self._samp.items()}
            tok = self._token(self._sample(logits, row).cpu().numpy()[0])
            self._samp["step"][rs.slot] = 1
        self.prefills += 1
        self.prefill_tokens += bucket
        self._slot_len[rs.slot] = plen
        self._last_tok[rs.slot] = tok
        if not g:
            rs.generated.append(tok)
            rs.t_first_token = clock()
            if self.token_sink is not None:
                self.token_sink(req.rid, tok)
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
        """Terminal transition: stamp, release the slot and its pages,
        archive, and fire ``finish_sink``."""
        rs.t_finish = clock()
        rs.finish_reason = reason
        self._release_slot(rs)
        if reason == "aborted":
            self.aborted.append(rs)
        else:
            self.finished.append(rs)
            m = RequestMetrics.from_state(rs, truncated=reason == "capacity")
            self.completed.append(m)
            if self._run_sink is not None:
                self._run_sink.append(m)
        if self.finish_sink is not None:
            self.finish_sink(rs.request.rid, reason, rs)
        if self.observer is not None:
            self.observer.finished(rs, reason)

    def _archive_error(self, rs: RequestState) -> None:
        """The shared tail of both admission-failure paths: stamp, count,
        archive, fire the terminal event. Unwinding the slot and pages
        stays with the caller (the reservation path bound no slot)."""
        rs.finish_reason = "error"
        self.admit_failures += 1
        self._admit_fail_streak += 1
        self.aborted.append(rs)
        if self.finish_sink is not None:
            self.finish_sink(rs.request.rid, "error", rs)

    def _fail_admission(self, rs: RequestState, resv: Optional[Dict],
                        clock) -> None:
        """Unwind a failed ``_admit``: free the slot, return the page
        reservation wherever the failure left it (the copy-on-write hold
        included), and archive the state with reason ``"error"``."""
        rs.t_finish = clock()
        # pages recorded on the slot (the failure came after _admit's
        # bookkeeping) go back with the slot; before that point the
        # reservation is still ours to return
        recorded = bool(self.page_size) and \
            self._slot_pages[rs.slot] is not None
        self._release_slot(rs)
        if self.page_size and not recorded and resv is not None:
            self.allocator.release(resv["shared"] + resv["fresh"])
            if resv["cow"] is not None:
                self.allocator.release([resv["cow"]])
        self._archive_error(rs)

    def abort(self, rid: int, now: Optional[float] = None) -> bool:
        """Cancel a queued or running request. A running one releases its
        slot and pages at once; the co-batched rows keep their cache rows,
        cursors and sampling chains. False if ``rid`` is not live here.
        Under a mesh, rank 0's abort reaches the other ranks at the top
        of the next step."""
        self._rank0_only("abort")
        done = self._abort(rid, now)
        if done and self._mesh is not None:
            self._mesh_ops.append(("abort", rid))
        return done

    def _abort(self, rid: int, now: Optional[float] = None) -> bool:
        clock = self._now if now is None else (lambda: now)
        if self.queue.remove(rid) is not None:
            # a preempted request waits in the queue with its state
            # parked; its pages went back at eviction
            rs = self._preempted.pop(rid, None)
            if rs is not None:
                rs.t_finish = clock()
                rs.finish_reason = "aborted"
                self.aborted.append(rs)
            if self.finish_sink is not None:
                self.finish_sink(rid, "aborted", rs)
            if self.observer is not None:
                self.observer.aborted_queued(rid, clock())
            return True
        for rs in self.scheduler.running.values():
            if rs.request.rid == rid:
                self._finish(rs, clock, "aborted")
                return True
        return False

    # ------------------------------------------------------------------
    # on-demand paging: decode-time growth and preemption by recompute

    def _age(self, rs: RequestState):
        """Total order on running requests, oldest first (victim choice
        and growth priority must agree, or progress is not guaranteed).
        Under a mesh the admission order stands in for the admission
        time, which each rank stamps on its own clock."""
        if self._mesh is not None:
            return (rs.admit_seq, rs.request.arrival, rs.request.rid)
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
        if self.observer is not None:
            self.observer.preempted(rs, self._now())

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
        """The cached draft view at ``bits`` and its head (a tied head
        decoded from the view's embedding; an untied one is the view's
        re-gridded ``embed.head``, built in the same K7 launch as the
        other leaves); at the serving width, the serving weights and head
        themselves."""
        view = self._draft_views.get(bits)
        if view is None:
            dparams = build_draft_params(self.params, bits)
            head = (self._head if dparams is self.params
                    else lm_head(dparams, self.cfg))
            view = self._draft_views[bits] = (dparams, head)
            # a new view: re-derive health (under a mesh every rank builds
            # it in the same step, and rank 0 asks again in a broadcast)
            self._numerics_cache = None
        return view

    def numerics_snapshot(self) -> Dict[str, Any]:
        """The serving tree's code-rail occupancy (``tree_code_stats``)
        and the re-grid error of every built draft view
        (``draft_requant_error``), for ``/health``. Computed on the first
        call and cached until a new draft view is built; it reads the
        engine's tensors, so call it from the thread that steps the
        engine.

        Under a mesh the snapshot is the whole tree's: each leaf's sums
        are summed over the ranks its shards lie on (a leaf every rank
        holds whole counts once). Those sums are collectives, so rank 0
        never takes them alone: a call with no fresh snapshot asks for
        one in the next step's broadcast, where every rank takes it, and
        returns the last one meanwhile (``{}`` before the first)."""
        if self._numerics_cache is not None:
            return self._numerics_cache
        if self._mesh is not None:
            self._rank0_only("numerics_snapshot")
            self._numerics_wanted = True
            return self._numerics_last
        self._numerics_cache = self._numerics()
        return self._numerics_cache

    def _numerics(self) -> Dict[str, Any]:
        reduce = None
        if self._mesh is not None:
            split = split_axes(self.params, self._mesh, self._mesh_rules)

            def reduce(path, sums):
                axes = tree_get(split, path)
                return (sum_reduce(sums, self._mesh.group(axes)) if axes
                        else sums)
        snap: Dict[str, Any] = {"weights": tree_code_stats(self.params,
                                                           reduce)}
        drafts = {f"b{bits}": draft_requant_error(self.params, view, reduce)
                  for bits, (view, _) in sorted(self._draft_views.items())
                  if view is not self.params}
        if drafts:
            snap["draft_requant"] = drafts
        return snap

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
        _set_cursors(self.caches, pos)
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
        _set_cursors(self.caches, (pos + m).to(torch.int32))
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
        obs = self.observer
        t0 = time.monotonic()
        t_s0 = self._now() if obs is not None else 0.0
        pos0 = self._slot_len.copy()
        s, acc, m = self._spec_cycle(bits, k)
        self._admit_fail_streak = 0
        self.spec_cycles += 1
        self.spec_draft_steps += k
        self.spec_verify_steps += 1
        self._slot_len = pos0 + m
        self._samp["step"] += m.astype(np.int32)
        self._last_tok = s[np.arange(self.num_slots), m - 1].astype(np.int32)
        emitted = 0
        per_class: Dict[str, Any] = {}
        obs_rows: Optional[List] = [] if obs is not None else None
        for slot, rs in list(self.scheduler.running.items()):
            a = int(acc[slot])
            if obs_rows is not None:
                obs_rows.append((rs.request.rid, a, int(m[slot])))
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
                if self.token_sink is not None:
                    self.token_sink(rs.request.rid, rs.generated[-1])
                if rs.done:
                    # the run's later tokens are not in the baseline's
                    # stream: drop them
                    break
            self._maybe_finish(rs, clock)
            if self._ondemand and self.scheduler.running.get(slot) is rs:
                self._trim_overshoot(rs)
        self.spec_emitted += emitted
        if obs is not None:
            obs.spec_cycle(t_s0, self._now(), k=k, rows=obs_rows,
                           emitted=emitted, gauges=self._obs_gauges())
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
        False when nothing ran. Under a mesh every rank calls it in
        lockstep: rank 0's clock (or its ``now``) gates the arrivals."""
        ready = now
        if self._mesh is not None:
            ready = self._mesh_sync(now=now)["now"]
        with self._ctx():
            return self._step(now, ready)

    def _step(self, now: Optional[float], ready: Optional[float]) -> bool:
        clock = self._now if now is None else (lambda: now)
        gate = clock if ready is None else (lambda: ready)
        obs = self.observer
        while self.scheduler.has_free():
            req = self.queue.pop_ready(gate())
            if req is None:
                break
            resv = None
            resume = self._preempted.get(req.rid)
            if self.page_size:
                n_tok = req.prompt_len
                if resume is not None:
                    n_tok += len(resume.generated) - 1
                try:
                    resv = self._reserve_pages(req, n_tok)
                except Exception:
                    # a prompt the reservation cannot even hash fails
                    # alone, before a slot is bound (slot -1)
                    rs = RequestState(request=req, slot=-1, t_admit=clock())
                    rs.t_finish = clock()
                    self._archive_error(rs)
                    if self._admit_fail_streak >= ADMIT_FAIL_TRIP:
                        raise
                    continue
                if resv is None:  # pool exhausted: wait for a release
                    self.queue.requeue(req)
                    break
            rs = self.scheduler.admit(req, clock())
            rs.admit_seq = self._admit_seq
            self._admit_seq += 1
            if resume is not None:
                # continuity across preemption: the same token list (the
                # resume prefill keys off it), timestamps and counters
                del self._preempted[req.rid]
                for f in ("generated", "t_admit", "t_first_token",
                          "spec_cycles", "spec_drafted", "spec_accepted",
                          "preemptions", "admit_seq"):
                    setattr(rs, f, getattr(resume, f))
            t_p0 = self._now() if obs is not None else 0.0
            try:
                self._admit(rs, clock, resv)
                self._admit_fail_streak = 0
                if obs is not None:
                    obs.admitted(rs, resumed=resume is not None)
                    obs.prefill(rs, t_p0, self._now(),
                                gauges=self._obs_gauges())
            except Exception:
                # a request that raises inside admission fails alone: its
                # slot and reservation unwind, its terminal event fires,
                # the co-batched rows keep serving. The pool tensors are
                # updated in place, never donated, and the failed prefill
                # can only have written this request's own fresh pages,
                # its copy-on-write target or the null page, so every
                # other row's KV is intact
                if rs.finish_reason is not None:
                    # it finished inside _admit and the raise came after
                    # (a sink): the teardown ran already
                    raise
                self._fail_admission(rs, resv, clock)
                if self._admit_fail_streak >= ADMIT_FAIL_TRIP:
                    raise
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

        t_d0 = self._now() if obs is not None else 0.0
        block_tables = (self._tensor(self._block_tables)
                        if self.page_size else None)
        logits = forward(self.params, self._tensor(self._last_tok[:, None]),
                         self.cfg, self.qcfg, caches=self.caches,
                         pos_offset=self._tensor(self._slot_len),
                         block_tables=block_tables, head=self._head)[:, -1]
        toks = self._sample(logits, self._samp).cpu().numpy()
        # a decode step that ran proves the engine healthy: keep
        # isolating whatever admissions fail
        self._admit_fail_streak = 0
        self.decode_steps += 1
        self._slot_len += 1
        self._samp["step"] += 1
        self._last_tok = toks.astype(np.int32)
        live = list(self.scheduler.running.items())
        for slot, rs in live:
            rs.generated.append(self._token(toks[slot]))
            if self.token_sink is not None:
                self.token_sink(rs.request.rid, rs.generated[-1])
            self._maybe_finish(rs, clock)
        if obs is not None:
            obs.decode_step(t_d0, self._now(), emitted=len(live),
                            gauges=self._obs_gauges())
        return True

    def drain_finished(self) -> List[RequestState]:
        """Hand over (and forget) the finished request states, and clear
        the metrics and abort archives with them. Long-lived
        ``submit``/``step`` callers drain now and then, or the kept token
        lists grow without bound; ``run`` counts its completions in a
        sink of its own, so draining is safe at any point."""
        out, self.finished = self.finished, []
        self.completed = []
        self.aborted = []
        return out

    def run(self, requests: Sequence[Request] = ()) -> Dict[str, float]:
        """Drive the requests to completion; aggregate metrics of the
        requests this call completed. Under a mesh every rank calls it,
        rank 0 with the requests and the others with none: the others
        :meth:`follow` until rank 0 has nothing live and stops them."""
        for r in requests:
            self.submit(r)
        self._run_sink = sink = []
        self._t0 = time.monotonic()
        try:
            if not self._root:
                self.follow()
            else:
                while self.queue or self.scheduler.running:
                    if not self.step():
                        nxt = self.queue.next_arrival()
                        if nxt is not None:
                            time.sleep(min(max(nxt - self._now(), 0.0),
                                           0.05))
                self.stop_followers()
        finally:
            self._run_sink = None
        return summarize(sink, self._now())
