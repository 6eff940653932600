"""Engine driver thread: the bridge between the asyncio gateway and the
synchronous continuous-batching engine (the port's counterpart of
``repro.server.driver``).

The engine is single-threaded by construction (its tensors, the host-side
slot mirrors), so exactly one thread may touch it. ``EngineDriver`` owns
that thread and exposes a thread-safe surface:

- ``submit()`` / ``abort()`` post commands to a FIFO **mailbox**; the
  driver drains it between engine steps, so commands land at step
  granularity (an abort can catch a request mid-queue, mid-prefill —
  admitted but not yet decoded — or mid-decode).
- **admission control**: at most ``max_inflight`` requests may be live
  (queued + running). ``submit()`` refuses above that watermark and the
  gateway answers 429 — the mailbox never becomes an unbounded buffer in
  front of the bounded engine queue.
- **streaming**: the engine's ``token_sink`` / ``finish_sink`` fire inside
  the driver thread; the driver routes them to the per-request ``sink``
  callables handed to ``submit()``. Sinks must be thread-safe (the
  gateway uses ``loop.call_soon_threadsafe`` into per-request asyncio
  queues) and fast — they run on the decode hot path.
- ``stats()`` returns a snapshot (occupancy counters + the rolling
  latency summary) refreshed once per loop iteration; ``health()`` the
  serving context, with the numerics snapshot the driver thread took
  (the engine's tensors are never read from the event loop's thread).

Under a mesh (``Engine(mesh=)``) the driver runs on rank 0 only: its
thread steps the engine, and each step's broadcast carries the
submissions and aborts to the other ranks, which :meth:`Engine.follow`.
An idle loop still steps every ``poll_s``, so no follower ever waits on a
broadcast longer than that. A normal stop aborts the live requests and
broadcasts ``stop`` with those aborts (``Engine.stop_followers``). A
fatal step fails every stream and then calls ``on_fatal``: the followers
may sit in any collective of that step, where no ``stop`` reaches them,
so the launcher exits the process and torchrun tears the group down
(``launch.serve``). The mesh shape is in ``/health``, the stats and the
Prometheus info labels, as in the JAX package's driver.

Events a sink receives: ``("token", tok)`` per generated token and one
terminal ``("finish", reason, token_list | None[, spec_dict])`` with
reason in ``{"stop", "length", "capacity", "aborted", "error"}``. The
optional 4th element carries the request's speculative-decoding usage
(cycles/drafted/accepted) when the engine speculated for it; consumers
index it defensively (``event[3] if len(event) > 3 else None``) —
internal error paths still emit bare 3-tuples.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.obs.prom import Histogram, render_prometheus
from repro_torch.server.sampling import SamplingParams
from repro_torch.serving.engine import Engine
from repro_torch.serving.metrics import summarize
from repro_torch.serving.request import Request

__all__ = ["EngineDriver"]

Sink = Callable[[tuple], None]


class EngineDriver:
    def __init__(self, engine: Engine, *, max_inflight: int = 64,
                 poll_s: float = 0.02, metrics_window: int = 4096,
                 on_fatal: Optional[Callable[[BaseException], None]] = None):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self._engine = engine
        self._on_fatal = on_fatal
        self._max_inflight = max_inflight
        self._poll_s = poll_s
        self._mail: "queue.Queue[tuple]" = queue.Queue()
        self._sinks: Dict[int, Sink] = {}      # driver thread only
        self._lock = threading.Lock()
        self._rids = itertools.count()
        self._inflight = 0
        self._aborted_total = 0
        self._completed_total = 0
        self._errors = 0
        self._metrics = deque(maxlen=metrics_window)
        # lifetime latency histograms for the Prometheus exposition —
        # fed per *finished request* (off the decode hot path), never
        # windowed, so scrape deltas are monotone
        self._hists = {
            "ttft_seconds": Histogram(
                "ttft_seconds", "Time to first token (arrival -> first "
                "token, queueing included)."),
            "tpot_seconds": Histogram(
                "tpot_seconds", "Time per output token over the decode "
                "phase."),
            "queue_wait_seconds": Histogram(
                "queue_wait_seconds", "Arrival -> slot admission."),
        }
        self._stats: Dict[str, Any] = {}
        self._numerics: Dict[str, Any] = {}
        self._t_start = time.monotonic()
        self._stopping = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="engine-driver", daemon=True)
        engine.token_sink = self._on_token
        engine.finish_sink = self._on_finish
        # seed the snapshot so stats() is complete before the loop's
        # first iteration (a /metrics probe can land that early)
        self._refresh_stats()

    # ------------------------------------------------------------------
    # public surface (any thread)

    def start(self) -> "EngineDriver":
        self._thread.start()
        return self

    @property
    def alive(self) -> bool:
        return self._thread.is_alive() and not self._stopping.is_set()

    def submit(self, prompt: Sequence, max_new_tokens: int, *,
               sampling: Optional[SamplingParams] = None,
               eos_id=None, sink: Sink) -> Optional[int]:
        """Enqueue a request; returns its rid, or None when the inflight
        watermark is hit (gateway backpressure — answer 429).

        Raises ValueError for requests the engine can never host (prompt
        longer than the cache / page pool, or a prompt whose rank / row
        width doesn't fit the model) — a 400, not backpressure."""
        eng = self._engine
        eng.validate(prompt, max_new_tokens)
        if not self.alive:
            return None
        with self._lock:
            if self._inflight >= self._max_inflight:
                return None
            self._inflight += 1
            rid = next(self._rids)
        req = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                      arrival=eng.now(), eos_id=eos_id, sampling=sampling)
        req._prevalidated = True  # validated above; skip the re-scan
        self._mail.put(("submit", req, sink))
        if not self.alive:
            # raced death: the put may have landed after the loop's (or
            # shutdown's) final drain — on both the shutdown() path and
            # the fatal-step path _stopping is set before that drain, so
            # re-checking alive here catches every ordering. Nobody else
            # will read the mailbox now; fail the submit rather than
            # hang the connection (idempotent: queue.get is atomic, so
            # whichever drain got the command first fires the sink)
            self._fail_pending()
        return rid

    def abort(self, rid: int) -> None:
        """Request cancellation; resolved in the driver thread at the next
        step boundary (idempotent, unknown rids ignored)."""
        self._mail.put(("abort", rid))

    def stats(self) -> Dict[str, Any]:
        """Latest per-loop snapshot + rolling latency summary. The
        summary covers the metrics *window*, so its rate denominators use
        the window's own span (engine clock) — dividing window tokens by
        process lifetime would decay tokens_per_s toward zero on a
        long-running server. Lifetime totals are separate counters."""
        with self._lock:
            out = dict(self._stats)
            mets = list(self._metrics)
            out["inflight"] = self._inflight
            out["aborted_total"] = self._aborted_total
            out["completed_total"] = self._completed_total
            out["errors"] = self._errors
        if mets:
            wall = (max(m.t_finish for m in mets)
                    - min(m.arrival for m in mets))
        else:
            wall = time.monotonic() - self._t_start
        out.update(summarize(mets, wall))
        return out

    def health(self) -> Dict[str, Any]:
        """Readiness context for ``GET /health``: what this node is
        actually serving with — the device (and the card's name on
        CUDA), KV layout policy, spec config, and the loaded checkpoint
        identity."""
        eng = self._engine
        out: Dict[str, Any] = {
            "status": "ok" if self.alive else "stopping",
            "device": eng.device.type,
            "arch": getattr(eng.cfg, "name", None),
            "checkpoint_id": eng.checkpoint_id,
            "num_slots": eng.num_slots,
            "max_len": eng.max_len,
            "max_inflight": self._max_inflight,
            "paged": bool(eng.page_size),
        }
        if eng.device.type == "cuda":
            out["card"] = torch.cuda.get_device_name(eng.device)
        if eng.page_size:
            out["page_size"] = eng.page_size
            out["num_pages"] = eng.num_pages
            out["alloc_policy"] = eng.alloc_policy
            out["prefix_cache"] = eng._prefix_ok
        mesh = self._mesh_shape()
        if mesh is not None:
            out["mesh"] = mesh
        if eng.spec is not None:
            out["spec"] = {"k": eng.spec.k,
                           "draft_bits": eng.spec.draft_bits,
                           "autotune": eng.spec.autotune}
        # code-rail occupancy of the serving tree + re-grid error of every
        # built draft view, as the driver thread last took them
        with self._lock:
            out["numerics"] = self._numerics
        return out

    def prom_text(self) -> str:
        """The Prometheus text exposition for ``GET /metrics``: the
        stats snapshot flattened to counters/gauges plus the lifetime
        latency histograms. Histograms render under the driver lock so
        a scrape never sees a bucket row torn across an observe()."""
        stats = self.stats()
        health = self.health()
        info = {"arch": health.get("arch"), "device": health["device"],
                "card": health.get("card"),
                "checkpoint_id": health.get("checkpoint_id"),
                "alloc_policy": health.get("alloc_policy"),
                "mesh": ",".join(f"{k}={v}" for k, v in
                                 health.get("mesh", {}).items()) or None}
        with self._lock:
            return render_prometheus(stats, self._hists.values(), info)

    def _mesh_shape(self) -> Optional[Dict[str, int]]:
        mesh = self._engine._mesh
        return None if mesh is None else {a: int(mesh.shape[a])
                                          for a in mesh.axis_names}

    def shutdown(self, timeout: Optional[float] = 10.0) -> None:
        """Stop the loop: live requests are aborted (sinks get their
        terminal event), then the thread exits (under a mesh after
        broadcasting ``stop``; pass ``timeout=None`` to wait for it)."""
        if not self._thread.is_alive():
            return
        self._stopping.set()
        self._mail.put(("stop",))
        self._thread.join(timeout)
        # a submit() that passed the alive check concurrently with the
        # stop may have mailed after the loop's final drain — fail it
        # here (the thread is dead, nobody else reads the mailbox)
        self._fail_pending()

    def _fail_pending(self) -> None:
        """Drain the mailbox, terminating any un-processed submits so no
        connection hangs on a request that will never run."""
        while True:
            try:
                cmd = self._mail.get_nowait()
            except queue.Empty:
                return
            if cmd[0] == "submit":
                _, req, sink = cmd
                with self._lock:
                    self._inflight -= 1
                    self._errors += 1
                sink(("finish", "error", None))

    # ------------------------------------------------------------------
    # engine callbacks (driver thread)

    def _on_token(self, rid: int, tok) -> None:
        sink = self._sinks.get(rid)
        if sink is not None:
            sink(("token", tok))

    def _on_finish(self, rid: int, reason: str, rs) -> None:
        # archive the metrics first: a client that reads /metrics once its
        # response ends must find its own request counted
        self._archive_completed()
        sink = self._sinks.pop(rid, None)
        with self._lock:
            self._inflight -= 1
            if reason == "aborted":
                self._aborted_total += 1
            elif reason == "error":
                self._errors += 1
        if sink is not None:
            spec = None
            if rs is not None and rs.spec_cycles:
                spec = {"cycles": rs.spec_cycles,
                        "drafted": rs.spec_drafted,
                        "accepted": rs.spec_accepted}
            sink(("finish", reason, list(rs.generated) if rs else None,
                  spec))

    # ------------------------------------------------------------------
    # driver thread

    def _handle(self, cmd: tuple) -> None:
        kind = cmd[0]
        if kind == "submit":
            _, req, sink = cmd
            self._sinks[req.rid] = sink
            try:
                self._engine.submit(req)
            except Exception as e:  # safety net — submit() prevalidates
                self._sinks.pop(req.rid, None)
                with self._lock:
                    self._inflight -= 1
                    self._errors += 1
                sink(("finish", "error", None))
                _ = e
        elif kind == "abort":
            self._engine.abort(cmd[1])

    def _loop(self) -> None:
        eng = self._engine
        if eng.device.type == "cuda" and eng.device.index is not None:
            # the CUDA runtime's current device is per thread (a mesh
            # rank's engine names its card; a bare "cuda" is the default)
            torch.cuda.set_device(eng.device)
        while True:
            busy = bool(eng.scheduler.running) or bool(eng.queue)
            cmds = []
            try:
                if not busy:  # idle: sleep on the mailbox
                    cmds.append(self._mail.get(timeout=self._poll_s))
                while True:
                    cmds.append(self._mail.get_nowait())
            except queue.Empty:
                pass
            stop = any(c[0] == "stop" for c in cmds)
            for cmd in cmds:
                if cmd[0] != "stop":
                    self._handle(cmd)
            if stop or self._stopping.is_set():
                self._stopping.set()
                for rid in list(self._sinks):
                    eng.abort(rid)
                eng.stop_followers()      # with those aborts
                self._fail_pending()
                self._refresh_stats()
                return
            try:
                eng.step()
            except Exception as exc:
                # a dying engine must not leave streams hanging: every
                # live sink gets a terminal event, /health flips to 503
                self._stopping.set()
                for rid, sink in list(self._sinks.items()):
                    sink(("finish", "error", None))
                    self._sinks.pop(rid, None)
                    with self._lock:
                        self._inflight -= 1
                        self._errors += 1
                self._fail_pending()  # submits mailed during the fatal step
                self._refresh_stats()
                if self._on_fatal is not None:
                    self._on_fatal(exc)
                raise
            # keep the engine's retained state bounded (token lists
            # already reached the sinks)
            self._archive_completed()
            if eng.finished or eng.aborted:
                eng.drain_finished()
            self._refresh_stats()

    def _archive_completed(self) -> None:
        """Move the engine's completed-request metrics into the driver's
        window, lifetime count and histograms (driver thread)."""
        eng = self._engine
        if not eng.completed:
            return
        with self._lock:
            self._metrics.extend(eng.completed)
            self._completed_total += len(eng.completed)
            for m in eng.completed:
                self._hists["ttft_seconds"].observe(m.ttft)
                self._hists["queue_wait_seconds"].observe(m.queued_s)
                if m.tpot is not None:
                    self._hists["tpot_seconds"].observe(m.tpot)
        eng.completed.clear()

    def _refresh_stats(self) -> None:
        eng = self._engine
        snap = {
            "running": len(eng.scheduler.running),
            "queued": len(eng.queue),
            "free_slots": eng.scheduler.free_slots,
            "num_slots": eng.num_slots,
            "max_inflight": self._max_inflight,
            "decode_steps": eng.decode_steps,
            "prefills": eng.prefills,
            "admit_failures": eng.admit_failures,
        }
        if eng.page_size:
            snap["kv_pages_available"] = eng.allocator.available
            snap["kv_pages_total"] = eng.num_pages
            snap["prefix_hits"] = eng.prefix_hits
            snap["prefix_reused_tokens"] = eng.prefix_reused_tokens
        mesh = self._mesh_shape()
        if mesh is not None:
            # tells a sharded deployment from a one-card one at a glance;
            # the step broadcasts taken and rank 0's host seconds in them
            snap["mesh"] = mesh
            snap["mesh_syncs"] = eng.mesh_syncs
            snap["mesh_sync_s"] = eng.mesh_sync_s
        spec = eng.spec_snapshot()
        if spec is not None:
            snap.update(spec)
        # the numerics snapshot reads the engine's tensors, so it is taken
        # here, on the driver thread (the only one that touches them): the
        # engine computes it once and again only after a new draft view,
        # so a refresh is a dict walk. health() hands out this copy under
        # the lock instead of calling into the engine from the event loop.
        # Under a mesh its sums are collectives: the engine takes it in
        # the next step's broadcast and hands out the last one meanwhile
        numerics = eng.numerics_snapshot()
        for scope, stats in numerics.items():
            for k, v in stats.items():
                if isinstance(v, dict):
                    for k2, v2 in v.items():
                        if isinstance(v2, (int, float)):
                            snap[f"numerics_{scope}_{k}_{k2}"] = v2
                elif isinstance(v, (int, float)):
                    snap[f"numerics_{scope}_{k}"] = v
        with self._lock:
            self._stats = snap
            self._numerics = numerics
