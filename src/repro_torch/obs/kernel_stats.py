"""Kernel-time attribution for the dispatch layer, the counterpart of
``repro.obs.kernel_stats``.

Every entry point of ``kernels/dispatch.py`` checks one module global
(:func:`active`); with no collector enabled, the default, that check is
all it pays. Once :func:`enable` has been called, each call runs through
:func:`observe`, which counts it and times it under the key
``(op, backend, bits)``: ``op`` is the JAX package's name of the
operation where it has one (``qmatmul``, ``encode_pack``,
``requant_pack``, ``madam_step``, ``paged_attend``, ``fused_sample``)
and the dispatch function's name otherwise; ``backend`` is what
``dispatch.route`` chose (``"kernel"`` or ``"plain"``); ``bits`` the
word width (0 where none applies).

* ``time_s`` is the call's wall time on the host's clock. A CUDA launch
  returns before the kernel ends, so for the kernels this is the launch.
* ``block_every=N`` times every Nth call of a key to completion as well
  (``blocked_s``, ``blocked_calls``). On a CUDA tensor the stream is
  drained before the clock starts and synchronized after the call, so
  ``blocked_s`` is the call's own time: its launch and its kernel, and
  not the queue of work launched before it. JAX's ``block_until_ready``
  waits only after the call, so its blocked time also holds whatever was
  queued ahead; the port drains first because an eager PyTorch step
  queues hundreds of kernels, which would otherwise be charged to
  whichever call happened to be blocked.
* ``traces`` stays in every row, always 0: eager PyTorch stages nothing,
  so there is no trace time to count, and the row keeps JAX's schema.

:func:`profiler_trace` wraps a run in ``torch.profiler`` (CPU and, where
there is a card, CUDA activity) and writes its Chrome trace, for the
cases that need the device's own view (``--torch-profile``).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

__all__ = ["KernelStats", "enable", "disable", "get", "active", "observe",
           "profiler_trace"]

Key = Tuple[str, str, int]  # (op, backend, bits; 0 = none)


class KernelStats:
    """Per-(op, backend, bits) accumulators, safe across threads."""

    def __init__(self, *, block_every: int = 0):
        # 0 never blocks; N > 0 blocks every Nth call of a key
        self.block_every = block_every
        self._lock = threading.Lock()
        self._calls: Dict[Key, int] = {}
        self._traces: Dict[Key, int] = {}
        self._time_s: Dict[Key, float] = {}
        self._blocked_s: Dict[Key, float] = {}
        self._blocked_n: Dict[Key, int] = {}

    def record_call(self, key: Key, dur_s: float,
                    blocked_s: Optional[float] = None) -> None:
        with self._lock:
            self._calls[key] = self._calls.get(key, 0) + 1
            self._time_s[key] = self._time_s.get(key, 0.0) + dur_s
            if blocked_s is not None:
                self._blocked_s[key] = (
                    self._blocked_s.get(key, 0.0) + blocked_s)
                self._blocked_n[key] = self._blocked_n.get(key, 0) + 1

    def should_block(self, key: Key) -> bool:
        if self.block_every <= 0:
            return False
        # the count before this call: block calls 0, N, 2N, ...
        return self._calls.get(key, 0) % self.block_every == 0

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """``{"op|backend|bN": {op, backend, bits, calls, traces, time_s,
        [blocked_calls, blocked_s]}}``."""
        with self._lock:
            keys = set(self._calls) | set(self._traces)
            out: Dict[str, Dict[str, Any]] = {}
            for key in sorted(keys):
                op, backend, bits = key
                row: Dict[str, Any] = {
                    "op": op, "backend": backend, "bits": bits,
                    "calls": self._calls.get(key, 0),
                    "traces": self._traces.get(key, 0),
                    "time_s": self._time_s.get(key, 0.0),
                }
                if key in self._blocked_n:
                    row["blocked_calls"] = self._blocked_n[key]
                    row["blocked_s"] = self._blocked_s[key]
                out[f"{op}|{backend}|b{bits}"] = row
            return out

    def clear(self) -> None:
        with self._lock:
            for d in (self._calls, self._traces, self._time_s,
                      self._blocked_s, self._blocked_n):
                d.clear()


# the one global the dispatch path checks
_stats: Optional[KernelStats] = None


def enable(*, block_every: int = 0) -> KernelStats:
    """Turn attribution on; returns the live collector."""
    global _stats
    _stats = KernelStats(block_every=block_every)
    return _stats


def disable() -> None:
    global _stats
    _stats = None


def active() -> Optional[KernelStats]:
    return _stats


def get() -> Dict[str, Dict[str, Any]]:
    """A snapshot of the live collector (``{}`` when disabled)."""
    return _stats.snapshot() if _stats is not None else {}


def _drain(probe) -> None:
    """Wait for the work queued on ``probe``'s stream (none on the CPU)."""
    dev = getattr(probe, "device", None)
    if dev is not None and dev.type == "cuda":
        import torch
        torch.cuda.current_stream(dev).synchronize()


def observe(op: str, backend: str, bits: int, probe: Any,
            fn, /, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under attribution.

    ``fn`` is the implementation ``dispatch.route`` already chose and
    ``backend`` its route; this only counts and times it. ``probe`` is one
    of the op's tensors: its device says which stream a blocked call
    drains. Called only with a collector enabled (dispatch checks first).
    The leading parameters are positional-only, so forwarded keyword
    arguments can never collide with them.
    """
    stats = _stats
    if stats is None:  # raced a disable(): just run
        return fn(*args, **kwargs)
    key = (op, backend, bits)
    block = stats.should_block(key)
    if block:
        _drain(probe)
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    t1 = time.perf_counter()
    blocked_s = None
    if block:
        _drain(probe)
        blocked_s = time.perf_counter() - t0
    stats.record_call(key, t1 - t0, blocked_s)
    return out


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """``torch.profiler`` over the with-block; on exit its Chrome trace is
    written to ``log_dir/torch_profile-<stamp>.json``. Yields the profiler
    (``key_averages()`` after the block)."""
    from torch.profiler import ProfilerActivity, profile
    import torch

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the block's kernels end inside
    prof.export_chrome_trace(
        os.path.join(log_dir, f"torch_profile-{stamp}.json"))
