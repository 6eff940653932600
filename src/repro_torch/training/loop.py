"""Fault-tolerant training supervisor, as ``repro.training.loop``.

Wraps a train step with:

* periodic async checkpointing (atomic, keep-k);
* restart from the last checkpoint when a step raises or its loss is NaN
  (injectable in tests through ``failure_injector``), with the data
  stream re-seeked to the manifest's cursor;
* a step-time watchdog: a step slower than ``straggler_factor`` times the
  running median is counted and, under the ``"skip"`` policy, dropped;
* an ``on_rebuild`` hook, called after ``max_retries`` failures in a row
  to rebuild the state (elastic down-shift);
* an ``observer`` hook whose ``record_step(step, metrics, walltime_s)``
  sees every committed step. The supervisor itself never prints.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, List, Optional

from repro_torch.checkpoint import CheckpointManager

__all__ = ["SupervisorConfig", "TrainReport", "run_supervised"]


@dataclasses.dataclass
class SupervisorConfig:
    max_steps: int = 100
    save_every: int = 20
    max_retries: int = 3
    straggler_factor: float = 3.0
    straggler_policy: str = "flag"   # "flag" | "skip"
    warmup_timing_steps: int = 3


@dataclasses.dataclass
class TrainReport:
    steps_done: int = 0
    failures_recovered: int = 0
    straggler_events: int = 0
    skipped_batches: int = 0
    rebuilds: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)


def run_supervised(
    step_fn: Callable,
    state,
    data,
    ckpt: CheckpointManager,
    sup: SupervisorConfig,
    *,
    failure_injector: Optional[Callable[[int], None]] = None,
    on_rebuild: Optional[Callable[[Any], Any]] = None,
    observer: Optional[Any] = None,
) -> TrainReport:
    """``step_fn(state, batch)`` moves the batch to the state's device
    itself (``training.steps.batch_to_device``)."""
    report = TrainReport()
    step_times: List[float] = []
    retries = 0
    data_iter = iter(data)
    step = 0

    ckpt.save(0, state, data_cursor=data.cursor, async_=False)

    while step < sup.max_steps:
        batch = next(data_iter)
        t0 = time.monotonic()
        try:
            if failure_injector is not None:
                failure_injector(step)
            new_state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])    # waits for the step to finish
            if loss != loss:
                raise FloatingPointError(f"NaN loss at step {step}")
        except Exception:
            report.failures_recovered += 1
            retries += 1
            if retries > sup.max_retries:
                if on_rebuild is not None:
                    state = on_rebuild(state)
                    report.rebuilds += 1
                    retries = 0
                    continue
                raise
            last = ckpt.latest_step()
            _, state = ckpt.restore_latest(state)
            man = ckpt.manifest(last)
            data.seek(man["data_cursor"])
            data_iter = iter(data)
            step = man["step"]
            continue

        retries = 0
        dt = time.monotonic() - t0
        if len(step_times) >= sup.warmup_timing_steps:
            med = statistics.median(step_times)
            if dt > sup.straggler_factor * med:
                report.straggler_events += 1
                if sup.straggler_policy == "skip":
                    report.skipped_batches += 1
                    step_times.append(dt)
                    continue
        step_times.append(dt)

        state = new_state
        step += 1
        report.steps_done += 1
        report.losses.append(loss)
        if observer is not None:
            observer.record_step(step, metrics, walltime_s=dt)
        if step % sup.save_every == 0:
            ckpt.save(step, state, data_cursor=data.cursor)

    ckpt.save(sup.max_steps, state, data_cursor=data.cursor, async_=False)
    ckpt.wait()
    return report
