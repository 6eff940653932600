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

Under a data-parallel mesh (active when it is called: the group the
rules split ``batch`` over) every rank runs the supervisor in lockstep,
and every decision that could part them is taken jointly: a failure
(raised or a NaN loss) and a straggler skip are MAX-reduced flags, one
before the step (the failure injector) and one before its state is
committed, so every rank retries, skips or commits together. A rank that
raises inside the step, between its collectives, cannot be recovered
this way: the others wait in the collective. Checkpoints are written by
rank 0 alone (``CheckpointManager(group=)``) and read by every rank.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import batch_group, current_mesh

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
    device_put_batch: Optional[Callable] = None,
    observer: Optional[Any] = None,
) -> TrainReport:
    """``step_fn(state, batch)`` moves the batch to the state's device
    itself (``training.steps.batch_to_device``; under data parallelism the
    step takes the global batch and moves only this rank's rows of each
    microbatch); ``device_put_batch``, as in the JAX package, maps each
    batch before the step sees it."""
    group = batch_group()
    flag_dev = current_mesh().device if group is not None else None

    def joint(*flags: bool) -> List[bool]:
        """The flags OR-ed over the data-parallel ranks (one MAX reduce;
        as they are without a group)."""
        if group is None:
            return list(flags)
        t = torch.tensor([int(f) for f in flags], dtype=torch.int32,
                         device=flag_dev)
        return [bool(v) for v in collectives.max_reduce(t, group).tolist()]

    def elsewhere() -> Exception:
        return RuntimeError(f"step {step} failed on another data-parallel "
                            f"rank")

    report = TrainReport()
    step_times: List[float] = []
    retries = 0
    data_iter = iter(data)
    step = 0

    ckpt.save(0, state, data_cursor=data.cursor, async_=False)

    while step < sup.max_steps:
        batch = next(data_iter)
        if device_put_batch is not None:
            batch = device_put_batch(batch)
        t0 = time.monotonic()
        err: Optional[Exception] = None
        try:
            if failure_injector is not None:
                failure_injector(step)
        except Exception as e:      # noqa: BLE001 - any failure retries
            err = e
        if group is not None and joint(err is not None)[0] and err is None:
            err = elsewhere()
        if err is None:
            try:
                new_state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])    # waits for the step
                if loss != loss:
                    raise FloatingPointError(f"NaN loss at step {step}")
            except Exception as e:  # noqa: BLE001
                err = e
        dt = time.monotonic() - t0
        straggler = (err is None and len(step_times)
                     >= sup.warmup_timing_steps
                     and dt > sup.straggler_factor
                     * statistics.median(step_times))
        if group is not None:
            failed, straggler = joint(err is not None, straggler)
            if failed and err is None:
                err = elsewhere()
            straggler = straggler and err is None

        if err is not None:
            report.failures_recovered += 1
            retries += 1
            if retries > sup.max_retries:
                if on_rebuild is not None:
                    state = on_rebuild(state)
                    report.rebuilds += 1
                    retries = 0
                    continue
                raise err
            last, state = ckpt.restore_latest(state)
            man = ckpt.manifest(last)
            data.seek(man["data_cursor"])
            data_iter = iter(data)
            step = man["step"]
            continue

        retries = 0
        if straggler:
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
