"""Training CLI of the port: LNS-Madam on synthetic tokens.

Builds the train state in the 16-bit LNS update store from random weights
(seed 0), and runs the fault-tolerant supervisor with async checkpoints;
prints the parameter count, then throughput and the loss trajectory.

  python -m repro_torch.launch.train --arch smollm-135m \
      --steps 6 --batch 8 --seq 256

``--format`` picks the quantizers: ``lns8`` (the paper's B=8, γ=8),
``fp8`` (the paper's e4m3 baseline: no GEMM routes, the weights stay in
the LNS store that Madam steps) or ``fp32``. ``--device cpu`` runs the
plain PyTorch versions of the kernels (use it with ``--smoke``). Without
``--ckpt-dir`` the checkpoints go to a temporary directory that is
removed at the end. ``--arch phi-3-vision-4.2b`` trains on
``SyntheticLM``'s 576 patches a row in front of ``--seq`` text tokens
(the loss covers the text), ``--arch musicgen-medium`` on (B, S, 4)
codebook tokens; ``--arch rwkv6-1.6b`` and ``--arch zamba2-7b`` run their
recurrences chunk-parallel; ``--arch deepseek-v3-671b`` and ``--arch
kimi-k2-1t-a32b`` add the MoE balance loss (and deepseek's MTP loss) and
fit one card only with ``--smoke`` (6.7e11 and 1.03e12 parameters).

Observability: ``--trace-dir``, ``--numerics-log`` or ``--quiet=false``
attach a ``NumericsObserver`` and build the step with ``numerics=True``
(K4 steps the weights and returns per-layer stats; K3 otherwise): the
trace (``train_step`` spans and numerics counter tracks) is exported into
``--trace-dir`` at the end, the jsonl step log goes to
``--numerics-log``, and a progress line is printed every
``--progress-every`` steps. ``--kernel-stats`` prints the time of every
dispatched kernel call by (op, backend, bits); ``--torch-profile DIR``
writes a ``torch.profiler`` Chrome trace of the run into DIR.

  python -m repro_torch.launch.train --smoke --device cpu --steps 3 \
      --trace-dir /tmp/trace --numerics-log /tmp/trace/steps.jsonl \
      --kernel-stats --quiet=false --progress-every 1

Data-parallel training (``--mesh DATA,1``): one process a card under
torchrun, as JAX's CLI trains on ``make_host_mesh(data=device_count)``.
Every rank draws the same state from seed 0 and steps the global batch
``--batch`` (each rank computes its ``--batch / DATA`` rows; scales, the
loss and the gradients are the global batch's), rank 0 prints and
writes the checkpoints and the observability outputs:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch smollm-135m --mesh 4,1 --steps 3 --batch 32 --seq 256

``--mesh`` with more than one rank and no torchrun environment raises,
and so does ``MODEL > 1``: the CLI is data-parallel, as JAX's is.
Tensor-parallel training of the dense family is
``training.steps.build_train_step`` built under a ``(data, model)`` mesh
and ``sharding.data_rules`` on a sharded state (``init_train_state(
shard=)``), as ``launch.dryrun`` and ``chip_smoke.py --mesh-tp`` run it.
"""
from __future__ import annotations

import argparse
import builtins
import contextlib
import tempfile
import time

from repro_torch.configs import ARCHS, get_config, get_rules, get_smoke_config
from repro_torch.core.lns import LNSFormat, is_lns_weight
from repro_torch.core.quantizer import QuantConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import batch_group, shard_ctx
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.obs import NumericsObserver, kernel_stats
from repro_torch.optim.madam import MadamConfig
from repro_torch.training.data import SyntheticLM
from repro_torch.training.loop import SupervisorConfig, run_supervised
from repro_torch.training.steps import build_train_step, init_train_state
from repro_torch.tree import leaves

def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m",
                    help="one of " + ", ".join(sorted(ARCHS)))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU scale)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2.0 ** -7)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--format", default="lns8",
                    choices=["lns8", "fp8", "fp32"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="collect per-layer numerics stats and export a "
                         "Chrome trace (train_step spans and numerics "
                         "counter tracks; opens in Perfetto) into DIR at "
                         "the end")
    ap.add_argument("--numerics-log", default=None, metavar="FILE",
                    help="jsonl step log (a line a step: loss, wall time, "
                         "per-layer LNS health)")
    ap.add_argument("--torch-profile", default=None, metavar="DIR",
                    help="wrap the run in torch.profiler and write its "
                         "Chrome trace into DIR")
    ap.add_argument("--kernel-stats", action="store_true",
                    help="per-(op, backend, bits) kernel-time attribution, "
                         "printed after the run")
    ap.add_argument("--quiet", default=True,
                    type=lambda s: s.lower() not in ("0", "false", "no"),
                    metavar="BOOL",
                    help="--quiet=false prints a progress line every "
                         "--progress-every steps through the observer")
    ap.add_argument("--progress-every", type=int, default=10)
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="data-parallel training on a (data, 1) mesh of "
                         "ranks started by torchrun (one a card); e.g. "
                         "'4,1'; --batch is the global batch. MODEL > 1 "
                         "is refused, as JAX's CLI trains data-parallel "
                         "only (tensor-parallel training is "
                         "build_train_step under a (data, model) mesh)")
    return ap


def _quant_config(fmt: str) -> QuantConfig:
    return {"lns8": QuantConfig.lns_madam(), "fp8": QuantConfig.fp8(),
            "fp32": QuantConfig.full_precision()}[fmt]


def _mesh(spec: str, device):
    try:
        data, model = (int(v) for v in spec.split(","))
    except ValueError:
        raise SystemExit(f"--mesh expects 'DATA,MODEL', got {spec!r}") \
            from None
    if model != 1:
        raise SystemExit(
            f"--mesh {spec}: the CLI trains data-parallel only (MODEL must "
            f"be 1), as the JAX CLI does; tensor-parallel training is "
            f"training.steps.build_train_step built under a (data, model) "
            f"mesh and sharding.data_rules, on a sharded state "
            f"(init_train_state(shard=))")
    return make_host_mesh(data, model, device=device)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    mesh = owned = None
    if args.mesh:
        import torch.distributed as dist
        owned = not dist.is_initialized()
        mesh = _mesh(args.mesh, args.device)
    try:
        with (shard_ctx(mesh, get_rules(args.arch)) if mesh is not None
              else contextlib.nullcontext()):
            return _main(args, mesh)
    finally:
        if owned:
            import torch.distributed as dist
            dist.destroy_process_group()


def _main(args, mesh) -> dict:
    qcfg = _quant_config(args.format)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    group = batch_group()
    root = mesh is None or mesh.rank == 0
    # under a mesh rank 0 prints, the other ranks stay quiet
    print = builtins.print if root else (lambda *a, **k: None)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    # Q_U, the store Madam steps, is the quantizer config's where it is
    # an LNS format; otherwise (fp32, and fp8's FP16 Q_U, which the step
    # does not read) Madam's default store, as the JAX CLI builds it
    mcfg = (MadamConfig(lr=args.lr, update_format=qcfg.update)
            if isinstance(qcfg.update, LNSFormat) else MadamConfig(lr=args.lr))
    state = init_train_state(cfg, mcfg, seed=0, device=device)
    n = sum(p.packed.numel() + p.scale.numel() if is_lns_weight(p)
            else p.numel() for _, p in leaves(state.params))
    print(f"arch={cfg.name} params={n:,} format={args.format} "
          f"device={device}"
          + (f" mesh={dict(mesh.shape)}" if mesh is not None else ""))
    observed = bool(args.trace_dir or args.numerics_log or not args.quiet)
    observer = stats = None
    step_fn = build_train_step(cfg, qcfg, mcfg, accum_steps=args.accum_steps,
                               numerics=observed)
    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq)
    with contextlib.ExitStack() as stack:
        ckpt_dir = args.ckpt_dir
        if ckpt_dir is None:
            # one temporary directory, rank 0's, that every rank reads
            tmp = (stack.enter_context(tempfile.TemporaryDirectory())
                   if root else None)
            ckpt_dir = (collectives.broadcast_object(tmp, group=group)
                        if group is not None else tmp)
            if group is not None:
                import torch.distributed as dist
                # rank 0 removes it only after every rank is done
                stack.callback(dist.barrier, group=group)
        ckpt = CheckpointManager(ckpt_dir, keep=3, group=group)
        if observed and root:
            observer = NumericsObserver(log_path=args.numerics_log,
                                        quiet=args.quiet,
                                        progress_every=args.progress_every)
            stack.callback(observer.close)
        if args.kernel_stats and root:
            stats = kernel_stats.enable()
            stack.callback(kernel_stats.disable)
        if args.torch_profile and root:
            stack.enter_context(
                kernel_stats.profiler_trace(args.torch_profile))
        t0 = time.monotonic()
        # every rank reads the global batch; the step moves the rank's
        # rows of each microbatch to its card
        report = run_supervised(
            step_fn, state, data, ckpt,
            SupervisorConfig(max_steps=args.steps,
                             save_every=args.save_every),
            observer=observer)
        dt = time.monotonic() - t0
    # the global batch's tokens
    tok = args.steps * args.batch * args.seq
    print(f"done: {report.steps_done} steps in {dt:.1f}s "
          f"({tok / dt:.0f} tok/s) loss {report.losses[0]:.4f} -> "
          f"{report.losses[-1]:.4f}; recovered={report.failures_recovered} "
          f"stragglers={report.straggler_events}")
    out = {"params": n, "steps": report.steps_done, "wall_s": dt,
           "tokens_per_s": tok / dt, "losses": report.losses,
           "failures_recovered": report.failures_recovered,
           "straggler_events": report.straggler_events}
    if mesh is not None:
        out["mesh"] = dict(mesh.shape)
        out["rank"] = mesh.rank
    if observer is not None:
        summary = out["numerics"] = observer.summary()
        worst = summary.get("worst_sat_frac")
        if worst is not None:
            print(f"numerics: worst saturation {worst:.4f} "
                  f"({summary['worst_sat_site']}), update qerr mean "
                  f"{summary.get('update.qerr_rel_mean', 0):.2e}")
        if args.trace_dir:
            out["trace"] = observer.export(args.trace_dir, tag=cfg.name)
            print("trace:", out["trace"]["trace"])
    if stats is not None:
        out["kernel_stats"] = stats.snapshot()
        for name, row in out["kernel_stats"].items():
            print(f"  kernel {name}: calls={row['calls']} "
                  f"traces={row['traces']} time={row['time_s']:.4f}s")
    return out


if __name__ == "__main__":
    main()
