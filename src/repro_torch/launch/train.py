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
removed at the end.
"""
from __future__ import annotations

import argparse
import tempfile
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.lns import LNSFormat, is_lns_weight
from repro_torch.core.quantizer import QuantConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.optim.madam import MadamConfig
from repro_torch.training.data import SyntheticLM
from repro_torch.training.loop import SupervisorConfig, run_supervised
from repro_torch.training.steps import build_train_step, init_train_state
from repro_torch.tree import leaves

_UNPORTED = {
    "trace_dir": "--trace-dir", "numerics_log": "--numerics-log",
    "jax_profile": "--jax-profile", "kernel_stats": "--kernel-stats",
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
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
    # the observer's flags: accepted for the JAX CLI's sake, not ported yet
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--numerics-log", default=None)
    ap.add_argument("--jax-profile", default=None)
    ap.add_argument("--kernel-stats", action="store_true")
    ap.add_argument("--quiet", default=True,
                    type=lambda s: s.lower() not in ("0", "false", "no"))
    return ap


def _quant_config(fmt: str) -> QuantConfig:
    return {"lns8": QuantConfig.lns_madam(), "fp8": QuantConfig.fp8(),
            "fp32": QuantConfig.full_precision()}[fmt]


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    for attr, flag in _UNPORTED.items():
        if getattr(args, attr):
            raise NotImplementedError(f"{flag} needs the observer, which is "
                                      f"not ported yet")
    if not args.quiet:
        raise NotImplementedError("--quiet=false needs the observer, which "
                                  "is not ported yet")
    qcfg = _quant_config(args.format)
    device = resolve_device(args.device)
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
          f"device={device}")
    step_fn = build_train_step(cfg, qcfg, mcfg, accum_steps=args.accum_steps)
    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(args.ckpt_dir or tmp, keep=3)
        t0 = time.monotonic()
        report = run_supervised(
            step_fn, state, data, ckpt,
            SupervisorConfig(max_steps=args.steps,
                             save_every=args.save_every))
        dt = time.monotonic() - t0
    tok = args.steps * args.batch * args.seq
    print(f"done: {report.steps_done} steps in {dt:.1f}s "
          f"({tok / dt:.0f} tok/s) loss {report.losses[0]:.4f} -> "
          f"{report.losses[-1]:.4f}; recovered={report.failures_recovered} "
          f"stragglers={report.straggler_events}")
    return {"params": n, "steps": report.steps_done, "wall_s": dt,
            "tokens_per_s": tok / dt, "losses": report.losses,
            "failures_recovered": report.failures_recovered,
            "straggler_events": report.straggler_events}


if __name__ == "__main__":
    main()
