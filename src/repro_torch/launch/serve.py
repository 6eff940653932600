"""Serving CLI of the port: replay a synthetic trace through the engine.

Builds the model in the packed 8-bit LNS serving format from random
weights (seeded), and drives ``repro_torch.serving.Engine`` on the card;
prints throughput, TTFT and each kernel's launch count.

  python -m repro_torch.launch.serve --arch smollm-135m \
      --requests 8 --slots 4 --prompt-len 32 --gen-len 32 --page-size 16

``--device cpu`` runs the plain PyTorch versions of the kernels instead.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.lns import LNSFormat
from repro_torch.core.quantizer import QuantConfig
from repro_torch.kernels import ops
from repro_torch.models.model import init_params
from repro_torch.optim.madam import MadamConfig, init_lns_params
from repro_torch.serving import Engine, max_trace_len, synthetic_trace


def build_engine(args) -> Engine:
    """Model, packed weights and engine for the parsed ``args``."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    qcfg = QuantConfig.lns_madam()
    mcfg = MadamConfig(update_format=LNSFormat(bits=args.serve_bits, gamma=8))
    params = init_lns_params(
        init_params(cfg, seed=args.seed, device=args.device), mcfg)
    lengths = args.lengths or ("uniform" if args.mixed else "fixed")
    max_len = args.max_len or max_trace_len(args.prompt_len, args.gen_len,
                                            lengths)
    return Engine(cfg, qcfg, params, num_slots=args.slots, max_len=max_len,
                  page_size=args.page_size, num_pages=args.num_pages,
                  alloc_policy=args.alloc_policy, device=args.device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch width (concurrent sequences)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--mixed", action="store_true",
                    help="alias for --lengths uniform")
    ap.add_argument("--lengths", default=None,
                    choices=("fixed", "uniform", "bimodal"))
    ap.add_argument("--rate", type=float, default=0.0,
                    help="offered load in requests/s (0 = all at t=0)")
    ap.add_argument("--serve-bits", type=int, default=8,
                    help="LNS weight bitwidth for serving")
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV page size in tokens (paged KV pools)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool pages per layer")
    ap.add_argument("--alloc-policy", default="reserve",
                    choices=("reserve", "ondemand"))
    ap.add_argument("--max-len", type=int, default=None,
                    help="per-slot cache capacity (default: from the trace)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    engine = build_engine(args)
    cfg = engine.cfg
    nbytes = 0
    stack = [engine.params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif hasattr(node, "packed"):
            nbytes += node.packed.nbytes + node.scale.nbytes
        else:
            nbytes += node.nbytes
    print(f"arch={cfg.name} device={engine.device} serve weights "
          f"{nbytes / 2**20:.1f} MiB (packed {args.serve_bits}-bit LNS "
          f"codes + scales)")
    lengths = args.lengths or ("uniform" if args.mixed else "fixed")
    trace = synthetic_trace(cfg, requests=args.requests,
                            prompt_len=args.prompt_len, gen_len=args.gen_len,
                            lengths=lengths, rate=args.rate, seed=args.seed)
    ops.reset_launch_counts()
    agg = engine.run(trace)
    print(f"slots={args.slots} requests={args.requests} "
          f"decode_steps={engine.decode_steps} prefills={engine.prefills}")
    if engine.page_size:
        print(f"paged KV: page_size={engine.page_size} "
              f"pages={engine.num_pages} alloc_policy={engine.alloc_policy}")
    print(f"completed {int(agg['completed'])} requests in "
          f"{agg['wall_s']:.2f}s: {agg['tokens_per_s']:.1f} tok/s, "
          f"ttft mean {agg['ttft_mean_s']:.3f}s p95 {agg['ttft_p95_s']:.3f}s, "
          f"latency p50 {agg['latency_p50_s']:.3f}s "
          f"p95 {agg['latency_p95_s']:.3f}s")
    print("kernel launches:", ops.launch_counts())
    for rs in sorted(engine.finished, key=lambda r: r.request.rid)[:4]:
        print(f"  req {rs.request.rid}: prompt {rs.request.prompt_len} -> "
              f"{len(rs.generated)} new tokens, sample {rs.generated[:8]}")
    return agg


if __name__ == "__main__":
    main()
