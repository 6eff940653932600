"""Serving CLI of the port.

Builds the model in the packed 8-bit LNS serving format from random
weights (seeded) and drives ``repro_torch.serving.Engine`` on the card.

Offline (default): replays a synthetic trace; prints throughput, TTFT,
the prefix cache's hits and each kernel's launch count.

  python -m repro_torch.launch.serve --arch smollm-135m \
      --requests 8 --slots 4 --prompt-len 32 --gen-len 32 --page-size 16 \
      [--alloc-policy ondemand] [--speculate-k 4 --draft-bitwidth 6]

Online (``--http HOST:PORT``): serves the asyncio gateway
(``repro_torch.server``) over the same engine: ``POST /v1/completions``
(SSE with ``"stream": true``), ``DELETE /v1/requests/{id}``, ``GET
/health``, ``/metrics`` and ``/metrics.json``. Ctrl-C shuts down cleanly
(live requests are aborted, their slots and pages released).

  python -m repro_torch.launch.serve --smoke --page-size 4 \
      --http 127.0.0.1:8000
  curl -N localhost:8000/v1/completions -d \
      '{"prompt": [1,2,3], "max_tokens": 8, "stream": true}'

``--device cpu`` runs the plain PyTorch versions of the kernels instead.

Observability: ``--trace-dir DIR`` attaches an ``EngineObserver`` (request
spans and the step timeline), prints the run's time breakdown and exports
a Chrome trace into DIR at the end (online: at shutdown);
``--kernel-stats`` prints the time of every dispatched kernel call by
(op, backend, bits); ``--torch-profile DIR`` writes a ``torch.profiler``
Chrome trace of the offline run into DIR.

  python -m repro_torch.launch.serve --smoke --device cpu --page-size 4 \
      --speculate-k 2 --trace-dir /tmp/trace --kernel-stats
  python -m repro_torch.obs.validate /tmp/trace/*.trace.json --require-spec
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.lns import LNSFormat
from repro_torch.core.quantizer import QuantConfig
from repro_torch.kernels import ops
from repro_torch.models.model import init_params
from repro_torch.obs import EngineObserver, kernel_stats
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
                  prefix_cache=not args.no_prefix_cache,
                  alloc_policy=args.alloc_policy,
                  speculate_k=args.speculate_k,
                  draft_bitwidth=args.draft_bitwidth,
                  spec_autotune=args.spec_autotune,
                  checkpoint_id=f"{cfg.name}-seed{args.seed}-init",
                  device=args.device)


def serve_http(engine: Engine, http: str, model: str,
               max_queue: int) -> None:
    """Run the gateway until interrupted; shutting down aborts the live
    requests, so their slots and pages are released."""
    from repro_torch.server.app import Gateway
    from repro_torch.server.driver import EngineDriver

    host, _, port = http.rpartition(":")
    driver = EngineDriver(engine, max_inflight=max_queue).start()

    async def run():
        gw = await Gateway(driver, host=host or "127.0.0.1",
                           port=int(port or 8000), model=model).start()
        h, p = gw.address
        print(f"gateway listening on http://{h}:{p}  "
              f"(slots={engine.num_slots} max_len={engine.max_len} "
              f"max_queue={max_queue})", flush=True)
        try:
            await gw.serve_forever()
        finally:
            await gw.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        print("shutting down: aborting live requests", flush=True)
    finally:
        driver.shutdown()


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
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable shared-prefix page reuse")
    ap.add_argument("--alloc-policy", default="reserve",
                    choices=("reserve", "ondemand"),
                    help="paged-KV page claiming: 'reserve' takes the "
                         "worst case up front, 'ondemand' grows the block "
                         "table as decode proceeds and preempts by "
                         "recompute under pool pressure")
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="self-speculative decoding: draft tokens per "
                         "draft+verify cycle (0 = off)")
    ap.add_argument("--draft-bitwidth", type=int, default=6,
                    help="wire bitwidth of the draft re-grid view "
                         "(8 = identity draft; 6/7 = coarser LNS grid)")
    ap.add_argument("--spec-autotune", action="store_true",
                    help="explore (draft bitwidth, k) arms from "
                         "accept-rate/throughput feedback")
    ap.add_argument("--http", default=None, metavar="HOST:PORT",
                    help="serve online over HTTP/SSE instead of replaying "
                         "a synthetic trace (port 0 = any free port)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="per-slot cache capacity (online mode; offline "
                         "derives it from the trace)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission watermark: live requests beyond this "
                         "are refused with 429")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="trace request spans and the step timeline; "
                         "export Chrome trace-event JSON (opens in "
                         "Perfetto) into DIR when the run ends")
    ap.add_argument("--torch-profile", default=None, metavar="DIR",
                    help="wrap the offline run in torch.profiler and "
                         "write its Chrome trace into DIR")
    ap.add_argument("--kernel-stats", action="store_true",
                    help="per-(op, backend, bits) kernel-time "
                         "attribution, printed after an offline run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    engine = build_engine(args)
    cfg = engine.cfg
    observer = EngineObserver() if args.trace_dir else None
    engine.attach_observer(observer)
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
    if args.http:
        try:
            serve_http(engine, args.http, cfg.name, args.max_queue)
        finally:
            if observer is not None:
                print("trace:", observer.export(args.trace_dir,
                                                tag=cfg.name))
        return {}
    lengths = args.lengths or ("uniform" if args.mixed else "fixed")
    trace = synthetic_trace(cfg, requests=args.requests,
                            prompt_len=args.prompt_len, gen_len=args.gen_len,
                            lengths=lengths, rate=args.rate, seed=args.seed)
    ops.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        stats = None
        if args.kernel_stats:
            stats = kernel_stats.enable()
            stack.callback(kernel_stats.disable)
        if args.torch_profile:
            stack.enter_context(
                kernel_stats.profiler_trace(args.torch_profile))
        agg = engine.run(trace)
    print(f"slots={args.slots} requests={args.requests} "
          f"decode_steps={engine.decode_steps} prefills={engine.prefills}")
    if engine.page_size:
        print(f"paged KV: page_size={engine.page_size} "
              f"pages={engine.num_pages} alloc_policy={engine.alloc_policy} "
              f"preemptions={engine.preemptions} "
              f"decode_page_allocs={engine.decode_page_allocs} "
              f"prefix_hits={engine.prefix_hits} "
              f"reused_tokens={engine.prefix_reused_tokens}")
    if engine.spec is not None:
        print(f"speculative: cycles={engine.spec_cycles} "
              f"k={engine._spec_arm[1]} draft_bits={engine._spec_arm[0]} "
              f"accept_rate={engine.spec_accept_rate:.3f} "
              f"emitted={engine.spec_emitted} "
              f"fallbacks={engine.spec_fallbacks} "
              f"pages_trimmed={engine.spec_pages_trimmed}")
    print(f"completed {int(agg['completed'])} requests in "
          f"{agg['wall_s']:.2f}s: {agg['tokens_per_s']:.1f} tok/s, "
          f"ttft mean {agg['ttft_mean_s']:.3f}s p95 {agg['ttft_p95_s']:.3f}s, "
          f"latency p50 {agg['latency_p50_s']:.3f}s "
          f"p95 {agg['latency_p95_s']:.3f}s")
    print("kernel launches:", ops.launch_counts())
    for rs in sorted(engine.finished, key=lambda r: r.request.rid)[:4]:
        print(f"  req {rs.request.rid}: prompt {rs.request.prompt_len} -> "
              f"{len(rs.generated)} new tokens, sample {rs.generated[:8]}")
    if observer is not None:
        bd = agg["time_breakdown"] = observer.time_breakdown(agg["wall_s"])
        print(f"time breakdown: prefill {bd.get('prefill_share', 0):.1%} "
              f"decode {bd.get('decode_share', 0):.1%} "
              f"spec {bd.get('spec_share', 0):.1%} "
              f"host {bd.get('host_share', 0):.1%}")
        agg["trace"] = observer.export(args.trace_dir, tag=cfg.name)
        print("trace:", agg["trace"])
    if stats is not None:
        agg["kernel_stats"] = stats.snapshot()
        for name, row in agg["kernel_stats"].items():
            print(f"  kernel {name}: calls={row['calls']} "
                  f"traces={row['traces']} time={row['time_s']:.4f}s")
    return agg


if __name__ == "__main__":
    main()
