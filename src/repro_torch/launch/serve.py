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
``--arch`` takes every ported config: musicgen-medium's trace has
``(len, 4)`` prompts and its tokens are one id a codebook (it refuses
``--speculate-k``); phi-3-vision-4.2b serves its text trunk;
rwkv6-1.6b and zamba2-7b keep a recurrent state a slot, prefill at the
exact prompt length and refuse ``--speculate-k`` (rwkv6 has no pageable
layer: ``--page-size`` leaves it dense); deepseek-v3-671b keeps MLA's
latent cache dense whatever ``--page-size`` says, kimi-k2-1t-a32b pages;
at full depth neither fits one card (``chip_smoke.py`` phase 24 serves
them at full width and a cut depth), ``--smoke`` runs anywhere.

  python -m repro_torch.launch.serve --arch musicgen-medium --page-size 16
  python -m repro_torch.launch.serve --arch zamba2-7b --page-size 16

Mesh serving (``--mesh DATA,MODEL``): one process a card under torchrun,
each drawing the same seeded weights and keeping its shard
(``repro_torch.serving.engine``'s mesh section); rank 0 prints. On the
CPU, gloo ranks stand in for the cards:

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --smoke \
      --device cpu --mesh 2,2 --page-size 4
  torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch qwen2.5-32b --mesh 1,4 --page-size 16

``--mesh`` with more than one rank and no torchrun environment raises;
``--mesh 1,1`` runs a world of one without torchrun.

``--http`` on a mesh: rank 0 runs the gateway and its driver thread,
which steps the engine; every other rank follows (``Engine.follow``):
each step it takes rank 0's broadcast (clock, submissions, aborts),
applies it and steps in lockstep, until rank 0's ``stop``. An idle
gateway still steps every poll, so no rank waits long in a broadcast.
torchrun passes SIGINT to every rank: a follower ignores it and ends
only on rank 0's ``stop``; rank 0 aborts the live requests, broadcasts
``stop`` with those aborts, and every rank destroys the process group
and exits 0. A fatal step fails every stream, and rank 0 exits 1 at
once (the others may sit in any collective of that step), so torchrun
tears the group down.

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --smoke \
      --device cpu --mesh 2,2 --page-size 4 --http 127.0.0.1:8000
  curl -N localhost:8000/v1/completions -d \
      '{"prompt": [1,2,3], "max_tokens": 8, "stream": true}'
  kill -INT <torchrun's pid>

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
import builtins
import contextlib
import os
import signal
import sys
import threading
from typing import Callable, Optional

import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.lns import LNSFormat
from repro_torch.core.quantizer import QuantConfig
from repro_torch.distributed.params_sharding import LocalShard
from repro_torch.distributed.sharding import serving_rules
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import init_params
from repro_torch.obs import EngineObserver, kernel_stats
from repro_torch.optim.madam import MadamConfig, lns_leaf_encoder
from repro_torch.serving import Engine, max_trace_len, synthetic_trace


def build_engine(args) -> Engine:
    """Model, packed weights and engine for the parsed ``args``."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    qcfg = QuantConfig.lns_madam()
    mcfg = MadamConfig(update_format=LNSFormat(bits=args.serve_bits, gamma=8))
    mesh = shard = None
    if args.mesh:
        try:
            data, model = (int(v) for v in args.mesh.split(","))
        except ValueError:
            raise SystemExit(f"--mesh expects 'DATA,MODEL', got "
                             f"{args.mesh!r}") from None
        mesh = make_host_mesh(data, model, device=args.device)
        shard = LocalShard(mesh, serving_rules(cfg, mesh))
    params = init_params(cfg, seed=args.seed,
                         device=mesh.device if mesh else args.device,
                         leaf_fn=lns_leaf_encoder(mcfg), shard=shard)
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
                  device=None if mesh else args.device, mesh=mesh,
                  sharded_params=mesh is not None)


def serve_http(engine: Engine, http: str, model: str, max_queue: int,
               ready: Optional[Callable[[str, int], None]] = None) -> bool:
    """Run the gateway until interrupted; shutting down aborts the live
    requests, so their slots and pages are released. ``ready`` gets the
    bound address once the gateway listens. Under a mesh this is rank 0's
    part (the others follow, :func:`run_http`): the stop reaches the
    followers, and a fatal step ends the gateway at once. Returns False
    after a fatal step under a mesh, True otherwise."""
    from repro_torch.server.app import Gateway
    from repro_torch.server.driver import EngineDriver

    host, _, port = http.rpartition(":")
    mesh = engine._mesh is not None
    fatal = threading.Event()
    driver = EngineDriver(engine, max_inflight=max_queue,
                          on_fatal=(lambda exc: fatal.set()) if mesh
                          else None).start()

    async def run():
        gw = await Gateway(driver, host=host or "127.0.0.1",
                           port=int(port or 8000), model=model).start()
        h, p = gw.address
        print(f"gateway listening on http://{h}:{p}  "
              f"(slots={engine.num_slots} max_len={engine.max_len} "
              f"max_queue={max_queue})", flush=True)
        if ready is not None:
            ready(h, p)
        serving = asyncio.ensure_future(gw.serve_forever())
        try:
            while not serving.done() and not fatal.is_set():
                await asyncio.wait([serving], timeout=0.05)
            if fatal.is_set():
                await asyncio.sleep(0.2)   # the streams' error frames
        finally:
            serving.cancel()
            await gw.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        if mesh:   # a second interrupt must not cut the stop broadcast
            signal.signal(signal.SIGINT, signal.SIG_IGN)
        print("shutting down: aborting live requests", flush=True)
    finally:
        if not fatal.is_set():
            driver.shutdown(timeout=None if mesh else 10.0)
    return not fatal.is_set()


def run_http(engine: Engine, http: str, model: str, max_queue: int,
             ready: Optional[Callable[[str, int], None]] = None) -> None:
    """``--http``: :func:`serve_http` on one card or on rank 0 of a mesh;
    every other rank ignores SIGINT for the rest of the process (torchrun
    passes it to every rank) and follows rank 0's steps until its
    ``stop``. After a fatal step under a mesh rank 0 exits 1 at once,
    without the group's teardown: the followers may sit in a collective
    of that step, and torchrun ends them."""
    if not engine._root:
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        engine.follow()
        return
    if not serve_http(engine, http, model, max_queue, ready):
        print("fatal step under a mesh: exiting", flush=True)
        sys.stderr.flush()
        os._exit(1)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m",
                    help="one of " + ", ".join(sorted(ARCHS)))
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
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="serve on a (data, model) mesh of ranks started "
                         "by torchrun (one a card); e.g. '1,4'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    engine = build_engine(args)
    try:
        return _main(args, engine)
    finally:
        if engine._mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _main(args, engine) -> dict:
    cfg = engine.cfg
    root = engine._root
    # under a mesh rank 0 prints, the other ranks stay quiet
    print = builtins.print if root else (lambda *a, **k: None)
    observer = EngineObserver() if args.trace_dir else None
    engine.attach_observer(observer)
    nbytes = 0
    stack = [engine.params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, list):
            stack.extend(node)
        elif hasattr(node, "packed"):
            nbytes += node.packed.nbytes + node.scale.nbytes
        else:
            nbytes += node.nbytes
    print(f"arch={cfg.name} device={engine.device} serve weights "
          f"{nbytes / 2**20:.1f} MiB (packed {args.serve_bits}-bit LNS "
          f"codes + scales)"
          + (f" a rank, mesh {args.mesh}" if args.mesh else ""))
    if engine.device.type == "cuda":
        # the draw and the layer-chunked encode's peak, and the caches
        print(f"peak allocated after the engine is built: "
              f"{torch.cuda.max_memory_allocated(engine.device) / 2**30:.2f}"
              f" GiB")
    if args.http:
        try:
            run_http(engine, args.http, cfg.name, args.max_queue)
        finally:
            if observer is not None and root:
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
        agg = engine.run(trace if root else ())
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
