#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the four CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. Hold each kernel against its plain PyTorch version on the card at the
   serving shapes of smollm-135m, and time the kernel, the plain version
   and a one-call PyTorch yardstick (``library_ms``) where one exists.
4. Serve smollm-135m at full width with random packed 8-bit LNS weights:
   the paged layout (8 requests, 4 slots, 32+32 tokens, page 16), then a
   short dense-layout run. Each run's kernel launch counts are zeroed just
   before it and read just after; every kernel of the path must have run.
5. One batch-1 prefill plus 4 greedy decode steps at full width through
   the kernels and again through the plain versions on the same card:
   logits within the stated tolerance, printed beside the noise floor of
   a pure accumulation-order change; tokens equal where the plain
   version's top-2 margin exceeds the tolerance.
6. Profile 3 decode steps with ``torch.profiler``: wall time, device busy
   time and share, and the kernels that take it.

The next-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Full results also go to
``chiprun_out/chip_smoke.json``. Nothing here imports JAX.
"""
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor
# FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# tolerances of the kernel-vs-plain checks (phase 3) and why:
# K2: both sides multiply the same bf16-rounded decodes exactly in f32 and
#     differ only in summation order over K <= 1536
K2_RTOL = 1e-4
# K5: f32 online softmax (kernel) vs a one-shot softmax (plain), expf vs
#     torch.exp; outputs are O(1)
K5_ATOL = 1e-4
# phase 5: the random-weight 30-layer model is chaotic under any change of
# rounding: a K2 summation-order difference rounds an activation the other
# way, a per-tensor Q_log code then moves by a whole step (2^(1/8)), and
# such flips compound over depth. Changing nothing but the plain GEMM's
# accumulation (f32 -> f64) moves the logits by ~6% of their largest value
# (the "floor" this script measures beside the kernels' error); the kernels
# are held to 15%
LOGIT_RTOL = 0.15

SERVE_PAGED = ["--requests", "8", "--slots", "4", "--prompt-len", "32",
               "--gen-len", "32", "--page-size", "16"]
SERVE_DENSE = ["--requests", "4", "--slots", "4", "--prompt-len", "32",
               "--gen-len", "8"]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, iters=20, replays=10):
    """Device time of one ``fn`` call in ms: ``iters`` calls captured in a
    CUDA graph, replayed ``replays`` times between two CUDA events. The
    graph removes the host's launch gaps, so this is the time the card
    spends, which ``bound_ms`` bounds from below."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def eager_ms(torch, fn, iters=50):
    """Time per call issued one after another from Python, as the engine
    issues them (host launch overhead included), in ms."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound_ms(nbytes, flops, peak):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_check(torch, ops, ref, fmt, shapes):
    """K1 words equal, except where the unrounded exponent sits within
    2^-10 of a half-integer (f32 log2 may round either way there)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for R, C in shapes:
        x = (torch.randn((R, C), generator=gen, device="cuda") * 3.0
             ).to(torch.bfloat16)
        kw, ks = ops.encode_pack(x, fmt)
        pw, ps = ref.encode_pack(x, fmt)
        check(torch.equal(ks, ps), f"K1 {R}x{C}: scales differ")
        e = -torch.log2(torch.clamp_min(x.double().abs() / ps.double(),
                                        torch.finfo(torch.float32).tiny))
        e = e * fmt.gamma
        near = (e - torch.floor(e) - 0.5).abs() < 2.0 ** -10
        diff = kw.int() != pw.int()
        bad = int((diff & ~near).sum())
        check(bad == 0, f"K1 {R}x{C}: {bad} words differ away from a tie")
        err = int((kw.int() - pw.int()).abs().max())
        nbytes = R * C * 2 + R * 4 + R * C
        b, by = bound_ms(nbytes, 10 * R * C, F32_FLOPS)
        rows.append(dict(
            shape=[R, C], tie_words=int(diff.sum()),
            near_half=int(near.sum()), max_abs_err=err,
            ms=cuda_ms(torch, lambda: ops.encode_pack(x, fmt)),
            eager_ms=eager_ms(torch, lambda: ops.encode_pack(x, fmt)),
            plain_ms=cuda_ms(torch, lambda: ref.encode_pack(x, fmt)),
            bound_ms=b, bound_by=by, library_ms=None))
        print(f"K1 encode_pack {R}x{C}: words differing at ties "
              f"{rows[-1]['tie_words']} (near-half elements "
              f"{rows[-1]['near_half']}), kernel {rows[-1]['ms']:.4f} ms "
              f"(eager {rows[-1]['eager_ms']:.4f} ms), "
              f"plain {rows[-1]['plain_ms']:.4f} ms, bound {b:.5f} ms")
    return rows


def k2_check(torch, ops, ref, fmt, shapes):
    from repro_torch.core.lns import lns_decode_packed
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for M, K, N in shapes:
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        pa, sa = ref.encode_pack(x, fmt)
        # >= 100 MB of weight copies rotate through the timed calls (one
        # graph node each) so the weights come from HBM, not the 50 MB L2,
        # as in a decode step that walks 30 layers of weights
        n_buf = max(64, -(-100_000_000 // (K * N)))
        pbs = [torch.randint(0, 256, (K, N), generator=gen, device="cuda",
                             dtype=torch.uint8) for _ in range(n_buf)]
        sb = torch.exp2(torch.randint(-6, -2, (1, N), generator=gen,
                                      device="cuda").float())
        out = ops.qmatmul(pa, pbs[0], fmt, sa, sb,
                          compute_dtype=torch.bfloat16)
        want = ref.qmatmul(pa, pbs[0], fmt, sa, sb,
                           compute_dtype=torch.bfloat16)
        err = float((out - want).abs().max())
        lim = K2_RTOL * float(want.abs().max())
        check(err <= lim, f"K2 {M}x{K}x{N}: max err {err} > {lim}")
        a16 = lns_decode_packed(pa, fmt, torch.bfloat16)
        b16 = [lns_decode_packed(p, fmt, torch.bfloat16) for p in pbs]
        it = {"i": 0}

        def rot():
            it["i"] = (it["i"] + 1) % len(pbs)
            return it["i"]

        nbytes = M * K + K * N + 4 * (M + N) + 4 * M * N
        b, by = bound_ms(nbytes, 2 * M * N * K, BF16_FLOPS)
        rows.append(dict(
            shape=[M, K, N], max_abs_err=err,
            ms=cuda_ms(torch, lambda: ops.qmatmul(
                pa, pbs[rot()], fmt, sa, sb, compute_dtype=torch.bfloat16),
                iters=n_buf),
            eager_ms=eager_ms(torch, lambda: ops.qmatmul(
                pa, pbs[rot()], fmt, sa, sb, compute_dtype=torch.bfloat16)),
            plain_ms=cuda_ms(torch, lambda: ref.qmatmul(
                pa, pbs[rot()], fmt, sa, sb, compute_dtype=torch.bfloat16),
                iters=n_buf, replays=3),
            library_ms=cuda_ms(torch, lambda: torch.matmul(a16, b16[rot()]),
                               iters=n_buf),
            bound_ms=b, bound_by=by))
        r = rows[-1]
        print(f"K2 qmatmul {M}x{K}x{N}: max err {err:.3e} (limit {lim:.3e}), "
              f"kernel {r['ms']:.4f} ms (eager {r['eager_ms']:.4f} ms), "
              f"plain {r['plain_ms']:.4f} ms, "
              f"torch.matmul bf16 {r['library_ms']:.4f} ms, bound {b:.5f} ms")
    return rows


def k5_inputs(torch, B, S, lengths, packed, fmt, gen):
    H, KV, HD, PAGE, MP = 9, 3, 64, 16, 5
    P = 4 * MP + 1  # the serving pool: 4 slots x 5 pages + the null page
    q = torch.randn((B, S, H, HD), generator=gen, device="cuda").to(
        torch.bfloat16)
    perm = torch.randperm(P - 1, generator=gen, device="cuda")[:B * MP]
    bt = perm.reshape(B, MP).to(torch.int32).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if packed:
        kp = torch.randint(0, 256, (P, PAGE, KV, HD), generator=gen,
                           device="cuda", dtype=torch.uint8)
        vp = torch.randint(0, 256, (P, PAGE, KV, HD), generator=gen,
                           device="cuda", dtype=torch.uint8)
        ks = torch.exp2(torch.randint(-2, 3, (P, PAGE, KV, 1), generator=gen,
                                      device="cuda").float()).to(torch.bfloat16)
        vs = torch.exp2(torch.randint(-2, 3, (P, PAGE, KV, 1), generator=gen,
                                      device="cuda").float()).to(torch.bfloat16)
    else:
        kp = torch.randn((P, PAGE, KV, HD), generator=gen, device="cuda").to(
            torch.bfloat16)
        vp = torch.randn((P, PAGE, KV, HD), generator=gen, device="cuda").to(
            torch.bfloat16)
        ks = vs = None
    return q, kp, vp, ks, vs, bt, ln


def k5_check(torch, ops, ref, fmt, cases):
    from repro_torch.core.lns import lns_decode_packed
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for name, B, S, lengths, packed in cases:
        q, kp, vp, ks, vs, bt, ln = k5_inputs(torch, B, S, lengths, packed,
                                              fmt, gen)
        kw = dict(fmt=fmt if packed else None, softcap=None,
                  sm_scale=1 / math.sqrt(64))
        out = ops.paged_attend(q, kp, vp, ks, vs, bt, ln, **kw)
        want = ref.paged_attend(q, kp, vp, ks, vs, bt, ln, **kw)
        err = float((out - want).abs().max())
        check(err <= K5_ATOL, f"K5 {name}: max err {err} > {K5_ATOL}")
        # yardstick: SDPA over pre-gathered, pre-decoded pages
        cap = bt.shape[1] * kp.shape[1]

        def gathered(pool, scale):
            x = pool[bt.long()].reshape(B, cap, 3, 64)
            if packed:
                s = scale[bt.long()].reshape(B, cap, 3, 1).float()
                x = lns_decode_packed(x, fmt, torch.float32) * s
            return x.to(torch.bfloat16).repeat_interleave(3, dim=2) \
                .transpose(1, 2).contiguous()

        kg, vg = gathered(kp, ks), gathered(vp, vs)
        qt = q.transpose(1, 2).contiguous()
        qpos = ln.long()[:, None] - S + torch.arange(S, device="cuda")
        mask = (torch.arange(cap, device="cuda")[None, None, :]
                <= qpos[:, :, None])[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        elem = 1 if packed else 2
        n_pos = [min(-(-int(n) // 16), 5) * 16 for n in lengths]
        nbytes = (q.numel() * 2 + sum(n_pos) * 2 * 3 * 64 * elem
                  + (sum(n_pos) * 2 * 3 * 2 if packed else 0)
                  + bt.numel() * 4 + B * 4 + q.numel() * 4)
        visible = sum(max(int(n) - S + s + 1, 0) for n in lengths
                      for s in range(S))
        b, by = bound_ms(nbytes, 4 * 9 * 64 * visible, BF16_FLOPS)
        rows.append(dict(
            shape=[B, S, 9, 64], case=name, lengths=list(lengths),
            max_abs_err=err,
            ms=cuda_ms(torch, lambda: ops.paged_attend(q, kp, vp, ks, vs, bt,
                                                       ln, **kw)),
            eager_ms=eager_ms(torch, lambda: ops.paged_attend(
                q, kp, vp, ks, vs, bt, ln, **kw)),
            plain_ms=cuda_ms(torch, lambda: ref.paged_attend(
                q, kp, vp, ks, vs, bt, ln, **kw)),
            library_ms=cuda_ms(torch, lambda: sdpa(qt, kg, vg,
                                                   attn_mask=mask)),
            bound_ms=b, bound_by=by))
        r = rows[-1]
        print(f"K5 paged_attend {name}: max err {err:.3e}, kernel "
              f"{r['ms']:.4f} ms (eager {r['eager_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, sdpa "
              f"{r['library_ms']:.4f} ms, bound {b:.5f} ms")
    return rows


def k6_check(torch, ops, ref):
    gen = torch.Generator(device="cuda").manual_seed(6)
    B, V = 4, 49152
    lg = torch.randn((B, V), generator=gen, device="cuda") * 4.0
    lg[0, 100] = lg[0, 20000] = 50.0  # a tie: the first maximum wins
    u = torch.rand((B, V), generator=gen, device="cuda").clamp_min(1e-30)
    gum = -torch.log(-torch.log(u))
    temp = torch.tensor([0.0, 0.7, 1.0, 1.3], device="cuda")
    rows = []
    for name, g, t in (("greedy", None, None), ("gumbel", gum, temp)):
        out = ops.fused_sample(lg, g, t)
        want = ref.fused_sample(lg, g, t)
        check(torch.equal(out, want), f"K6 {name}: tokens differ "
              f"{out.tolist()} vs {want.tolist()}")
        check(name != "greedy" or int(out[0]) == 100, "K6: not first max")
        nbytes = B * V * 4 * (2 if g is not None else 1) + B * 4 * 2
        b, by = bound_ms(nbytes, B * V * (3 if g is not None else 1),
                         F32_FLOPS)
        rows.append(dict(
            shape=[B, V], case=name, max_abs_err=0,
            ms=cuda_ms(torch, lambda: ops.fused_sample(lg, g, t)),
            eager_ms=eager_ms(torch, lambda: ops.fused_sample(lg, g, t)),
            plain_ms=cuda_ms(torch, lambda: ref.fused_sample(lg, g, t)),
            library_ms=cuda_ms(torch, lambda: torch.argmax(lg, dim=-1)),
            bound_ms=b, bound_by=by))
        r = rows[-1]
        print(f"K6 fused_sample {name}: tokens equal, kernel "
              f"{r['ms']:.4f} ms (eager {r['eager_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, argmax "
              f"{r['library_ms']:.4f} ms, bound {b:.5f} ms")
    return rows


def serve(torch, argv, ops):
    """One full-width serving run through the CLI's own engine; returns
    (aggregate metrics, engine, launch counts of exactly this run)."""
    from repro_torch.launch.serve import build_engine, parser
    from repro_torch.serving import synthetic_trace

    args = parser().parse_args(argv)
    engine = build_engine(args)
    trace = lambda: synthetic_trace(engine.cfg, requests=args.requests,
                                    prompt_len=args.prompt_len,
                                    gen_len=args.gen_len, seed=args.seed)
    engine.run(trace())          # warm-up: cuBLAS handles, allocator
    engine.reset()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    agg = engine.run(trace())
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    return agg, engine, counts


@contextlib.contextmanager
def plain_versions(dispatch, ref):
    """Point the dispatch layer's four entries at the plain versions, for
    the phase-5 comparison on the card only."""
    names = ("encode_pack", "qmatmul", "paged_attend", "fused_sample")
    saved = {n: getattr(dispatch, n) for n in names}
    for n in names:
        setattr(dispatch, n, getattr(ref, n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(dispatch, n, f)


def logits_check(torch, engine):
    """Phase 5: batch-1 prefill + 4 greedy decode steps at full width,
    through the kernels, through the plain versions, and through the
    plain versions with an f64-accumulating GEMM (the noise floor)."""
    from repro_torch.core.lns import lns_decode_packed
    from repro_torch.kernels import dispatch, ref
    from repro_torch.models.model import forward, init_caches

    cfg, qcfg, params = engine.cfg, engine.qcfg, engine.params
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen,
                           device="cuda", dtype=torch.int32)
    bt = torch.arange(5, dtype=torch.int32, device="cuda")[None]

    def run(tokens_seq):
        caches = init_caches(1, 80, cfg, page_size=16, num_pages=5,
                             device="cuda")
        out, pos = [], 0
        for toks in tokens_seq:
            lg = forward(params, toks, cfg, qcfg, caches=caches,
                         pos_offset=torch.tensor([pos], device="cuda"),
                         block_tables=bt)[:, -1].float()
            check(lg.shape == (1, cfg.vocab_size) and
                  bool(torch.isfinite(lg).all()), "non-finite logits")
            out.append(lg)
            pos += toks.shape[1]
        return out

    def qmatmul_f64(pa, pb, fmt, scale_a=None, scale_b=None, *,
                    compute_dtype=torch.bfloat16):
        a = lns_decode_packed(pa, fmt, compute_dtype).double()
        b = lns_decode_packed(pb, fmt, compute_dtype).double()
        return (a @ b).float() * scale_a * scale_b

    seq = [prompt]     # both runs follow the plain run's greedy tokens
    with plain_versions(dispatch, ref):
        for _ in range(4):
            lg = run(seq)[-1]
            seq.append(lg.argmax(-1, keepdim=True).to(torch.int32))
        plain = run(seq)
        dispatch.qmatmul = qmatmul_f64
        floor_run = run(seq)
    kern = run(seq)
    worst = floor = 0.0
    clear = 0
    for p, k, f in zip(plain, kern, floor_run):
        top = float(p.abs().max())
        tol = LOGIT_RTOL * top
        err = float((p - k).abs().max())
        worst = max(worst, err / top)
        floor = max(floor, float((p - f).abs().max()) / top)
        check(err <= tol, f"full-width logits: err {err} > {tol}")
        top2 = torch.topk(p, 2, dim=-1).values
        if float(top2[0, 0] - top2[0, 1]) > tol:
            clear += 1
            check(int(p.argmax()) == int(k.argmax()),
                  "full-width greedy token differs beyond the margin")
    print(f"full-width logits over 5 steps: kernels vs plain max err "
          f"{worst:.4f} of max |logit| (limit {LOGIT_RTOL}); floor (plain, "
          f"f64 GEMM accumulation) {floor:.4f}; greedy tokens checked on "
          f"{clear} steps whose margin exceeds the limit")
    return {"max_rel_err": worst, "floor_rel_err": floor,
            "margin_steps": clear}


def profile_decode(torch, engine, ops):
    """Device busy share over 3 decode steps of a full engine."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import synthetic_trace

    engine.reset()
    for r in synthetic_trace(engine.cfg, requests=4, prompt_len=32,
                             gen_len=16, seed=1):
        engine.submit(r)
    engine.step()              # admissions + first decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(3):
            engine.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    evs = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    busy_us = sum(dev(e) for e in evs)
    top = sorted(evs, key=dev, reverse=True)[:6]
    share = busy_us / 1e6 / wall if busy_us else None
    print(f"profile, 3 decode steps: wall {wall * 1e3 / 3:.1f} ms/step, "
          f"device busy "
          + (f"{busy_us / 3e3:.2f} ms/step ({share:.1%})" if busy_us
             else "not measured (no device time in the trace)"))
    for e in top:
        print(f"  {e.key[:60]}: {dev(e) / 3e3:.3f} ms/step, "
              f"{e.count // 3} calls/step")
    return {"wall_ms_per_step": wall * 1e3 / 3,
            "device_busy_ms_per_step": busy_us / 3e3 if busy_us else None,
            "device_busy_share": share,
            "top": [[e.key, dev(e) / 3e3, e.count // 3] for e in top]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"FAIL: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(card.returncode == 0, f"nvidia-smi failed: {card.stderr}")
    print(card.stdout.strip().splitlines()[0])
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    from repro_torch.core.lns import LNSFormat
    from repro_torch.kernels import _build, ops, ref

    t0 = time.monotonic()
    _build.build(ptxas_verbose=True)
    _build.library()
    build_s = time.monotonic() - t0
    print(f"kernels built and loaded in {build_s:.1f}s")

    fmt = LNSFormat(8, 8)
    k1 = k1_check(torch, ops, ref, fmt, [(4, 576), (4, 1536), (32, 576),
                                         (32, 1536)])
    gemms = [(576, 576), (576, 192), (576, 1536), (1536, 576)]
    k2 = k2_check(torch, ops, ref, fmt, [(4, k, n) for k, n in gemms]
                  + [(32, k, n) for k, n in gemms])
    k5 = k5_check(torch, ops, ref, fmt, [
        ("decode bf16 pool", 4, 1, [33, 48, 61, 66], False),
        ("decode packed pool", 4, 1, [33, 48, 61, 66], True),
        ("prefill bf16 pool", 1, 32, [32], False),
        ("prefill packed pool", 1, 32, [32], True)])
    k6 = k6_check(torch, ops, ref)

    agg, engine, counts = serve(torch, SERVE_PAGED, ops)
    print(f"paged serve: completed {int(agg['completed'])}/8 requests, "
          f"{agg['tokens_per_s']:.1f} tok/s, ttft mean "
          f"{agg['ttft_mean_s'] * 1e3:.1f} ms p95 "
          f"{agg['ttft_p95_s'] * 1e3:.1f} ms, tpot p50 "
          f"{agg['tpot_p50_s'] * 1e3:.2f} ms, decode_steps "
          f"{engine.decode_steps}, launches {counts}")
    check(agg["completed"] == 8, "paged serve did not complete 8 requests")
    check(all(n > 0 for n in counts.values()),
          f"a kernel was not launched on the paged path: {counts}")
    paged = dict(agg=agg, decode_steps=engine.decode_steps,
                 prefills=engine.prefills, launches=counts)

    dagg, deng, dcounts = serve(torch, SERVE_DENSE, ops)
    print(f"dense serve: completed {int(dagg['completed'])}/4 requests, "
          f"{dagg['tokens_per_s']:.1f} tok/s, ttft mean "
          f"{dagg['ttft_mean_s'] * 1e3:.1f} ms, decode_steps "
          f"{deng.decode_steps}, launches {dcounts}")
    check(dagg["completed"] == 4, "dense serve did not complete 4 requests")
    check(all(dcounts[k] > 0 for k in ("encode_pack", "qmatmul",
                                       "fused_sample")),
          f"a kernel was not launched on the dense path: {dcounts}")
    dense = dict(agg=dagg, decode_steps=deng.decode_steps,
                 launches=dcounts)

    logits = logits_check(torch, engine)
    prof = profile_decode(torch, engine, ops)

    meta = {
        "encode_pack": ("lns_quantize.cu", "lns_quantize.py:80", k1, 1),
        "qmatmul": ("lns_qmatmul.cu", "lns_qmatmul.py:48", k2, 3),
        "paged_attend": ("paged_attend.cu", "paged_attend.py:172", k5, 0),
        "fused_sample": ("sampler.cu", "sampler.py:62", k6, 0),
    }
    kernels = []
    for name, (src, tpu, rows, pick) in meta.items():
        r = rows[pick]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": counts[name],
            "max_abs_err": max(x["max_abs_err"] for x in rows),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    full = {"card": card.stdout.strip(), "build_s": build_s,
            "kernels": kernels,
            "shapes": {"encode_pack": k1, "qmatmul": k2, "paged_attend": k5,
                       "fused_sample": k6},
            "serve_paged": paged, "serve_dense": dense,
            "logits": logits, "profile": prof, "device": device}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(full, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
