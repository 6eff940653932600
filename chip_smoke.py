#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the six CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. Hold each kernel against its plain PyTorch version on the card at the
   serving and training shapes of smollm-135m (K3/K4 at the four packed
   leaf shapes), and time the kernel, the plain version and a one-call
   PyTorch yardstick (``library_ms``) where one exists.
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
7. Train smollm-135m at full width through ``repro_torch.launch.train``:
   6 steps of 8 x 256 tokens, checkpoints in a temporary directory. The
   loss is finite every step, no step was retried by the supervisor, K1
   and K2 launch, and K3 launches exactly 8 times a step (once per packed
   leaf).
8. One ``numerics=True`` step: K4 launches 8 times, K3 none, and every
   update and gradient-encode stat is finite.
9. One full-width train step from the same state and batch through the
   kernels, the plain versions, and the plain versions with an
   f64-accumulating GEMM (the noise floor): loss and the share of packed
   words that differ after the update, within the stated limits.
10. Time 3 train steps, then profile one: wall time, device busy share,
    top kernels.

The next-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Full results also go to
``chiprun_out/chip_smoke.json``. Nothing here imports JAX.
"""
import contextlib
import json
import math
import subprocess
import sys
import tempfile
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

# K3/K4 vs plain on the card: both run rsqrtf (the kernel by name, torch
# through ATen's rsqrt) and round the same f32 ops in the same order, so
# words should be equal; the band allows a word to round the other way
# where its target lies within 2 ulp of a half-integer. K4's counts may
# move by one per such word. qerr_sum is an f32 sum in another order (per
# block, then across blocks in f64).
MADAM_TIE_ULPS = 2
MADAM_QERR_RTOL = 1e-4
# phase 9: as in phase 5, the 30-layer 8-bit model is chaotic under any
# change of rounding. One update step moves each code by +-16 by the sign
# of its quantized gradient (g* = +-1 at step 1), so a word differs where
# a gradient element changed sign or underflowed; the loss is the forward
# alone. On the H100 the f64-accumulation floor read a loss rel. diff of
# 4.97e-5 and 2.66% of the words, the kernels 5.06e-5 and 2.72%. Limits:
# 5e-4 of the loss (10x the floor; a uniform output is 0.8% from this
# loss, so a much looser limit would pass a broken forward), 10% of the
# words; this run's floor is printed beside them.
TRAIN_LOSS_RTOL = 5e-4
TRAIN_WORD_SHARE = 0.10
TRAIN_STEPS = 6
TRAIN_ARGV = ["--arch", "smollm-135m", "--steps", str(TRAIN_STEPS),
              "--batch", "8", "--seq", "256"]

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
        # as in a step that walks 30 layers of weights. The packed
        # activation (<= 3 MB) stays in the L2, as it is in a step, where
        # K1 writes it just before K2 reads it
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


def madam_inputs(torch, R, C, bits, gdt, gen):
    """A leaf as the train step hands it to K3/K4: words of a trained-ish
    LNS store (codes spread over the range, both signs), a Q_G-like
    gradient in ``gdt`` and a warm second moment."""
    wdt = torch.int32 if bits > 8 else torch.uint8
    w = torch.randint(0, 1 << bits, (R, C), generator=gen, device="cuda",
                      dtype=torch.int32).to(wdt)
    g = (torch.randn((R, C), generator=gen, device="cuda")
         * torch.exp2(torch.randint(-12, -4, (R, C), generator=gen,
                                    device="cuda").float())).to(gdt)
    v = torch.rand((R, C), generator=gen, device="cuda") * 1e-6
    return w, g, v


def k34_check(torch, ops, ref, cases):
    """K3 and K4 against their plain versions on the card: v' bit-equal,
    words equal except where the target sits within MADAM_TIE_ULPS ulp of
    a half-integer, K4's stat vector equal in its integer slots and within
    MADAM_QERR_RTOL in qerr_sum."""
    from repro_torch.core.lns import LNSFormat
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {"madam_step": [], "madam_step_stats": []}
    for R, C, bits, gamma, gdt in cases:
        fmt = LNSFormat(bits, gamma)
        w, g, v = madam_inputs(torch, R, C, bits, gdt, gen)
        count = 7
        bc = ref.bias_correction(0.999, count)
        kw = dict(lr=2.0 ** -7, beta=0.999, eps=1e-30)
        req = (fmt.gamma // 8, 127) if bits > 8 else None
        kw_s = dict(kw, requant=req)
        kw_p, kv_p = ref.madam_step(w, g, v, bc, fmt, **kw)
        ws = w.to(torch.int32)
        sign = 1 - 2 * ((ws >> (bits - 1)) & 1)
        _, _, target = ref.step_math(ws & fmt.max_code, sign, g, v, bc,
                                     gamma=fmt.gamma, max_code=fmt.max_code,
                                     **kw)
        frac = target - torch.floor(target)
        ulp = torch.abs(torch.nextafter(target, target + 1) - target)
        near = (frac - 0.5).abs() <= MADAM_TIE_ULPS * ulp
        n = R * C
        w_b, g_b = (4 if bits > 8 else 1), (2 if gdt == torch.bfloat16 else 4)
        nbytes = n * (2 * w_b + g_b + 2 * 4)   # word, g, v in; word, v out
        b, by = bound_ms(nbytes, 15 * n, F32_FLOPS)
        for name in rows:
            if name == "madam_step":
                kw_w, kv_w = ops.madam_step(w, g, v, bc, fmt, **kw)
                fn = lambda: ops.madam_step(w, g, v, bc, fmt, **kw)
                pfn = lambda: ref.madam_step(w, g, v, bc, fmt, **kw)
            else:
                kw_w, kv_w, kvec = ops.madam_step_stats(w, g, v, bc, fmt,
                                                        **kw_s)
                _, _, pvec = ref.madam_step_stats(w, g, v, bc, fmt, **kw_s)
                fn = lambda: ops.madam_step_stats(w, g, v, bc, fmt, **kw_s)
                pfn = lambda: ref.madam_step_stats(w, g, v, bc, fmt, **kw_s)
            torch.cuda.synchronize()
            check(torch.equal(kv_w.view(torch.int32), kv_p.view(torch.int32)),
                  f"{name} {R}x{C} B={bits}: v' differs from the plain version")
            diff = kw_w.to(torch.int32) != kw_p.to(torch.int32)
            bad = int((diff & ~near).sum())
            check(bad == 0, f"{name} {R}x{C} B={bits}: {bad} words differ "
                  f"away from a tie")
            err = int((kw_w.to(torch.int32) - kw_p.to(torch.int32)).abs().max())
            extra = {}
            if name == "madam_step_stats":
                # a word that rounds the other way at a tie moves each
                # count and code_sum by at most one
                ints = [0, 1, 2, 4, 5]
                dc = float((kvec[ints] - pvec[ints]).abs().max())
                check(dc <= int(diff.sum()),
                      f"K4 {R}x{C}: stat counts differ {kvec.tolist()} vs "
                      f"{pvec.tolist()}")
                q_err = abs(float(kvec[3] - pvec[3])) / max(float(pvec[3]),
                                                            1e-30)
                check(q_err <= MADAM_QERR_RTOL,
                      f"K4 {R}x{C}: qerr_sum rel err {q_err}")
                extra = {"stats": kvec.tolist(), "qerr_rel_err": q_err}
            rows[name].append(dict(
                shape=[R, C], bits=bits,
                g_dtype=str(gdt).replace("torch.", ""),
                tie_words=int(diff.sum()), near_tie=int(near.sum()),
                max_abs_err=err, ms=cuda_ms(torch, fn, iters=10, replays=5),
                eager_ms=eager_ms(torch, fn, iters=20),
                plain_ms=cuda_ms(torch, pfn, iters=2, replays=3),
                bound_ms=b, bound_by=by, library_ms=None, **extra))
            r = rows[name][-1]
            print(f"{'K3' if name == 'madam_step' else 'K4'} {name} {R}x{C} "
                  f"B={bits} g {r['g_dtype']}: v' equal, words differing at "
                  f"ties {r['tie_words']} (near-tie {r['near_tie']}), kernel "
                  f"{r['ms']:.4f} ms (eager {r['eager_ms']:.4f} ms), plain "
                  f"{r['plain_ms']:.4f} ms, bound {b:.4f} ms")
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


def device_time(torch, prof, n_top):
    """Total kernel time (us) in a profile and its ``n_top`` kernels. Only
    device events count: a CPU op's self device time repeats the time of
    the kernels it launched, so summing both would count them twice."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:n_top]
    return busy_us, top


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
    busy_us, top = device_time(torch, prof, 6)
    share = busy_us / 1e6 / wall if busy_us else None
    print(f"profile, 3 decode steps: wall {wall * 1e3 / 3:.1f} ms/step, "
          f"device busy "
          + (f"{busy_us / 3e3:.2f} ms/step ({share:.1%})" if busy_us
             else "not measured (no device time in the trace)"))
    for e in top:
        print(f"  {e.key[:60]}: {e.self_device_time_total / 3e3:.3f} "
              f"ms/step, {e.count // 3} calls/step")
    return {"wall_ms_per_step": wall * 1e3 / 3,
            "device_busy_ms_per_step": busy_us / 3e3 if busy_us else None,
            "device_busy_share": share,
            "top": [[e.key, e.self_device_time_total / 3e3, e.count // 3]
                    for e in top]}


def train_run(torch, ops):
    """Phase 7: the training CLI at full width. Returns its summary and
    the launch counts of exactly this run."""
    from repro_torch.launch.train import main as train_main
    with tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = train_main(TRAIN_ARGV + ["--ckpt-dir", ckpt])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    steps = out["steps"]
    check(steps == TRAIN_STEPS, f"training took {steps} steps")
    # the supervisor retries a step that raised or lost its loss to NaN;
    # on this path any such failure is a fault, not something to recover
    check(out["failures_recovered"] == 0,
          f"training recovered from {out['failures_recovered']} failures")
    check(all(math.isfinite(x) for x in out["losses"]),
          f"non-finite training loss: {out['losses']}")
    check(counts["madam_step"] == 8 * steps,
          f"K3 launched {counts['madam_step']} times, not 8 per step")
    check(counts["encode_pack"] > 0 and counts["qmatmul"] > 0,
          f"K1/K2 not launched on the training path: {counts}")
    print(f"train: {steps} steps x 2048 tokens, {out['tokens_per_s']:.0f} "
          f"tok/s over {out['wall_s']:.2f}s, loss "
          + " ".join(f"{x:.4f}" for x in out["losses"])
          + f", straggler events {out['straggler_events']}, launches "
          f"{counts}")
    return dict(out, launches=counts)


def train_setup(torch):
    from repro_torch.configs import get_config
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.steps import batch_to_device, init_train_state
    cfg, mcfg = get_config("smollm-135m"), MadamConfig()
    state = init_train_state(cfg, mcfg, seed=0, device="cuda")
    batch = batch_to_device(SyntheticLM(cfg, batch=8, seq=256).batch_at(0),
                            "cuda")
    return cfg, QuantConfig.lns_madam(), mcfg, state, batch


def numerics_step(torch, ops, setup):
    """Phase 8: one ``numerics=True`` step: K4 in place of K3 on every
    packed leaf, and every stat finite."""
    from repro_torch.training.steps import build_train_step
    cfg, qcfg, mcfg, state, batch = setup
    step = build_train_step(cfg, qcfg, mcfg, numerics=True)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    _, m = step(state, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts["madam_step_stats"] == 8 and counts["madam_step"] == 0,
          f"numerics step launches: {counts}")
    stats = {site: {layer: {k: float(v) for k, v in d.items()}
                    for layer, d in m["numerics"][site].items()}
             for site in ("update", "grad_encode")}
    bad = [(site, layer, k) for site, d in stats.items()
           for layer, st in d.items() for k, v in st.items()
           if not math.isfinite(v)]
    check(not bad, f"non-finite numerics stats: {bad[:5]}")
    upd = stats["update"]
    print(f"numerics step: K4 launches {counts['madam_step_stats']}, "
          f"{len(upd)} packed leaves, loss {float(m['loss']):.4f}; "
          + ", ".join(f"{layer} dead {st['dead_frac']:.3f} qerr "
                      f"{st['qerr_rel']:.2e} req_hi "
                      f"{st['requant_sat_hi']:.2e}"
                      for layer, st in upd.items()))
    return dict(launches=counts, stats=stats, loss=float(m["loss"]))


@contextlib.contextmanager
def plain_madam(ops, ref):
    """Point the Madam kernel wrappers at their plain versions (same
    signatures), for the phase-9 comparison only."""
    saved = (ops.madam_step, ops.madam_step_stats)
    ops.madam_step, ops.madam_step_stats = ref.madam_step, ref.madam_step_stats
    try:
        yield
    finally:
        ops.madam_step, ops.madam_step_stats = saved


def train_step_check(torch, setup):
    """Phase 9: one full-width train step from the same state and batch
    through the kernels, the plain versions, and the plain versions with
    an f64-accumulating GEMM (the noise floor): loss and the share of
    packed words that differ after the update."""
    from repro_torch.core.lns import lns_decode_packed
    from repro_torch.kernels import dispatch, ops, ref
    from repro_torch.training.steps import build_train_step
    from repro_torch.tree import leaves
    cfg, qcfg, mcfg, state, batch = setup
    step = build_train_step(cfg, qcfg, mcfg)

    def run():
        new, m = step(state, batch)
        return float(m["loss"]), float(m["grad_norm"]), new.params

    def qmatmul_f64(pa, pb, fmt, scale_a=None, scale_b=None, *,
                    compute_dtype=torch.bfloat16):
        a = lns_decode_packed(pa, fmt, compute_dtype).double()
        b = lns_decode_packed(pb, fmt, compute_dtype).double()
        return (a @ b).float() * scale_a * scale_b

    with plain_versions(dispatch, ref), plain_madam(ops, ref):
        plain = run()
        dispatch.qmatmul = qmatmul_f64
        floor_run = run()
    kern = run()

    def words_share(a, b):
        n = tot = 0
        for (_, x), (_, y) in zip(leaves(a), leaves(b)):
            if hasattr(x, "packed"):
                n += int((x.packed != y.packed).sum())
                tot += x.packed.numel()
        return n / tot

    res = {"loss_plain": plain[0], "loss_kernels": kern[0],
           "loss_floor": floor_run[0],
           "grad_norm_plain": plain[1], "grad_norm_kernels": kern[1],
           "loss_rel_err": abs(kern[0] - plain[0]) / abs(plain[0]),
           "loss_rel_floor": abs(floor_run[0] - plain[0]) / abs(plain[0]),
           "word_share": words_share(kern[2], plain[2]),
           "word_share_floor": words_share(floor_run[2], plain[2])}
    print(f"full-width train step: loss kernels {kern[0]:.5f} vs plain "
          f"{plain[0]:.5f} (rel {res['loss_rel_err']:.2e}, floor "
          f"{res['loss_rel_floor']:.2e}, limit {TRAIN_LOSS_RTOL}); words "
          f"differing after the update {res['word_share']:.4%} (floor "
          f"{res['word_share_floor']:.4%}, limit {TRAIN_WORD_SHARE:.0%}); "
          f"grad norm {kern[1]:.4f} vs {plain[1]:.4f}")
    check(res["loss_rel_err"] <= TRAIN_LOSS_RTOL,
          f"train-step loss differs by {res['loss_rel_err']}")
    check(res["word_share"] <= TRAIN_WORD_SHARE,
          f"{res['word_share']:.2%} of words differ after one step")
    return res


def profile_train(torch, setup):
    """Phase 10: device busy share of one full-width train step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.steps import build_train_step
    cfg, qcfg, mcfg, state, batch = setup
    step = build_train_step(cfg, qcfg, mcfg)
    float(step(state, batch)[1]["loss"])        # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(3):
        float(step(state, batch)[1]["loss"])
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        float(step(state, batch)[1]["loss"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy_us, top = device_time(torch, prof, 10)
    share = busy_us / 1e6 / wall if busy_us else None
    print(f"train step without the profiler: {step_ms:.1f} ms "
          f"({2048 / step_ms * 1e3:.0f} tok/s)")
    print(f"profile, 1 train step: wall {wall * 1e3:.1f} ms, device busy "
          + (f"{busy_us / 1e3:.1f} ms ({share:.1%})" if busy_us
             else "not measured (no device time in the trace)"))
    for e in top:
        print(f"  {e.key[:60]}: {e.self_device_time_total / 1e3:.3f} ms, "
              f"{e.count} calls")
    return {"step_ms": step_ms, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "device_busy_share": share,
            "top": [[e.key, e.self_device_time_total / 1e3, e.count]
                    for e in top]}


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
    # serving shapes (M = 4 decode, 32 prefill), then the training step's
    # M = 8 x 256 = 2048
    k1 = k1_check(torch, ops, ref, fmt, [(4, 576), (4, 1536), (32, 576),
                                         (32, 1536), (2048, 576),
                                         (2048, 1536)])
    gemms = [(576, 576), (576, 192), (576, 1536), (1536, 576)]
    k2 = k2_check(torch, ops, ref, fmt, [(4, k, n) for k, n in gemms]
                  + [(32, k, n) for k, n in gemms]
                  + [(2048, k, n) for k, n in gemms])
    # the packed leaves of smollm-135m: embed, then wq/wo, up/gate, down
    # and wk/wv stacked over 30 layers, folded to (-1, last); B=16 words
    # with bf16 gradients as the train step gives them, and B=8 once
    bf16 = torch.bfloat16
    k34 = k34_check(torch, ops, ref, [
        (49152, 576, 16, 2048, bf16), (17280, 576, 16, 2048, bf16),
        (17280, 1536, 16, 2048, bf16), (46080, 576, 16, 2048, bf16),
        (17280, 192, 16, 2048, bf16), (17280, 576, 8, 8, torch.float32)])
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
    check(all(counts[k] > 0 for k in ("encode_pack", "qmatmul",
                                      "paged_attend", "fused_sample")),
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
    del engine, deng
    torch.cuda.empty_cache()

    train = train_run(torch, ops)
    setup = train_setup(torch)
    numerics = numerics_step(torch, ops, setup)
    step_cmp = train_step_check(torch, setup)
    train_prof = profile_train(torch, setup)

    # launches: each kernel's count on its own path's run (serving for
    # K1/K2/K5/K6, the training run for K3, the numerics step for K4)
    meta = {
        "encode_pack": ("lns_quantize.cu", "lns_quantize.py:80", k1, 1,
                        counts),
        "qmatmul": ("lns_qmatmul.cu", "lns_qmatmul.py:48", k2, 3, counts),
        "paged_attend": ("paged_attend.cu", "paged_attend.py:172", k5, 0,
                         counts),
        "fused_sample": ("sampler.cu", "sampler.py:62", k6, 0, counts),
        "madam_step": ("madam_update.cu", "madam_update.py:231",
                       k34["madam_step"], 0, train["launches"]),
        "madam_step_stats": ("madam_update.cu", "madam_update.py:291",
                             k34["madam_step_stats"], 0,
                             numerics["launches"]),
    }
    kernels = []
    for name, (src, tpu, rows, pick, launched) in meta.items():
        r = rows[pick]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": launched[name],
            "max_abs_err": max(x["max_abs_err"] for x in rows),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    full = {"card": card.stdout.strip(), "build_s": build_s,
            "kernels": kernels,
            "shapes": {"encode_pack": k1, "qmatmul": k2, "paged_attend": k5,
                       "fused_sample": k6, **k34},
            "serve_paged": paged, "serve_dense": dense,
            "logits": logits, "profile": prof, "train": train,
            "numerics": numerics, "train_step": step_cmp,
            "train_profile": train_prof, "device": device}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(full, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
