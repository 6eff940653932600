#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --k1-sweep   # K1's block size and grid only
    python3 chip_smoke.py --k2-sweep   # K2's skinny plan constants only
    python3 chip_smoke.py --k6-sweep   # K6's blocks a row and block size
    python3 chip_smoke.py --k8-sweep   # K8's tiles, splits, table copies
    python3 chip_smoke.py --serving    # phases 1, 2 and 19 only
    python3 chip_smoke.py --obs        # phases 1, 2 and 20 only

Phases, each of which fails the run (non-zero exit, no result line):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the nine CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. Hold each kernel against its plain PyTorch version on the card at the
   serving and training shapes of smollm-135m (K1 also per row, at an
   absmax of 2^k and one ulp either side for every f32 exponent in f32 and
   bf16, and with a NaN or an inf in x; one K1 call must show exactly one
   device kernel, its own, in torch.profiler; K3/K4 at the packed leaf
   shapes; K6 greedy, noise-in and seeded at 4 x 49152 and the verify's
   16 x 49152, its seeded noise equal to ``ref.gumbel_noise`` on the card
   and within ``K6_NOISE_ATOL`` of the CPU's; K7 at the 8 packed leaves
   for 8->6 and 8->7 in one grouped launch and one leaf at a time, on a
   misaligned slice and a ragged length; K5 also at the speculative
   verify's S=4 and with warps that see no position), and
   time the kernel, the plain version and a one-call PyTorch yardstick
   (``library_ms``) where one exists. K2 prints the path its plan took
   (skinny split-K mma.sync, wgmma, or f32), also runs at the verify's
   M=16 and M=24, at M=128/256/512 beside the other path (the
   crossover), on ragged shapes (skinny with one and two row tiles,
   wgmma) and at the smoke config's f32 compute, checks the fused bf16
   output against the f32 output cast, and decodes every word of every
   accepted format on both bf16 paths as the plain version does; the
   wgmma path's decode pass (``qmatmul_decode``, a kernel of its own)
   must give the plain version's padded operands bit for bit; every K2
   and K5 case is called twice and must repeat bit for bit. K5 also runs
   an f32 pool whose pages take one stage a warp. TF32 must be off.
   ``sample_logits`` on a 4-row temperature batch and its 16-row verify
   batch must launch K6 once a call (its count) and run no torch kernel,
   no copy (torch.profiler) and no ``torch.Generator``; its wall time and device work are printed
   beside the earlier sampler's pattern (``k6_noise_in_torch``: a
   generator and a torch chain a row, then the noise-in K6); a top-k batch must give the tokens
   of the plain noise.
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
   time and share, the kernels that take it, K2's and K5's share, and the
   device work a step (the port's kernels, torch's, copies); then 3 steps
   with K1's scale computed by torch first, the launches K1 saves.
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
   words that differ after the update, within the stated limits. Then,
   measured and not limited, the same step with K2 forced onto its skinny
   path (no wgmma) and with K1's plain version in place of the kernel.
10. Time 3 train steps, then profile one: wall time, device busy share,
    top kernels, device work (as phase 6), and one more step with K1's
    scale computed by torch first.
11. Speculative serving at full width through the serve CLI's engine:
    phase 4's paged trace with ``--speculate-k 4`` at draft bitwidths 6,
    7 and 8, then bitwidth 6 and the non-speculating engine under
    ``--alloc-policy ondemand``, then ``--speculate-k 1``, with the
    non-speculating reserve engine first and last. Every run completes
    8/8; K7 launches once per draft view built; K5 runs at S=k once
    per layer per cycle; the ondemand pool ends full; the baselines, the
    ondemand baseline and the k=1 run reproduce phase 4's streams
    exactly. Accept rates, stream agreement with phase 4, tok/s and the
    tok/s ratio to the two baseline runs are printed, not limited.
12. At the smoke config on the card: a mixed greedy/seeded trace gives
    the speculating engine's streams equal to the baseline's, dense and
    ondemand.
13. Profile 2 speculative cycles as phase 6 profiles decode steps.
14. Measure why k>1 streams leave phase 4's: from 8 states of the paged
    trace, 4 greedy one-token steps against one S=4 verify over the same
    tokens, counting differing tokens and differing per-tensor
    activation scales (printed, not limited). Then every K2 shape that
    phases 4-14 ran (recorded as they ran) is held against the plain
    version on fresh operands: within ``K2_RTOL``, bit-identical on a
    repeat, bf16 output equal to the f32 output cast.
15. K8, the bit-exact Fig.-6 datapath, against its plain version at
    smollm-135m's GEMM shapes (M 4 and 2048; each prints its tiles, grid,
    split and share of the bound), over the LUT sweep 1/2/4/8
    at 2048x576x1536 and on the saturating all-zero case: int32 outputs
    equal in every case. Then the Table-10 kernel sweep through the public
    ``repro_torch.kernels.lns_matmul`` (exact, LUT 1/2/4/8): K8 launches
    once per call; the error against the f32 matmul is printed beside the
    paper's calibrated fJ/op (an energy model, not a measurement).
16. K9, the unpacked Madam step, against its plain version at the packed
    leaf shapes of phase 3 (int32 codes, B=16; int16 codes, B=16, at the
    embedding; uint8 codes, B=8): codes
    equal outside the tie band, v' equal; through
    ``dispatch.madam_step_unpacked`` it launches once per call.
17. Approximation-aware training of smollm-135m at full width, from phase
    9's state and batch: one step each under ``QuantConfig.lns_madam()``
    and ``approx_lut`` 8 and 1, then 3 more steps at LUT 1, with TF32 off.
    Losses finite; K3 launches 8 times a step, K1 and K2 none under the
    approximation; the LUT-8 loss equals the exact fake-quant forward's
    within ``APPROX_LOSS_RTOL``, printed beside an f64-accumulation floor,
    and the LUT-4/2/1 losses (the controls) must lie outside it;
    step wall time and peak memory printed, and one LUT-1 step profiled.

18. The paper's baselines at full width (each step prints one JSON
    line): (a) ``fp_quantize`` at e4m3 and e5m10, per tensor and per
    row, bf16 and f32, 2048x1536: two calls bit-identical, the normalized
    values equal to the ``float8_e4m3fn``/``float16`` round trip bit for
    bit, differences from the same call on the CPU printed, ms and device
    kernels a call; (b) ``launch.train --format fp8`` (smollm-135m, 4
    steps of 8 x 256): K3 8 times a step, K1 and K2 never, no retry,
    finite losses, and one fp8 step profiled beside phase 10's lns8 step;
    (c) BERT-base at full width (12 layers, d 768, untied head, ungated
    GELU, bf16), 8 x 384 tokens: 2 lns8 and 2 fp8 steps, K3 once per
    packed leaf a step, K1/K2 on lns8 only, every K2 shape the lns8 steps
    ran held against the plain version (as phase 14) and timed beside
    ``torch.matmul`` bf16, one step of each profiled; (d) Fig. 7 on
    smollm-135m with dense f32 weights: sgd_q and adamw_q at Q_U 16 and
    10 bits, and ``madam_fp``, 3 steps each: finite losses, no kernel
    launched, every >=2-D leaf a fixed point of Q_log at Q_U; (e) Fig. 4
    at d = 2^20 on the card and the CPU from the same uniforms: r_t within
    ``FIG4_RTOL``, MUL and signMUL below GD, Madam printed beside GD.
19. Online serving at full width. (a) smollm-135m, page 16, 4 slots,
    greedy: 8 requests sharing one 64-token prefix (4 pages), each with
    its own 16-32-token suffix and 32 new tokens, with the prefix cache
    on and off (the same submissions): every admission's prefill logits
    within ``LOGIT_RTOL`` of the uncached ones, and a stream may leave the
    uncached one only at a top-2 margin within ``LOGIT_RTOL`` of max
    |logit| (phase 5's rule; each divergence prints its token and margin:
    Q_A's per-tensor scale spans the prefill's own suffix, so a reused
    prefix was quantized under another request's scales, H7, which the
    phase measures for requests 0 and 1: the K1 scales that differ and
    the prefix KV's bit-equal share by layer), 7 prefix hits reusing
    7 x 64 tokens, no page in use after, K1/K2/K5/K6 launched; at the
    smoke config on the card (f32, page 4) the streams with the cache
    equal those without exactly; each
    admission's prefill timed with CUDA events, TTFT printed; a request
    whose prompt is the prefix alone copies its boundary page on write:
    the 15 shared tokens of every layer's K and V equal the source page
    bit for bit, its stream equal to the uncached engine's; K5 at the
    suffix prefill's S = 16 and 32 over lengths 64 + S (bf16 and packed
    pools) against its plain version. (b) the same engine behind
    ``Gateway`` on 127.0.0.1:0 over an ``EngineDriver``: one request,
    then 7 at once (4 over SSE, one cancelled by DELETE after its 4th
    frame, one seeded at temperature 0.8, which runs K6's seeded mode; 3
    unary): every other request ends "length" with 32 tokens, every SSE
    stream ends in ``data: [DONE]``, a submission past the watermark gets
    429, no page is in use after, ``/metrics`` parses and carries the
    TTFT/TPOT histograms and the prefix counters, ``/health`` names the
    device and card; submit-to-first-frame times printed. (c) BERT-base
    (untied head) paged, 4 slots, 8 requests of 32 + 32: the head's
    decode GEMM 4x768 @ 768x30522 runs on K2 and matches its plain
    version (ragged N), timed beside ``torch.matmul``; every K2 shape
    held as phase 14 holds them; logits as phase 5; a k=4 draft view at
    6 bits is one K7 launch with the head re-gridded; k=1 reproduces the
    baseline's streams.
20. Observability at full width (``repro_torch.obs``). (a) Phase 4's
    paged trace through the serve CLI's engine with an ``EngineObserver``
    attached and ``kernel_stats`` on, then the same trace at k=4, 6 bits,
    from cold: every request completes, the trace validates (spec spans
    required on the spec run), the timeline's prefill/decode/spec rows
    equal the engine's admissions, decode steps and spec cycles, its
    emitted tokens total 8 x 32, each op's ``kernel_stats`` calls equal
    its kernel's launch count over the same run; the time breakdown
    (host share included) printed. (b) On that engine, 4 requests
    decoding: windows of 3 decode steps under torch.profiler with the
    observer and ``kernel_stats`` (``block_every=0``) off, on, off, on
    after a warm window: every window issues the same kernel launches
    and copies (the CUDA runtime calls that put work on the card, by
    name; the profiler's device records, which lose a few a window, are
    printed beside them); the walls printed side by side, not limited.
    (c) 3 decode
    steps at ``block_every=1``: K1's, K2's, K5's and K6's mean blocked time
    a call beside the profiler's device time a launch, the blocked time
    at least ``OBS_BLOCKED_MIN`` of it. (d) ``launch.train`` for 2 steps of
    8 x 256 with ``--trace-dir --numerics-log --kernel-stats --quiet=false
    --progress-every 1``, then without them: K4 8 times a step and K3
    never, then the reverse; losses equal bit for bit (else the first
    leaf and word where the checkpoints part are printed); 2 jsonl rows
    of finite stats, fractions in [0, 1]; the trace passes
    ``validate_train_trace``; ``record_step``'s wall time a step printed.
    (e) ``python -m repro_torch.obs.validate`` exits 0 on the spec run's
    export (``--require-spec``) and the train export (``--train``). (f) A 2-request ``launch.serve --torch-profile``: its Chrome
    trace holds device events of K1, K2, K5 and K6.

The next-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Full results also go to
``chiprun_out/chip_smoke.json``. Nothing here imports JAX.
"""
import collections
import contextlib
import json
import math
import os
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
# phase 11: the paged trace with speculation, by run name
SPEC_K = 4
SPEC_RUNS = [
    ("baseline", []),
    ("spec_b6", ["--speculate-k", str(SPEC_K), "--draft-bitwidth", "6"]),
    ("spec_b7", ["--speculate-k", str(SPEC_K), "--draft-bitwidth", "7"]),
    ("spec_b8", ["--speculate-k", str(SPEC_K), "--draft-bitwidth", "8"]),
    ("spec_b6_ondemand", ["--speculate-k", str(SPEC_K), "--draft-bitwidth",
                          "6", "--alloc-policy", "ondemand"]),
    ("ondemand", ["--alloc-policy", "ondemand"]),
    ("spec_k1_b6", ["--speculate-k", "1", "--draft-bitwidth", "6"]),
    ("baseline_end", []),
]
# K8's bound counts what the function needs, not what the kernel does. A
# term's magnitude depends only on m = code_a + code_b, so a table of the
# 2 max_code + 1 terms (built in shared memory by the datapath's own
# arithmetic, at any LUT size) leaves per product an add (m), one
# shared-memory load, a sign apply and an accumulate. Each word is decoded
# once (code mask, sign bit); each output takes an add, a min and a max
# per block_k slice. Integer ops issue at up to 128 lanes per SM per clock
# (4 schedulers x 32: adds and shifts go to the INT32 pipe and, as IMAD
# forms, to the FMA pipe); shared-memory loads at 32 per SM per clock (32
# four-byte banks). SMs and the maximum SM clock are read from the card.
K8_ALU_OPS_PER_PRODUCT = 3
K8_ALU_OPS_PER_WORD = 2
K8_ALU_OPS_PER_SLICE = 3
ISSUE_LANES_PER_SM = 128
SMEM_LOADS_PER_SM = 32
# phase 17: the LUT-8 approximation is the exact conversion, so its loss
# differs from the exact fake-quant forward's only by rounding (bucket
# factors within ulps of 1, the sum split over 8 buckets). On the H100 the
# gap read 7.05e-5 at LUT 8 beside an f64-accumulation floor of 2.24e-5,
# and 1.74e-4/5.84e-4/7.02e-4 at LUT 4/2/1. The limit is the geometric mean
# of the LUT-8 and LUT-4 readings, and the smaller LUT sizes run through
# the same check as controls that must fail it, so LUT-4 factors in place
# of LUT-8 ones would not pass
APPROX_LOSS_RTOL = 1.1e-4
APPROX_EXTRA_STEPS = 3
# K6's operations an element, for its bound: greedy a compare; noise-in a
# divide, an add and a compare; seeded also the noise (two mix32 rounds of
# 8 integer ops, 4 more to key, shift and convert, 2 to scale, two logs
# and two negations)
K6_OPS = {"greedy": 1, "noise-in": 3, "seeded": 3 + 16 + 4 + 2 + 4}
# K6's seeded noise on the card against the plain version on the CPU:
# torch's CPU log (a vectorised polynomial) and CUDA's logf may round the
# last bit apart. An ulp of the inner log moves g by about that ulp over
# its value, at most 2^-23 in absolute terms, and the outer log's own ulp
# adds 2^-24 |g|; so |dg| <= 2^-21 max(1, |g|) bounds two such roundings
# with room
K6_NOISE_ATOL = 2.0 ** -21
# phase 19: online serving. 19a's trace: one 64-token prefix (4 pages of
# 16) shared by 8 requests, a 16-32-token suffix each, 32 new tokens;
# the copy-on-write request (the prefix alone) generates COW_GEN
PREFIX_LEN, PREFIX_REQS, PREFIX_GEN, COW_GEN = 64, 8, 32, 8
# phase 18: the paper's baselines at full width
FP_SHAPE = (2048, 1536)
FP8_STEPS = 4
FP8_TRAIN_ARGV = ["--arch", "smollm-135m", "--format", "fp8", "--steps",
                  str(FP8_STEPS), "--batch", "8", "--seq", "256"]
BERT_BATCH, BERT_SEQ = 8, 384
FIG7_STEPS = 3
FIG4_D, FIG4_ETA, FIG4_GAMMA = 1 << 20, 2.0 ** -6, 2.0 ** 10
# Fig. 4 on the card against the CPU from the same uniforms: CUDA's and
# the CPU's log2/exp2 round an ulp or two apart (as across frameworks,
# H1), which moves a stochastic rounding across its threshold where the
# uniform lies within gamma·eps of it: tens of the 2^20 terms, each by
# under a grid step squared, in either direction. GD, MUL and Madam (r_t
# 0.03-0.17) are held to 2e-3 relative. signMUL at gamma·eta = 16 moves
# every exponent by exactly 16 codes, so its r_t is nothing but that
# noise: each term flips with probability gamma·|eps| and costs (1/gamma)^2,
# so E r_t = sum |eps|/gamma; with |eps| <= 4 ulps of log2|w| < 16 (2^-18)
# both sides must stay under d·2^-18/gamma
FIG4_RTOL = 2e-3
# phase 20: observability. 20b/20c take windows of OBS_DECODE_STEPS decode
# steps over 4 requests of 32 + OBS_GEN tokens (room for the admission
# step and six windows); 20d trains OBS_TRAIN_STEPS steps of 8 x 256
OBS_DECODE_STEPS = 3
OBS_GEN = 28
OBS_TRAIN_STEPS = 2
OBS_TRAIN_ARGV = ["--arch", "smollm-135m", "--steps", str(OBS_TRAIN_STEPS),
                  "--batch", "8", "--seq", "256"]
# 20c: a blocked call drains the stream before its clock starts and waits
# for its kernel after, so its time holds the launch and the kernel and
# reads above the kernel's device time; 0.9 allows for the profiler's and
# the host clock's granularity at kernels of a few microseconds
OBS_BLOCKED_MIN = 0.9
# the profiler's kernel names of the ops 20c and 20f read
OBS_BLOCKED_KERNELS = {
    "encode_pack": ("k1_tensor_kernel", "k1_row_kernel"),
    "qmatmul": ("qmatmul_skinny_kernel", "qmatmul_wgmma_kernel",
                "qmatmul_f32_kernel"),
    "paged_attend": ("paged_attend_kernel",),
    "fused_sample": ("fused_sample_kernel",)}
# 20b: the CUDA runtime calls that put a kernel or a copy on the card. The
# observer's cost is held to them, counted on the host: the profiler's
# device records of the same windows lose a few of ~17,600 a window
# (CUPTI), in windows whose runtime calls are identical
OBS_WORK_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                   "cudaMemcpy", "cudaMemsetAsync", "cudaMemset")
# kernel_stats ops and launch counts grouped by the kernel they launch
OBS_OP_KERNEL = {"fused_sample_seeded": "fused_sample",
                 "requant_pack_many": "requant_pack",
                 "madam_step_stats": "madam_step"}
# the numerics stats that are shares of a leaf's elements
OBS_FRACTIONS = ("sat_lo", "sat_hi", "dead_frac", "requant_sat_hi")
# the packed leaves of smollm-135m as K7 re-grids them, in tree order
K7_LEAVES = [("embed", (49152, 576)), ("wq", (30, 576, 576)),
             ("wk", (30, 576, 192)), ("wv", (30, 576, 192)),
             ("wo", (30, 576, 576)), ("gate", (30, 576, 1536)),
             ("up", (30, 576, 1536)), ("down", (30, 1536, 576))]


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


def k1_near_tie(torch, x, s, fmt):
    """Elements whose unrounded exponent sits within 2^-10 of a
    half-integer (f32 log2 may round either way there)."""
    e = -torch.log2(torch.clamp_min(x.double().abs() / s.double(),
                                    torch.finfo(torch.float32).tiny))
    e = e * fmt.gamma
    return (e - torch.floor(e) - 0.5).abs() < 2.0 ** -10


def same_floats(torch, a, b):
    """Equal bit for bit where neither is NaN, NaN at the same places."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        torch.where(a.isnan(), 0.0, a), torch.where(b.isnan(), 0.0, b))


def k1_pair(torch, ops, ref, x, fmt, scale_axis, what):
    """One K1 call against the plain version: scales equal, words equal
    away from the near-half ties. Returns the differing words, the
    near-ties and the largest word difference."""
    kw, ks = ops.encode_pack(x, fmt, scale_axis)
    pw, ps = ref.encode_pack(x, fmt, scale_axis)
    check(same_floats(torch, ks, ps), f"K1 {what}: scales differ")
    diff = kw.int() != pw.int()
    near = k1_near_tie(torch, x, ps, fmt)
    bad = int((diff & ~near & ~ps.isnan().expand_as(diff)).sum())
    check(bad == 0, f"K1 {what}: {bad} words differ away from a tie")
    check(not bool(ps.isnan().any()) or torch.equal(kw, pw),
          f"K1 {what}: words differ under a NaN scale")
    return (int(diff.sum()), int(near.sum()),
            int((kw.int() - pw.int()).abs().max()))


def k1_edges(torch, ops, ref, fmt):
    """K1 where the absmax sits at 2^k and one ulp either side (f32 and
    bf16 ulps) for every f32 exponent, per row (one edge a row) and per
    tensor, and with a NaN or an inf in x."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    cases = 0
    for dt in (torch.float32, torch.bfloat16):
        edges = []
        for k in range(-126, 128):
            for u in (-1, 0, 1):
                v = torch.tensor(2.0 ** k, dtype=dt)
                if u:
                    v = torch.nextafter(v, torch.tensor(
                        math.inf if u > 0 else 0.0, dtype=dt))
                edges.append(float(v))
        amax = torch.tensor(edges, device="cuda")[:, None]
        x = (torch.rand((len(edges), 64), generator=gen, device="cuda")
             - 0.5) * 0.9 * amax
        x[:, 5] = amax[:, 0] * torch.where(
            torch.arange(len(edges), device="cuda") % 2 == 0, 1.0, -1.0)
        x = x.to(dt)
        k1_pair(torch, ops, ref, x, fmt, 0, f"{dt} per-row pow2 edges")
        for r in range(len(edges)):
            xt = torch.zeros((4, 576), dtype=dt, device="cuda")
            xt[1, 3], xt[2, 8] = x[r, 5], x[r, 9]
            k1_pair(torch, ops, ref, xt, fmt, None,
                    f"{dt} per-tensor pow2 edge {edges[r]!r}")
        cases += 1 + len(edges)
    for special in (math.nan, math.inf, -math.inf):
        for R, C in ((32, 1536), (2048, 1536)):
            for axis in (None, 0):
                x = torch.randn((R, C), generator=gen, device="cuda")
                x[R // 2, 7] = special
                k1_pair(torch, ops, ref, x.to(torch.bfloat16), fmt, axis,
                        f"{R}x{C} with {special} (scale_axis={axis})")
                cases += 1
    print(f"K1 edges: {cases} calls (absmax at 2^k and +-1 ulp for k = "
          f"-126..127 in f32 and bf16, per row and per tensor; NaN, +inf "
          f"and -inf per row and per tensor): scales equal, words equal "
          f"away from ties")
    return cases


def k1_one_launch(torch, ops, fmt):
    """One ``ops.encode_pack`` call issues K1's own kernel and no torch
    kernel, per tensor and per row (torch.profiler's device events)."""
    from torch.profiler import ProfilerActivity, profile
    res = {}
    for R, C, axis in ((4, 1536, None), (2048, 1536, None),
                       (2048, 1536, 0)):
        x = torch.randn((R, C), device="cuda").to(torch.bfloat16)
        ops.encode_pack(x, fmt, axis)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ops.encode_pack(x, fmt, axis)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        check(names, "K1: the profiler saw no device event")
        check(len(names) == 1 and names[0].startswith("void k1_"),
              f"K1 {R}x{C} (scale_axis={axis}): one call ran {names}")
        res[f"{R}x{C}/{axis}"] = names
    print(f"K1 one launch a call: {res}")
    return res


def k1_check(torch, ops, ref, fmt, shapes):
    """K1 scales equal and words equal, except where the unrounded
    exponent sits within 2^-10 of a half-integer, at each shape, per
    tensor and (untimed) per row; timed per tensor."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for R, C in shapes:
        x = (torch.randn((R, C), generator=gen, device="cuda") * 3.0
             ).to(torch.bfloat16)
        ties, near, err = k1_pair(torch, ops, ref, x, fmt, None,
                                  f"{R}x{C}")
        row_ties, _, row_err = k1_pair(torch, ops, ref, x, fmt, 0,
                                       f"{R}x{C} per row")
        err = max(err, row_err)
        nbytes = R * C * 2 + R * 4 + R * C
        b, by = bound_ms(nbytes, 10 * R * C, F32_FLOPS)
        rows.append(dict(
            shape=[R, C], tie_words=ties, tie_words_per_row=row_ties,
            near_half=near, max_abs_err=err,
            ms=cuda_ms(torch, lambda: ops.encode_pack(x, fmt)),
            ms_per_row=cuda_ms(torch, lambda: ops.encode_pack(x, fmt, 0)),
            eager_ms=eager_ms(torch, lambda: ops.encode_pack(x, fmt)),
            plain_ms=cuda_ms(torch, lambda: ref.encode_pack(x, fmt)),
            bound_ms=b, bound_by=by, library_ms=None))
        r = rows[-1]
        print(f"K1 encode_pack {R}x{C}: words differing at ties "
              f"{ties} (per row {row_ties}; near-half elements {near}), "
              f"kernel {r['ms']:.4f} ms (per row {r['ms_per_row']:.4f}; "
              f"eager {r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} "
              f"ms, bound {b:.5f} ms ({by}; kernel at {b / r['ms']:.1%} "
              f"of it)")
    return rows


@contextlib.contextmanager
def k2_path(ops, path):
    """Route every bf16 K2 call through ``path`` (``"skinny"`` or
    ``"wgmma"``) by moving the plan's threshold, to time or check the path
    the plan would not pick."""
    keep = ops.QMATMUL_WGMMA_MIN_M
    ops.QMATMUL_WGMMA_MIN_M = 0 if path == "wgmma" else 1 << 62
    try:
        yield
    finally:
        ops.QMATMUL_WGMMA_MIN_M = keep


@contextlib.contextmanager
def k2_shapes_seen(torch, ops):
    """Record every K2 call's (M, K, N, compute dtype, out dtype) while
    the main paths run (the wrapper still counts every launch itself)."""
    seen = collections.Counter()
    launch = ops.qmatmul

    def record(pa, pb, fmt, *args, compute_dtype=None, out_dtype=None,
               **kw):
        cdt = compute_dtype or torch.bfloat16
        odt = out_dtype or torch.float32
        seen[(pa.shape[0], pa.shape[1], pb.shape[1], cdt, odt)] += 1
        return launch(pa, pb, fmt, *args, compute_dtype=cdt, out_dtype=odt,
                      **kw)

    ops.qmatmul = record
    try:
        yield seen
    finally:
        ops.qmatmul = launch


def k2_check(torch, ops, ref, fmt, shapes):
    """K2 against its plain version at each ``(M, K, N[, opts])``: within
    ``K2_RTOL`` of the output's max, two calls bit-identical, the path the
    plan picked printed. ``opts``: ``compute`` (the compute dtype, bf16 by
    default), ``out`` (bf16: the fused cast must equal the f32 output cast
    to bf16, bit for bit), ``also`` (another bf16 path, timed beside the
    planned one: the skinny/wgmma crossover) and ``brief`` (no eager or
    plain timing)."""
    from repro_torch.core.lns import lns_decode_packed
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 is on for float32 matmuls")
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for M, K, N, *opt in shapes:
        o = opt[0] if opt else {}
        cdt = o.get("compute", torch.bfloat16)
        odt = o.get("out", torch.float32)
        brief = o.get("brief", False)
        x = torch.randn((M, K), generator=gen, device="cuda").to(cdt)
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
        kw = dict(compute_dtype=cdt)
        plan = ops.qmatmul_plan(M, N, K, cdt)
        out = ops.qmatmul(pa, pbs[0], fmt, sa, sb, **kw)
        again = ops.qmatmul(pa, pbs[0], fmt, sa, sb, **kw)
        want = ref.qmatmul(pa, pbs[0], fmt, sa, sb, **kw)
        err = float((out - want).abs().max())
        lim = K2_RTOL * float(want.abs().max())
        tag = f"K2 {M}x{K}x{N} ({plan['path']}"
        check(err <= lim, f"{tag}): max err {err} > {lim}")
        check(torch.equal(out, again), f"{tag}): two calls differ")
        if odt != torch.float32:
            cast = ops.qmatmul(pa, pbs[0], fmt, sa, sb, out_dtype=odt, **kw)
            check(cast.dtype == odt and torch.equal(cast, out.to(odt)),
                  f"{tag}): the fused {odt} cast differs from the f32 "
                  f"output cast")
        a16 = lns_decode_packed(pa, fmt, cdt)
        b16 = [lns_decode_packed(p, fmt, cdt) for p in pbs]
        kw["out_dtype"] = odt
        it = {"i": 0}

        def rot():
            it["i"] = (it["i"] + 1) % len(pbs)
            return it["i"]

        esize = 2 if odt == torch.bfloat16 else 4
        nbytes = M * K + K * N + 4 * (M + N) + esize * M * N
        b, by = bound_ms(nbytes, 2 * M * N * K,
                         BF16_FLOPS if cdt == torch.bfloat16 else F32_FLOPS)
        rows.append(dict(
            shape=[M, K, N], path=plan["path"], splits=plan["splits"],
            blocks=plan["blocks"], out=str(odt).replace("torch.", ""),
            compute=str(cdt).replace("torch.", ""), max_abs_err=err,
            ms=cuda_ms(torch, lambda: ops.qmatmul(
                pa, pbs[rot()], fmt, sa, sb, **kw), iters=n_buf),
            eager_ms=None if brief else eager_ms(torch, lambda: ops.qmatmul(
                pa, pbs[rot()], fmt, sa, sb, **kw)),
            plain_ms=None if brief else cuda_ms(torch, lambda: ref.qmatmul(
                pa, pbs[rot()], fmt, sa, sb, **kw),
                iters=n_buf, replays=3),
            library_ms=cuda_ms(torch, lambda: torch.matmul(a16, b16[rot()]),
                               iters=n_buf),
            bound_ms=b, bound_by=by))
        r = rows[-1]
        also = ""
        if "also" in o:
            r["also_path"] = o["also"]
            with k2_path(ops, o["also"]):
                r["also_ms"] = cuda_ms(torch, lambda: ops.qmatmul(
                    pa, pbs[rot()], fmt, sa, sb, **kw), iters=n_buf)
            also = f", {o['also']} path {r['also_ms']:.4f} ms"
        timed = "" if brief else (f" (eager {r['eager_ms']:.4f} ms)")
        plain = "" if brief else f", plain {r['plain_ms']:.4f} ms"
        tiles = (f"{plan['mt8'] * 8}-row tiles, "
                 if plan["path"] == "skinny" else "")
        print(f"{tag}, {plan['blocks']} blocks, splits {plan['splits']}, "
              f"{tiles}"
              f"{r['compute']} -> {r['out']}): max err {err:.3e} (limit "
              f"{lim:.3e}), repeat bit-identical, kernel {r['ms']:.4f} ms"
              f"{timed}{also}{plain}, torch.matmul {r['library_ms']:.4f} "
              f"ms, bound {b:.5f} ms ({by}; {b / r['ms']:.1%})")
    return rows


def k2_decode_pass_check(torch, ops, ref, fmt, shapes):
    """The wgmma path's decode pass (``qmatmul_decode``) at each
    ``(M, K, N)``: both padded bf16 operands equal to the plain version's
    bit for bit, two calls bit-identical; timed with the weights rotating
    through >= 100 MB as in ``k2_check``."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for M, K, N in shapes:
        pa = torch.randint(0, 256, (M, K), generator=gen, device="cuda",
                           dtype=torch.uint8)
        n_buf = max(64, -(-100_000_000 // (K * N)))
        pbs = [torch.randint(0, 256, (K, N), generator=gen, device="cuda",
                             dtype=torch.uint8) for _ in range(n_buf)]
        got = ops.qmatmul_decode(pa, pbs[0], fmt)
        again = ops.qmatmul_decode(pa, pbs[0], fmt)
        want = ref.qmatmul_decode(pa, pbs[0], fmt)
        tag = f"K2 decode pass {M}x{K}x{N}"
        for g, a, w, n in zip(got, again, want, ("A", "B")):
            check(g.shape == w.shape and torch.equal(g, w),
                  f"{tag}: operand {n} differs from the plain decode")
            check(torch.equal(g, a), f"{tag}: two calls differ")
        it = {"i": 0}

        def rot():
            it["i"] = (it["i"] + 1) % len(pbs)
            return it["i"]

        # each word read once, each padded bf16 element written once; a
        # table lookup and a sign apply an element (CUDA cores)
        nbytes = M * K + K * N + 2 * (want[0].numel() + want[1].numel())
        b, by = bound_ms(nbytes, 2 * (M * K + K * N), F32_FLOPS)
        rows.append(dict(
            shape=[M, K, N], max_abs_err=0.0,
            ms=cuda_ms(torch, lambda: ops.qmatmul_decode(pa, pbs[rot()],
                                                         fmt), iters=n_buf),
            plain_ms=cuda_ms(torch, lambda: ref.qmatmul_decode(
                pa, pbs[rot()], fmt), iters=n_buf, replays=3),
            library_ms=None, bound_ms=b, bound_by=by))
        r = rows[-1]
        print(f"{tag}: operands equal to the plain decode, repeat "
              f"bit-identical, kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {b:.5f} ms ({by}; "
              f"{b / r['ms']:.1%})")
    return rows


def k2_driven_check(torch, ops, ref, fmt, seen):
    """Every (M, K, N, compute, out) that K2 took on the main paths
    (``k2_shapes_seen``), on fresh random operands: within ``K2_RTOL``,
    two calls bit-identical, and a bf16 output equal to the f32 output
    cast. So each launch configuration the paths ran (path, split, row
    tiles, partly masked tiles) is held against the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    by_path = collections.defaultdict(set)
    for M, K, N, cdt, odt in sorted(seen, key=str):
        x = torch.randn((M, K), generator=gen, device="cuda").to(cdt)
        pa, sa = ref.encode_pack(x, fmt)
        pb = torch.randint(0, 256, (K, N), generator=gen, device="cuda",
                           dtype=torch.uint8)
        sb = torch.exp2(torch.randint(-6, -2, (1, N), generator=gen,
                                      device="cuda").float())
        kw = dict(compute_dtype=cdt)
        out = ops.qmatmul(pa, pb, fmt, sa, sb, **kw)
        again = ops.qmatmul(pa, pb, fmt, sa, sb, **kw)
        want = ref.qmatmul(pa, pb, fmt, sa, sb, **kw)
        err = float((out - want).abs().max())
        lim = K2_RTOL * float(want.abs().max())
        plan = ops.qmatmul_plan(M, N, K, cdt)
        tag = f"K2 driven {M}x{K}x{N} ({plan['path']}, {cdt} -> {odt})"
        check(err <= lim, f"{tag}: max err {err} > {lim}")
        check(torch.equal(out, again), f"{tag}: two calls differ")
        if odt != torch.float32:
            cast = ops.qmatmul(pa, pb, fmt, sa, sb, out_dtype=odt, **kw)
            check(torch.equal(cast, out.to(odt)),
                  f"{tag}: the fused {odt} cast differs from the f32 "
                  f"output cast")
        by_path[plan["path"]].add(M)
    summary = {p: sorted(ms) for p, ms in by_path.items()}
    print(f"K2 on the main paths: {len(seen)} distinct shapes "
          f"({sum(seen.values())} calls), each within K2_RTOL and "
          f"bit-identical on a repeat; M by path {summary}")
    return {"shapes": [[M, K, N, str(c), str(o), n]
                       for (M, K, N, c, o), n in sorted(seen.items(),
                                                        key=str)],
            "m_by_path": summary}


def k2_sweep(torch, ops, ref, fmt):
    """``--k2-sweep``: the skinny plan's two constants re-derived on the
    card. At M = 4, 16 and 32 and the four GEMMs, K2 is timed (weights
    rotating through >= 100 MB) as one 8-warp block over all of K (where 8
    warps' shares fit the kernel's 6 steps) and split over the grid in
    4-warp blocks of 1..6 steps a warp; then at the default plan, with
    the decode pass alone, at M = 2048."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    gemms = [(576, 576), (576, 192), (576, 1536), (1536, 576)]
    configs = [("one block", 6, 3)] + [(f"split, {t} steps", 0, t)
                                      for t in range(1, 7)]
    keep = ops._SK_ONE_STEPS, ops._SK_SPLIT_STEPS
    rows = []
    for M in (4, 16, 32, 2048):
        for K, N in gemms:
            pa, sa = ref.encode_pack(torch.randn(
                (M, K), generator=gen, device="cuda").to(torch.bfloat16), fmt)
            n_buf = max(64, -(-100_000_000 // (K * N)))
            pbs = [torch.randint(0, 256, (K, N), generator=gen,
                                 device="cuda", dtype=torch.uint8)
                   for _ in range(n_buf)]
            it = {"i": 0}

            def rot():
                it["i"] = (it["i"] + 1) % len(pbs)
                return it["i"]

            def t(fn):
                return cuda_ms(torch, fn, iters=n_buf)

            row = {"shape": [M, K, N]}
            if M == 2048:
                row["default_ms"] = t(lambda: ops.qmatmul(pa, pbs[rot()], fmt,
                                                          sa))
                row["decode_pass_ms"] = t(lambda: ops.qmatmul_decode(
                    pa, pbs[rot()], fmt))
            else:
                for name, one, split in configs:
                    ops._SK_ONE_STEPS, ops._SK_SPLIT_STEPS = one, split
                    try:
                        plan = ops.qmatmul_plan(M, N, K)
                        if name == "one block" and plan["splits"] > 1:
                            row[name] = None      # K too deep for one block
                            continue
                        row[name] = t(lambda: ops.qmatmul(pa, pbs[rot()], fmt,
                                                          sa))
                    finally:
                        ops._SK_ONE_STEPS, ops._SK_SPLIT_STEPS = keep
                row["default_ms"] = t(lambda: ops.qmatmul(pa, pbs[rot()], fmt,
                                                          sa))
            rows.append(row)
            print("k2 sweep " + json.dumps(row))
    return rows


def k2_decode_check(torch, ops, ref):
    """Every word of every format the wrapper takes (B 2..8, gamma 1..64)
    through both bf16 paths, as ``1.0 x dec(word)`` (K = 1, a code-0
    activation): equal bit for bit to the plain decode, subnormals at
    gamma 1 included. Covers the skinny path's ALU decode wherever
    ``ops.arith_decode`` picks it and the table elsewhere."""
    from repro_torch.core.lns import LNSFormat, lns_decode_packed
    n_fmt = n_arith = 0
    for bits in range(2, 9):
        for gamma in (1, 2, 4, 8, 16, 64):
            f = LNSFormat(bits, gamma)
            words = torch.arange(1 << bits, device="cuda", dtype=torch.int32
                                 ).to(torch.uint8)[None]
            want = lns_decode_packed(words, f, torch.bfloat16).float()
            for M, path in ((1, "skinny"), (128, "wgmma")):
                pa = torch.zeros((M, 1), dtype=torch.uint8, device="cuda")
                with k2_path(ops, path):
                    got = ops.qmatmul(pa, words, f)
                check(torch.equal(got, want.expand(M, -1)),
                      f"K2 {path} decode of {f} differs from the plain "
                      f"decode (skinny ALU decode: {ops.arith_decode(f)})")
            n_fmt += 1
            n_arith += ops.arith_decode(f)
    print(f"K2 decode: every word of {n_fmt} formats equal to the plain "
          f"decode on both bf16 paths ({n_arith} by the skinny path's ALU "
          f"decode)")
    return {"formats": n_fmt, "alu_formats": n_arith}


def k5_inputs(torch, B, S, lengths, packed, fmt, gen, heads, PAGE=16,
              pool=None, MP=5):
    H, KV, HD = heads
    P = 4 * MP + 1  # the serving pool: 4 slots x MP pages + the null page
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
            pool or torch.bfloat16)
        vp = torch.randn((P, PAGE, KV, HD), generator=gen, device="cuda").to(
            pool or torch.bfloat16)
        ks = vs = None
    return q, kp, vp, ks, vs, bt, ln


def k5_check(torch, ops, ref, fmt, cases):
    from repro_torch.core.lns import lns_decode_packed
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for name, B, S, lengths, packed, *rest in cases:
        # (heads, kv heads, head_dim): smollm-135m's, or a case's own;
        # then the page size and the float pool's dtype, if not 16 and bf16
        H, KV, HD = heads = rest[0] if rest else (9, 3, 64)
        pool = rest[1] if len(rest) > 1 else {}
        q, kp, vp, ks, vs, bt, ln = k5_inputs(torch, B, S, lengths, packed,
                                              fmt, gen, heads, **pool)
        kw = dict(fmt=fmt if packed else None, softcap=None,
                  sm_scale=1 / math.sqrt(HD))
        out = ops.paged_attend(q, kp, vp, ks, vs, bt, ln, **kw)
        again = ops.paged_attend(q, kp, vp, ks, vs, bt, ln, **kw)
        want = ref.paged_attend(q, kp, vp, ks, vs, bt, ln, **kw)
        err = float((out - want).abs().max())
        check(err <= K5_ATOL, f"K5 {name}: max err {err} > {K5_ATOL}")
        check(torch.equal(out, again), f"K5 {name}: two calls differ")
        # yardstick: SDPA over pre-gathered, pre-decoded pages
        cap = bt.shape[1] * kp.shape[1]

        def gathered(pool, scale):
            x = pool[bt.long()].reshape(B, cap, KV, HD)
            if packed:
                s = scale[bt.long()].reshape(B, cap, KV, 1).float()
                x = lns_decode_packed(x, fmt, torch.float32) * s
            return x.to(torch.bfloat16).repeat_interleave(H // KV, dim=2) \
                .transpose(1, 2).contiguous()

        kg, vg = gathered(kp, ks), gathered(vp, vs)
        qt = q.transpose(1, 2).contiguous()
        qpos = ln.long()[:, None] - S + torch.arange(S, device="cuda")
        mask = (torch.arange(cap, device="cuda")[None, None, :]
                <= qpos[:, :, None])[:, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        elem, page = kp.element_size(), kp.shape[1]
        n_pos = [min(-(-int(n) // page), bt.shape[1]) * page
                 for n in lengths]
        nbytes = (q.numel() * 2 + sum(n_pos) * 2 * KV * HD * elem
                  + (sum(n_pos) * 2 * KV * 2 if packed else 0)
                  + bt.numel() * 4 + B * 4 + q.numel() * 4)
        visible = sum(max(int(n) - S + s + 1, 0) for n in lengths
                      for s in range(S))
        b, by = bound_ms(nbytes, 4 * H * HD * visible, BF16_FLOPS)
        rows.append(dict(
            shape=[B, S, H, HD], case=name, lengths=list(lengths),
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
        print(f"K5 paged_attend {name}: max err {err:.3e}, repeat "
              f"bit-identical, kernel "
              f"{r['ms']:.4f} ms (eager {r['eager_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, sdpa "
              f"{r['library_ms']:.4f} ms, bound {b:.5f} ms")
    return rows


def k6_inputs(torch, B, V, gen):
    """Logits ``(B, V)`` with a tie across blocks in row 0 (greedy in every
    case: the first maximum must win), torch-drawn noise for the noise-in
    case, and host rows: row 0 greedy, the rest sampled."""
    import numpy as np
    lg = torch.randn((B, V), generator=gen, device="cuda") * 4.0
    lg[0, 100] = lg[0, 20000] = 50.0
    u = torch.rand((B, V), generator=gen, device="cuda").clamp_min(1e-30)
    gum = -torch.log(-torch.log(u))
    temp = np.array([0.0] + [0.7 + 0.2 * (b % 4) for b in range(1, B)],
                    np.float32)
    seed = np.arange(100, 100 + B, dtype=np.uint32) * np.uint32(2654435761)
    step = np.array([3 * b % 7 for b in range(B)], np.int32)
    return lg, gum, temp, seed, step


def k6_check(torch, ops, ref):
    """K6 against its plain version at the decode batch (4 x 49152) and
    the verify's (16 x 49152), greedy, noise-in (the TPU kernel's
    function, noise fed in) and seeded (noise drawn in the kernel): tokens
    equal; the seeded noise_out equal to ``ref.gumbel_noise`` on the card
    and within ``K6_NOISE_ATOL`` of it on the CPU."""
    import numpy as np
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for B in (4, 16):
        V = 49152
        lg, gum, temp, seed, step = k6_inputs(torch, B, V, gen)
        # the plain versions take device rows (graph capture copies no
        # host memory)
        temp_t, seed_t, step_t = (torch.as_tensor(a.astype(dt), device="cuda")
                                  for a, dt in ((temp, np.float32),
                                                (seed, np.int64),
                                                (step, np.int64)))
        calls = {
            "greedy": (lambda: ops.fused_sample(lg, None, None),
                       lambda: ref.fused_sample(lg, None, None), 1),
            "noise-in": (lambda: ops.fused_sample(lg, gum, temp_t),
                         lambda: ref.fused_sample(lg, gum, temp_t), 2),
            "seeded": (lambda: ops.fused_sample_seeded(lg, temp, seed, step),
                       lambda: ref.fused_sample_seeded(lg, temp_t, seed_t,
                                                       step_t), 1),
        }
        for name, (kern, plain, reads) in calls.items():
            out, want = kern(), plain()
            check(torch.equal(out, want), f"K6 {name} {B}x{V}: tokens differ "
                  f"{out.tolist()} vs {want.tolist()}")
            check(int(out[0]) == 100, f"K6 {name}: not the first maximum")
            nbytes = B * V * 4 * reads + B * 4 * (2 if name != "seeded" else 1)
            b, by = bound_ms(nbytes, B * V * K6_OPS[name], F32_FLOPS)
            rows.append(dict(
                shape=[B, V], case=name, max_abs_err=0,
                blocks=ops.fused_sample_plan(B, V)["blocks"],
                ms=cuda_ms(torch, kern), eager_ms=eager_ms(torch, kern),
                plain_ms=cuda_ms(torch, plain),
                library_ms=cuda_ms(torch, lambda: torch.argmax(lg, dim=-1)),
                bound_ms=b, bound_by=by))
            r = rows[-1]
            print(f"K6 fused_sample {name} {B}x{V} ({r['blocks']} blocks a "
                  f"row): tokens equal, kernel {r['ms']:.4f} ms (eager "
                  f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
                  f"argmax {r['library_ms']:.4f} ms, bound {b:.5f} ms",
                  flush=True)
        toks, noise = ops.fused_sample_seeded(lg, temp, seed, step,
                                              noise_out=True)
        check(torch.equal(toks, ref.fused_sample_seeded(lg, temp, seed,
                                                        step)),
              "K6 seeded with noise_out: tokens differ")
        want = ref.gumbel_noise(seed, step, V, "cuda")
        check(torch.equal(noise, want), f"K6 {B}x{V}: noise_out differs from "
              f"ref.gumbel_noise on the card at "
              f"{int((noise != want).sum())} elements")
        cpu = ref.gumbel_noise(seed, step, V, "cpu")
        err = (noise.cpu() - cpu).abs()
        lim = K6_NOISE_ATOL * torch.clamp_min(cpu.abs(), 1.0)
        check(bool((err <= lim).all()), f"K6 {B}x{V}: noise_out vs the CPU's "
              f"ref.gumbel_noise: {float(err.max()):.3g} > the limit")
        rows.append(dict(shape=[B, V], case="seeded noise_out",
                         max_abs_err=0, noise_equal_card=True,
                         noise_vs_cpu_max_abs=float(err.max()),
                         noise_vs_cpu_differing=int((err > 0).sum()),
                         noise_vs_cpu_max_ratio=float((err / lim).max())))
        print(f"K6 seeded noise_out {B}x{V}: equal to ref.gumbel_noise on "
              f"the card; vs the CPU: {rows[-1]['noise_vs_cpu_differing']} "
              f"of {B * V} differ, max {rows[-1]['noise_vs_cpu_max_abs']:.3g}"
              f" ({rows[-1]['noise_vs_cpu_max_ratio']:.3f} of the limit)",
              flush=True)
    return rows


@contextlib.contextmanager
def k6_noise_in_torch(torch, dispatch, ops):
    """Sample as the sampler did before the seeded K6: a zeroed (B, V)
    noise buffer, for each sampled row a ``torch.Generator`` seeded by
    splitmix64 of (seed, step) and a rand/clamp/log/neg/log/neg chain
    copied into it, the temperatures copied from host memory, then the
    noise-in K6; to time and profile that pattern beside the seeded K6."""
    import numpy as np
    seeded = dispatch.fused_sample_seeded

    def mix64(x):
        m = (1 << 64) - 1
        x = (x + 0x9E3779B97F4A7C15) & m
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
        return x ^ (x >> 31)

    def chain(logits, temp, seed, step, *, noise_out=False):
        gumbel = torch.zeros_like(logits)
        V = logits.shape[1]
        for b in np.flatnonzero(temp > 0.0):
            g = torch.Generator(device=logits.device).manual_seed(mix64(
                (int(seed[b]) << 32) | (int(step[b]) & 0xFFFFFFFF)))
            u = torch.rand((V,), generator=g, device=logits.device)
            u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
            gumbel[b] = -torch.log(-torch.log(u))
        temp_t = torch.as_tensor(temp, dtype=torch.float32,
                                 device=logits.device)
        out = ops.fused_sample(logits, gumbel, temp_t)
        return (out, gumbel) if noise_out else out

    dispatch.fused_sample_seeded = chain
    try:
        yield
    finally:
        dispatch.fused_sample_seeded = seeded


def sampler_batches():
    """The 4-row temperature batch of a decode step and the 16-row batch
    of a k=4 verify over it (``step_offset`` 0..3 per row)."""
    import numpy as np
    from repro_torch.server.sampling import SamplingParams, sampling_rows, \
        set_row
    rows = sampling_rows(4)
    for b in range(4):
        set_row(rows, b, SamplingParams(temperature=0.7 + 0.2 * b,
                                        seed=1000 + b))
        rows["step"][b] = 5 + 3 * b
    verify = {n: np.repeat(v, SPEC_K) for n, v in rows.items()}
    return [("decode 4 rows", rows, None),
            ("verify 16 rows", verify, np.tile(np.arange(SPEC_K), 4))]


def sampler_check(torch, ops, ref):
    """``sample_logits`` on a temperature-only batch: the seeded K6 (one
    launch a call, no torch kernel, no copy, no torch.Generator) against the pattern of
    ``k6_noise_in_torch``, wall time and device work a call, the same
    call; and a masked batch (top-k) whose noise comes from K6's
    noise_out, tokens equal to the plain seeded path's."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import dispatch
    from repro_torch.server import sampling
    gen = torch.Generator(device="cuda").manual_seed(16)
    res = []
    for name, rows, off in sampler_batches():
        B = len(rows["temp"])
        lg = torch.randn((B, 49152), generator=gen, device="cuda") * 4.0

        def call():
            return sampling.sample_logits(lg, rows, step_offset=off)

        real_gen = torch.Generator

        def refuse(*a, **k):
            raise SmokeFailure("seeded sampling built a torch.Generator")

        torch.Generator = refuse
        try:
            toks = call()
        finally:
            torch.Generator = real_gen
        step = (rows["step"].astype(np.int64)
                + (0 if off is None else off)).astype(np.int32)
        check(torch.equal(toks, ref.fused_sample_seeded(
            lg, rows["temp"], rows["seed"], step)),
              f"sample_logits {name}: tokens differ from the plain version")
        r = {"batch": name}
        for how in ("seeded", "noise-in torch"):
            ctx = (k6_noise_in_torch(torch, dispatch, ops)
                   if how != "seeded" else contextlib.nullcontext())
            with ctx:
                wall = eager_ms(torch, call, iters=100)
                n = 20
                ops.reset_launch_counts()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(n):
                        call()
                    torch.cuda.synchronize()
            split = launch_split(torch, prof, n)
            r[how] = dict(wall_ms=wall,
                          launches=ops.launch_counts()["fused_sample"],
                          port=split["port"],
                          torch=split["torch"], copies=split["copies"],
                          torch_top=split["torch_top"])
        new = r["seeded"]
        # K6's own count gives the launches exactly; the profiler window
        # may lose an event at its edges, but must hold no other kernel
        check(new["launches"] == n and new["torch"] == 0
              and new["copies"] == 0 and 0 < new["port"] <= 1,
              f"sample_logits {name}: {n} seeded calls launched K6 "
              f"{new['launches']} times and ran {new['torch']} torch "
              f"kernels and {new['copies']} copies a call")
        old = r["noise-in torch"]
        print(f"sample_logits {name}: seeded K6 {new['wall_ms']:.4f} ms wall,"
              f" {new['launches'] / n:.0f} K6 launch, {new['torch']:.0f} "
              f"torch kernels and {new['copies']:.0f} copies a call; the "
              f"per-row chain then noise-in K6 {old['wall_ms']:.4f} ms wall, "
              f"{old['launches'] / n:.0f} K6 launch, {old['torch']:.1f} torch "
              f"kernels and {old['copies']:.1f} copies a call", flush=True)
        res.append(r)
    # a masked batch: top-k rows sample on the sort path with K6's noise
    rows = sampler_batches()[0][1]
    rows["top_k"][1:3] = 8
    lg = torch.randn((4, 49152), generator=gen, device="cuda") * 4.0
    got = sampling.sample_logits(lg, rows)
    plain = dispatch.fused_sample_seeded
    dispatch.fused_sample_seeded = ref.fused_sample_seeded
    try:
        want = sampling.sample_logits(lg, rows)
    finally:
        dispatch.fused_sample_seeded = plain
    check(torch.equal(got, want), f"masked sample_logits: tokens {got.tolist()}"
          f" differ from the plain noise's {want.tolist()}")
    print(f"masked sample_logits (top-k 8 on 2 of 4 rows): tokens equal to "
          f"the plain noise's {got.tolist()}")
    return res


def k7_check(torch, ops, ref):
    """K7 against its plain version at the 8 packed leaves, 8->6 and
    8->7, through the grouped launch (the whole draft view, as
    ``build_draft_params`` calls it) and through the one-leaf entry: words
    equal; also on a misaligned slice and a length that is not a multiple
    of 16. Timed with >= 100 MB of source words rotating through the
    graph, so the big leaves are not read L2-warm: the view in one launch,
    then at 8->6 each leaf alone (the sum is the view in 8 launches, the
    earlier pattern)."""
    from repro_torch.core.lns import LNSFormat
    gen = torch.Generator(device="cuda").manual_seed(7)
    src = LNSFormat(8, 8)

    def words(shape):
        return torch.randint(0, 256, shape, generator=gen, device="cuda",
                             dtype=torch.uint8)

    # two whole views' words (269 MB) rotate through the view's timing
    views = [[words(shape) for _, shape in K7_LEAVES] for _ in range(2)]
    n_view = sum(math.prod(shape) for _, shape in K7_LEAVES)
    it = {"v": 0}

    def rot_view():
        it["v"] = (it["v"] + 1) % 2
        return views[it["v"]]

    rows = []
    for bits in (6, 7):
        dst = src.with_bits(bits)
        got = ops.requant_pack_many(views[0], src, dst)
        for (name, shape), w, o in zip(K7_LEAVES, views[0], got):
            want = ref.requant_pack(w, src, dst)
            one = ops.requant_pack(w, src, dst)
            check(o.shape == w.shape and torch.equal(o, want),
                  f"K7 view 8->{bits} {name}: "
                  f"{int((o != want).sum())} words differ from the plain "
                  f"version")
            check(torch.equal(one, want), f"K7 one leaf 8->{bits} {name}: "
                  f"{int((one != want).sum())} words differ")
        # a misaligned slice (offset 3) of a ragged length, and a ragged
        # leaf on its own, in one launch and alone
        flat = views[0][0].reshape(-1)
        odd = [flat[3:3 + 1_000_003], words((1_000_003,)),
               flat[17:17 + 15]]
        for w, o in zip(odd, ops.requant_pack_many(odd, src, dst)):
            want = ref.requant_pack(w, src, dst)
            check(torch.equal(o, want) and torch.equal(
                ops.requant_pack(w, src, dst), want),
                f"K7 8->{bits}: words differ at a misaligned or ragged leaf "
                f"of {w.numel()} (offset {w.data_ptr() % 16})")
        b, by = bound_ms(2 * n_view, 5 * n_view, F32_FLOPS)
        rows.append(dict(
            leaf="view", shape=[n_view], bits=bits, launches=1,
            max_abs_err=0,
            ms=cuda_ms(torch, lambda: ops.requant_pack_many(rot_view(), src,
                                                            dst), iters=2),
            eager_ms=eager_ms(torch, lambda: ops.requant_pack_many(
                rot_view(), src, dst), iters=20),
            plain_ms=cuda_ms(torch, lambda: ref.requant_pack_many(
                rot_view(), src, dst), iters=2, replays=3),
            bound_ms=b, bound_by=by, library_ms=None))
        r = rows[-1]
        print(f"K7 requant_pack_many draft view 8->{bits} (1 launch, 8 "
              f"leaves): words equal (also one leaf at a time, misaligned "
              f"and ragged), kernel {r['ms']:.4f} ms (eager "
              f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"bound {b:.4f} ms ({b / r['ms']:.1%})", flush=True)
    del views
    torch.cuda.empty_cache()
    for name, shape in K7_LEAVES:
        n = math.prod(shape)
        n_buf = max(2, -(-100_000_000 // n))
        leaf = [words(shape) for _ in range(n_buf)]
        it["i"] = 0

        def rot():
            it["i"] = (it["i"] + 1) % n_buf
            return leaf[it["i"]]

        for bits in (6,):
            dst = src.with_bits(bits)
            b, by = bound_ms(2 * n, 5 * n, F32_FLOPS)
            rows.append(dict(
                leaf=name, shape=list(shape), bits=bits, launches=1,
                max_abs_err=0,
                ms=cuda_ms(torch, lambda: ops.requant_pack(rot(), src, dst),
                           iters=n_buf),
                eager_ms=eager_ms(torch, lambda: ops.requant_pack(
                    rot(), src, dst)),
                plain_ms=cuda_ms(torch, lambda: ref.requant_pack(
                    rot(), src, dst), iters=n_buf, replays=3),
                bound_ms=b, bound_by=by, library_ms=None))
            r = rows[-1]
            print(f"K7 requant_pack {name} {'x'.join(map(str, shape))} "
                  f"8->{bits} alone: kernel {r['ms']:.4f} ms (eager "
                  f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
                  f"bound {b:.4f} ms ({b / r['ms']:.1%})", flush=True)
        del leaf
    one = [r for r in rows if r["leaf"] != "view"]
    print(f"K7 draft view 8->6: 1 launch {rows[0]['ms']:.4f} ms against 8 "
          f"one-leaf launches {sum(r['ms'] for r in one):.4f} ms, bound "
          f"{rows[0]['bound_ms']:.4f} ms")
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


def serve(torch, argv, ops, warm=True):
    """One full-width serving run through the CLI's own engine; returns
    (aggregate metrics, engine, launch counts of exactly this run).
    ``warm`` runs the trace once before the measured run (cuBLAS handles,
    the allocator); without it the measured run also builds the engine's
    draft views, whose K7 launches it then counts."""
    from repro_torch.launch.serve import build_engine, parser
    from repro_torch.serving import synthetic_trace

    args = parser().parse_args(argv)
    engine = build_engine(args)
    trace = lambda: synthetic_trace(engine.cfg, requests=args.requests,
                                    prompt_len=args.prompt_len,
                                    gen_len=args.gen_len, seed=args.seed)
    if warm:
        engine.run(trace())
        engine.reset()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    agg = engine.run(trace())
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    return agg, engine, counts


def streams(engine):
    return {rs.request.rid: list(rs.generated) for rs in engine.finished}


@contextlib.contextmanager
def k5_query_rows(ops):
    """Count K5 launches by their query length S (the wrapper still counts
    every launch itself)."""
    seen = collections.Counter()
    launch = ops.paged_attend

    def record(q, *args, **kw):
        seen[q.shape[1]] += 1
        return launch(q, *args, **kw)

    ops.paged_attend = record
    try:
        yield seen
    finally:
        ops.paged_attend = launch


def spec_serve(torch, ops, base):
    """Phase 11: the paged trace with speculation (and the ondemand
    runs) at full width, each held to phase 4's streams ``base``. The
    non-speculating reserve engine runs first and last, unwarmed like
    the rest, and tok/s ratios are taken to the mean of those two runs:
    host-bound times drift within one call."""
    base_streams = base["streams"]
    runs, engines = {}, {}
    for name, extra in SPEC_RUNS:
        with k5_query_rows(ops) as seen:
            agg, eng, counts = serve(torch, SERVE_PAGED + extra, ops,
                                     warm=False)
        got = streams(eng)
        check(agg["completed"] == 8, f"{name}: completed "
              f"{int(agg['completed'])}/8 requests")
        same = [rid for rid in base_streams if got[rid] == base_streams[rid]]
        first = [next((i for i, (a, b) in enumerate(zip(got[rid],
                                                         base_streams[rid]))
                       if a != b), min(len(got[rid]),
                                       len(base_streams[rid])))
                 for rid in base_streams if rid not in same]
        k = eng.spec.k if eng.spec is not None else 0
        # one draft view is built where the draft width is not the
        # serving width (8)
        views = int(k > 0 and eng.spec.draft_bits != 8)
        check(counts["requant_pack"] == views,
              f"{name}: K7 launched {counts['requant_pack']} times for "
              f"{views} draft views")
        check(sum(seen.values()) == counts["paged_attend"],
              f"{name}: K5 launches {dict(seen)} vs {counts}")
        if k:
            # one verify per layer per cycle (at k=1 the drafts and the
            # one-token steps run at S=1 as well)
            L = eng.cfg.num_layers
            want = L * eng.spec_cycles + (
                L * (eng.spec_cycles + eng.decode_steps) if k == 1 else 0)
            check(eng.spec_cycles > 0 and seen[k] == want,
                  f"{name}: K5 at S={k} launched {seen[k]} times over "
                  f"{eng.spec_cycles} cycles")
        if eng.alloc_policy == "ondemand":
            check(eng.allocator.available == eng.num_pages and
                  eng.allocator.in_use == 0,
                  f"{name}: pool ends at {eng.allocator.available}/"
                  f"{eng.num_pages} pages")
        r = dict(
            agg=agg, launches=counts, k5_by_query_rows=dict(seen),
            spec=eng.spec_snapshot(), decode_steps=eng.decode_steps,
            prefills=eng.prefills, preemptions=eng.preemptions,
            decode_page_allocs=eng.decode_page_allocs,
            draft_views_built=views,
            same_as_phase4=len(same) / len(base_streams),
            first_divergence=min(first) if first else None)
        runs[name] = r
        sp = r["spec"] or {}
        print(f"{name}: completed 8/8, {agg['tokens_per_s']:.2f} tok/s, "
              f"tpot p50 {agg['tpot_p50_s'] * 1e3:.1f} "
              f"ms, ttft mean {agg['ttft_mean_s'] * 1e3:.1f} ms; accept "
              f"rate {sp.get('spec_accept_rate')}, cycles "
              f"{sp.get('spec_cycles')}, fallbacks "
              f"{sp.get('spec_fallbacks')}, decode steps "
              f"{eng.decode_steps}; streams equal to phase 4 for "
              f"{len(same)}/8 (first divergence at token "
              f"{r['first_divergence']}); K7 {counts['requant_pack']}, "
              f"K5 by S {dict(seen)}, preemptions {eng.preemptions}")
        engines[name] = eng
    for name in ("baseline", "ondemand", "spec_k1_b6", "baseline_end"):
        check(runs[name]["same_as_phase4"] == 1.0,
              f"{name}: streams differ from phase 4's (first divergence at "
              f"token {runs[name]['first_divergence']})")
    base_tps = (runs["baseline"]["agg"]["tokens_per_s"]
                + runs["baseline_end"]["agg"]["tokens_per_s"]) / 2
    for name, r in runs.items():
        r["tok_s_ratio_to_baseline"] = r["agg"]["tokens_per_s"] / base_tps
    print("tok/s over the mean of the first and last baseline runs ("
          f"{base_tps:.2f}): " + ", ".join(
              f"{name} {r['tok_s_ratio_to_baseline']:.3f}"
              for name, r in runs.items()))
    print("random weights: the 30-layer 8-bit model is chaotic, and the "
          "per-tensor activation scales of a B*k verify batch differ from "
          "a decode step's B rows, so a k=4 stream may leave phase 4's "
          "at a near-tie; k=1 and the ondemand baseline may not")
    return runs, engines["spec_b6"]


@contextlib.contextmanager
def k1_scales(ops):
    """Record the per-tensor activation scale of every K1 call."""
    seen = []
    launch = ops.encode_pack

    def record(x, fmt, scale_axis=None):
        packed, scale = launch(x, fmt, scale_axis)
        seen.append(float(scale[0, 0]))
        return packed, scale

    ops.encode_pack = record
    try:
        yield seen
    finally:
        ops.encode_pack = launch


def verify_coupling(torch, ops, cycles=8):
    """Phase 14 (measured, not limited): from the states of the paged
    trace's baseline engine, k greedy S=1 steps against one S=k verify
    over the same tokens (the identity draft). Counts the positions whose
    greedy token differs and the K1 sites whose per-tensor activation
    scale differs between the two."""
    from repro_torch.launch.serve import build_engine, parser
    from repro_torch.models.model import forward
    from repro_torch.serving import synthetic_trace
    args = parser().parse_args(SERVE_PAGED)
    eng = build_engine(args)
    for r in synthetic_trace(eng.cfg, requests=args.requests,
                             prompt_len=args.prompt_len,
                             gen_len=args.gen_len, seed=args.seed):
        eng.submit(r)
    eng.step()
    cache = eng.caches["period"]["pos0"]
    tok_diff = positions = site_diff = sites = unexplained = 0
    for _ in range(cycles):
        saved = {k: v.clone() for k, v in cache.items()}
        bt = eng._tensor(eng._block_tables)
        pos = eng._tensor(eng._slot_len)
        cur = eng._tensor(eng._last_tok)
        steps, step_scales = [], []
        for j in range(SPEC_K):
            with k1_scales(ops) as sc:
                lg = forward(eng.params, cur[:, None], eng.cfg, eng.qcfg,
                             caches=eng.caches, pos_offset=pos + j,
                             block_tables=bt, head=eng._head)[:, -1]
            cur = lg.float().argmax(-1).to(torch.int32)
            steps.append(cur)
            step_scales.append(sc)
        for k, v in saved.items():
            cache[k].copy_(v)
        x = torch.cat([eng._tensor(eng._last_tok)[:, None]]
                      + [t[:, None] for t in steps[:-1]], dim=1)
        with k1_scales(ops) as vsc:
            ver = forward(eng.params, x, eng.cfg, eng.qcfg,
                          caches=eng.caches, pos_offset=pos,
                          block_tables=bt, head=eng._head)
        ver = ver.float().argmax(-1).to(torch.int32)
        for k, v in saved.items():
            cache[k].copy_(v)
        for j in range(SPEC_K):
            d = int((ver[:, j] != steps[j]).sum())
            n = sum(a != b for a, b in zip(vsc, step_scales[j]))
            tok_diff += d
            positions += ver.shape[0]
            site_diff += n
            sites += len(vsc)
            unexplained += int(d > 0 and n == 0)
        eng.step()
    res = {"cycles": cycles, "token_diffs": tok_diff,
           "positions": positions, "scale_site_diffs": site_diff,
           "scale_sites": sites,
           "token_diffs_without_scale_diff": unexplained}
    print(f"verify (S={SPEC_K}) vs {SPEC_K} one-token steps over the same "
          f"tokens, {cycles} states of the paged trace: greedy tokens "
          f"differ at {tok_diff}/{positions} positions, per-tensor K1 "
          f"scales at {site_diff}/{sites} sites; positions with a token "
          f"difference but no scale difference: {unexplained}")
    return res


def mixed_trace(cfg):
    """The CPU tests' mixed trace: greedy and seeded rows interleaved."""
    import numpy as np
    from repro_torch.server.sampling import SamplingParams
    from repro_torch.serving import Request
    rng = np.random.default_rng(3)
    out = []
    for i in range(6):
        sp = None if i % 2 == 0 else SamplingParams(
            temperature=0.9, top_k=0 if i % 4 == 1 else 8, seed=100 + i)
        prompt = rng.integers(0, cfg.vocab_size, (4 + (i % 3) * 3,)).tolist()
        out.append(Request(rid=i, prompt=prompt, max_new_tokens=12 - (i % 4),
                           sampling=sp))
    return out


def smoke_spec(torch):
    """Phase 12: at the smoke config on the card, the speculating
    engine's streams equal the baseline's on the mixed trace."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.lns import LNSFormat
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.models.model import init_params
    from repro_torch.optim.madam import MadamConfig, init_lns_params
    from repro_torch.serving import Engine
    cfg = get_smoke_config("smollm-135m")
    params = init_lns_params(init_params(cfg, seed=0, device="cuda"),
                             MadamConfig(update_format=LNSFormat(8, 8)))
    out = {}
    for name, kw, bits in (
            ("dense", {}, 7),
            ("ondemand", dict(page_size=8, num_pages=18,
                              alloc_policy="ondemand"), 6)):
        mk = lambda **extra: Engine(cfg, QuantConfig.lns_madam(), params,
                                    num_slots=3, max_len=48, device="cuda",
                                    **kw, **extra)
        base = mk()
        base.run(mixed_trace(cfg))
        eng = mk(speculate_k=3, draft_bitwidth=bits)
        eng.run(mixed_trace(cfg))
        b, g = streams(base), streams(eng)
        diff = [rid for rid in b if b[rid] != g.get(rid)]
        check(len(b) == 6 and not diff,
              f"smoke {name}: spec streams differ for requests {diff}")
        if eng.page_size:
            check(eng.allocator.available == eng.num_pages,
                  f"smoke {name}: pool not returned")
        out[name] = eng.spec_snapshot()
        print(f"smoke {name}: spec (k=3, B={bits}) streams equal the "
              f"baseline's for 6/6 mixed greedy/seeded requests, accept "
              f"rate {eng.spec_accept_rate:.3f}, cycles {eng.spec_cycles}")
    return out


def profile_spec(torch, engine, decode_ms):
    """Phase 13: wall and device time of 2 speculative cycles of the
    B=6 engine (its draft view already built)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import synthetic_trace

    engine.reset()
    for r in synthetic_trace(engine.cfg, requests=4, prompt_len=32,
                             gen_len=16, seed=1):
        engine.submit(r)
    engine.step()              # admissions + first cycle
    torch.cuda.synchronize()
    c0, d0 = engine.spec_cycles, engine.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(2):
            engine.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    check(engine.spec_cycles - c0 == 2 and engine.decode_steps == d0,
          "profile: the 2 steps were not 2 speculative cycles")
    busy_us, top = device_time(torch, prof, 8)
    share = busy_us / 1e6 / wall if busy_us else None
    print(f"profile, 2 spec cycles (k={SPEC_K}, B=6): wall "
          f"{wall * 1e3 / 2:.1f} ms/cycle = "
          f"{wall * 1e3 / 2 / decode_ms:.2f} decode steps, device busy "
          + (f"{busy_us / 2e3:.2f} ms/cycle ({share:.1%})" if busy_us
             else "not measured (no device time in the trace)"))
    for e in top:
        print(f"  {e.key[:60]}: {e.self_device_time_total / 2e3:.3f} "
              f"ms/cycle, {e.count // 2} calls/cycle")
    shares = kernel_shares(torch, prof, busy_us, 2, "cycle")
    return {"wall_ms_per_cycle": wall * 1e3 / 2, "k2_k5": shares,
            "cycle_over_decode_step": wall * 1e3 / 2 / decode_ms,
            "device_busy_ms_per_cycle": busy_us / 2e3 if busy_us else None,
            "device_busy_share": share,
            "top": [[e.key, e.self_device_time_total / 2e3, e.count // 2]
                    for e in top]}


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


def qmatmul_f64(pa, pb, fmt, scale_a=None, scale_b=None, *,
                compute_dtype=None, out_dtype=None):
    """K2's function with the plain decode and an f64-accumulated GEMM:
    the noise floor of a pure change of summation order (phases 5, 9 and
    19a)."""
    import torch
    from repro_torch.core.lns import lns_decode_packed
    cdt = compute_dtype or torch.bfloat16
    a = lns_decode_packed(pa, fmt, cdt).double()
    b = lns_decode_packed(pb, fmt, cdt).double()
    return ((a @ b).float() * scale_a * scale_b).to(out_dtype or torch.float32)


def logits_check(torch, engine):
    """Phase 5: batch-1 prefill + 4 greedy decode steps at full width,
    through the kernels, through the plain versions, and through the
    plain versions with an f64-accumulating GEMM (the noise floor)."""
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


def kernel_shares(torch, prof, busy_us, per, unit):
    """Device ms per ``unit`` and launches of K2 (``qmatmul``: its GEMM
    kernels; ``qmatmul_decode``: the wgmma path's decode pass) and K5
    (``paged_attend``) in a profile, beside their share of the busy time;
    printed and returned."""
    cuda = torch.autograd.DeviceType.CUDA
    res = {}
    for name in ("qmatmul", "qmatmul_decode", "paged_attend"):
        evs = [e for e in prof.key_averages()
               if e.device_type == cuda and name in e.key
               and (name != "qmatmul" or "qmatmul_decode" not in e.key)]
        us = sum(e.self_device_time_total for e in evs)
        res[name] = {"ms": us / 1e3 / per,
                     "calls": sum(e.count for e in evs) // per,
                     "share": us / busy_us if busy_us else None}
    print("  " + ", ".join(
        f"{n} {r['ms']:.3f} ms/{unit} ({r['calls']} calls"
        + (f", {r['share']:.1%} of busy)" if r["share"] is not None else ")")
        for n, r in res.items()))
    return res


# the port's kernels by name; every other device kernel in a profile is
# torch's own (ATen, cuBLAS)
PORT_KERNELS = ("k1_tensor_kernel", "k1_row_kernel", "qmatmul_",
                "paged_attend_kernel", "fused_sample_kernel", "madam_step",
                "requant_kernel", "lns_matmul_kernel")


def launch_split(torch, prof, per, n_top=8):
    """Device work items per ``per`` in a profile: the port's kernels,
    torch's kernels, memcpy/memset operations, and torch's ``n_top``
    kernels by launches."""
    cuda = torch.autograd.DeviceType.CUDA
    n = {"port": 0, "torch": 0, "copies": 0}
    torch_k = []
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        kind = ("port" if any(k in e.key for k in PORT_KERNELS) else
                "copies" if e.key.startswith(("Memcpy", "Memset")) else
                "torch")
        n[kind] += e.count
        if kind == "torch":
            torch_k.append((e.count / per, e.key[:70]))
    res = {k: v / per for k, v in n.items()}
    res["torch_top"] = sorted(torch_k, reverse=True)[:n_top]
    return res


@contextlib.contextmanager
def k1_scale_in_torch(ops, ref):
    """Launch K1 after ``ref.row_scale``'s torch chain (cast, abs, amax,
    clamp, log2, ceil, exp2, copy), as K1's wrapper did when the scale was
    a torch reduction, to profile that launch pattern beside K1's own."""
    launch = ops.encode_pack

    def scale_first(x, fmt, scale_axis=None):
        ref.row_scale(x, scale_axis)
        return launch(x, fmt, scale_axis)

    ops.encode_pack = scale_first
    try:
        yield
    finally:
        ops.encode_pack = launch


def scale_copies(torch, params):
    """Per-layer weight scales that the routed GEMM's ``reshape(1, -1)
    .to(f32).expand(1, N).contiguous()`` (core/quantizer.py
    ``_routed_impl``) would copy, of all it reads: 0 means every one
    returns the stored tensor and launches nothing."""
    from repro_torch.core.lns import LNSWeight
    from repro_torch.tree import leaves
    copied = total = 0
    for _, w in leaves(params):
        if not isinstance(w, LNSWeight) or w.packed.dim() != 3:
            continue
        for i in range(w.packed.shape[0]):
            s = w[i].scale
            sw = s.reshape(1, -1).to(torch.float32).expand(
                1, w.packed.shape[2]).contiguous()
            copied += sw.data_ptr() != s.data_ptr()
            total += 1
    return copied, total


def profile_decode(torch, engine, ops):
    """Device busy share over 3 decode steps of a full engine, and the
    device work a step (the port's kernels and torch's); then 3 more steps
    with K1's scale computed by torch first (the launches K1 saves)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ref
    from repro_torch.serving import synthetic_trace

    engine.reset()
    for r in synthetic_trace(engine.cfg, requests=4, prompt_len=32,
                             gen_len=16, seed=1):
        engine.submit(r)
    engine.step()              # admissions + first decode
    torch.cuda.synchronize()

    def window():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(3):
                engine.step()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        return prof, wall

    prof, wall = window()
    with k1_scale_in_torch(ops, ref):
        prof_ts, wall_ts = window()
    busy_us, top = device_time(torch, prof, 6)
    busy_ts, _ = device_time(torch, prof_ts, 1)
    launches = launch_split(torch, prof, 3)
    launches_ts = launch_split(torch, prof_ts, 3)
    share = busy_us / 1e6 / wall if busy_us else None
    print(f"profile, 3 decode steps: wall {wall * 1e3 / 3:.1f} ms/step, "
          f"device busy "
          + (f"{busy_us / 3e3:.2f} ms/step ({share:.1%})" if busy_us
             else "not measured (no device time in the trace)"))
    print(f"  device work a decode step: {launches['port']:.0f} port "
          f"kernels, {launches['torch']:.0f} torch kernels, "
          f"{launches['copies']:.0f} copies; with K1's scale in torch "
          f"first: {launches_ts['torch']:.0f} torch kernels, busy "
          f"{busy_ts / 3e3:.2f} ms/step, wall {wall_ts * 1e3 / 3:.1f} "
          f"ms/step")
    copied, total = scale_copies(torch, engine.params)
    print(f"  weight scales the routed GEMM copies: {copied} of {total} "
          f"layer weights")
    for tag, ls in (("", launches), ("K1's scale in torch, ", launches_ts)):
        print(f"  {tag}torch kernels by launches a step: " + "; ".join(
            f"{name} {cnt:.0f}" for cnt, name in ls["torch_top"]))
    for e in top:
        print(f"  {e.key[:60]}: {e.self_device_time_total / 3e3:.3f} "
              f"ms/step, {e.count // 3} calls/step")
    shares = kernel_shares(torch, prof, busy_us, 3, "step")
    return {"wall_ms_per_step": wall * 1e3 / 3, "k2_k5": shares,
            "device_busy_ms_per_step": busy_us / 3e3 if busy_us else None,
            "device_busy_share": share, "launches_per_step": launches,
            "weight_scale_copies": [copied, total],
            "k1_scale_in_torch": {
                "launches_per_step": launches_ts,
                "device_busy_ms_per_step": busy_ts / 3e3,
                "wall_ms_per_step": wall_ts * 1e3 / 3},
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
    # at M = 2048 K2 takes the wgmma path: one decode pass a GEMM
    check(0 < counts["qmatmul_decode"] <= counts["qmatmul"],
          f"K2's decode pass launched {counts['qmatmul_decode']} times for "
          f"{counts['qmatmul']} GEMMs on the training path")
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
    from repro_torch.kernels import dispatch, ops, ref
    from repro_torch.training.steps import build_train_step
    from repro_torch.tree import leaves
    cfg, qcfg, mcfg, state, batch = setup
    step = build_train_step(cfg, qcfg, mcfg)

    def run():
        new, m = step(state, batch)
        return float(m["loss"]), float(m["grad_norm"]), new.params

    with plain_versions(dispatch, ref), plain_madam(ops, ref):
        plain = run()
        dispatch.qmatmul = qmatmul_f64
        floor_run = run()
    kern = run()
    # where the kernels' gap comes from (measured, not limited): K2 on its
    # skinny path at M=2048 in place of wgmma, and K1's plain version in
    # place of the kernel
    with k2_path(ops, "skinny"):
        kern_skinny = run()
    keep = dispatch.encode_pack
    dispatch.encode_pack = ref.encode_pack
    try:
        kern_k1_plain = run()
    finally:
        dispatch.encode_pack = keep

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
           "word_share_floor": words_share(floor_run[2], plain[2]),
           "loss_rel_err_k2_skinny": abs(kern_skinny[0] - plain[0])
           / abs(plain[0]),
           "word_share_k2_skinny": words_share(kern_skinny[2], plain[2]),
           "loss_rel_err_k1_plain": abs(kern_k1_plain[0] - plain[0])
           / abs(plain[0]),
           "k1_plain_same_loss": kern_k1_plain[0] == kern[0],
           "k1_plain_word_share": words_share(kern_k1_plain[2], kern[2])}
    print(f"full-width train step: loss kernels {kern[0]:.5f} vs plain "
          f"{plain[0]:.5f} (rel {res['loss_rel_err']:.2e}, floor "
          f"{res['loss_rel_floor']:.2e}, limit {TRAIN_LOSS_RTOL}); words "
          f"differing after the update {res['word_share']:.4%} (floor "
          f"{res['word_share_floor']:.4%}, limit {TRAIN_WORD_SHARE:.0%}); "
          f"grad norm {kern[1]:.4f} vs {plain[1]:.4f}")
    print(f"  the gap's sources: K2 skinny in place of wgmma: loss rel "
          f"{res['loss_rel_err_k2_skinny']:.2e}, words "
          f"{res['word_share_k2_skinny']:.4%}; K1's plain version in place "
          f"of the kernel: loss rel {res['loss_rel_err_k1_plain']:.2e} "
          f"(same loss as the kernels: {res['k1_plain_same_loss']}; words "
          f"differing from the kernels' step "
          f"{res['k1_plain_word_share']:.4%})")
    check(res["loss_rel_err"] <= TRAIN_LOSS_RTOL,
          f"train-step loss differs by {res['loss_rel_err']}")
    check(res["word_share"] <= TRAIN_WORD_SHARE,
          f"{res['word_share']:.2%} of words differ after one step")
    return res


def step_profile(torch, step, state, batch, timed=1, n_top=8):
    """One train step's wall time unprofiled (after a warm-up, over
    ``timed`` steps), then one profiled step: wall, device busy time and
    share, the device work (the port's kernels, torch's, copies) and the
    top kernels by device time. Returns the numbers and the profile."""
    from torch.profiler import ProfilerActivity, profile
    float(step(state, batch)[1]["loss"])        # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(timed):
        float(step(state, batch)[1]["loss"])
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) * 1e3 / timed
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        float(step(state, batch)[1]["loss"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy_us, top = device_time(torch, prof, n_top)
    return {"step_ms": step_ms, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "device_busy_share": busy_us / 1e6 / wall if busy_us else None,
            "launches": launch_split(torch, prof, 1),
            "top": [[e.key, e.self_device_time_total / 1e3, e.count]
                    for e in top]}, prof


def profile_train(torch, setup):
    """Phase 10: device busy share of one full-width train step, its
    device work (port and torch kernels), and one more step with K1's
    scale computed by torch first."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops, ref
    from repro_torch.training.steps import build_train_step
    cfg, qcfg, mcfg, state, batch = setup
    step = build_train_step(cfg, qcfg, mcfg)
    res, prof = step_profile(torch, step, state, batch, timed=3, n_top=10)
    with k1_scale_in_torch(ops, ref), profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof_ts:
        float(step(state, batch)[1]["loss"])
        torch.cuda.synchronize()
    busy_ts, _ = device_time(torch, prof_ts, 1)
    launches_ts = launch_split(torch, prof_ts, 1)
    busy, launches = res["device_busy_ms"], res["launches"]
    print(f"train step without the profiler: {res['step_ms']:.1f} ms "
          f"({2048 / res['step_ms'] * 1e3:.0f} tok/s)")
    print(f"profile, 1 train step: wall {res['wall_ms']:.1f} ms, device busy "
          + (f"{busy:.1f} ms ({res['device_busy_share']:.1%})" if busy
             else "not measured (no device time in the trace)"))
    print(f"  device work a train step: {launches['port']:.0f} port "
          f"kernels, {launches['torch']:.0f} torch kernels, "
          f"{launches['copies']:.0f} copies; with K1's scale in torch "
          f"first: {launches_ts['torch']:.0f} torch kernels, busy "
          f"{busy_ts / 1e3:.1f} ms")
    for key, ms, n in res["top"]:
        print(f"  {key[:60]}: {ms:.3f} ms, {n} calls")
    res["k2_k5"] = kernel_shares(torch, prof, (busy or 0) * 1e3, 1, "step")
    res["k1_scale_in_torch"] = {"launches": launches_ts,
                                "device_busy_ms": busy_ts / 1e3}
    return res


def once_ms(torch, fn):
    """Device time of a single ``fn`` call (CUDA events) and its result:
    for plain versions too slow to repeat at full size."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def k8_rates(torch):
    """K8's peak rates: integer ops and shared-memory loads per second,
    from the SM count and the maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(clk.returncode == 0, f"nvidia-smi clocks failed: {clk.stderr}")
    mhz = float(clk.stdout.strip().splitlines()[0])
    return {"sms": sms, "max_sm_mhz": mhz,
            "int_ops_per_s": sms * ISSUE_LANES_PER_SM * mhz * 1e6,
            "smem_loads_per_s": sms * SMEM_LOADS_PER_SM * mhz * 1e6}


def k8_operands(torch, M, K, N, fmt, gen):
    """Random f32 operands and their packed words with per-tensor scales,
    as ``kernels.lns_matmul`` encodes them."""
    from repro_torch.core.lns import compute_scale, lns_encode, lns_pack
    a = torch.randn((M, K), generator=gen, device="cuda")
    b = torch.randn((K, N), generator=gen, device="cuda")
    sa, sb = compute_scale(a), compute_scale(b)
    pa = lns_pack(*lns_encode(a, fmt, sa), fmt)
    pb = lns_pack(*lns_encode(b, fmt, sb), fmt)
    return a, b, sa, sb, pa, pb


def k8_check(torch, ops, ref, fmt, gemms):
    """Phase 15: K8 against its plain version (int32 outputs equal) at
    the GEMM shapes, the LUT sweep and the saturating case; then the
    Table-10 sweep through the public ``kernels.lns_matmul``."""
    from repro_torch.core.energy import DATAPATH_FJ_PER_OP
    from repro_torch.kernels import lns_matmul
    gen = torch.Generator(device="cuda").manual_seed(8)
    rates = k8_rates(torch)
    print(f"K8 bound: {rates['sms']} SMs x {rates['max_sm_mhz']:.0f} MHz; "
          f"per product {K8_ALU_OPS_PER_PRODUCT} integer ops at "
          f"{ISSUE_LANES_PER_SM} lanes/SM/clock "
          f"({rates['int_ops_per_s']:.4g} op/s) and 1 shared-memory load "
          f"at {SMEM_LOADS_PER_SM}/SM/clock "
          f"({rates['smem_loads_per_s']:.4g} load/s), the same at every "
          f"LUT size")

    def bound(M, K, N):
        products = M * K * N
        slices = -(-K // 16)
        alu = (K8_ALU_OPS_PER_PRODUCT * products
               + K8_ALU_OPS_PER_WORD * (M * K + K * N)
               + K8_ALU_OPS_PER_SLICE * M * N * slices)
        t_b = (M * K + K * N + 4 * M * N) / HBM_BPS * 1e3
        t_o = max(alu / rates["int_ops_per_s"],
                  products / rates["smem_loads_per_s"]) * 1e3
        return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")

    def rel_err(out, a, b, sa, sb):
        val = out.float() * (sa * sb) / (1 << 16)
        exact = a @ b
        return float((val - exact).abs().max() / exact.abs().max())

    rows, sweep = [], []
    for M, K, N in gemms:
        a, b, sa, sb, pa, pb = k8_operands(torch, M, K, N, fmt, gen)
        fn = lambda: ops.lns_matmul_packed(pa, pb, fmt)
        out = fn()
        if M >= 2048:     # the plain version runs once at full size
            plain_ms, want = once_ms(torch, lambda: ref.lns_matmul_packed(
                pa, pb, fmt))
        else:
            want = ref.lns_matmul_packed(pa, pb, fmt)
            plain_ms = cuda_ms(torch, lambda: ref.lns_matmul_packed(
                pa, pb, fmt), iters=5, replays=3)
        diff = int((out != want).sum())
        check(diff == 0, f"K8 {M}x{K}x{N}: {diff} outputs differ from the "
              f"plain version")
        b_ms, by = bound(M, K, N)
        plan = ops.lns_matmul_plan(M, N, K)
        rows.append(dict(
            shape=[M, K, N], lut_entries=None, max_abs_err=0,
            rel_err_vs_f32=rel_err(out, a, b, sa, sb), plan=plan,
            ms=cuda_ms(torch, fn, iters=5 if M >= 2048 else 20, replays=3),
            eager_ms=eager_ms(torch, fn, iters=10), plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=by, library_ms=None))
        r = rows[-1]
        print(f"K8 lns_matmul_packed {M}x{K}x{N}: int32 outputs equal, "
              f"{plan['cfg']} tiles, grid {plan['grid_n']}x"
              f"{plan['grid_m']}x{plan['splits']} (splits of "
              f"{plan['slices']} slices), table copies {plan['repl']}; "
              f"kernel {r['ms']:.4f} ms (eager {r['eager_ms']:.4f} ms), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}; "
              f"kernel at {b_ms / r['ms']:.1%} of it)")
    M, K, N = 2048, 576, 1536
    a, b, sa, sb, pa, pb = k8_operands(torch, M, K, N, fmt, gen)
    for lut in (1, 2, 4, 8):
        fn = lambda: ops.lns_matmul_packed(pa, pb, fmt, lut_entries=lut)
        out = fn()
        want = ref.lns_matmul_packed(pa, pb, fmt, lut_entries=lut)
        diff = int((out != want).sum())
        check(diff == 0, f"K8 LUT {lut}: {diff} outputs differ from the "
              f"plain version")
        b_ms, by = bound(M, K, N)
        sweep.append(dict(
            shape=[M, K, N], lut_entries=lut, max_abs_err=0,
            ms=cuda_ms(torch, fn, iters=5, replays=3), bound_ms=b_ms,
            bound_by=by))
        print(f"K8 LUT {lut} {M}x{K}x{N}: int32 outputs equal, kernel "
              f"{sweep[-1]['ms']:.4f} ms, bound {b_ms:.4f} ms (kernel at "
              f"{b_ms / sweep[-1]['ms']:.1%} of it)")
    zeros_a = torch.zeros((128, 256), dtype=torch.uint8, device="cuda")
    zeros_b = torch.zeros((256, 128), dtype=torch.uint8, device="cuda")
    sat = ops.lns_matmul_packed(zeros_a, zeros_b, fmt)
    check(torch.equal(sat, ref.lns_matmul_packed(zeros_a, zeros_b, fmt))
          and bool((sat == ref.SAT24).all()),
          "K8 saturation: the collector did not clamp to 2^23 - 1")
    print("K8 saturation (all-zero words, K=256): every output "
          f"{ref.SAT24}, equal to the plain version")

    # the Table-10 kernel sweep through the public entry point
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    table10 = []
    for lut in (None, 1, 2, 4, 8):
        out = lns_matmul(a, b, fmt, lut_entries=lut)
        exact = a @ b
        fj = DATAPATH_FJ_PER_OP["lns8" if lut is None else f"lns8_lut{lut}"]
        table10.append(dict(lut_entries=lut, rel_err_vs_f32=float(
            (out - exact).abs().max() / exact.abs().max()), fj_per_op=fj))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts["lns_matmul_packed"] == 5,
          f"K8 launched {counts['lns_matmul_packed']} times for 5 "
          f"lns_matmul calls")
    for t in table10:
        print(f"Table 10, kernels.lns_matmul {M}x{K}x{N} LUT "
              f"{t['lut_entries'] or 'exact (8)'}: max error "
              f"{t['rel_err_vs_f32']:.4f} of max |f32 matmul|; paper's "
              f"calibrated model {t['fj_per_op']} fJ/op (not measured)")
    return rows, sweep, table10, counts, rates


def k1_sweep(torch, ops, ref, fmt):
    """``--k1-sweep``: K1 per tensor at the six phase-3 shapes (bf16) for
    each block size and minimum chunk (which set the grid; no one-block
    threshold), every call's scales and words held to the plain
    version."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    keep = ops._K1_THREADS, ops._K1_ONE_BLOCK, ops._K1_MIN_CHUNK
    ops._K1_ONE_BLOCK = 0
    rows = []
    try:
        for R, C in ((4, 576), (4, 1536), (32, 576), (32, 1536),
                     (2048, 576), (2048, 1536)):
            x = (torch.randn((R, C), generator=gen, device="cuda") * 3.0
                 ).to(torch.bfloat16)
            b, _ = bound_ms(R * C * 2 + R * 4 + R * C, 0, 1)
            for threads in (256, 512, 1024):
                for chunk in (2048, 4096, 8192, 16384):
                    ops._K1_THREADS, ops._K1_MIN_CHUNK = threads, chunk
                    k1_pair(torch, ops, ref, x, fmt, None,
                            f"sweep {R}x{C} {threads}/{chunk}")
                    rows.append(dict(shape=[R, C], threads=threads,
                                     min_chunk=chunk, bound_ms=b,
                                     ms=cuda_ms(torch, lambda: ops.encode_pack(
                                         x, fmt))))
            best = sorted((r for r in rows if r["shape"] == [R, C]),
                          key=lambda r: r["ms"])
            print(f"K1 sweep {R}x{C} (bound {b:.5f} ms): " + ", ".join(
                f"{r['threads']}/{r['min_chunk']} {r['ms']:.4f}"
                for r in best), flush=True)
    finally:
        ops._K1_THREADS, ops._K1_ONE_BLOCK, ops._K1_MIN_CHUNK = keep
    return rows


def k6_sweep(torch, ops, ref, fmt):
    """``--k6-sweep``: K6 at 4 x 49152 and 16 x 49152, greedy and seeded,
    for each cluster size (blocks a row) and block size, tokens held to
    the plain version at every setting."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    plan = ops.fused_sample_plan
    rows = []
    try:
        for B in (4, 16):
            lg, _, temp, seed, step = k6_inputs(torch, B, 49152, gen)
            for case in ("greedy", "seeded"):
                if case == "greedy":
                    kern = lambda: ops.fused_sample(lg, None, None)
                    want = ref.fused_sample(lg, None, None)
                else:
                    kern = lambda: ops.fused_sample_seeded(lg, temp, seed,
                                                           step)
                    want = ref.fused_sample_seeded(lg, temp, seed, step)
                for blocks in (1, 2, 4, 8, 16):
                    for threads in (128, 256, 512, 1024):
                        ops.fused_sample_plan = lambda B_, V_, b=blocks, \
                            t=threads: dict(blocks=b, threads=t)
                        check(torch.equal(kern(), want), f"K6 sweep {case} "
                              f"{B} rows {blocks}/{threads}: tokens differ")
                        rows.append(dict(shape=[B, 49152], case=case,
                                         blocks=blocks, threads=threads,
                                         ms=cuda_ms(torch, kern)))
                best = sorted((r for r in rows if r["shape"][0] == B
                               and r["case"] == case), key=lambda r: r["ms"])
                print(f"K6 sweep {case} {B}x49152: " + ", ".join(
                    f"{r['blocks']}/{r['threads']} {r['ms']:.4f}"
                    for r in best[:8]), flush=True)
    finally:
        ops.fused_sample_plan = plan
    return rows


@contextlib.contextmanager
def k8_forced(ops, cfg, splits, repl):
    """Route every K8 call through tile config ``cfg`` with ``splits``
    K splits (whole 16-column slices, none empty) and ``repl`` table
    copies, to time the options the plan did not pick."""
    keep = ops.lns_matmul_plan

    def plan(M, N, K, block_k=16):
        gm, gn = ops._k8_tiles(cfg, M, N)
        n = -(-K // block_k)
        per = -(-n // splits)
        return dict(cfg=cfg, repl=repl, grid_n=gn, grid_m=gm,
                    splits=-(-n // per), slices=per)

    ops.lns_matmul_plan = plan
    try:
        yield
    finally:
        ops.lns_matmul_plan = keep


def k8_sweep(torch, ops, ref, fmt):
    """``--k8-sweep``: K8 at the phase-15 GEMMs under each tile config,
    split count and number of table copies (1 or 32: bank conflicts
    against table size), every output held to the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    gemms = [(576, 576), (576, 192), (576, 1536), (1536, 576)]
    rows = []
    for M in (4, 2048):
        if M == 4:
            opts = [("skinny", s, r) for s in (1, 4, 8, 16, 36)
                    for r in (1, 32)] + [("mid", s, 32) for s in (8, 36)]
        else:
            opts = [("wide", 1, r) for r in (32, 1)]
            opts += [("mid", s, 32) for s in (1, 2, 3)] + [("mid", 1, 1)]
        for K, N in gemms:
            *_, pa, pb = k8_operands(torch, M, K, N, fmt, gen)
            want = ref.lns_matmul_packed(pa, pb, fmt)
            for cfg, splits, repl in opts:
                with k8_forced(ops, cfg, splits, repl):
                    out = ops.lns_matmul_packed(pa, pb, fmt)
                    check(torch.equal(out, want),
                          f"K8 sweep {M}x{K}x{N} {cfg}/{splits}/{repl}: "
                          f"outputs differ from the plain version")
                    ms = cuda_ms(torch, lambda: ops.lns_matmul_packed(
                        pa, pb, fmt), iters=5 if M > 4 else 20, replays=3)
                rows.append(dict(shape=[M, K, N], cfg=cfg, splits=splits,
                                 repl=repl, ms=ms))
            best = sorted((r for r in rows if r["shape"] == [M, K, N]),
                          key=lambda r: r["ms"])
            print(f"K8 sweep {M}x{K}x{N} (plan "
                  f"{ops.lns_matmul_plan(M, N, K)}): " + ", ".join(
                      f"{r['cfg']}/{r['splits']}/{r['repl']} "
                      f"{r['ms']:.4f}" for r in best), flush=True)
    return rows


def k9_inputs(torch, R, C, bits, gdt, cdt, gen):
    """A leaf kept as (code, sign) with codes of dtype ``cdt``."""
    max_code = (1 << (bits - 1)) - 1
    code = torch.randint(0, max_code + 1, (R, C), generator=gen,
                         device="cuda", dtype=torch.int32).to(cdt)
    sign = (1 - 2 * torch.randint(0, 2, (R, C), generator=gen,
                                  device="cuda")).to(torch.int8)
    _, g, v = madam_inputs(torch, R, C, bits, gdt, gen)
    return code, sign, g, v


def k9_check(torch, ops, ref, cases):
    """Phase 16: K9 against its plain version (codes equal outside the
    tie band, v' bit-equal), then once per case through
    ``dispatch.madam_step_unpacked``, one launch each."""
    from repro_torch.core.lns import LNSFormat
    from repro_torch.kernels import dispatch
    gen = torch.Generator(device="cuda").manual_seed(9)
    kw = dict(lr=2.0 ** -7, beta=0.999, eps=1e-30)
    count = 7
    bc = ref.bias_correction(0.999, count)
    rows, inputs = [], []
    for R, C, bits, gamma, gdt, cdt in cases:
        fmt = LNSFormat(bits, gamma)
        code, sign, g, v = k9_inputs(torch, R, C, bits, gdt, cdt, gen)
        inputs.append((code, sign, g, v, fmt))
        fn = lambda: ops.madam_step_unpacked(code, sign, g, v, bc, fmt, **kw)
        pfn = lambda: ref.madam_step_unpacked(code, sign, g, v, bc, fmt,
                                              **kw)
        kc, kv = fn()
        pc, pv = pfn()
        _, _, target = ref.step_math(code, sign, g, v, bc, gamma=fmt.gamma,
                                     max_code=fmt.max_code, **kw)
        torch.cuda.synchronize()
        check(kc.dtype == code.dtype, f"K9 {R}x{C}: code dtype {kc.dtype}")
        check(torch.equal(kv.view(torch.int32), pv.view(torch.int32)),
              f"K9 {R}x{C} B={bits}: v' differs from the plain version")
        frac = target - torch.floor(target)
        ulp = torch.abs(torch.nextafter(target, target + 1) - target)
        near = (frac - 0.5).abs() <= MADAM_TIE_ULPS * ulp
        diff = kc.to(torch.int32) != pc.to(torch.int32)
        bad = int((diff & ~near).sum())
        check(bad == 0, f"K9 {R}x{C} B={bits}: {bad} codes differ away "
              f"from a tie")
        n = R * C
        c_b = code.element_size()
        nbytes = n * (2 * c_b + 1 + g.element_size() + 2 * 4)
        b_ms, by = bound_ms(nbytes, 15 * n, F32_FLOPS)
        rows.append(dict(
            shape=[R, C], bits=bits, code_dtype=str(code.dtype)[6:],
            g_dtype=str(gdt)[6:], tie_codes=int(diff.sum()),
            near_tie=int(near.sum()),
            max_abs_err=int((kc.to(torch.int32) - pc.to(torch.int32)).abs()
                            .max()),
            ms=cuda_ms(torch, fn, iters=10, replays=5),
            eager_ms=eager_ms(torch, fn, iters=20),
            plain_ms=cuda_ms(torch, pfn, iters=2, replays=3),
            bound_ms=b_ms, bound_by=by, library_ms=None))
        r = rows[-1]
        print(f"K9 madam_step_unpacked {R}x{C} B={bits} code "
              f"{r['code_dtype']} g {r['g_dtype']}: v' equal, codes "
              f"differing at ties {r['tie_codes']} (near-tie "
              f"{r['near_tie']}), kernel {r['ms']:.4f} ms (eager "
              f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"bound {b_ms:.4f} ms")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for i, (code, sign, g, v, fmt) in enumerate(inputs):
        dispatch.madam_step_unpacked(code, sign, g, v, count, fmt,
                                     lr=kw["lr"])
        check(ops.launch_counts()["madam_step_unpacked"] == i + 1,
              "K9 did not launch exactly once per call")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    return rows, counts


@contextlib.contextmanager
def exact_fake_quant(quant_training, acc):
    """Replace the approximate GEMM by the exact fake-quantized one on the
    same decoded operands, accumulated in ``acc`` (f32, or f64 for the
    floor), for phase 17's comparison only."""
    saved = quant_training.approx_qeinsum

    def fn(eq, x, w, cfg):
        import torch
        _, xq, wq = quant_training.approx_value(eq, x, w, cfg)
        return torch.einsum(eq, xq.to(acc), wq.to(acc)).to(x.dtype)

    quant_training.approx_qeinsum = fn
    try:
        yield
    finally:
        quant_training.approx_qeinsum = saved


def approx_train(torch, ops, setup):
    """Phase 17: approximation-aware training steps at full width."""
    from repro_torch.core import quant_training
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.models.model import lm_loss
    from repro_torch.training.steps import build_train_step
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 is on: the approximate GEMMs must run in full f32")
    cfg, _, mcfg, state, batch = setup
    runs = {}

    def one_step(name, qcfg, st):
        step = build_train_step(cfg, qcfg, mcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        new, m = step(st, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(math.isfinite(loss), f"{name}: non-finite loss {loss}")
        check(counts["madam_step"] == 8,
              f"{name}: K3 launched {counts['madam_step']} times, not 8")
        if qcfg.approx_lut is None:
            check(counts["encode_pack"] > 0 and counts["qmatmul"] > 0,
                  f"{name}: K1/K2 not launched: {counts}")
        else:
            check(counts["encode_pack"] == 0 and counts["qmatmul"] == 0,
                  f"{name}: the approximation launched K1/K2: {counts}")
        r = dict(loss=loss, grad_norm=float(m["grad_norm"]),
                 step_s=wall, peak_gib=peak, launches=counts)
        print(f"approx train {name}: loss {loss:.5f}, grad norm "
              f"{r['grad_norm']:.4f}, step {wall * 1e3:.1f} ms, peak "
              f"{peak:.2f} GiB, K3 {counts['madam_step']}, K1 "
              f"{counts['encode_pack']}, K2 {counts['qmatmul']}")
        return new, r

    for name, lut in (("exact", None), ("lut8", 8), ("lut1", 1)):
        new, runs[name] = one_step(name, QuantConfig.lns_madam(
            approx_lut=lut), state)
    st, extra = new, []
    for i in range(APPROX_EXTRA_STEPS):
        st, r = one_step(f"lut1 step {i + 2}", QuantConfig.lns_madam(
            approx_lut=1), st)
        extra.append(r)
    runs["lut1_more"] = extra

    # where a LUT-1 step's time goes (as phase 10 profiles the K-path step)
    from torch.profiler import ProfilerActivity, profile
    step = build_train_step(cfg, QuantConfig.lns_madam(approx_lut=1), mcfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        float(step(st, batch)[1]["loss"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy_us, top = device_time(torch, prof, 6)
    share = busy_us / 1e6 / wall if busy_us else None
    print(f"profile, 1 LUT-1 step: wall {wall * 1e3:.1f} ms, device busy "
          + (f"{busy_us / 1e3:.1f} ms ({share:.1%})" if busy_us
             else "not measured (no device time in the trace)"))
    for e in top:
        print(f"  {e.key[:60]}: {e.self_device_time_total / 1e3:.3f} ms, "
              f"{e.count} calls")
    runs["lut1_profile"] = {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3 if busy_us else None,
        "device_busy_share": share,
        "top": [[e.key, e.self_device_time_total / 1e3, e.count]
                for e in top]}

    q8 = QuantConfig.lns_madam(approx_lut=8)
    with torch.no_grad():
        fwd = {lut: float(lm_loss(state.params, batch, cfg,
                                  QuantConfig.lns_madam(approx_lut=lut)))
               for lut in (8, 4, 2, 1)}
        with exact_fake_quant(quant_training, torch.float32):
            exact = float(lm_loss(state.params, batch, cfg, q8))
        with exact_fake_quant(quant_training, torch.float64):
            floor = float(lm_loss(state.params, batch, cfg, q8))
    rels = {lut: abs(v - exact) / exact for lut, v in fwd.items()}
    rel, rel_floor = rels[8], abs(floor - exact) / exact
    print(f"approx train: forward loss vs the exact fake-quant forward "
          f"{exact:.6f}: " + ", ".join(
              f"LUT {lut} {fwd[lut]:.6f} (rel {rels[lut]:.2e})"
              for lut in fwd)
          + f"; limit {APPROX_LOSS_RTOL} (LUT 8 within, the controls LUT "
          f"4/2/1 outside); floor, f64 accumulation, {rel_floor:.2e}; LUT-1 "
          "losses " + " ".join(f"{r['loss']:.4f}"
                               for r in [runs["lut1"]] + extra)
          + f"; LUT-1 step {sum(r['step_s'] for r in extra) / len(extra):.3f}"
          f" s over the last {len(extra)}")
    check(rel <= APPROX_LOSS_RTOL,
          f"LUT-8 loss differs from the exact fake-quant loss by {rel}")
    for lut in (4, 2, 1):
        check(rels[lut] > APPROX_LOSS_RTOL,
              f"control: the LUT-{lut} loss is within {APPROX_LOSS_RTOL} of "
              f"the exact fake-quant loss ({rels[lut]}), so the check cannot "
              f"tell LUT {lut} from the exact conversion")
    return dict(runs=runs, forward_loss={str(k): v for k, v in fwd.items()},
                forward_rel={str(k): v for k, v in rels.items()},
                exact_fq_loss=exact, floor_loss=floor, lut8_rel=rel,
                floor_rel=rel_floor)


def profile_line(tag, p):
    busy = ("not measured (no device time in the trace)"
            if p["device_busy_ms"] is None else
            f"{p['device_busy_ms']:.1f} ms ({p['device_busy_share']:.1%})")
    ls = p["launches"]
    return (f"{tag}: {p['step_ms']:.1f} ms a step unprofiled, profiled "
            f"wall {p['wall_ms']:.1f} ms, device busy {busy}; "
            f"{ls['port']:.0f} port kernels, {ls['torch']:.0f} torch "
            f"kernels, {ls['copies']:.0f} copies a step; top "
            + ", ".join(f"{k[:40]} {ms:.2f} ms ({n})"
                        for k, ms, n in p["top"][:4]))


def fp_check(torch):
    """Phase 18a: ``fp_quantize`` on the card at e4m3 and e5m10, per
    tensor and per row, in bf16 and f32: two calls bit-identical, the
    normalized values equal to the ``float8_e4m3fn``/``float16`` round
    trip bit for bit (the oracle), the result held against the same call
    on the CPU (differences printed), timed, its device kernels counted."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.numerics.fp import FPFormat, fp_quantize, fp_round
    gen = torch.Generator(device="cuda").manual_seed(18)
    base = torch.randn(FP_SHAPE, generator=gen, device="cuda") * torch.exp2(
        2.0 * torch.randn(FP_SHAPE, generator=gen, device="cuda"))
    tiny = torch.finfo(torch.float32).tiny
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for bits, cast in {(4, 3): torch.float8_e4m3fn,
                       (5, 10): torch.float16}.items():
        fmt = FPFormat(*bits)
        for axis in (None, -1):
            for dt in (torch.bfloat16, torch.float32):
                x = base.to(dt)
                got = fp_quantize(x, fmt, axis)
                tag = (f"fp_quantize e{bits[0]}m{bits[1]} "
                       f"{'per row' if axis is not None else 'per tensor'} "
                       f"{str(dt)[6:]} {FP_SHAPE[0]}x{FP_SHAPE[1]}")
                check(got.dtype == dt and torch.isfinite(got).all(),
                      f"{tag}: not finite or not {dt}")
                check(torch.equal(got, fp_quantize(x, fmt, axis)),
                      f"{tag}: two calls differ")
                xf = x.to(torch.float32)
                amax = (xf.abs().amax() if axis is None
                        else xf.abs().amax(dim=0, keepdim=True))
                v = xf / (torch.clamp_min(amax, tiny) / fmt.max_value)
                oracle = int((fp_round(v, fmt).view(torch.int32)
                              != v.to(cast).to(torch.float32).view(
                                  torch.int32)).sum())
                check(oracle == 0, f"{tag}: {oracle} normalized values "
                      f"differ from the {cast} round trip")
                cpu = fp_quantize(x.cpu(), fmt, axis).to(torch.float32)
                diff = got.cpu().to(torch.float32) - cpu
                n_diff = int((diff != 0).sum())
                # profiled after a synchronize and before this step's
                # graph captures, as k1_one_launch does; a trace with no
                # device event reads "not measured"
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    fp_quantize(x, fmt, axis)
                    torch.cuda.synchronize()
                rows.append(dict(
                    case=tag, cpu_diffs=n_diff,
                    cpu_max_abs_diff=float(diff.abs().max()),
                    oracle_diffs=oracle, device_kernels=sum(
                        e.device_type == cuda for e in prof.events()) or None,
                    call=(x, fmt, axis)))
    for r in rows:
        x, fmt, axis = r.pop("call")
        r["ms"] = cuda_ms(torch, lambda: fp_quantize(x, fmt, axis))
        print(f"{r['case']}: oracle equal, vs CPU {r['cpu_diffs']} elements "
              f"differ (max {r['cpu_max_abs_diff']:.3e}), {r['ms']:.4f} ms "
              f"a call, {r['device_kernels'] or 'not measured'} device "
              f"kernels a call")
    return rows


def fp8_train(torch, ops, lns8_profile):
    """Phase 18b: ``launch.train --format fp8`` at full width through
    ``main()`` (K3 once per packed leaf a step, K1/K2 never, no retry,
    finite losses), then one fp8 step profiled beside phase 10's lns8
    step."""
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.launch.train import main as train_main
    from repro_torch.training.steps import build_train_step
    with tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = train_main(FP8_TRAIN_ARGV + ["--ckpt-dir", ckpt])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    steps = out["steps"]
    check(steps == FP8_STEPS, f"fp8 training took {steps} steps")
    check(out["failures_recovered"] == 0,
          f"fp8 training recovered from {out['failures_recovered']} failures")
    check(all(math.isfinite(x) for x in out["losses"]),
          f"non-finite fp8 training loss: {out['losses']}")
    check(counts["madam_step"] == 8 * steps,
          f"fp8: K3 launched {counts['madam_step']} times, not 8 a step")
    check(counts["encode_pack"] == counts["qmatmul"]
          == counts["qmatmul_decode"] == 0,
          f"fp8: a GEMM routed through K1/K2: {counts}")
    cfg, _, mcfg, state, batch = train_setup(torch)
    prof, _ = step_profile(torch, build_train_step(cfg, QuantConfig.fp8(),
                                                   mcfg), state, batch)
    del state
    print(f"fp8 train: {steps} steps x {batch['tokens'].numel()} tokens, "
          f"{out['tokens_per_s']:.0f} tok/s, loss "
          + " ".join(f"{x:.4f}" for x in out["losses"])
          + f", launches {counts}")
    print("  " + profile_line("fp8 step", prof))
    extra = prof["launches"]["torch"] - lns8_profile["launches"]["torch"]
    print("  " + profile_line("lns8 step (phase 10)", lns8_profile))
    print(f"  fp8 adds {extra:.0f} torch kernels a step to lns8's")
    return dict(out, launches=counts, profile=prof)


def bert_train(torch, ops, ref, fmt):
    """Phase 18c: BERT-base at full width (untied head, ungated GELU,
    bf16), 2 lns8 and 2 fp8 train steps through ``build_train_step``: K3
    once per packed leaf a step, K1/K2 on lns8 only; every K2 shape the
    lns8 steps ran held against the plain version and timed beside
    ``torch.matmul``; one step of each profiled."""
    from repro_torch.configs.paper_models import BERT_BASE
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.steps import (batch_to_device,
                                            build_train_step,
                                            init_train_state)
    from repro_torch.tree import leaves
    cfg, mcfg = BERT_BASE, MadamConfig()
    state = init_train_state(cfg, mcfg, seed=0, device="cuda")
    n_packed = sum(hasattr(p, "packed") for _, p in leaves(state.params))
    data = SyntheticLM(cfg, batch=BERT_BATCH, seq=BERT_SEQ)
    batches = [batch_to_device(data.batch_at(i), "cuda") for i in range(2)]
    res = {"packed_leaves": n_packed}
    with k2_shapes_seen(torch, ops) as seen:
        for name, qcfg in (("lns8", QuantConfig.lns_madam()),
                           ("fp8", QuantConfig.fp8())):
            step = build_train_step(cfg, qcfg, mcfg)
            st, losses = state, []
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.monotonic()
            for b in batches:
                st, m = step(st, b)
                losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            wall = (time.monotonic() - t0) / len(batches)
            counts = ops.launch_counts()
            check(all(math.isfinite(x) for x in losses),
                  f"BERT-base {name}: non-finite loss {losses}")
            check(counts["madam_step"] == n_packed * len(batches),
                  f"BERT-base {name}: K3 launched {counts['madam_step']} "
                  f"times for {n_packed} packed leaves a step")
            if name == "lns8":
                check(counts["encode_pack"] > 0 and counts["qmatmul"] > 0,
                      f"BERT-base lns8: K1/K2 not launched: {counts}")
            else:
                check(counts["encode_pack"] == counts["qmatmul"] == 0,
                      f"BERT-base fp8: a GEMM routed: {counts}")
            prof, _ = step_profile(torch, step, st, batches[0])
            res[name] = dict(losses=losses, step_s=wall, launches=counts,
                             profile=prof)
            print(f"BERT-base {name}: 2 steps x {BERT_BATCH}x{BERT_SEQ} "
                  f"tokens, {wall * 1e3:.1f} ms a step, loss "
                  + " ".join(f"{x:.4f}" for x in losses)
                  + f", K1 {counts['encode_pack']} K2 {counts['qmatmul']} "
                  f"K3 {counts['madam_step']}")
            print("  " + profile_line(f"BERT-base {name} step", prof))
            del st
    torch.cuda.empty_cache()
    res["k2_driven"] = k2_driven_check(torch, ops, ref, fmt, seen)
    shapes = sorted({(M, K, N) for M, K, N, _, _ in seen})
    res["k2"] = k2_check(torch, ops, ref, fmt, [
        (M, K, N, {"out": torch.bfloat16, "brief": True})
        for M, K, N in shapes])
    del state
    torch.cuda.empty_cache()
    return res


def fig7(torch, ops):
    """Phase 18d: Fig. 7's optimizers on smollm-135m at full width with
    dense f32 weights (``init_params``) on the fake-quant leg under
    ``QuantConfig.lns_madam()``: sgd_q and adamw_q at Q_U 16 and 10 bits,
    and ``madam_fp``, 3 steps each. Finite losses, no kernel launched,
    every updated leaf of rank >= 2 a fixed point of Q_log at Q_U."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.lns import LNSFormat, lns_quantize
    from repro_torch.core.quantizer import QuantConfig, quantize_grads
    from repro_torch.models.model import init_params, lm_loss
    from repro_torch.optim import adamw, madam_fp, quantized_update, sgd
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.steps import batch_to_device
    from repro_torch.tree import leaves, tree_map
    cfg = dataclasses.replace(get_config("smollm-135m"), dtype="float32")
    qcfg = QuantConfig.lns_madam()
    data = SyntheticLM(cfg, batch=8, seq=256)
    batches = [batch_to_device(data.batch_at(i), "cuda")
               for i in range(FIG7_STEPS)]
    arms = []
    for bits in (16, 10):
        fmt = LNSFormat(8, 8).with_bits(bits)
        arms += [(f"sgd_q_u{bits}", quantized_update(
                     sgd(lr=0.3, weight_decay=0.0), fmt), fmt),
                 (f"adamw_q_u{bits}", quantized_update(adamw(lr=3e-3), fmt),
                  fmt)]
    arms.append(("madam_fp", madam_fp(), None))
    res = {}
    for name, (init, update), fmt in arms:
        params = init_params(cfg, seed=0, device="cuda")
        st = init(params)
        losses, times = [], []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for b in batches:
            t0 = time.monotonic()
            proxies = tree_map(lambda p: p.detach().requires_grad_(True),
                               params)
            loss = lm_loss(proxies, b, cfg, qcfg)
            loss.backward()
            grads = quantize_grads(tree_map(lambda p: p.grad, proxies), qcfg)
            params, st = update(grads, st, params)
            losses.append(float(loss.detach()))
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        counts = ops.launch_counts()
        check(all(math.isfinite(x) for x in losses),
              f"Fig. 7 {name}: non-finite loss {losses}")
        check(not any(counts.values()),
              f"Fig. 7 {name}: a kernel launched on the dense path: {counts}")
        off = []
        if fmt is not None:
            off = [".".join(path) for path, p in leaves(params)
                   if p.dim() >= 2 and not torch.equal(
                       lns_quantize(p, fmt, scale_axis=-1), p)]
            check(not off, f"Fig. 7 {name}: leaves off the Q_U grid: {off}")
        res[name] = dict(losses=losses, step_ms=[t * 1e3 for t in times])
        print(f"Fig. 7 {name}: loss " + " ".join(f"{x:.4f}" for x in losses)
              + f", {sum(times[1:]) / len(times[1:]) * 1e3:.1f} ms a step "
              f"(after the first), 0 kernel launches"
              + ("" if fmt is None else
                 f", every >=2-D leaf on the B={fmt.bits} grid"))
        del params, st
    torch.cuda.empty_cache()
    return res


def fig4(torch):
    """Phase 18e: Fig. 4's measurement at d = 2^20 on the card and on the
    CPU from the same uniforms (``benchmarks/quant_error.py``'s
    distributions): r_t within ``FIG4_RTOL``, MUL and signMUL below GD;
    Madam's r_t printed beside GD's and the closed form d/(6γ²)."""
    from repro_torch.core import error_analysis as ea
    gen = torch.Generator(device="cuda").manual_seed(4)
    d = FIG4_D
    w = torch.exp2(2.0 * torch.randn(d, generator=gen, device="cuda"))
    g = 0.003 * torch.randn(d, generator=gen, device="cuda")
    g2 = torch.full((d,), 0.003 ** 2, device="cuda")
    u = [torch.rand(d, generator=gen, device="cuda") for _ in ea.RULES]
    card = {k: float(v) for k, v in ea.measure_all(
        None, w, g, FIG4_ETA, FIG4_GAMMA, g2, u=u).items()}
    cpu = {k: float(v) for k, v in ea.measure_all(
        None, w.cpu(), g.cpu(), FIG4_ETA, FIG4_GAMMA, g2.cpu(),
        u=[x.cpu() for x in u]).items()}
    noise = d * 2.0 ** -18 / FIG4_GAMMA
    for k in ea.RULES:
        ok = (max(card[k], cpu[k]) <= noise if k == "signmul" else
              abs(card[k] - cpu[k]) <= FIG4_RTOL * abs(cpu[k]))
        check(ok, f"Fig. 4 {k}: r_t {card[k]} on the card, {cpu[k]} on "
              f"the CPU")
    check(card["mul"] < card["gd"] and card["signmul"] < card["gd"],
          f"Fig. 4: a multiplicative rule is not below GD: {card}")
    ms = cuda_ms(torch, lambda: ea.measure_all(None, w, g, FIG4_ETA,
                                               FIG4_GAMMA, g2, u=u))
    closed = d / (6 * FIG4_GAMMA ** 2)
    print(f"Fig. 4 at d={d}, eta={FIG4_ETA}, gamma={FIG4_GAMMA:.0f}: r_t "
          f"on the card "
          + ", ".join(f"{k} {card[k]:.4e}" for k in ea.RULES)
          + f" (CPU " + ", ".join(f"{cpu[k]:.4e}" for k in ea.RULES)
          + f"; rtol {FIG4_RTOL}, signMUL under the noise floor "
          f"{noise:.2e}); MUL and signMUL below GD; Madam "
          f"{card['madam'] / card['gd']:.2f}x GD (d/(6 gamma^2) = "
          f"{closed:.4e}: g* = g/sqrt(g2) moves every exponent by about "
          f"gamma*eta*|g*| = 16 codes, SR's largest variance); "
          f"{ms:.3f} ms a measurement")
    return dict(card=card, cpu=cpu, ms=ms, madam_closed_form=closed,
                signmul_noise_floor=noise)


def baselines(torch, ops, ref, fmt, lns8_profile):
    """Phase 18: the paper's baselines at full width. Each step prints one
    JSON line of its main numbers and its seconds (the full results go to
    the JSON file)."""
    def run(step, fn, summary):
        t = time.monotonic()
        res = fn()
        print(json.dumps({"phase18": step, "s": time.monotonic() - t,
                          "result": summary(res)}))
        return res

    t0 = time.monotonic()
    out = {
        "fp": run("fp_quantize", lambda: fp_check(torch), lambda r: [
            [x["case"], x["cpu_diffs"], x["ms"], x["device_kernels"]]
            for x in r]),
        "fp8_train": run(
            "fp8_train", lambda: fp8_train(torch, ops, lns8_profile),
            lambda r: {"losses": r["losses"], "launches": r["launches"],
                       **step_summary(r["profile"])}),
        "bert": run("bert_base", lambda: bert_train(torch, ops, ref, fmt),
                    lambda r: {**{q: {"losses": r[q]["losses"],
                                      "launches": r[q]["launches"],
                                      **step_summary(r[q]["profile"])}
                                  for q in ("lns8", "fp8")},
                               "k2": [[x["shape"], x["path"], x["ms"],
                                       x["library_ms"], x["bound_ms"],
                                       x["max_abs_err"]] for x in r["k2"]]}),
        "fig7": run("fig7", lambda: fig7(torch, ops), lambda r: r),
        "fig4": run("fig4", lambda: fig4(torch), lambda r: r),
    }
    out["seconds"] = time.monotonic() - t0
    print(f"phase 18 took {out['seconds']:.1f}s")
    return out


def step_summary(p):
    return {"step_ms": p["step_ms"], "device_busy_ms": p["device_busy_ms"],
            "device_busy_share": p["device_busy_share"],
            "torch_kernels": p["launches"]["torch"],
            "copies": p["launches"]["copies"]}


# ---------------------------------------------------------------------------
# phase 19: online serving (the prefix cache, the gateway, an untied head)


def prefix_requests(cfg):
    """19a's trace: one shared PREFIX_LEN-token prefix (4 full pages of
    16), then a distinct suffix of 16-32 tokens a request, PREFIX_GEN new
    tokens each, greedy, all arriving at once."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(19)
    head = rng.integers(0, cfg.vocab_size, (PREFIX_LEN,)).tolist()
    return [Request(rid=i, prompt=head + rng.integers(
        0, cfg.vocab_size, (int(rng.integers(16, 33)),)).tolist(),
        max_new_tokens=PREFIX_GEN) for i in range(PREFIX_REQS)]


@contextlib.contextmanager
def prefill_events(torch, engine):
    """CUDA events around every paged prefill of ``engine``: the stream
    time of each admission's prefill (the host's launch gaps included),
    its suffix bucket, ``n_cached``, the other arguments and the logits,
    in admission order."""
    rows = []
    real = engine._prefill_paged

    def timed(tokens, n_new, n_cached, *args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(tokens, n_new, n_cached, *args)
        b.record()
        rows.append((a, b, tokens.shape[1], n_cached, args, out))
        return out

    engine._prefill_paged = timed
    try:
        yield rows
    finally:
        del engine._prefill_paged


def first_divergence(torch, engine, prompt, a, b):
    """Where greedy streams ``a`` and ``b`` of one prompt part: the token
    index, and the top-2 logit margin and max |logit| there from one
    uncached forward of the prompt and the shared tokens."""
    from repro_torch.models.model import forward
    j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    seq = torch.tensor([list(prompt) + list(a[:j])], dtype=torch.int32,
                       device="cuda")
    lg = forward(engine.params, seq, engine.cfg, engine.qcfg)[0, -1].float()
    top2 = torch.topk(lg, 2).values
    return j, float(top2[0] - top2[1]), float(lg.abs().max())


K1_CALLS = ("wq", "wk", "wv", "wo", "up", "gate", "down")


@contextlib.contextmanager
def dispatch_scales(dispatch):
    """Record the per-tensor scale of every ``dispatch.encode_pack`` call
    (K1 or its plain version, whichever dispatch holds)."""
    seen = []
    launch = dispatch.encode_pack

    def record(x, fmt, *args, **kw):
        packed, scale = launch(x, fmt, *args, **kw)
        seen.append(float(scale.reshape(-1)[0]))
        return packed, scale

    dispatch.encode_pack = record
    try:
        yield seen
    finally:
        dispatch.encode_pack = launch


def scale_coupling(torch, engine, reqs):
    """Why a prefix hit's stream may leave the uncached one (H7 at
    prefill): uncached prefills of request 0 (whose pages the hits reuse)
    and of request 1, one at a time, through the kernels and through the
    plain versions with f64 GEMMs (no summation order left to differ).
    Q_A's per-tensor scale spans every row of the prefill, the request's
    own suffix and padding included, so the prefix rows of the two see
    different scales where the suffixes' absmax crosses a power of two;
    codes then shift by exactly gamma, except those at the flush-to-zero
    rail, and 30 layers amplify the few that move. Returns, by mode, the
    K1 calls whose scales differ (layer, GEMM input, both scales) and the
    share of the prefix's K and V, by layer, equal bit for bit."""
    from repro_torch.kernels import dispatch, ref
    from repro_torch.serving import Request
    out = {}
    for mode in ("kernels", "plain_f64"):
        runs = []
        for r in reqs[:2]:
            kv = {}
            real = engine._prefill_paged

            def grab(tokens, n_new, n_cached, n_total, slot, table, *a):
                lg = real(tokens, n_new, n_cached, n_total, slot, table, *a)
                big = engine.caches["period"]["pos0"]
                pages = torch.as_tensor(table[:PREFIX_LEN // 16]).long()
                kv["kv"] = [big[k][:, pages].clone() for k in ("kp", "vp")]
                return lg

            engine._prefill_paged = grab
            engine.reset()
            with contextlib.ExitStack() as stack:
                if mode == "plain_f64":
                    stack.enter_context(plain_versions(dispatch, ref))
                    dispatch.qmatmul = qmatmul_f64
                seen = stack.enter_context(dispatch_scales(dispatch))
                engine.run([Request(rid=r.rid, prompt=list(r.prompt),
                                    max_new_tokens=1)])
            del engine._prefill_paged
            runs.append((seen, kv["kv"]))
        (s0, kv0), (s1, kv1) = runs
        diff = [(i // len(K1_CALLS), K1_CALLS[i % len(K1_CALLS)], s0[i],
                 s1[i]) for i in range(min(len(s0), len(s1)))
                if s0[i] != s1[i]]
        equal = [[float((a[l] == b[l]).float().mean())
                  for l in range(a.shape[0])] for a, b in zip(kv0, kv1)]
        out[mode] = {"scales_differing": diff, "k_equal_by_layer": equal[0],
                     "v_equal_by_layer": equal[1]}
    engine.reset()
    return out


def prefix_serve(torch, ops, ref, fmt):
    """Phase 19a: smollm-135m at full width, page 16, 4 slots, greedy:
    the shared-prefix trace with the prefix cache on and off (the same
    submissions, so the same batch composition), then one request whose
    prompt is the shared prefix alone (a copy-on-write boundary page);
    K5 at the suffix prefill's shapes."""
    from repro_torch.launch.serve import build_engine, parser
    from repro_torch.serving import Engine, Request
    args = parser().parse_args(["--arch", "smollm-135m", "--slots", "4",
                                "--page-size", "16", "--max-len",
                                str(PREFIX_LEN + 32 + PREFIX_GEN)])
    on = build_engine(args)
    off = Engine(on.cfg, on.qcfg, on.params, num_slots=4,
                 max_len=on.max_len, page_size=16, prefix_cache=False,
                 device="cuda")
    res, out, first_logits = {}, {}, {}
    for name, eng in (("cache_off", off), ("cache_on", on)):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with prefill_events(torch, eng) as ev, k5_query_rows(ops) as k5_rows:
            agg = eng.run(prefix_requests(eng.cfg))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(agg["completed"] == PREFIX_REQS,
              f"19a {name}: completed {int(agg['completed'])}/8")
        check(all(counts[k] > 0 for k in ("encode_pack", "qmatmul",
                                          "paged_attend", "fused_sample")),
              f"19a {name}: a kernel of the path did not launch: {counts}")
        check(eng.allocator.in_use == 0 and
              eng.allocator.available == eng.num_pages,
              f"19a {name}: pages leaked ({eng.allocator.in_use} in use)")
        pre = [dict(ms=a.elapsed_time(b), bucket=bk, n_cached=nc)
               for a, b, bk, nc, _, _ in ev]
        first_logits[name] = [lg[0].float() for *_, lg in ev]
        out[name] = streams(eng)
        res[name] = dict(agg=agg, launches=counts, prefills=pre,
                         k5_by_query_rows=dict(k5_rows),
                         prefix_hits=eng.prefix_hits,
                         prefix_reused_tokens=eng.prefix_reused_tokens,
                         prefill_tokens=eng.prefill_tokens,
                         decode_steps=eng.decode_steps,
                         cached_pages=eng.allocator.cached)
        print(f"19a {name}: completed 8/8, {agg['tokens_per_s']:.2f} tok/s, "
              f"ttft mean {agg['ttft_mean_s'] * 1e3:.1f} ms, prefix hits "
              f"{eng.prefix_hits}, reused {eng.prefix_reused_tokens} "
              f"tokens, prefilled {eng.prefill_tokens} (buckets), decode "
              f"steps {eng.decode_steps}, launches {counts}")
    reqs = prefix_requests(on.cfg)
    # exact stream equality cannot hold at full width: a hit reuses the
    # prefix KV that request 0's prefill computed under Q_A scales that
    # span request 0's suffix, where its own prefill would span its own
    # (H7, measured below by scale_coupling); the random-weight model's
    # greedy choices sit at top-2 margins of a few bf16 ulps. So the
    # streams are held by phase 5's rule: every admission's prefill
    # logits within LOGIT_RTOL of the uncached ones, and a stream may
    # leave the uncached one only where the top-2 margin lies within
    # LOGIT_RTOL of max |logit|
    gaps = []
    for lon, loff in zip(first_logits["cache_on"],
                         first_logits["cache_off"]):
        gaps.append(float((lon - loff).abs().max() / loff.abs().max()))
    res["prefill_logits_rel_err"] = gaps
    check(max(gaps) <= LOGIT_RTOL,
          f"19a: a prefix hit's prefill logits are {max(gaps):.4f} of max "
          f"|logit| from the uncached ones (limit {LOGIT_RTOL})")
    diverged = {}
    for r in reqs:
        a, b = out["cache_on"][r.rid], out["cache_off"][r.rid]
        if a != b:
            diverged[r.rid] = first_divergence(torch, off, r.prompt, a, b)
    res["diverged"] = {rid: dict(token=j, top2_margin=m, max_logit=t)
                       for rid, (j, m, t) in diverged.items()}
    coupling = res["scale_coupling"] = scale_coupling(torch, off, reqs)
    same = PREFIX_REQS - len(diverged)
    print(f"19a streams: {same}/8 equal with and without the cache; "
          f"prefill logits of each admission within "
          f"{max(gaps):.4f} of max |logit| (limit {LOGIT_RTOL})")
    for rid, (j, m, t) in sorted(diverged.items()):
        print(f"19a request {rid}: the cached stream leaves the uncached "
              f"one at token {j}, top-2 logit margin there {m:.4g} "
              f"({m / t:.4f} of max |logit|)")
        check(m <= LOGIT_RTOL * t,
              f"19a request {rid}: streams part at token {j} where the "
              f"top-2 margin {m:.4g} exceeds {LOGIT_RTOL} of max |logit|")
    for mode, cp in coupling.items():
        d = cp["scales_differing"]
        print(f"19a cause (H7 at prefill, {mode}): requests 0 and 1 "
              f"prefilled alone differ in {len(d)} of K1's per-tensor "
              f"scales"
              + (f", first at layer {d[0][0]}'s {d[0][1]} input ({d[0][2]} "
                 f"vs {d[0][3]})" if d else "")
              + f"; their shared prefix's K equal bit for bit in "
              f"{cp['k_equal_by_layer'][0]:.4f} of layer 0, "
              f"{cp['k_equal_by_layer'][1]:.4f} of layer 1, "
              f"{cp['k_equal_by_layer'][-1]:.4f} of layer "
              f"{len(cp['k_equal_by_layer']) - 1}")
    # every admission after the first matches the 4 prefix pages: the
    # first registers them right after its prefill, inside the same
    # step() that admits the next three
    check(res["cache_on"]["prefix_hits"] == PREFIX_REQS - 1 and
          res["cache_on"]["prefix_reused_tokens"]
          == (PREFIX_REQS - 1) * PREFIX_LEN,
          f"19a: prefix hits {res['cache_on']['prefix_hits']}, reused "
          f"{res['cache_on']['prefix_reused_tokens']} tokens (want 7, 448)")
    check(res["cache_off"]["prefix_hits"] == 0, "19a: hits with no cache")
    miss = [p["ms"] for p in res["cache_off"]["prefills"]]
    hit = [p["ms"] for p in res["cache_on"]["prefills"] if p["n_cached"]]
    res["prefill_ms"] = {"uncached_mean": sum(miss) / len(miss),
                         "hit_mean": sum(hit) / len(hit),
                         "uncached": miss,
                         "cached": [p["ms"]
                                    for p in res["cache_on"]["prefills"]]}
    print(f"19a prefill per admission (CUDA events, launch gaps included): "
          f"uncached mean {res['prefill_ms']['uncached_mean']:.1f} ms "
          f"(buckets {[p['bucket'] for p in res['cache_off']['prefills']]}),"
          f" prefix hit mean {res['prefill_ms']['hit_mean']:.1f} ms "
          f"(buckets {[p['bucket'] for p in res['cache_on']['prefills']]});"
          f" TTFT mean {res['cache_off']['agg']['ttft_mean_s'] * 1e3:.1f} "
          f"-> {res['cache_on']['agg']['ttft_mean_s'] * 1e3:.1f} ms")

    # the copy-on-write boundary: a prompt that is the prefix alone
    # matches all 4 pages; the last token is recomputed, so page 3 is
    # copied onto a fresh page and token 63 written on the copy
    prefix = reqs[0].prompt[:PREFIX_LEN]
    cow_out = {}
    for name, eng in (("cache_off", off), ("cache_on", on)):
        hits0 = eng.prefix_hits
        with prefill_events(torch, eng) as ev:
            eng.run([Request(rid=100, prompt=list(prefix),
                             max_new_tokens=COW_GEN)])
        cow_out[name] = eng.finished[-1].generated
        if name == "cache_on":
            check(eng.prefix_hits == hits0 + 1 and ev[0][3] == PREFIX_LEN - 1,
                  f"19a CoW: n_cached {ev[0][3]}, want {PREFIX_LEN - 1}")
            _, _, _, src, dst = ev[0][4]   # n_total, slot, table, cow
            check(src != dst, "19a CoW: no boundary page was copied")
            big = eng.caches["period"]["pos0"]
            keep = (PREFIX_LEN - 1) % 16
            for key in ("kp", "vp", "kp_scale", "vp_scale"):
                if key in big:
                    check(torch.equal(big[key][:, dst, :keep],
                                      big[key][:, src, :keep]),
                          f"19a CoW: {key} of page {dst} differs from "
                          f"page {src} over the shared tokens")
            res["cow"] = dict(src=int(src), dst=int(dst), shared_tokens=keep)
    check(cow_out["cache_on"] == cow_out["cache_off"],
          "19a CoW: the stream differs from the uncached engine's")
    print(f"19a copy-on-write: page {res['cow']['src']} -> "
          f"{res['cow']['dst']}, the {res['cow']['shared_tokens']} shared "
          f"tokens equal bit for bit in every layer's K and V; stream equal "
          f"to the uncached engine's")
    res["smoke"] = smoke_prefix(torch, ops)
    # K5 at the suffix prefill: S = the suffix bucket, lengths = 64 + S,
    # the serving pool's block table (8 pages a slot)
    res["k5"] = k5_check(torch, ops, ref, fmt, [
        (f"suffix prefill S={S} {kind} pool", 1, S, [PREFIX_LEN + S],
         packed, (9, 3, 64), {"MP": 8})
        for S in (16, 32) for kind, packed in (("bf16", False),
                                               ("packed", True))])
    return res, on


def smoke_prefix(torch, ops):
    """19a at the smoke config on the card (f32, 3 layers, page 4), where
    the per-tensor scales do not couple the prefix rows to the suffix:
    8 requests sharing a 16-token prefix (4 pages), a 4-8-token suffix
    each, 8 new tokens, 4 slots; the streams with the cache equal those
    without exactly, 7 hits reuse 7 x 16 tokens, K5 runs the suffix
    prefills."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.lns import LNSFormat
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.models.model import init_params
    from repro_torch.optim.madam import MadamConfig, init_lns_params
    from repro_torch.serving import Engine, Request
    cfg = get_smoke_config("smollm-135m")
    params = init_lns_params(init_params(cfg, seed=0, device="cuda"),
                             MadamConfig(update_format=LNSFormat(8, 8)))
    rng = np.random.default_rng(19)
    head = rng.integers(0, cfg.vocab_size, (16,)).tolist()
    prompts = [head + rng.integers(0, cfg.vocab_size, (int(
        rng.integers(4, 9)),)).tolist() for _ in range(8)]
    got = {}
    for cache in (False, True):
        eng = Engine(cfg, QuantConfig.lns_madam(), params, num_slots=4,
                     max_len=40, page_size=4, prefix_cache=cache,
                     device="cuda")
        ops.reset_launch_counts()
        with k5_query_rows(ops) as seen:
            eng.run([Request(rid=i, prompt=p, max_new_tokens=8)
                     for i, p in enumerate(prompts)])
        got[cache] = (streams(eng), eng.prefix_hits,
                      eng.prefix_reused_tokens, dict(seen))
    check(got[True][0] == got[False][0],
          "19a smoke: streams with the cache differ from those without")
    check(got[True][1:3] == (7, 7 * 16),
          f"19a smoke: hits {got[True][1]}, reused {got[True][2]}")
    print(f"19a at the smoke config: streams with the cache equal those "
          f"without (8/8), {got[True][1]} hits reusing {got[True][2]} "
          f"tokens; K5 launches by query rows {got[True][3]}")
    return {"hits": got[True][1], "reused": got[True][2],
            "k5_by_query_rows": got[True][3]}


@contextlib.contextmanager
def seeded_calls(ops):
    """Count K6's seeded launches (the wrapper counts every K6 launch
    under ``fused_sample`` itself)."""
    seen = {"rows": 0, "calls": 0}
    launch = ops.fused_sample_seeded

    def record(logits, *args, **kw):
        seen["calls"] += 1
        seen["rows"] += logits.shape[0]
        return launch(logits, *args, **kw)

    ops.fused_sample_seeded = record
    try:
        yield seen
    finally:
        ops.fused_sample_seeded = launch


async def http_call(host, port, method, path, body=None):
    """One HTTP/1.1 request on a fresh connection: (status, body bytes)."""
    import asyncio
    reader, writer = await asyncio.open_connection(host, port)
    payload = json.dumps(body).encode() if body is not None else b""
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(payload)}\r\n\r\n").encode()
                 + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), data


async def sse_call(host, port, body, delete_after=None):
    """One streaming completion: status, tokens, finish reason, the raw
    frames and the seconds from sending the request to the first frame."""
    import asyncio
    from repro_torch.server.sse import DONE, SSEParser
    t0 = time.monotonic()
    reader, writer = await asyncio.open_connection(host, port)
    payload = json.dumps({**body, "stream": True}).encode()
    writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(payload)}\r\n\r\n").encode()
                 + payload)
    await writer.drain()
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = await reader.read(4096)
        if not chunk:
            break
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    parser, frames, tokens, reason, rid, first = SSEParser(), [], [], None, \
        None, None
    chunk = rest
    while status == 200:
        for ev in parser.feed(chunk):
            if first is None:
                first = time.monotonic() - t0
            frames.append(ev)
            if ev == DONE:
                continue
            obj = json.loads(ev)
            rid = rid or obj["id"]
            choice = obj["choices"][0]
            tokens.extend(choice["delta"]["token_ids"])
            reason = choice["finish_reason"] or reason
        if frames and frames[-1] == DONE:
            break
        if delete_after is not None and len(frames) >= delete_after:
            await http_call(host, port, "DELETE", f"/v1/requests/{rid}")
            delete_after = None
        chunk = await reader.read(4096)
        if not chunk:
            break
    writer.close()
    return dict(status=status, tokens=tokens, reason=reason, frames=frames,
                first_frame_s=first, rid=rid)


def gateway_trace(torch, ops, engine):
    """Phase 19b: the 19a engine (reset) behind ``Gateway`` on
    127.0.0.1:0 over an ``EngineDriver``: one request completes first,
    so its pages are registered; then 7 at once, 4 streaming over SSE (one
    cancelled by DELETE after its 4th frame, one sampled at temperature
    0.8 with a seed, K6's seeded mode) and 3 not; one more past the
    watermark gets 429."""
    import asyncio
    import threading
    from repro_torch.obs.prom import parse_prometheus_text
    from repro_torch.server.app import Gateway
    from repro_torch.server.driver import EngineDriver
    from repro_torch.server.sse import DONE

    engine.reset()
    reqs = prefix_requests(engine.cfg)
    bodies = [{"prompt": list(r.prompt), "max_tokens": PREFIX_GEN}
              for r in reqs]
    bodies[2].update(temperature=0.8, seed=5)
    driver = EngineDriver(engine, max_inflight=7)
    loop = asyncio.new_event_loop()
    box = {}

    def serve():
        asyncio.set_event_loop(loop)
        gw = loop.run_until_complete(Gateway(driver, host="127.0.0.1",
                                             port=0, model="smollm-135m")
                                     .start())
        box["gw"], box["addr"] = gw, gw.address
        loop.run_forever()

    thread = threading.Thread(target=serve, daemon=True)
    res = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    driver.start()
    thread.start()
    try:
        t_end = time.monotonic() + 30
        while "addr" not in box and time.monotonic() < t_end:
            time.sleep(0.01)
        check("addr" in box, "19b: the gateway did not start")
        host, port = box["addr"]

        async def trace():
            first = await http_call(host, port, "POST", "/v1/completions",
                                    bodies[0])
            streams_ = [asyncio.ensure_future(sse_call(
                host, port, bodies[i], delete_after=4 if i == 1 else None))
                for i in (1, 2, 3, 4)]
            unary = [asyncio.ensure_future(http_call(
                host, port, "POST", "/v1/completions", bodies[i]))
                for i in (5, 6, 7)]
            t_end = time.monotonic() + 60
            while (driver.stats()["inflight"] < 7
                   and time.monotonic() < t_end):
                await asyncio.sleep(0.005)
            over = await http_call(host, port, "POST", "/v1/completions",
                                   bodies[0])
            return (first, await asyncio.gather(*streams_),
                    await asyncio.gather(*unary), over)

        t0 = time.monotonic()
        with seeded_calls(ops) as seeded:
            first, sse_res, unary, over = asyncio.run(trace())
        wall = time.monotonic() - t0
        counts = ops.launch_counts()
        t_end = time.monotonic() + 30
        while (engine.scheduler.running or engine.queue
               or engine.allocator.in_use) and time.monotonic() < t_end:
            time.sleep(0.01)
        health = json.loads(asyncio.run(http_call(host, port, "GET",
                                                  "/health"))[1])
        metrics = asyncio.run(http_call(host, port, "GET",
                                        "/metrics"))[1].decode()
        stats = json.loads(asyncio.run(http_call(host, port, "GET",
                                                 "/metrics.json"))[1])
    finally:
        if "gw" in box:
            asyncio.run_coroutine_threadsafe(box["gw"].stop(),
                                             loop).result(10)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        driver.shutdown()
    check(not thread.is_alive() and not driver.alive,
          "19b: the gateway or driver thread did not stop")
    check(first[0] == 200, f"19b: the first request got {first[0]}")
    one = json.loads(first[1])["choices"][0]
    check(len(one["token_ids"]) == PREFIX_GEN
          and one["finish_reason"] == "length",
          f"19b: the first request ended {one['finish_reason']} after "
          f"{len(one['token_ids'])} tokens")
    for i, s in zip((1, 2, 3, 4), sse_res):
        check(s["status"] == 200 and s["frames"] and s["frames"][-1] == DONE,
              f"19b: stream {i} did not end in data: [DONE] "
              f"({s['status']}, {s['frames'][-1:]})")
        if i == 1:
            check(s["reason"] == "aborted" and 4 <= len(s["tokens"])
                  < PREFIX_GEN, f"19b: the cancelled stream ended "
                  f"{s['reason']} after {len(s['tokens'])} tokens")
        else:
            check(s["reason"] == "length" and len(s["tokens"]) == PREFIX_GEN,
                  f"19b: stream {i} ended {s['reason']} after "
                  f"{len(s['tokens'])} tokens")
    for i, (status, data) in zip((5, 6, 7), unary):
        c = json.loads(data)["choices"][0] if status == 200 else {}
        check(status == 200 and c["finish_reason"] == "length"
              and len(c["token_ids"]) == PREFIX_GEN,
              f"19b: request {i} got {status} {c.get('finish_reason')}")
    check(over[0] == 429, f"19b: the submission past the watermark got "
                          f"{over[0]}, not 429")
    check(engine.allocator.in_use == 0 and
          engine.allocator.available == engine.num_pages,
          f"19b: pages leaked: {engine.allocator.in_use} in use")
    check(seeded["calls"] > 0, "19b: K6's seeded mode never ran")
    check(all(counts[k] > 0 for k in ("encode_pack", "qmatmul",
                                      "paged_attend", "fused_sample")),
          f"19b: a kernel of the path did not launch: {counts}")
    parsed = parse_prometheus_text(metrics)
    for name, kind in (("repro_ttft_seconds", "histogram"),
                       ("repro_tpot_seconds", "histogram"),
                       ("repro_prefix_hits", "counter"),
                       ("repro_prefix_reused_tokens", "gauge")):
        check(parsed.get(name, {}).get("type") == kind,
              f"19b: /metrics lacks {name} ({kind})")
    name = torch.cuda.get_device_name(0)
    check(health.get("device") == "cuda" and health.get("card") == name,
          f"19b: /health names {health.get('device')} {health.get('card')}")
    check(stats["prefix_hits"] == engine.prefix_hits >= 6,
          f"19b: prefix hits {stats['prefix_hits']} (want >= 6: every "
          f"request after the first matches the prefix)")
    res = dict(wall_s=wall, launches=counts, seeded_k6=seeded,
               first_frame_s={i: s["first_frame_s"]
                              for i, s in zip((1, 2, 3, 4), sse_res)},
               tokens_by_stream={i: len(s["tokens"])
                                 for i, s in zip((1, 2, 3, 4), sse_res)},
               prefix_hits=engine.prefix_hits,
               prefix_reused_tokens=engine.prefix_reused_tokens,
               health=health, stats={k: v for k, v in stats.items()
                                     if isinstance(v, (int, float, str))})
    print(f"19b gateway: 1 + 7 requests in {wall:.2f} s, 429 past the "
          f"watermark, the DELETE after 4 frames ended 'aborted' with "
          f"[DONE], no page in use after; prefix hits {engine.prefix_hits} "
          f"({engine.prefix_reused_tokens} tokens); K6 seeded calls "
          f"{seeded['calls']}; submit -> first SSE frame "
          + ", ".join(f"#{i} {t * 1e3:.0f} ms"
                      for i, t in res["first_frame_s"].items())
          + f"; /health {health['device']} {health.get('card')}; launches "
          f"{counts}")
    return res


def bert_serve(torch, ops, ref, fmt):
    """Phase 19c: BERT-base (untied head) at full width through the
    engine: paged, 4 slots, 8 requests of 32 + 32 tokens; K2 at the
    head's decode shape 4x768 @ 768x30522 against its plain version and
    ``torch.matmul``; the model's logits through the kernels against the
    plain versions (phase 5's rule); a k=4 draft view at 6 bits in one K7
    launch, the head included; k=1 reproduces the baseline's streams."""
    from repro_torch.configs.paper_models import BERT_BASE
    from repro_torch.core.lns import LNSFormat
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.models.model import init_params
    from repro_torch.optim.madam import MadamConfig, init_lns_params
    from repro_torch.serving import Engine, synthetic_trace
    cfg = BERT_BASE
    params = init_lns_params(init_params(cfg, seed=0, device="cuda"),
                             MadamConfig(update_format=LNSFormat(8, 8)))
    trace = lambda: synthetic_trace(cfg, requests=8, prompt_len=32,
                                    gen_len=32, seed=0)
    res = {}
    base_streams = None
    with k2_shapes_seen(torch, ops) as seen:
        for name, kw in (("baseline", {}),
                         ("spec_k4_b6", dict(speculate_k=4,
                                             draft_bitwidth=6)),
                         ("spec_k1_b6", dict(speculate_k=1,
                                             draft_bitwidth=6))):
            eng = Engine(cfg, QuantConfig.lns_madam(), params, num_slots=4,
                         max_len=66, page_size=16, device="cuda", **kw)
            check(eng._head is eng.params["embed"]["head"],
                  "19c: the untied head is not the packed embed.head")
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            agg = eng.run(trace())
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            got = streams(eng)
            check(agg["completed"] == 8, f"19c {name}: completed "
                  f"{int(agg['completed'])}/8")
            check(all(counts[k] > 0 for k in ("encode_pack", "qmatmul",
                                              "paged_attend",
                                              "fused_sample")),
                  f"19c {name}: a kernel did not launch: {counts}")
            r = dict(agg=agg, launches=counts,
                     decode_steps=eng.decode_steps,
                     spec=eng.spec_snapshot())
            if name == "baseline":
                r["head_decode_launches"] = sum(
                    n for s, n in seen.items() if s[:3] == (4, 768, 30522))
                base_streams = got
                logits = logits_check(torch, eng)
                res["logits"] = logits
            else:
                view, head = eng._draft_params(6)
                check(counts["requant_pack"] == 1,
                      f"19c {name}: K7 launched {counts['requant_pack']} "
                      f"times for one draft view")
                check(head is view["embed"]["head"] and head.fmt.bits == 6,
                      f"19c {name}: the draft head is not re-gridded")
                same = sum(got[rid] == base_streams[rid]
                           for rid in base_streams)
                r["same_as_baseline"] = same / len(base_streams)
                if name == "spec_k1_b6":
                    check(same == len(base_streams),
                          f"19c k=1: {same}/8 streams equal the baseline's")
            res[name] = r
            sp = r["spec"] or {}
            print(f"19c BERT-base {name}: completed 8/8, "
                  f"{agg['tokens_per_s']:.2f} tok/s, tpot p50 "
                  f"{agg['tpot_p50_s'] * 1e3:.1f} ms, decode steps "
                  f"{eng.decode_steps}, accept rate "
                  f"{sp.get('spec_accept_rate')}, streams equal to the "
                  f"baseline {r.get('same_as_baseline', 1.0):.3f}, "
                  f"launches {counts}")
            del eng
    check((4, 768, 30522) in {s[:3] for s in seen},
          f"19c: K2 never ran the head's decode shape: {sorted(seen)[:8]}")
    res["k2_driven"] = k2_driven_check(torch, ops, ref, fmt, seen)
    res["k2_head"] = k2_check(torch, ops, ref, fmt, [(4, 768, 30522)])
    del params
    torch.cuda.empty_cache()
    return res


def online_serving(torch, ops, ref, fmt):
    """Phase 19: 19a, 19b over 19a's engine, 19c."""
    t0 = time.monotonic()
    prefix, engine = prefix_serve(torch, ops, ref, fmt)
    gateway = gateway_trace(torch, ops, engine)
    del engine
    torch.cuda.empty_cache()
    bert = bert_serve(torch, ops, ref, fmt)
    secs = time.monotonic() - t0
    print(f"phase 19 took {secs:.1f}s")
    return {"prefix": prefix, "gateway": gateway, "bert": bert,
            "seconds": secs}


# ---------------------------------------------------------------------------
# phase 20: observability at full width


def obs_groups(stats, launches):
    """kernel_stats' calls and the kernels' launch counts, both grouped by
    kernel: an op counts toward the kernel its wrapper launches (seeded K6
    and grouped K7 share their kernels' counts, K3 and K4 share
    ``madam_step``). Returns (calls, launches), zero groups dropped."""
    calls = collections.Counter()
    for row in stats.values():
        check(row["backend"] == "kernel" and row["traces"] == 0,
              f"kernel_stats row off the kernel path: {row}")
        calls[OBS_OP_KERNEL.get(row["op"], row["op"])] += row["calls"]
    got = collections.Counter()
    for name, n in launches.items():
        got[OBS_OP_KERNEL.get(name, name)] += n
    return ({k: v for k, v in calls.items() if v},
            {k: v for k, v in got.items() if v})


def obs_serve(torch, ops, argv, spec, tmp):
    """20a: the serve CLI's engine over phase 4's paged trace with an
    observer attached and kernel_stats on, from cold (a speculating
    engine builds its draft view, one K7 launch, inside the run)."""
    from repro_torch.launch.serve import build_engine, parser
    from repro_torch.obs import EngineObserver, kernel_stats
    from repro_torch.obs.spans import validate_chrome_trace
    from repro_torch.serving import synthetic_trace

    args = parser().parse_args(argv)
    engine = build_engine(args)
    obs = EngineObserver()
    engine.attach_observer(obs)
    trace = synthetic_trace(engine.cfg, requests=args.requests,
                            prompt_len=args.prompt_len, gen_len=args.gen_len,
                            seed=args.seed)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    stats = kernel_stats.enable()
    try:
        agg = engine.run(trace)
        torch.cuda.synchronize()
    finally:
        kernel_stats.disable()
    launches = ops.launch_counts()
    tag = "spec" if spec else "baseline"
    check(agg["completed"] == args.requests,
          f"20a {tag}: {agg['completed']} of {args.requests} completed")
    per = validate_chrome_trace(obs.to_chrome(), require_spec=spec)
    check(sorted(per) == list(range(args.requests)),
          f"20a {tag}: spans of requests {sorted(per)}")
    s = obs.summary()
    steps = {"decode": engine.decode_steps, "spec": engine.spec_cycles,
             "prefill": engine.prefills}
    for kind, n in steps.items():
        check(s[f"{kind}_steps"] == n,
              f"20a {tag}: {s[f'{kind}_steps']} {kind} rows, engine {n}")
    check(engine.prefills == args.requests and engine.preemptions == 0,
          f"20a {tag}: {engine.prefills} admissions, "
          f"{engine.preemptions} preemptions")
    check(s["emitted_tokens"] == args.requests * args.gen_len,
          f"20a {tag}: the timeline emitted {s['emitted_tokens']} tokens")
    rows = stats.snapshot()
    calls, got = obs_groups(rows, launches)
    check(calls == got, f"20a {tag}: kernel_stats calls {calls} != launch "
                        f"counts {got}")
    need = {"encode_pack", "qmatmul", "paged_attend", "fused_sample"}
    need |= {"requant_pack"} if spec else set()
    check(need <= set(calls), f"20a {tag}: no call of {need - set(calls)}")
    bd = obs.time_breakdown(agg["wall_s"])
    path = obs.export(str(tmp), tag=f"smollm-135m-{tag}")
    print(f"20a {tag}: {int(agg['completed'])}/{args.requests} requests, "
          f"{agg['tokens_per_s']:.1f} tok/s, {s['prefill_steps']} prefill / "
          f"{s['decode_steps']} decode / {s['spec_steps']} spec rows (= the "
          f"engine's), {s['emitted_tokens']} tokens emitted, "
          f"{s['span_events']} span events; time breakdown: "
          + ", ".join(f"{k[:-6]} {bd[k]:.1%}" for k in
                      ("prefill_share", "decode_share", "spec_share",
                       "host_share") if k in bd)
          + f" of {bd['wall_s']:.2f} s; kernel_stats calls = launches "
          f"{dict(sorted(calls.items()))}")
    return engine, {"agg": agg, "summary": s, "time_breakdown": bd,
                    "calls": calls, "launches": launches, "trace": path,
                    "kernel_stats": rows}


def obs_windows(torch, engine, ops):
    """20b and 20c on the baseline engine: 4 requests decoding, then
    windows of ``OBS_DECODE_STEPS`` decode steps under torch.profiler:
    a warm window, then observer and kernel_stats off, on, off, on (the
    same kernel launches and copies issued, counted at the CUDA runtime
    calls; walls printed side by side), then one window at ``block_every=1`` (each call's blocked
    time beside the profiler's device time a launch)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import EngineObserver, kernel_stats
    from repro_torch.serving import synthetic_trace

    engine.reset()
    obs = EngineObserver()
    for r in synthetic_trace(engine.cfg, requests=4, prompt_len=32,
                             gen_len=OBS_GEN, seed=1):
        engine.submit(r)
    engine.step()              # admissions and the first decode
    torch.cuda.synchronize()

    def window(on, block_every=0):
        engine.attach_observer(obs if on else None)
        if on:
            kernel_stats.enable(block_every=block_every)
        before = engine.decode_steps
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                for _ in range(OBS_DECODE_STEPS):
                    engine.step()
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
        finally:
            rows = kernel_stats.get()
            kernel_stats.disable()
            engine.attach_observer(None)
        check(engine.decode_steps - before == OBS_DECODE_STEPS
              and len(engine.scheduler.running) == 4,
              "20b: a window held more than decode steps of 4 requests")
        return prof, wall * 1e3 / OBS_DECODE_STEPS, rows

    cuda = torch.autograd.DeviceType.CUDA

    def issued(prof):
        """The runtime calls that put work on the card, by name."""
        return collections.Counter({e.key: e.count
                                    for e in prof.key_averages()
                                    if e.device_type != cuda
                                    and e.key in OBS_WORK_CALLS})

    window(False)              # warm: the profiler's first window
    walls, work, calls = {"off": [], "on": []}, [], []
    for on in (False, True, False, True):
        prof, wall, _ = window(on)
        walls["on" if on else "off"].append(wall)
        w = launch_split(torch, prof, OBS_DECODE_STEPS)
        work.append({k: w[k] * OBS_DECODE_STEPS
                     for k in ("port", "torch", "copies")})
        calls.append(issued(prof))
    for i in range(1, len(calls)):
        check(calls[i] == calls[0],
              f"20b: window {i} ({'on' if i % 2 else 'off'}) issued "
              f"{dict(calls[i])}, window 0 (off) {dict(calls[0])}")
    print(f"20b decode step wall, observer and kernel_stats off / on "
          f"(interleaved, ms): "
          + ", ".join(f"{a:.1f} / {b:.1f}"
                      for a, b in zip(walls["off"], walls["on"]))
          + f"; every window of {OBS_DECODE_STEPS} steps issued "
          f"{dict(calls[0])}; device records kept by the profiler (port "
          f"kernels, torch kernels, copies): "
          + ", ".join(f"{w['port']:.0f}/{w['torch']:.0f}/{w['copies']:.0f}"
                      for w in work))

    prof, wall_b, rows = window(True, block_every=1)
    blocked = {}
    for op, names in OBS_BLOCKED_KERNELS.items():
        n = sum(r.get("blocked_calls", 0) for r in rows.values()
                if r["op"] == op)
        b_s = sum(r.get("blocked_s", 0.0) for r in rows.values()
                  if r["op"] == op)
        evs = [e for e in prof.key_averages() if e.device_type == cuda
               and any(k in e.key for k in names)]
        cnt = sum(e.count for e in evs)
        dev_us = sum(e.self_device_time_total for e in evs)
        check(n > 0 and cnt > 0, f"20c: {op} blocked {n} calls, profiler "
                                 f"saw {cnt} launches")
        blocked[op] = {"blocked_ms": b_s * 1e3 / n, "calls": n,
                       "device_ms": dev_us / 1e3 / cnt, "launches": cnt}
        check(blocked[op]["blocked_ms"] >= OBS_BLOCKED_MIN
              * blocked[op]["device_ms"],
              f"20c: {op} blocked {blocked[op]['blocked_ms']:.4f} ms a call "
              f"under {OBS_BLOCKED_MIN} x its device time "
              f"{blocked[op]['device_ms']:.4f} ms")
    print(f"20c blocked (block_every=1, {wall_b:.1f} ms a step): "
          + "; ".join(f"{op} {r['blocked_ms']:.4f} ms a call (device "
                      f"{r['device_ms']:.4f} ms a launch, {r['calls']} "
                      f"calls)" for op, r in blocked.items()))
    return {"wall_ms_per_step": walls, "issued_per_window": calls[0],
            "device_records_per_window": work, "blocked": blocked,
            "blocked_wall_ms_per_step": wall_b}


def first_word_apart(a_dir, b_dir, step):
    """The first leaf (in key order) and flat word where two checkpoints
    of ``step`` differ, or None."""
    import numpy as np
    d = [Path(x) / f"step_{step:08d}" for x in (a_dir, b_dir)]
    keys = json.loads((d[0] / "manifest.json").read_text())["keys"]
    for k in keys:
        a, b = (np.load(x / (k.replace("/", "_") + ".npy")) for x in d)
        diff = np.flatnonzero(a.reshape(-1) != b.reshape(-1))
        if diff.size:
            i = int(diff[0])
            return {"leaf": k, "word": i, "differing": int(diff.size),
                    "values": [a.reshape(-1)[i].item(),
                               b.reshape(-1)[i].item()]}
    return None


def obs_train(torch, ops, tmp):
    """20d: ``launch.train`` for 2 full-width steps with the observer's
    flags, then the same 2 steps without them."""
    from repro_torch.launch.train import main as train_main
    from repro_torch.obs import NumericsObserver
    from repro_torch.obs.numerics import validate_train_trace

    record_s = []
    real = NumericsObserver.record_step

    def timed(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, *a, **k)
        record_s.append(time.perf_counter() - t0)
        return out

    log = tmp / "train-steps.jsonl"
    flags = ["--trace-dir", str(tmp), "--numerics-log", str(log),
             "--kernel-stats", "--quiet=false", "--progress-every", "1"]
    runs = {}
    NumericsObserver.record_step = timed
    try:
        for tag, extra in (("observed", flags), ("control", [])):
            ckpt = tmp / f"ckpt-{tag}"
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            out = train_main(OBS_TRAIN_ARGV + ["--ckpt-dir", str(ckpt)]
                             + extra)
            torch.cuda.synchronize()
            runs[tag] = dict(out, launches=ops.launch_counts(),
                             ckpt=str(ckpt))
    finally:
        NumericsObserver.record_step = real
    steps = OBS_TRAIN_STEPS
    for tag, k4, k3 in (("observed", 8 * steps, 0), ("control", 0, 8 * steps)):
        r = runs[tag]
        got = (r["launches"]["madam_step_stats"], r["launches"]["madam_step"])
        check(r["steps"] == steps and r["failures_recovered"] == 0,
              f"20d {tag}: {r['steps']} steps, {r['failures_recovered']} "
              f"retried")
        check(got == (k4, k3), f"20d {tag}: K4/K3 launched {got}, not "
                               f"{(k4, k3)}")
    lo, lc = runs["observed"]["losses"], runs["control"]["losses"]
    apart = None
    if lo != lc:
        apart = first_word_apart(runs["observed"]["ckpt"],
                                 runs["control"]["ckpt"], steps)
        print(f"20d: losses {lo} vs {lc}; the states part at {apart}")
    check(lo == lc, f"20d: observed losses {lo} != control {lc}")
    rows = [json.loads(x) for x in log.read_text().splitlines()]
    check(len(rows) == steps, f"20d: the step log holds {len(rows)} rows")
    n_stats = 0
    for row in rows:
        for site, layers in row["numerics"].items():
            for layer, st in layers.items():
                for k, v in st.items():
                    n_stats += 1
                    check(math.isfinite(v), f"20d: {site}.{layer}.{k} = {v}")
                    check(k not in OBS_FRACTIONS or 0.0 <= v <= 1.0,
                          f"20d: fraction {site}.{layer}.{k} = {v}")
    trace = runs["observed"]["trace"]["trace"]
    info = validate_train_trace(json.loads(Path(trace).read_text()))
    ks = runs["observed"]["kernel_stats"]
    madam = ks.get("madam_step|kernel|b16", {}).get("calls")
    check(madam == 8 * steps, f"20d: kernel_stats saw {madam} Madam calls")
    print(f"20d train, {steps} steps of 8 x 256: observed K4 "
          f"{runs['observed']['launches']['madam_step_stats']} / K3 "
          f"{runs['observed']['launches']['madam_step']}, control K4 "
          f"{runs['control']['launches']['madam_step_stats']} / K3 "
          f"{runs['control']['launches']['madam_step']}; losses equal bit "
          f"for bit ({', '.join(f'{x:.6f}' for x in lo)}); {len(rows)} "
          f"jsonl rows, {n_stats} stats finite; trace: {info['steps']} "
          f"train steps, {len(info['tracks'])} tracks; record_step "
          + ", ".join(f"{x * 1e3:.2f}" for x in record_s)
          + " ms a step; step wall observed "
          f"{runs['observed']['wall_s'] / steps * 1e3:.1f} ms, control "
          f"{runs['control']['wall_s'] / steps * 1e3:.1f} ms (2 steps, "
          f"checkpoints included)")
    return {"runs": {k: {x: v[x] for x in ("losses", "launches", "wall_s")}
                     for k, v in runs.items()},
            "record_step_s": record_s, "trace": trace, "trace_info": info,
            "rows": len(rows), "stats": n_stats, "apart": apart,
            "kernel_stats": ks}


def obs_validate_cli(serve_trace, train_trace):
    """20e: ``python -m repro_torch.obs.validate`` on the speculating
    serve export (spec spans required) and the train export, each in a
    subprocess: exit 0 on each."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cases = [(serve_trace, ["--require-spec"]), (train_trace, ["--train"])]
    for path, flags in cases:
        out = subprocess.run([sys.executable, "-m", "repro_torch.obs.validate",
                              path] + flags, env=env, capture_output=True,
                             text=True, timeout=120)
        check(out.returncode == 0, f"20e: validate {flags} exited "
                                   f"{out.returncode}: {out.stdout}"
                                   f"{out.stderr}")
        print("20e " + out.stdout.strip().replace(str(ROOT) + "/", ""))
    return len(cases)


def obs_torch_profile(torch, tmp):
    """20f: a 2-request ``launch.serve --torch-profile``; its Chrome trace
    must hold device events of K1, K2, K5 and K6."""
    from repro_torch.launch.serve import main as serve_main
    out_dir = tmp / "torch-profile"
    serve_main(["--requests", "2", "--slots", "2", "--prompt-len", "32",
                "--gen-len", "2", "--page-size", "16", "--torch-profile",
                str(out_dir)])
    files = sorted(out_dir.glob("torch_profile-*.json"))
    check(len(files) == 1, f"20f: {len(files)} profiler traces written")
    doc = json.loads(files[0].read_text())
    kernels = collections.Counter()
    for e in doc["traceEvents"]:
        if e.get("cat") == "kernel":
            for k, names in OBS_BLOCKED_KERNELS.items():
                if any(n in e.get("name", "") for n in names):
                    kernels[k] += 1
    check(set(kernels) == set(OBS_BLOCKED_KERNELS),
          f"20f: the profiler trace's device events hold {dict(kernels)}")
    print(f"20f --torch-profile: {files[0].stat().st_size / 2**20:.1f} MiB "
          f"trace, device events {dict(kernels)}")
    return dict(kernels)


def observability(torch, ops, card):
    """Phase 20: the obs modules on the card at full width."""
    t0 = time.monotonic()
    marks = [("start", t0)]
    mark = lambda name: marks.append((name, time.monotonic()))
    print(f"phase 20 (observability) on {card}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        engine, base = obs_serve(torch, ops, SERVE_PAGED, False, tmp)
        mark("20a baseline")
        windows = obs_windows(torch, engine, ops)
        mark("20b+c")
        del engine
        torch.cuda.empty_cache()
        spec_engine, spec = obs_serve(
            torch, ops, SERVE_PAGED + ["--speculate-k", str(SPEC_K),
                                       "--draft-bitwidth", "6"], True, tmp)
        mark("20a spec")
        del spec_engine
        torch.cuda.empty_cache()
        train = obs_train(torch, ops, tmp)
        mark("20d")
        torch.cuda.empty_cache()
        n_cli = obs_validate_cli(spec["trace"], train["trace"])
        mark("20e")
        prof = obs_torch_profile(torch, tmp)
        mark("20f")
    secs = time.monotonic() - t0
    parts = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    print(f"phase 20 took {secs:.1f}s ("
          + ", ".join(f"{k} {v:.1f}s" for k, v in parts.items()) + ")")
    strip = lambda d: {k: v for k, v in d.items() if k != "trace"}
    return {"serve": strip(base), "spec": strip(spec), "windows": windows,
            "train": {k: v for k, v in train.items() if k != "trace"},
            "validate_cli_files": n_cli, "torch_profile_kernels": prof,
            "seconds": secs, "seconds_by_part": parts}


def main() -> int:
    import torch

    t_start = time.monotonic()
    sweeps = {"--k1-sweep": k1_sweep, "--k2-sweep": k2_sweep,
              "--k6-sweep": k6_sweep, "--k8-sweep": k8_sweep,
              "--serving": online_serving,
              "--obs": lambda torch, ops, ref, fmt: observability(
                  torch, ops, card.stdout.strip())}
    sweep = len(sys.argv) == 2 and sys.argv[1] in sweeps
    if sys.argv[1:] and not sweep:
        print(f"usage: {Path(__file__).name} [--k1-sweep | --k2-sweep | "
              f"--k6-sweep | --k8-sweep | --serving | --obs]",
              file=sys.stderr)
        return 2
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
    if sweep:
        name = sys.argv[1][2:].replace("-", "_")
        rows = sweeps[sys.argv[1]](torch, ops, ref, fmt)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / f"{name}.json").write_text(json.dumps(
            {"card": card.stdout.strip(), "rows": rows}, indent=1))
        return 0
    # serving shapes (M = 4 decode, 32 prefill), then the training step's
    # M = 8 x 256 = 2048
    k1 = k1_check(torch, ops, ref, fmt, [(4, 576), (4, 1536), (32, 576),
                                         (32, 1536), (2048, 576),
                                         (2048, 1536)])
    k1_edge_calls = k1_edges(torch, ops, ref, fmt)
    k1_launch = k1_one_launch(torch, ops, fmt)
    gemms = [(576, 576), (576, 192), (576, 1536), (1536, 576)]
    # the main path's shapes first (decode M=4, prefill M=32, training
    # M=2048), then the verify's M=16 and M=24 (two 8-row tiles a block,
    # the second partly masked); M=32, 128, 256 and 512 are also timed on
    # the other path (the skinny/wgmma crossover); ragged shapes (skinny
    # with one and two row tiles, wgmma), the smoke config's f32 compute,
    # and the fused bf16 cast at M=2048. "brief" rows skip the eager and
    # plain timings
    bf16, f32 = torch.bfloat16, torch.float32
    k2 = k2_check(torch, ops, ref, fmt, [(4, k, n) for k, n in gemms]
                  + [(32, k, n, {"also": "wgmma"}) for k, n in gemms]
                  + [(2048, k, n) for k, n in gemms]
                  + [(16, k, n) for k, n in gemms]
                  + [(24, k, n) for k, n in gemms]
                  + [(128, k, n, {"also": "wgmma", "brief": True})
                     for k, n in gemms]
                  + [(m, k, n, {"also": "skinny", "brief": True})
                     for m in (256, 512) for k, n in gemms]
                  + [(5, 577, 193, {"brief": True}),
                     (24, 577, 193, {"brief": True}),
                     (2047, 584, 1543, {"brief": True}),
                     (4, 48, 128, {"compute": f32, "brief": True})]
                  + [(2048, k, n, {"out": bf16}) for k, n in gemms])
    k2_decode = k2_decode_check(torch, ops, ref)
    k2_pass = k2_decode_pass_check(torch, ops, ref, fmt,
                                   [(2048, k, n) for k, n in gemms]
                                   + [(2047, 584, 1543)])
    # the packed leaves of smollm-135m: embed, then wq/wo, up/gate, down
    # and wk/wv stacked over 30 layers, folded to (-1, last); B=16 words
    # with bf16 gradients as the train step gives them, and B=8 once
    k34 = k34_check(torch, ops, ref, [
        (49152, 576, 16, 2048, bf16), (17280, 576, 16, 2048, bf16),
        (17280, 1536, 16, 2048, bf16), (46080, 576, 16, 2048, bf16),
        (17280, 192, 16, 2048, bf16), (17280, 576, 8, 8, torch.float32)])
    k5 = k5_check(torch, ops, ref, fmt, [
        ("decode bf16 pool", 4, 1, [33, 48, 61, 66], False),
        ("decode packed pool", 4, 1, [33, 48, 61, 66], True),
        ("prefill bf16 pool", 1, 32, [32], False),
        ("prefill packed pool", 1, 32, [32], True),
        ("verify bf16 pool", 4, SPEC_K, [36, 45, 52, 63], False),
        ("verify packed pool", 4, SPEC_K, [36, 45, 52, 63], True),
        # the smoke config's heads (phase 12 serves it paged)
        ("smoke verify bf16 pool", 3, 3, [9, 20, 31], False, (3, 1, 16)),
        # one visible page for four warps: three merge as no-ops
        ("decode empty warps", 4, 1, [9, 1, 16, 5], True),
        # two stages a warp exceed 227 KB here: one stage a warp
        ("decode f32 pool page 32 hd 128", 2, 1, [100, 160], False,
         (8, 2, 128), {"PAGE": 32, "pool": torch.float32})])
    k6 = k6_check(torch, ops, ref)
    sampler = sampler_check(torch, ops, ref)
    k7 = k7_check(torch, ops, ref)

    # every K2 shape of phases 4-14 is recorded and checked after them
    k2_seen_ctx = k2_shapes_seen(torch, ops)
    k2_seen = k2_seen_ctx.__enter__()
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
                 prefills=engine.prefills, launches=counts,
                 streams=streams(engine))

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
    del setup
    torch.cuda.empty_cache()

    spec_runs, spec_engine = spec_serve(torch, ops, paged)
    smoke = smoke_spec(torch)
    spec_prof = profile_spec(torch, spec_engine,
                             prof["wall_ms_per_step"])
    del spec_engine
    coupling = verify_coupling(torch, ops)
    k2_seen_ctx.__exit__(None, None, None)
    torch.cuda.empty_cache()
    k2_driven = k2_driven_check(torch, ops, ref, fmt, k2_seen)

    k8, k8_luts, table10, k8_counts, k8_rate_inputs = k8_check(
        torch, ops, ref, fmt, [(m, k, n) for m in (4, 2048) for k, n in gemms])
    # K9 at phase 3's leaves with int32 codes, the embedding once with
    # int16 codes (JAX's madam_update_pallas takes int16) and B=8 in uint8
    i32, i16, u8 = torch.int32, torch.int16, torch.uint8
    k9, k9_counts = k9_check(torch, ops, ref, [
        (49152, 576, 16, 2048, bf16, i32), (17280, 576, 16, 2048, bf16, i32),
        (17280, 1536, 16, 2048, bf16, i32), (46080, 576, 16, 2048, bf16, i32),
        (17280, 192, 16, 2048, bf16, i32), (49152, 576, 16, 2048, bf16, i16),
        (17280, 576, 8, 8, torch.float32, u8)])
    approx = approx_train(torch, ops, train_setup(torch))
    torch.cuda.empty_cache()
    paper = baselines(torch, ops, ref, fmt, train_prof)
    torch.cuda.empty_cache()
    online = online_serving(torch, ops, ref, fmt)
    torch.cuda.empty_cache()
    observed = observability(torch, ops, card.stdout.strip())
    torch.cuda.empty_cache()

    # launches: each kernel's count on its own path's run (serving for
    # K1/K2/K5/K6, the training run for K2's decode pass and K3, the numerics step for K4, the
    # B=6 speculative serve for K7, the Table-10 sweep through
    # kernels.lns_matmul for K8, the dispatch calls of phase 16 for K9)
    meta = {
        "encode_pack": ("lns_quantize.cu", "lns_quantize.py:80", k1, 1,
                        counts),
        "qmatmul": ("lns_qmatmul.cu", "lns_qmatmul.py:48", k2, 3, counts),
        "qmatmul_decode": ("lns_qmatmul.cu", "lns_qmatmul.py:48", k2_pass, 2,
                           train["launches"]),
        "paged_attend": ("paged_attend.cu", "paged_attend.py:172", k5, 0,
                         counts),
        "fused_sample": ("sampler.cu", "sampler.py:62", k6, 0, counts),
        "madam_step": ("madam_update.cu", "madam_update.py:231",
                       k34["madam_step"], 0, train["launches"]),
        "madam_step_stats": ("madam_update.cu", "madam_update.py:291",
                             k34["madam_step_stats"], 0,
                             numerics["launches"]),
        "requant_pack": ("lns_requant.cu", "lns_quantize.py:44", k7, 0,
                         spec_runs["spec_b6"]["launches"]),
        "lns_matmul_packed": ("lns_matmul.cu", "lns_matmul.py:96", k8, 6,
                              k8_counts),
        "madam_step_unpacked": ("madam_update.cu", "madam_update.py:172", k9,
                                0, k9_counts),
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
            "bound_share": r["bound_ms"] / r["ms"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
        if name == "fused_sample":
            kernels[-1]["cases"] = [
                {k: x[k] for k in ("case", "shape", "ms", "plain_ms",
                                   "bound_ms", "library_ms")}
                for x in rows if "ms" in x]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    full = {"card": card.stdout.strip(), "build_s": build_s,
            "kernels": kernels,
            "qmatmul_decode": k2_decode, "qmatmul_driven": k2_driven,
            "encode_pack_edge_calls": k1_edge_calls,
            "encode_pack_one_launch": k1_launch,
            "sample_logits": sampler,
            "shapes": {"encode_pack": k1, "qmatmul": k2,
                       "qmatmul_decode_pass": k2_pass, "paged_attend": k5,
                       "fused_sample": k6, "requant_pack": k7, **k34,
                       "lns_matmul_packed": k8,
                       "lns_matmul_packed_lut_sweep": k8_luts,
                       "madam_step_unpacked": k9},
            "table10": table10, "k8_rate_inputs": k8_rate_inputs,
            "approx_train": approx, "baselines": paper,
            "online_serving": online, "observability": observed,
            "serve_paged": paged, "serve_dense": dense,
            "logits": logits, "profile": prof, "train": train,
            "numerics": numerics, "train_step": step_cmp,
            "train_profile": train_prof,
            "spec": {"runs": spec_runs, "smoke": smoke,
                     "profile": spec_prof, "verify_coupling": coupling},
            "seconds": time.monotonic() - t_start, "device": device}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(full, indent=1))
    print(f"chip_smoke took {full['seconds']:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
