#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --k1-sweep   # K1's block size and grid only
    python3 chip_smoke.py --k2-sweep   # K2's skinny plan constants only
    python3 chip_smoke.py --k6-sweep   # K6's blocks a row and block size
    python3 chip_smoke.py --k8-sweep   # K8's tiles, splits, table copies
    python3 chip_smoke.py --serving    # phases 1, 2 and 19 only
    python3 chip_smoke.py --obs        # phases 1, 2 and 20 only
    python3 chip_smoke.py --dense-variants  # 1, 2, K5 at hd 256, and 21
    python3 chip_smoke.py --modality   # 1, 2, K5 at hd 96, and 22
    python3 chip_smoke.py --recurrent  # 1, 2, K5 at hd 112, and 23
    python3 chip_smoke.py --moe        # 1, 2, K5 at rep 8, and 24
    python3 chip_smoke.py --mesh       # 1, 2, 25c-e, 26, 27, 28b on four cards
    python3 chip_smoke.py --mesh-train # 1, 2 and 26 on four cards
    python3 chip_smoke.py --mesh-serve # 1, 2 and 27 on four cards
    python3 chip_smoke.py --mesh-25c   # 1, 2 and 25c five times, four cards
    python3 chip_smoke.py --mesh-long  # 1, 2 and 30 on four cards
    python3 chip_smoke.py --mesh-tp    # 1, 2 and 31 on four cards
    python3 chip_smoke.py --mesh-rp    # 1, 2 and 32 on four cards
    python3 chip_smoke.py --k1-given   # K1 with a given scale only

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
   an f32 pool whose pages take one stage a warp, and gemma3-12b's
   global layers at head_dim 256 (``K5_HD256_CASES``: decode over a bf16
   and a packed pool, the verify's S=4, warps that see no position, an
   f32 pool at page 16, one stage a warp), phi-3-vision's at
   head_dim 96 (``K5_HD96_CASES``: bf16 and packed decode and verify
   S=4, warps that see no position, an f32 pool) and zamba2's shared
   attention at head_dim 112 (``K5_HD112_CASES``: bf16 and packed
   decode, the exact-length prefill 1 x 32 over 32 positions, warps that
   see no position, an f32 pool) and kimi-k2's 8 query heads a KV head
   (``K5_KIMI_CASES``: bf16 and packed decode), each timed beside SDPA
   over gathered pages. TF32 must be off.
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
    phase 4's paged trace cut to 4 requests of 32 + 16 tokens
    (``SPEC_SERVE``: one batch of the 4 slots) with ``--speculate-k 4``
    at draft bitwidths 6, 7 and 8, then bitwidth 6 and the
    non-speculating engine under ``--alloc-policy ondemand``, then
    ``--speculate-k 1``, with the
    non-speculating reserve engine first and last. Every run completes
    4/4; K7 launches once per draft view built; K5 runs at S=k once
    per layer per cycle; the ondemand pool ends full; the last baseline,
    the ondemand baseline and the k=1 run reproduce the first baseline's
    streams exactly. Accept rates, stream agreement with the baseline,
    tok/s and the tok/s ratio to the two baseline runs are printed, not
    limited.
12. At the smoke config on the card: a mixed greedy/seeded trace gives
    the speculating engine's streams equal to the baseline's, dense and
    ondemand.
13. Profile 1 speculative cycle as phase 6 profiles decode steps.
14. Measure why k>1 streams leave phase 4's: from 4 states of the paged
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
    and ``approx_lut`` 8 and 1 (``APPROX_EXTRA_STEPS`` more at LUT 1: 0),
    with TF32 off.
    Losses finite; K3 launches 8 times a step, K1 and K2 none under the
    approximation; the LUT-8 loss equals the exact fake-quant forward's
    within ``APPROX_LOSS_RTOL``, printed beside an f64-accumulation floor,
    and the LUT-4/2/1 losses (the controls) must lie outside it;
    step wall time and peak memory printed.

18. The paper's baselines at full width (each step prints one JSON
    line): (a) ``fp_quantize`` at e4m3 and e5m10, per tensor and per
    row, bf16 and f32, 2048x1536: two calls bit-identical, the normalized
    values equal to the ``float8_e4m3fn``/``float16`` round trip bit for
    bit, differences from the same call on the CPU printed, ms and device
    kernels a call; (b) ``launch.train --format fp8`` (smollm-135m, 2
    steps of 8 x 256): K3 8 times a step, K1 and K2 never, no retry,
    finite losses, and one fp8 step profiled beside phase 10's lns8 step;
    (c) BERT-base at full width (12 layers, d 768, untied head, ungated
    GELU, bf16), 8 x 384 tokens: 2 lns8 and 2 fp8 steps, K3 once per
    packed leaf a step, K1/K2 on lns8 only, every K2 shape the lns8 steps
    ran held against the plain version (as phase 14) and timed beside
    ``torch.matmul`` bf16, one step of each profiled; (d) Fig. 7 on
    smollm-135m with dense f32 weights: sgd_q and adamw_q at Q_U 16 and
    10 bits, and ``madam_fp``, 2 steps each: finite losses, no kernel
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
    attached and ``kernel_stats`` on, then phase 11's trace (4 requests
    of 32 + 16) at k=4, 6 bits, from cold: every request completes, the
    trace validates (spec spans required on the spec run), the
    timeline's prefill/decode/spec rows equal the engine's admissions,
    decode steps and spec cycles, its emitted tokens total requests x
    new tokens, each op's ``kernel_stats`` calls equal
    its kernel's launch count over the same run; the time breakdown
    (host share included) printed. (b) On that engine, 4 requests
    decoding: windows of 2 decode steps under torch.profiler with the
    observer and ``kernel_stats`` (``block_every=0``) off, then on,
    after a warm window: every window issues the same kernel launches
    and copies (the CUDA runtime calls that put work on the card, by
    name; the profiler's device records, which lose a few a window, are
    printed beside them); the walls printed side by side, not limited.
    (c) 2 decode
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
21. The dense variants at full width, random packed 8-bit LNS weights
    from seed 0, each serve warmed by its first request for 2 tokens,
    each model's launch counts zeroed before its counted run and read
    after. (a) gemma3-12b (48 layers, d 3840, head_dim 256,
    vocab 262,144, untied; 5:1 local:global, sliding-window rings on the
    local layers) through the serve CLI's engine: phase 4's paged trace,
    then the dense layout: every request completes; every forward
    launches K2 (and K1) once a projection, the head included, K5 once a
    global layer (8; none on the 40 ring layers) and K6 once; the weights'
    packed size and the peak allocated memory printed. (b) Its logits
    through the kernels against the plain versions, as phase 5. (f) 1
    decode step profiled as phase 6, and the device time a step of the
    local layers' plain ring attention beside the global layers' K5.
    (c) gemma3's smoke config (window 8, f32) with the JAX package's
    sliding-window spec test setup (4 mixed requests, 2 slots, max_len
    32, page 8, 8 pages, ondemand): the baseline and k=3 at 7 bits, on
    the card and on the CPU, all four streams equal, no page in use
    after. (d) granite-8b (36 x 4096, tied) and qwen2.5-32b (64 x 5120,
    QKV bias, untied 152,064 head), 4 requests of 16 + 16 tokens, paged,
    with (a)'s checks. (e) One train step of gemma3-12b at full width one
    period deep (6 layers), 4 x 256 tokens, remat on and then off: a
    finite loss, K1, K2 with its wgmma decode pass and K3 once a packed
    leaf; step time and peak memory printed.
22. The modality stubs at full width, random packed 8-bit LNS weights
    from seed 0, each serve warmed by its first request for 2 tokens,
    then counted as 21a counts. (a) phi-3-vision-4.2b (32 layers, d
    3072, 32 heads at head_dim 96, vocab 32,064, untied) paged, 8 x (32
    + 32), 4 slots, page 16: every request completes; K2 (and K1) 225,
    K5 32 and K6 1 launches a forward; the words' size, peak memory,
    TPOT p50 and tok/s printed. (b) One forward 2 layers deep over 576
    stub patches (``models.stubs``) and 64 text tokens, through the
    kernels, the plain versions and an f64-GEMM floor: every position's
    logits within ``LOGIT_RTOL`` of max |logit| (phase 5's rule). (c) One
    train step at full width, 16 of 32 layers, 2 x (576 + 256), remat
    on: a finite loss over the text positions, K3 once a packed leaf, the
    peak printed. (d) musicgen-medium (48 layers, d 1536, 4 codebooks of
    2,048) paged as (a) with (32, 4)-id prompts: every request completes,
    K2 289, K5 48, K6 1 a forward, K6 at 16 rows a decode step (4 at a
    prefill), every token 4 ids; then one request at temperature 0.8
    served alone twice replays token for token, and in each of its K6
    launches its 4 codebook rows carry ``codebook_seed``'s seeds and draw
    pairwise different noise (rerun with ``noise_out``: equal to
    ``ref.gumbel_noise``, the same tokens). (e) One musicgen train step
    at full depth, 4 x 256 x 4: a finite loss, K3 once a packed leaf.
    Then every K1 and K2 shape 22a-22e ran is held to the plain versions
    (``k1_shapes_seen``, ``k2_shapes_seen``); K1 timed at both models'
    decode activations (4 x 3072/8192/1536/6144); K2 at their decode
    GEMMs beside ``torch.matmul`` bf16; K6 greedy, noise-in and seeded at
    16 x 2048 and 4 x 32,064 beside ``torch.argmax``; K3 at 22c's largest
    leaf (up/gate, 49,152 x 8192).
23. The recurrent families at full width, random packed 8-bit LNS
    weights from seed 0, each serve warmed by its first request for 2
    tokens, then counted as 21a counts. (a) rwkv6-1.6b (24 RWKV6 layers,
    d 2048, vocab 65,536, untied), 8 x (32 + 32), 4 slots, with
    ``--page-size 16``: the engine keeps the dense layout and builds no
    allocator (no layer kind pages, as in the JAX engine); every request
    completes; K1 = K2 = 193 (8 a layer and the head), K5 0 and K6 1
    launches a forward; every prefill at the exact prompt length; the
    words' and the state's size, peak memory, TPOT p50 and tok/s
    printed. (b) zamba2-7b (81 layers: 3 Mamba2 layers, then 13 periods
    of 5 Mamba2 layers and the shared attention block with its
    per-occurrence LoRA; head_dim 112, vocab 32,000) paged, page 16, the
    same trace: K2 461 (6 a Mamba2 layer, 4 a shared occurrence, the
    head), K5 13 at head_dim 112, K6 1 a forward, with (a)'s other
    checks. (c) Each model cut to ``RECURRENT_LOGIT_LAYERS`` (rwkv6 4,
    zamba2 7: one shared occurrence): phase 5's kernels-vs-plain logits
    beside the f64 floor, then the training forward's chunked scans
    against a cached prefill's sequential steps over 64 tokens (last
    position, phase 5's rule). (d) One rwkv6 train step at full depth,
    4 x 256, remat on; (e) one zamba2 train step 33 layers deep (3 prefix
    layers, 5 periods), 2 x 256: finite losses, K3 15 and 83 times (one
    a packed leaf), peaks printed. Then every K1 and K2 shape 23a-23e ran
    is held to the plain versions (K2 at N = 64 and 112 among them), K2
    at both models' decode GEMMs beside ``torch.matmul`` bf16, K6 at
    4 x 65,536 and 4 x 32,000 beside ``torch.argmax``, K3 at each train
    step's largest leaf.
24. The mixtures of experts at full width, random packed 8-bit LNS
    weights from seed 0, each serve warmed by its first request for 2
    tokens, then counted as 21a counts; every router call recorded. (a)
    deepseek-v3-671b (MLA: q rank 1536, kv rank 512, nope 128 + rope 64,
    v 128; 256 routed experts top 8 and a shared one; vocab 129,280) cut
    to its 3 dense layers and 2 of its 58 MoE layers (``MOE_SERVE_CUT``:
    at 8 bits a word 671.7e9 parameters do not fit one card), 8 x (32 +
    32), 4 slots, with ``--page-size 16``: the engine keeps the dense
    latent cache and builds no allocator (MLA is never paged, as in the
    JAX engine); every request completes; K1 = K2 = 36 (7 a layer, the
    head), K5 0 and K6 1 launches a forward; the words' size, peak
    memory, TTFT, TPOT p50 and the share of (token, k) assignments
    capacity dropped at prefill and at decode printed. (b) kimi-k2-1t-a32b
    (64 heads over 8 KV heads at head_dim 128, 384 experts, vocab
    163,840) cut to its dense layer and 2 MoE layers, paged, page 16, the
    prefix cache on, the same trace: K1 = K2 = 22, K5 3, K6 1 a forward,
    with (a)'s other checks. (c) Each model at one dense and one MoE
    layer: phase 5's kernels-vs-plain logits beside the f64 floor with
    the count of (token, k) routes on which the paths part by step, each
    step whose routes agree held to ``LOGIT_RTOL``; then a cached prefill
    of 63 tokens and one decode step against the training forward over
    64 (deepseek: MLA's absorbed form from the latent cache against the
    expanded one; Q_A off the attention operands, a capacity that drops
    nothing), the dense layer alone and both layers, the last position
    held where its routes agree. (d) One deepseek train step,
    one MoE layer of 16 experts (top 8 and the shared one kept), MTP on,
    2 x 128, remat on: a finite loss, K3 once a packed leaf (the 4-D
    expert stacks included), the peak and bytes a parameter printed.
    Then every K1 and K2 shape 24a-24d ran is held to the plain versions,
    K2 at both models' decode GEMMs beside ``torch.matmul`` bf16, K6 at
    4 x 129,280 and 4 x 163,840 beside ``torch.argmax``, K3 at 24d's 4-D
    expert leaf (16 x 7168 x 2048).
25. Mesh serving (``repro_torch.distributed``). (a) Shard invariance:
    K2 on each contiguous column block (m = 2 and 4) of qwen2.5-32b's and
    kimi-k2's column-parallel decode GEMMs (``MESH_K2_GEMMS``, skinny and
    one wgmma case), f32 and bf16 out, equals those columns of the whole
    call bit for bit; K5 on each head group (m = 2 and 4) of qwen2.5-32b's
    40 / 8 heads at 128 and gemma3's 16 / 8 at 256, bf16 and packed
    pools, equals those heads of the whole call bit for bit; then the
    shard shapes timed as phase 3 times K2 and K5 (the JSON's
    ``qmatmul_colshard`` and ``paged_attend_headgroup``). (b) An NCCL
    world of one: ``Engine(mesh=)`` on a (1, 1) mesh serves phase 4's
    trace through the serve CLI's engine (``--mesh 1,1``), 8/8, streams
    equal to phase 4's, every kernel of the path launched; then the same
    engine serves 3 streamed completions through ``launch.serve``'s
    gateway path (``run_http``, stopped by the process's own SIGINT):
    each ends 'length', ``/health`` names the mesh, no page left in use.
    ``--mesh`` (four cards; fewer fails): the one-card runs first, on
    card 0 in this process, then one NCCL rank a card (spawned, torchrun's
    environment, one intra-op thread a rank, a 300 s collective timeout)
    runs each through the serve CLI's engine with ``--mesh``, rank 0
    taking the trace. (c) smollm-135m at full width on (2, 2), phase 11's
    trace on demand at k = 4: streams equal one card's. (d) qwen2.5-32b
    at full width and depth on (1, 4), phase 4's trace: streams equal one
    card's; words and peak a rank, TPOT beside one card's, K2/K5
    launches and collectives a forward on each rank, one decode step
    profiled (NCCL's device time, the collective calls' host time, rank
    0's trace to ``chiprun_out/``). (e) kimi-k2 at its dense layer and 8
    MoE layers on (1, 4) (more words than one card holds): 8/8, drops
    at prefill and decode, TPOT, the peak a rank; then phase 24b's cut
    (1 + 2) on (1, 4) beside its one-card run: the streams equal, or the
    first sampled batch where the logits part and its gap are printed.
    Every rank's streams equal rank 0's. Results in
    ``chiprun_out/chip_smoke_mesh.json``.
26. Data-parallel training on four cards (``--mesh``; ``--mesh-train``
    runs this phase alone): each part first takes one card's steps on the
    global batches in this process (card 0), then one NCCL rank a card
    takes the same steps on a (4, 1) mesh (``build_train_step`` under
    ``shard_ctx``, every rank drawing the state from seed 0). (a)
    smollm-135m at full width and depth, lns8, 32 x 256 a step (8 x 256
    a rank), 3 steps, first through ``launch.train --mesh 4,1`` (the
    main path: K1 with a given scale, K2, K3 8 times a step, no retry)
    and then step by step; (b) gemma3-12b at full width, 6 layers deep
    (21e's cut), 4 x 256 (1 x 256 a rank), 2 steps; (c) deepseek-v3 at
    its smoke config (MLA, MoE, MTP, the balance loss), 8 x 64, 3 steps,
    one card's dispatch groups set to 4. Checked every step: every
    rank's checksum of its words and second moments is rank 0's; step
    0's loss within ``DP_STEP0_RTOL`` of one card's, later losses within
    ``TRAIN_LOSS_RTOL`` and grad norms within ``DP_GNORM_RTOL``; (a) and
    (c) words after step 1 apart from one card's on at most
    ``TRAIN_WORD_SHARE``, the differences' sizes printed. Printed: the
    step time (every rank starts a step at a barrier), collectives a step
    by kind, and from one more, profiled step NCCL's device time, the
    c10d calls' host time and count; from one more step (and one more on
    one card), cut into stages at synchronized boundaries, the forward,
    backward, SUM reduce, Q_G and update times and the MAX reduces' host
    time; the peak a rank.

27. Mesh serving completed (``--mesh``; ``--mesh-serve`` runs this phase
    alone). On card 0 first: K2 on every column block (m = 2, 4) of
    rwkv6's ``ck`` (4 x 2048 @ 2048 x 7168) and zamba2's shared
    ``up``/``gate`` (4 x 3584 @ 3584 x 14336) and K5 on every head group
    of zamba2's 32 / 32 heads at 112 (bf16 and packed pools) equal the
    whole calls' columns / heads bit for bit, the model = 4 blocks timed
    (the kernel table's rows); zamba2's LoRA-merged QKV (random packed
    weights, rank 128) merged on each rank's column blocks equals one
    card's merged columns bit for bit, and the dense GEMM on a block is
    compared with the whole GEMM's columns (the reason the port merges
    at the whole width, ``params_sharding.kept_whole``); the one-card runs
    of 27a-c. (a) The gateway on (2, 2): one NCCL rank a card runs
    ``launch.serve.run_http`` over smollm-135m at full width (paged, on
    demand, k = 2), rank 0 serving loopback HTTP, this process the
    client: 8 streamed completions one after another equal one card's
    replay; an idle gap of ``GATEWAY_IDLE_S`` (broadcasts a second and
    rank 0's host cost of one printed); a DELETE after 4 frames ends
    'aborted'; 429 past ``--max-queue``; ``/health`` names the mesh and
    its numerics are one card's (weights exactly, the draft view's mean
    error within 1e-5); ``/metrics`` carries the mesh label; SIGINT to
    every rank: each exits 0 with every page back and rank 0's number of
    broadcasts. (b) rwkv6-1.6b and (c) zamba2-7b at full width and depth
    on (1, 4) through the serve CLI's engine (4 requests of 8 + 16
    tokens, paged at 16: rwkv6 stays dense): greedy streams equal one
    card's; TPOT and TTFT beside one card's, collectives and launches a
    forward, words and peak a rank. Results in
    ``chiprun_out/chip_smoke_mesh*.json``.
28. The dry run (``repro_torch.launch.dryrun``) held to the card. (a) In
    the default run, smollm-135m at full width and depth: train 8 x 4096,
    prefill 4 x 8192 and decode 32 x 32768 over dense caches, each traced
    on ``meta`` (processes of their own started after the build) and run
    once on card 0 under the same cost mode (``launch.cost``): argument
    and output bytes, FLOPs and bytes equal, the modelled peak within
    ``DRY_PEAK_RTOL`` of ``max_memory_allocated`` less what was allocated
    before; a second call's wall beside max(T_compute, T_memory); card 0's
    ``total_memory``. (b) In ``--mesh``, after 25 and 26: qwen2.5-32b
    decode on (1, 4) at full depth dry-run on the fake backend gives 25d's
    words a rank, and its profiled step's gathers and MAX reduces and
    their bytes; smollm-135m's (4, 1) train step gives 26a's last step's
    collectives and bytes; every rank times all-gather and SUM all-reduce
    at 1, 16 and 256 MB (bus bandwidth beside ``NVLINK_BW``).

25c's replicas (ROADMAP H20). In every 25c run each rank also keeps,
for every sampled batch, a digest of the logits and the sampled ids, and
at the end a digest of every pool's null page: the printed line names
the first batch at which two data replicas (ranks 0/2, 1/3) part, if
any, and whether their null pages are equal. ``--mesh-25c`` runs 25c
alone five times in one spawn (each run held to rank 0's and one card's
streams as ``--mesh`` holds it), then once more with the paged write's
last-writer rule turned off (``25c.old``, the write before the repair:
duplicate null-page targets in the card's scatter order), reported and
not checked.
30. Split-KV decode at 524,288 positions (``--mesh-long``, four cards).
    Caches are filled, not prefilled: each block of ``LONG_BLOCK``
    positions of each layer's K and V is drawn on the card from a
    ``torch.Generator`` seeded by (seed, layer, k/v, block), so every
    placement holds the same values and no rank draws more than its
    block; a ring holds its layer's draw of the last ring-size positions,
    recurrent state is zero, every cursor ``LONG_SEQ - LONG_STEPS``.
    Then ``LONG_STEPS`` greedy steps (K6 on the logits) through
    ``build_decode_step``. (a) gemma3-12b at full width and depth, B = 1:
    first one card (card 0, this process) holds the whole cache and
    runs the unsplit path, then one NCCL rank a card runs split-KV on
    (2, 2) (``decode_rules``: the batch of 1 replicated, the positions
    over data and model, 131,072 a rank) on the one card's tokens. (b)
    zamba2-7b at full width and depth, B = 1, on (1, 4): first the
    head-parallel serving placement (``serving_rules``: the shared
    block's cache holds 8 of 32 KV heads a rank), then split-KV (131,072
    positions a rank, every head) on its tokens; one card cannot hold the
    97.7 GB cache. Checked: every rank's tokens are rank 0's; each split
    run's logits within ``LOGIT_RTOL`` of max |logit| of its reference
    run's at every step, its greedy token equal wherever the reference's
    top-2 margin exceeds that (the first closer step printed); K1, K2
    and K6 launched, K6 once a step. Printed: TPOT p50, the peak and the
    cache GB a rank, the merge's collectives a step by kind, count and
    bytes. Then on card 0: K2 at gemma3's M = 1 shapes (the one-card run)
    and at zamba2's (rank 0 of the split run), and K6 at 1 x 262144 and
    1 x 32000, each beside its plain version and ``torch.matmul`` /
    ``torch.argmax``. Results in ``chiprun_out/chip_smoke_mesh_long.json``.

31. JAX's (data, model) placement for prefill and training
    (``--mesh-tp``, four cards; ``sharding.data_rules``: the rows over
    the data axis, the weights on the serving rules, a column-parallel
    leaf a rank's columns). Each part's one-card reference runs first on
    card 0 from the same seed and batches, then one NCCL rank a card.
    (a) smollm-135m at full width and depth, a prefill of 8 x 4096
    tokens (``build_prefill_step(mesh=)``) on (2, 2) and (4, 1): every
    rank's rows of last-position logits hold one card's argmax and lie
    within ``LOGIT_RTOL`` of its max |logit| (bit equality printed); the
    peak a rank and the wall of a second, warm call beside one card's.
    (b) lns8 training, ``TP_STEPS`` steps, every rank drawing its shard
    from seed 0 (``init_train_state(shard=LocalShard)``): smollm-135m at
    full width and depth, 32 x 256, on (1, 4) and (2, 2) (then one
    observed step on (1, 4): K4, whole-leaf stats equal on every rank),
    and granite-8b at full width 12 of 36 layers deep, 8 x 256, on (1, 4)
    (one card must train the reference step). Held with phase 26's
    bounds: step 0 within ``DP_STEP0_RTOL``, losses within
    ``TRAIN_LOSS_RTOL``, grad norms within ``DP_GNORM_RTOL``, the words
    after step 1 (the column shards concatenated; granite's stacked
    leaves at their first layer) within ``TRAIN_WORD_SHARE``; every
    rank's whole leaves and every data group's shards equal after every
    step (checksums); K1, K2, K3 and the model group's gathers and SUMs
    on every step. Printed: the peak a rank against one card's, the step
    walls, the collectives a step by kind and bytes. Then on card 0: K2
    at every column block the parts launched beside its plain version
    and ``torch.matmul``, K1 with a given scale at the (2, 2) shapes,
    K3 and K4 at the largest column shards. Results in
    ``chiprun_out/chip_smoke_mesh_tp.json``.

32. JAX's training placement for the dense family (``--mesh-rp``, four
    cards; ``sharding.train_rules``: phase 31's column blocks, and ``wo``
    and ``down`` a rank's rows, their partial products SUM-reduced over
    the model group; the embedding, an untied head and the logits a
    rank's vocabulary block). lns8, ``TP_STEPS`` steps, every rank
    drawing its shard from seed 0. (a) gemma3-12b at full width 6 of 48
    layers deep, 4 x 256, on (1, 4) and (2, 2), and (b) granite-8b at full
    width 12 of 36 layers deep, 8 x 256, on (1, 4) (then one observed
    step: K4, whole-leaf stats equal on every rank), each held to one
    card's steps as 31b is (step 0 within ``DP_STEP0_RTOL``; row, column
    and vocabulary shards concatenated for the words), with no gather on
    any step. (c) granite-8b at full width and depth (36 layers), 8 x
    256, on (1, 4): one card cannot hold its training state, so its
    reference is one card's forward-only ``lm_loss`` on the same words,
    plain and as m = 2, 4, 8 model ranks compute it (the row blocks' SUM
    reorders the forward, and at 36 layers one card's own orders lie
    ~2e-4 apart); step 0 within ``DP_STEP0_RTOL`` of their range, the
    ranks equal after every step, every loss and grad norm finite, the
    peak a rank under 80 GB. In every part, step 0's first ``wo`` and
    ``down`` SUMs on every rank within ``RP_SUM_RTOL`` of the rank-order
    f32 sum of the partials recomputed from the rank's own inputs, and
    the same partials rounded to bf16 (the control) beyond it. Printed:
    the peak a rank (and the draw's), the step walls, the collectives a
    step by kind and bytes. Then on card 0: K2 at every row block and
    vocabulary block the parts launched beside its plain version and
    ``torch.matmul``, K1 with a given scale at the row blocks' inputs, K3
    at the largest row and vocabulary shards, K4 at 32b's row shard.
    Results in ``chiprun_out/chip_smoke_mesh_rp.json``.

Phase 21d serves qwen2.5-32b at the depth ``SERVE_DEPTH_CUT`` gives (32
of its 64 layers), at full width, to keep the run inside its time limit.

The next-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Full results also go to
``chiprun_out/chip_smoke.json``. Nothing here imports JAX.
"""
import collections
import contextlib
import gc
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
# FLOP/s, f32 FLOP/s outside the tensor cores (``launch.roofline``), and
# each kernel's operations and bytes (``kernels.costs``); neither module
# imports torch. Without the repo beside the script main() refuses to run
sys.path.insert(0, str(SRC))
try:
    from repro_torch.kernels import costs
    from repro_torch.launch.roofline import F32_FLOPS
    from repro_torch.launch.roofline import HBM_BW as HBM_BPS
    from repro_torch.launch.roofline import PEAK_FLOPS as BF16_FLOPS
except ImportError:
    costs = HBM_BPS = BF16_FLOPS = F32_FLOPS = None

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
# K1 with a given scale (phase 3): smollm's and gemma3's training rows
K1_GIVEN_SHAPES = [(2048, 576), (1024, 3840)]
TRAIN_LOSS_RTOL = 5e-4
TRAIN_WORD_SHARE = 0.10
TRAIN_STEPS = 6
TRAIN_ARGV = ["--arch", "smollm-135m", "--steps", str(TRAIN_STEPS),
              "--batch", "8", "--seq", "256"]

SERVE_PAGED = ["--requests", "8", "--slots", "4", "--prompt-len", "32",
               "--gen-len", "32", "--page-size", "16"]
SERVE_DENSE = ["--requests", "4", "--slots", "4", "--prompt-len", "32",
               "--gen-len", "8"]
# phase 11: phase 4's paged trace cut to 4 requests (one batch of the 4
# slots) of 32 + 16 tokens, with speculation, by run name; the first run
# is the reference the others are held to
SPEC_SERVE = ["--requests", "4", "--slots", "4", "--prompt-len", "32",
              "--gen-len", "16", "--page-size", "16"]
SPEC_K = 4
# phase 13 profiles this many spec cycles (2 before the recurrent slice)
SPEC_PROFILE_CYCLES = 1
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
# K8's bound counts what the function needs, not what the kernel does
# (``kernels.costs.lns_matmul_packed``: per product an add, one
# shared-memory load, a sign apply and an accumulate). Integer ops issue
# at up to 128 lanes per SM per clock (4 schedulers x 32: adds and shifts
# go to the INT32 pipe and, as IMAD forms, to the FMA pipe); shared-memory
# loads at 32 per SM per clock (32 four-byte banks). SMs and the maximum
# SM clock are read from the card.
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
APPROX_EXTRA_STEPS = 0
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
FP8_STEPS = 2
FP8_TRAIN_ARGV = ["--arch", "smollm-135m", "--format", "fp8", "--steps",
                  str(FP8_STEPS), "--batch", "8", "--seq", "256"]
BERT_BATCH, BERT_SEQ = 8, 384
FIG7_STEPS = 2
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
# step and the windows: a warm one, OBS_WINDOWS observer off and on, the
# blocked one); 20d trains OBS_TRAIN_STEPS steps of 8 x 256. Since the
# recurrent slice 2 steps a window and one off/on pair (3 steps and two
# pairs before), to make room for phase 23
OBS_DECODE_STEPS = 2
OBS_GEN = 28
OBS_WINDOWS = (False, True)
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
# phase 21: granite-8b's and qwen2.5-32b's paged trace (4 slots, page 16)
# serve runs cut in depth (at full width) to keep the default run inside
# its time limit: the layers each runs (qwen2.5-32b's full depth is 64)
SERVE_DEPTH_CUT = {"qwen2.5-32b": 32}
VARIANT_SERVE = ["--requests", "4", "--slots", "4", "--prompt-len", "16",
                 "--gen-len", "16", "--page-size", "16"]
# 21f profiles this many gemma3-12b decode steps (3 before the recurrent
# slice)
VARIANT_PROFILE_STEPS = 1
# gemma3-12b's decode GEMMs (M = 4 slots): wq, wk/wv, wo, up/gate, down,
# the untied head
GEMMA3_DECODE_GEMMS = [(4, 3840, 4096), (4, 3840, 2048), (4, 4096, 3840),
                       (4, 3840, 15360), (4, 15360, 3840), (4, 3840, 262144)]
# K5 at gemma3-12b's global layers (16 heads over 8 KV heads, head_dim
# 256), phase 3 and --dense-variants
K5_HD256 = (16, 8, 256)
K5_HD256_CASES = [
    ("gemma3 decode bf16 pool hd 256", 4, 1, [33, 48, 61, 66], False,
     K5_HD256),
    ("gemma3 decode packed pool hd 256", 4, 1, [33, 48, 61, 66], True,
     K5_HD256),
    ("gemma3 verify bf16 pool hd 256", 4, SPEC_K, [36, 45, 52, 63], False,
     K5_HD256),
    ("gemma3 decode empty warps hd 256", 4, 1, [9, 1, 16, 5], True,
     K5_HD256),
    # two stages a warp exceed 227 KB here: one stage a warp
    ("gemma3 decode f32 pool page 16 hd 256", 2, 1, [60, 70], False,
     K5_HD256, {"pool": "float32"})]
# K5 at phi-3-vision-4.2b's layers (32 heads over 32 KV heads, head_dim
# 96), phase 3 and --modality
K5_HD96 = (32, 32, 96)
K5_HD96_CASES = [
    ("phi-3-vision decode bf16 pool hd 96", 4, 1, [33, 48, 61, 66], False,
     K5_HD96),
    ("phi-3-vision decode packed pool hd 96", 4, 1, [33, 48, 61, 66], True,
     K5_HD96),
    ("phi-3-vision verify bf16 pool hd 96", 4, SPEC_K, [36, 45, 52, 63],
     False, K5_HD96),
    ("phi-3-vision verify packed pool hd 96", 4, SPEC_K, [36, 45, 52, 63],
     True, K5_HD96),
    ("phi-3-vision decode empty warps hd 96", 4, 1, [9, 1, 16, 5], True,
     K5_HD96),
    ("phi-3-vision decode f32 pool hd 96", 2, 1, [60, 70], False, K5_HD96,
     {"pool": "float32"})]
# K5 at zamba2-7b's shared attention (32 heads over 32 KV heads, head_dim
# 112), phase 3 and --recurrent (zamba2 cannot speculate: no verify case)
K5_HD112 = (32, 32, 112)
K5_HD112_CASES = [
    ("zamba2 decode bf16 pool hd 112", 4, 1, [33, 48, 61, 66], False,
     K5_HD112),
    ("zamba2 decode packed pool hd 112", 4, 1, [33, 48, 61, 66], True,
     K5_HD112),
    ("zamba2 prefill bf16 pool hd 112", 1, 32, [32], False, K5_HD112),
    ("zamba2 decode empty warps hd 112", 4, 1, [9, 1, 16, 5], True,
     K5_HD112),
    ("zamba2 decode f32 pool hd 112", 2, 1, [60, 70], False, K5_HD112,
     {"pool": "float32"})]
# phase 23: the decode GEMMs (M = 4 slots) of rwkv6-1.6b (wr/wk/wv/wg/wo
# and cr, ck, cv, the head) and zamba2-7b (z/x_proj, b/c_proj, dt_proj,
# out_proj, the shared block's wo, up/gate and down, the head)
RWKV_DECODE_GEMMS = [(4, 2048, 2048), (4, 2048, 7168), (4, 7168, 2048),
                     (4, 2048, 65536)]
ZAMBA2_DECODE_GEMMS = [(4, 3584, 7168), (4, 3584, 64), (4, 3584, 112),
                       (4, 7168, 3584), (4, 3584, 3584), (4, 3584, 14336),
                       (4, 14336, 3584), (4, 3584, 32000)]
# 23c: the kernel-vs-plain logits and the chunked-vs-sequential check at
# a cut depth (zamba2 keeps its first prefix layer and one period, so one
# shared-block occurrence); 23e: zamba2 trains 33 of 81 layers (3 prefix
# mamba layers and 5 periods: at ~19 B a parameter 81 layers pass 80 GB,
# ROADMAP 6.7)
RECURRENT_LOGIT_LAYERS = {"rwkv6-1.6b": 4, "zamba2-7b": 7}
RECURRENT_SEQ_TOKENS = 64
ZAMBA2_TRAIN_LAYERS = 33
RECURRENT_TRAIN = {"rwkv6-1.6b": (24, 4, 256),
                   "zamba2-7b": (ZAMBA2_TRAIN_LAYERS, 2, 256)}
# phase 22: the decode GEMMs (M = 4 slots) of phi-3-vision (wq/wk/wv/wo,
# up/gate, down, the untied head) and musicgen-medium (the same, ungated)
PHI3V_DECODE_GEMMS = [(4, 3072, 3072), (4, 3072, 8192), (4, 8192, 3072),
                      (4, 3072, 32064)]
MUSICGEN_DECODE_GEMMS = [(4, 1536, 1536), (4, 1536, 6144), (4, 6144, 1536),
                         (4, 1536, 8192)]
# 22b: phi-3-vision's forward over the stub's patches and 64 text tokens,
# cut to 2 of its 32 layers: over 640 positions the f64-accumulation
# floor alone moves the random model's logits by 15.2% of max |logit| at
# full depth and 11.7% at 8 layers, near or past LOGIT_RTOL, so no kernel
# error could show there (PERF.md, phase 22);
# 22c: its train step, cut to half depth (the store, its moments and the
# update's new copies of 32 layers would pass 80 GB: ROADMAP 6.7)
# phase 24: the mixtures of experts at full width. At 8 bits a word the
# full depths (671.7e9 and 1027.9e9 parameters) do not fit one card:
# deepseek-v3 serves its 3 dense layers and 2 of its 58 MoE layers
# (27.3e9 parameters with the MTP module the tree carries), kimi-k2 its
# dense layer and 2 of its 60 MoE layers (36.7e9)
MOE_SERVE_CUT = {"deepseek-v3-671b": dict(num_layers=5),
                 "kimi-k2-1t-a32b": dict(num_layers=3)}
# 24c: kernels vs plain at one dense and one MoE layer each
MOE_LOGIT_CUT = dict(num_layers=2, num_dense_layers=1)
MOE_SEQ_TOKENS = 64
# 24d: one deepseek MoE layer (no dense layer) with 16 of its 256
# experts (top-8 and the shared expert kept), MTP on, 2 x 128 tokens:
# 3.48e9 parameters, at ~18-19 B a parameter (ROADMAP 6.7) ~65 GB
MOE_TRAIN = ("deepseek-v3-671b", 1, 2, 128,
             dict(num_dense_layers=0, num_experts=16))
# K5 at kimi-k2's GQA: 64 query heads over 8 KV heads (8 a KV head, two
# 4-row tiles a group), head_dim 128
K5_KIMI = (64, 8, 128)
K5_KIMI_CASES = [
    ("kimi-k2 decode bf16 pool rep 8", 4, 1, [33, 48, 61, 66], False,
     K5_KIMI),
    ("kimi-k2 decode packed pool rep 8", 4, 1, [33, 48, 61, 66], True,
     K5_KIMI)]
# the decode GEMMs (M = 4 slots): deepseek's MLA (q_down, q_up, kv_down,
# wo), dense MLP (up/gate, down), shared expert (up/gate, down), head;
# kimi's attention (wq, wk/wv, wo), dense MLP = shared expert, head
DEEPSEEK_DECODE_GEMMS = [(4, 7168, 1536), (4, 1536, 24576), (4, 7168, 576),
                         (4, 16384, 7168), (4, 7168, 18432),
                         (4, 18432, 7168), (4, 7168, 2048), (4, 2048, 7168),
                         (4, 7168, 129280)]
KIMI_DECODE_GEMMS = [(4, 7168, 8192), (4, 7168, 1024), (4, 8192, 7168),
                     (4, 7168, 2048), (4, 2048, 7168), (4, 7168, 163840)]
PHI3V_TEXT = 64
PHI3V_LOGIT_LAYERS = 2
PHI3V_TRAIN_LAYERS = 16
PHI3V_TRAIN_SEQ = 256
MUSICGEN_TRAIN_SEQ = 256
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


def device_kernels(torch, fn, tries=6):
    """Names of the device kernels one call of ``fn`` runs, from
    torch.profiler's device events. A capture holding no device event at
    all (CUPTI recorded nothing, as a run's first captures on one H100
    machine did, three in a row once) is taken again a second later, up
    to ``tries`` captures in all."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(tries):
        if i:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def k1_one_launch(torch, ops, fmt):
    """One ``ops.encode_pack`` call issues K1's own kernel and no torch
    kernel, per tensor and per row (torch.profiler's device events)."""
    res = {}
    for R, C, axis in ((4, 1536, None), (2048, 1536, None),
                       (2048, 1536, 0)):
        x = torch.randn((R, C), device="cuda").to(torch.bfloat16)
        ops.encode_pack(x, fmt, axis)
        torch.cuda.synchronize()
        names = device_kernels(torch, lambda: ops.encode_pack(x, fmt, axis))
        check(names, "K1: the profiler saw no device event")
        check(len(names) == 1 and names[0].startswith("void k1_"),
              f"K1 {R}x{C} (scale_axis={axis}): one call ran {names}")
        res[f"{R}x{C}/{axis}"] = names
    print(f"K1 one launch a call: {res}")
    return res


def k1_given_check(torch, ops, ref, fmt, shapes=K1_GIVEN_SHAPES):
    """K1 with a given scale (``encode_pack(scale=)``, a data-parallel
    rank's global scale): per tensor and per row, at the scale equal to
    the tensor's own absmax scale and at 2^4 above it, words and scale
    rows equal to the plain version's bit for bit; one device kernel a
    call (its own); timed beside the self-scaled launch."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    rows = []
    for R, C in shapes:
        x = (torch.randn((R, C), generator=gen, device="cuda") * 3.0
             ).to(torch.bfloat16)
        for axis in (None, 0):
            own = ref.row_scale(x, axis)
            own = own[:1] if axis is None else own
            for mult in (1.0, 16.0):
                s = (own * mult).contiguous()
                kw, ks = ops.encode_pack(x, fmt, axis, scale=s)
                pw, ps = ref.encode_pack(x, fmt, axis, scale=s)
                check(torch.equal(kw, pw) and torch.equal(ks, ps),
                      f"K1 given scale {R}x{C} (scale_axis={axis}, x{mult:g})"
                      f": {int((kw != pw).sum())} words differ from the "
                      f"plain version")
            torch.cuda.synchronize()
            names = device_kernels(
                torch, lambda: ops.encode_pack(x, fmt, axis, scale=s))
            check(len(names) == 1 and names[0].startswith("void k1_"),
                  f"K1 given scale {R}x{C} (scale_axis={axis}): one call "
                  f"ran {names}")
            c = costs.encode_pack(R, C, x.element_size(),
                                  scale_numel=s.numel())
            b, by = bound_ms(c.bytes, c.ops, F32_FLOPS)
            rows.append(dict(
                shape=[R, C], scale_axis=axis, kernels=names,
                ms=cuda_ms(torch, lambda: ops.encode_pack(x, fmt, axis,
                                                          scale=s)),
                self_ms=cuda_ms(torch, lambda: ops.encode_pack(x, fmt, axis)),
                plain_ms=cuda_ms(torch, lambda: ref.encode_pack(
                    x, fmt, axis, scale=s)),
                bound_ms=b, bound_by=by, library_ms=None, max_abs_err=0))
            r = rows[-1]
            print(f"K1 given scale {R}x{C} (scale_axis={axis}): words and "
                  f"scales equal the plain version's at 1x and 16x the own "
                  f"scale, one kernel a call ({names[0][:40]}), "
                  f"{r['ms']:.4f} ms beside the self-scaled {r['self_ms']:.4f}"
                  f" ms, plain {r['plain_ms']:.4f} ms, bound {b:.5f} ms ({by};"
                  f" {b / r['ms']:.1%})")
    return rows


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
        c = costs.encode_pack(R, C, x.element_size())
        b, by = bound_ms(c.bytes, c.ops, F32_FLOPS)
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
def k1_shapes_seen(torch, ops):
    """Record every K1 call's (R, C, dtype, scale_axis) while the main
    paths run (the wrapper still counts every launch itself)."""
    seen = collections.Counter()
    launch = ops.encode_pack

    def record(x, fmt, scale_axis=None, scale=None):
        seen[(x.shape[0], x.shape[1], x.dtype, scale_axis)] += 1
        return launch(x, fmt, scale_axis, scale)

    ops.encode_pack = record
    try:
        yield seen
    finally:
        ops.encode_pack = launch


def k1_driven_check(torch, ops, ref, fmt, seen):
    """Every (R, C, dtype, scale_axis) that K1 took on the main paths
    (``k1_shapes_seen``), on fresh random inputs: scales equal and words
    equal away from the near-half ties (``k1_pair``)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    ties = 0
    for R, C, dt, axis in sorted(seen, key=str):
        x = (torch.randn((R, C), generator=gen, device="cuda") * 3.0).to(dt)
        ties += k1_pair(torch, ops, ref, x, fmt, axis,
                        f"driven {R}x{C} {dt} axis={axis}")[0]
    print(f"K1 on the main paths: {len(seen)} distinct shapes "
          f"({sum(seen.values())} calls), scales equal and words equal "
          f"away from the ties ({ties} words at ties)")
    return {"shapes": [[R, C, str(dt), axis, n] for (R, C, dt, axis), n
                       in sorted(seen.items(), key=str)],
            "tie_words": ties}


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
        # (a weight past 100 MB misses the L2 on its own: two copies)
        n_buf = (max(64, -(-100_000_000 // (K * N)))
                 if K * N <= 100_000_000 else 2)
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

        c = costs.qmatmul(M, K, N, odt.itemsize)
        b, by = bound_ms(c.bytes, c.ops,
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
        # (a weight past 100 MB misses the L2 on its own: two copies)
        n_buf = (max(64, -(-100_000_000 // (K * N)))
                 if K * N <= 100_000_000 else 2)
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
        c = costs.qmatmul_decode(M, K, N, want[0].numel(), want[1].numel())
        b, by = bound_ms(c.bytes, c.ops, F32_FLOPS)
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
        dt = getattr(torch, pool) if isinstance(pool, str) else (
            pool or torch.bfloat16)
        kp = torch.randn((P, PAGE, KV, HD), generator=gen, device="cuda").to(
            dt)
        vp = torch.randn((P, PAGE, KV, HD), generator=gen, device="cuda").to(
            dt)
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
        c = costs.paged_attend(B, S, H, HD, KV, kp.shape[1], bt.shape[1],
                               [int(n) for n in lengths],
                               q_bytes=q.element_size(),
                               pool_bytes=kp.element_size(), packed=packed)
        b, by = bound_ms(c.bytes, c.ops, BF16_FLOPS)
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
    lg[0, 100] = lg[0, 20000 if V > 20000 else V - 1] = 50.0
    u = torch.rand((B, V), generator=gen, device="cuda").clamp_min(1e-30)
    gum = -torch.log(-torch.log(u))
    temp = np.array([0.0] + [0.7 + 0.2 * (b % 4) for b in range(1, B)],
                    np.float32)
    seed = np.arange(100, 100 + B, dtype=np.uint32) * np.uint32(2654435761)
    step = np.array([3 * b % 7 for b in range(B)], np.int32)
    return lg, gum, temp, seed, step


def k6_check(torch, ops, ref, shapes=((4, 49152), (16, 49152))):
    """K6 against its plain version at each ``(B, V)`` (by default the
    decode batch, 4 x 49152, and the verify's, 16 x 49152), greedy,
    noise-in (the TPU kernel's function, noise fed in) and seeded (noise
    drawn in the kernel): tokens equal; the seeded noise_out equal to
    ``ref.gumbel_noise`` on the card and within ``K6_NOISE_ATOL`` of it
    on the CPU."""
    import numpy as np
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for B, V in shapes:
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
            c = costs.fused_sample(B, V, name, lg.element_size())
            b, by = bound_ms(c.bytes, c.ops, F32_FLOPS)
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
        c = costs.requant_pack(n_view)
        b, by = bound_ms(c.bytes, c.ops, F32_FLOPS)
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
            c = costs.requant_pack(n)
            b, by = bound_ms(c.bytes, c.ops, F32_FLOPS)
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
        c = costs.madam_step(R * C, w.element_size(), g.element_size())
        b, by = bound_ms(c.bytes, c.ops, F32_FLOPS)
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
    the allocator), ``"short"`` only its first request for 2 tokens (the
    prefill bucket and the decode step's shapes); without it the measured
    run also builds the engine's draft views, whose K7 launches it then
    counts."""
    from repro_torch.launch.serve import build_engine, parser
    from repro_torch.serving import synthetic_trace

    args = parser().parse_args(argv)
    engine = build_engine(args)
    trace = lambda: synthetic_trace(engine.cfg, requests=args.requests,
                                    prompt_len=args.prompt_len,
                                    gen_len=args.gen_len, seed=args.seed)
    if warm == "short":
        first = trace()[0]
        first.max_new_tokens = 2
        engine.run([first])
        engine.reset()
    elif warm:
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


def spec_serve(torch, ops):
    """Phase 11: ``SPEC_SERVE`` (4 requests of 32 + 16 tokens, paged)
    with speculation (and the ondemand runs) at full width,
    each held to the streams of the first run, the non-speculating
    reserve engine. That engine runs first and last, unwarmed like the
    rest, and tok/s ratios are taken to the mean of those two runs:
    host-bound times drift within one call."""
    runs, engines = {}, {}
    n_req = int(SPEC_SERVE[SPEC_SERVE.index("--requests") + 1])
    base_streams = None
    for name, extra in SPEC_RUNS:
        with k5_query_rows(ops) as seen:
            agg, eng, counts = serve(torch, SPEC_SERVE + extra, ops,
                                     warm=False)
        got = streams(eng)
        base_streams = base_streams or got
        check(agg["completed"] == n_req, f"{name}: completed "
              f"{int(agg['completed'])}/{n_req} requests")
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
            same_as_baseline=len(same) / len(base_streams),
            first_divergence=min(first) if first else None)
        runs[name] = r
        sp = r["spec"] or {}
        print(f"{name}: completed {n_req}/{n_req}, "
              f"{agg['tokens_per_s']:.2f} tok/s, "
              f"tpot p50 {agg['tpot_p50_s'] * 1e3:.1f} "
              f"ms, ttft mean {agg['ttft_mean_s'] * 1e3:.1f} ms; accept "
              f"rate {sp.get('spec_accept_rate')}, cycles "
              f"{sp.get('spec_cycles')}, fallbacks "
              f"{sp.get('spec_fallbacks')}, decode steps "
              f"{eng.decode_steps}; streams equal to the baseline's for "
              f"{len(same)}/{n_req} (first divergence at token "
              f"{r['first_divergence']}); K7 {counts['requant_pack']}, "
              f"K5 by S {dict(seen)}, preemptions {eng.preemptions}")
        engines[name] = eng
    for name in ("ondemand", "spec_k1_b6", "baseline_end"):
        check(runs[name]["same_as_baseline"] == 1.0,
              f"{name}: streams differ from the baseline's (first "
              f"divergence at token {runs[name]['first_divergence']})")
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
          "a decode step's B rows, so a k=4 stream may leave the baseline's "
          "at a near-tie; k=1, the ondemand engine and a second baseline "
          "engine may not")
    return runs, engines["spec_b6"]


@contextlib.contextmanager
def k1_scales(ops):
    """Record the per-tensor activation scale of every K1 call."""
    seen = []
    launch = ops.encode_pack

    def record(x, fmt, scale_axis=None, given=None):
        packed, scale = launch(x, fmt, scale_axis, given)
        seen.append(float(scale[0, 0]))
        return packed, scale

    ops.encode_pack = record
    try:
        yield seen
    finally:
        ops.encode_pack = launch


def verify_coupling(torch, ops, cycles=4):
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
    """Phase 13: wall and device time of ``SPEC_PROFILE_CYCLES``
    speculative cycles of the B=6 engine (its draft view already
    built)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import synthetic_trace

    n = SPEC_PROFILE_CYCLES
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
        for _ in range(n):
            engine.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    check(engine.spec_cycles - c0 == n and engine.decode_steps == d0,
          f"profile: the {n} steps were not {n} speculative cycles")
    busy_us, top = device_time(torch, prof, 8)
    share = busy_us / 1e6 / wall if busy_us else None
    print(f"profile, {n} spec cycles (k={SPEC_K}, B=6): wall "
          f"{wall * 1e3 / n:.1f} ms/cycle = "
          f"{wall * 1e3 / n / decode_ms:.2f} decode steps, device busy "
          + (f"{busy_us / n / 1e3:.2f} ms/cycle ({share:.1%})" if busy_us
             else "not measured (no device time in the trace)"))
    for e in top:
        print(f"  {e.key[:60]}: {e.self_device_time_total / n / 1e3:.3f} "
              f"ms/cycle, {e.count // n} calls/cycle")
    shares = kernel_shares(torch, prof, busy_us, n, "cycle")
    return {"wall_ms_per_cycle": wall * 1e3 / n, "k2_k5": shares,
            "cycle_over_decode_step": wall * 1e3 / n / decode_ms,
            "device_busy_ms_per_cycle": busy_us / n / 1e3 if busy_us else None,
            "device_busy_share": share,
            "top": [[e.key, e.self_device_time_total / n / 1e3, e.count // n]
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


def logits_check(torch, engine, steps=4):
    """Phase 5: batch-1 prefill + ``steps`` greedy decode steps at full
    width, through the kernels, through the plain versions, and through
    the plain versions with an f64-accumulating GEMM (the noise
    floor)."""
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
        for _ in range(steps):
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
    print(f"full-width logits over {steps + 1} steps: kernels vs plain "
          f"max err "
          f"{worst:.4f} of max |logit| (limit {LOGIT_RTOL}); floor (plain, "
          f"f64 GEMM accumulation) {floor:.4f}; greedy tokens checked on "
          f"{clear} steps whose margin exceeds the limit")
    return {"max_rel_err": worst, "floor_rel_err": floor,
            "margin_steps": clear}


def averages(prof):
    """``prof.key_averages()``, aggregated once a profile: each call
    walks every event of the trace again, and the helpers below read the
    same trace up to five times."""
    avg = getattr(prof, "_averages", None)
    if avg is None:
        avg = prof._averages = prof.key_averages()
    return avg


def device_time(torch, prof, n_top, exclude=()):
    """Total kernel time (us) in a profile and its ``n_top`` kernels. Only
    device events count: a CPU op's self device time repeats the time of
    the kernels it launched, so summing both would count them twice.
    ``exclude``: names of profiler ranges, whose device-side annotations
    span the kernels inside them."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in averages(prof)
               if e.device_type == cuda and e.key not in exclude]
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
        evs = [e for e in averages(prof)
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


def launch_split(torch, prof, per, n_top=8, exclude=()):
    """Device work items per ``per`` in a profile: the port's kernels,
    torch's kernels, memcpy/memset operations, and torch's ``n_top``
    kernels by launches (``exclude`` as in ``device_time``)."""
    cuda = torch.autograd.DeviceType.CUDA
    n = {"port": 0, "torch": 0, "copies": 0}
    torch_k = []
    for e in averages(prof):
        if e.device_type != cuda or e.key in exclude:
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

    def scale_first(x, fmt, scale_axis=None, scale=None):
        ref.row_scale(x, scale_axis)
        return launch(x, fmt, scale_axis, scale)

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
          f"per product {costs.K8_ALU_OPS_PER_PRODUCT} integer ops at "
          f"{ISSUE_LANES_PER_SM} lanes/SM/clock "
          f"({rates['int_ops_per_s']:.4g} op/s) and 1 shared-memory load "
          f"at {SMEM_LOADS_PER_SM}/SM/clock "
          f"({rates['smem_loads_per_s']:.4g} load/s), the same at every "
          f"LUT size")

    def bound(M, K, N):
        c = costs.lns_matmul_packed(M, K, N)
        t_b = c.bytes / HBM_BPS * 1e3
        t_o = max(c.ops / rates["int_ops_per_s"],
                  c.smem_loads / rates["smem_loads_per_s"]) * 1e3
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
            b, _ = bound_ms(costs.encode_pack(R, C, x.element_size()).bytes,
                            0, 1)
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
        c = costs.madam_step_unpacked(R * C, code.element_size(),
                                      g.element_size())
        b_ms, by = bound_ms(c.bytes, c.ops, F32_FLOPS)
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

    def fn(eq, x, w, cfg, x_scale=None):
        import torch
        _, xq, wq = quant_training.approx_value(eq, x, w, cfg, x_scale)
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
    marks = [("start", time.monotonic())]

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
    marks.append(("steps", time.monotonic()))

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
          + (f"; LUT-1 step {sum(r['step_s'] for r in extra) / len(extra):.3f}"
             f" s over the last {len(extra)}" if extra else ""))
    check(rel <= APPROX_LOSS_RTOL,
          f"LUT-8 loss differs from the exact fake-quant loss by {rel}")
    for lut in (4, 2, 1):
        check(rels[lut] > APPROX_LOSS_RTOL,
              f"control: the LUT-{lut} loss is within {APPROX_LOSS_RTOL} of "
              f"the exact fake-quant loss ({rels[lut]}), so the check cannot "
              f"tell LUT {lut} from the exact conversion")
    marks.append(("forward losses", time.monotonic()))
    parts = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    print("phase 17 took " + ", ".join(f"{k} {v:.1f}s"
                                       for k, v in parts.items()))
    return dict(runs=runs, forward_loss={str(k): v for k, v in fwd.items()},
                forward_rel={str(k): v for k, v in rels.items()},
                exact_fq_loss=exact, floor_loss=floor, lut8_rel=rel,
                floor_rel=rel_floor, seconds_by_part=parts)


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
    and ``madam_fp``, 2 steps each. Finite losses, no kernel launched,
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
    parts = {}

    def run(step, fn, summary):
        t = time.monotonic()
        res = fn()
        parts[step] = time.monotonic() - t
        print(json.dumps({"phase18": step, "s": parts[step],
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
    out["seconds_by_part"] = parts
    print(f"phase 18 took {out['seconds']:.1f}s ("
          + ", ".join(f"{k} {v:.1f}s" for k, v in parts.items()) + ")")
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
    """20a: the serve CLI's engine over ``argv``'s paged trace with an
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
    a warm window, then observer and kernel_stats off and on (the
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
                                    for e in averages(prof)
                                    if e.device_type != cuda
                                    and e.key in OBS_WORK_CALLS})

    window(False)              # warm: the profiler's first window
    walls, work, calls = {"off": [], "on": []}, [], []
    for on in OBS_WINDOWS:
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
        evs = [e for e in averages(prof) if e.device_type == cuda
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
        # phase 11's trace (phase 4's, 8 x (32 + 32), before the recurrent
        # slice)
        spec_engine, spec = obs_serve(
            torch, ops, SPEC_SERVE + ["--speculate-k", str(SPEC_K),
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


# ---------------------------------------------------------------------------
# phase 21: the dense variants (gemma3-12b, granite-8b, qwen2.5-32b)


def packed_bytes(params):
    """Bytes of a serving tree: packed words and scales, and the f32
    leaves."""
    from repro_torch.core.lns import is_lns_weight
    from repro_torch.tree import leaves
    n = 0
    for _, x in leaves(params):
        n += (x.packed.nbytes + x.scale.nbytes) if is_lns_weight(x) \
            else x.nbytes
    return n


# K2 launches of one layer of each kind: attention's four projections
# and the MLP's two or three; rwkv's eight (r, k, v, g, o; ck, cv, cr);
# mamba's six (z, x, B, C, dt, out); the shared block's wo and MLP (its
# QKV is decoded plus the occurrence's LoRA delta: the fake-quant leg)
def _kind_gemms(cfg, kind):
    mlp = 2 + cfg.mlp_gated
    if kind == "moe":    # attention's four (MLA's cached form: q_down,
        # q_up, kv_down, wo) and the shared expert's three; the routed
        # experts' stacks are decoded, not packed GEMMs
        return 4 + (3 if cfg.num_shared_experts else 0)
    return {"rwkv": 8, "mamba": 6, "shared_attn": 1 + mlp}.get(kind, 4 + mlp)


def _kinds(cfg):
    prefix, n_periods, period = cfg.layer_pattern()
    return list(prefix) + list(period) * n_periods


def gemms_per_forward(cfg):
    """K2 launches of one forward: every packed projection of every
    layer, and an untied head (a tied head is a decoded matrix, not
    packed)."""
    return (sum(_kind_gemms(cfg, k) for k in _kinds(cfg))
            + (not cfg.tie_embeddings))


def k5_layers(cfg):
    """Layers whose attention pages through K5: the full-context kinds
    (not gemma3's ring layers, not the recurrent ones; none under MLA,
    whose latent cache is never paged)."""
    if cfg.use_mla:
        return 0
    return sum(k in ("dense", "global", "shared_attn", "moe")
               for k in _kinds(cfg))


def variant_serve(torch, ops, arch, argv, tag, phase="21"):
    """One full-width serve of ``arch`` through the serve CLI's engine
    (a warm run, then the counted one); returns the summary row and the
    engine. Every request completes, and every forward launches K2 on
    every projection (the head included when untied), K5 once a
    full-context layer (none on ring layers), and K6 once a sampled
    token (all of a step's rows, every codebook's, in one launch).
    ``phase`` labels the lines (21, 22, 23). The warm-up is the trace's first
    request for 2 tokens (``serve``'s ``"short"``). An arch in
    ``SERVE_DEPTH_CUT`` serves at that depth."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    depth = SERVE_DEPTH_CUT.get(arch)
    with (cut_config(arch, num_layers=depth) if depth
          else contextlib.nullcontext()):
        agg, engine, counts = serve(torch, ["--arch", arch] + argv, ops,
                                    warm="short")
    secs = time.monotonic() - t0
    cfg = engine.cfg
    n_req = int(argv[argv.index("--requests") + 1])
    check(agg["completed"] == n_req,
          f"{phase} {tag}: {int(agg['completed'])}/{n_req} requests "
          f"completed")
    fwd = engine.decode_steps + engine.prefills
    full_ctx = k5_layers(cfg)
    paged = engine.page_size is not None
    want = {"qmatmul": gemms_per_forward(cfg) * fwd,
            "paged_attend": full_ctx * fwd if paged else 0,
            "fused_sample": fwd}
    for k, n in want.items():
        check(counts[k] == n, f"{phase} {tag}: {k} launched {counts[k]} "
              f"times, "
              f"expected {n} ({fwd} forwards)")
    check(counts["encode_pack"] == counts["qmatmul"],
          f"{phase} {tag}: K1 launched {counts['encode_pack']} times for "
          f"{counts['qmatmul']} K2 GEMMs")
    peak = torch.cuda.max_memory_allocated()
    size = packed_bytes(engine.params)
    row = {"arch": arch, "layout": "paged" if paged else "dense",
           "completed": int(agg["completed"]),
           "tokens_per_s": agg["tokens_per_s"],
           "ttft_mean_ms": agg["ttft_mean_s"] * 1e3,
           "tpot_p50_ms": agg["tpot_p50_s"] * 1e3,
           "decode_steps": engine.decode_steps, "prefills": engine.prefills,
           "launches": counts, "k5_layers_a_forward": full_ctx if paged
           else 0, "weights_gb": size / 1e9, "peak_gb": peak / 1e9,
           "seconds": secs}
    row["num_layers"] = cfg.num_layers
    print(f"{phase} {tag}: {arch} ({cfg.num_layers} layers) {row['layout']} "
          f"{row['completed']}/{n_req} "
          f"requests, {agg['tokens_per_s']:.1f} tok/s, tpot p50 "
          f"{row['tpot_p50_ms']:.2f} ms, {fwd} forwards, launches {counts}; "
          f"weights {size / 1e9:.2f} GB, peak allocated {peak / 1e9:.2f} GB "
          f"({secs:.1f}s with the build and the warm run)")
    return row, engine


def profile_variant(torch, engine):
    """21f: ``VARIANT_PROFILE_STEPS`` decode steps of a full engine under
    torch.profiler, as phase 6 profiles smollm's (wall, device busy
    share, top kernels, K2's and K5's shares), with each layer's
    attention call in a profiler range:
    the device time a step of the local layers' plain ring attention and
    of the global layers' KV scatter and K5 (a host-side range's device
    time sums the kernels launched inside it)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import attention as attn_mod
    from repro_torch.serving import synthetic_trace
    n = VARIANT_PROFILE_STEPS
    names = {"_ring_attend": "ring_attend", "_paged_attend": "paged_layer"}
    saved = {f: getattr(attn_mod, f) for f in names}

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    engine.reset()
    for r in synthetic_trace(engine.cfg, requests=4, prompt_len=32,
                             gen_len=16, seed=1):
        engine.submit(r)
    engine.step()              # admissions + first decode
    torch.cuda.synchronize()
    for f, name in names.items():
        setattr(attn_mod, f, ranged(name, saved[f]))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(n):
                engine.step()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        for f, fn in saved.items():
            setattr(attn_mod, f, fn)
    ranged_names = tuple(names.values())
    busy_us, top = device_time(torch, prof, 6, exclude=ranged_names)
    share = busy_us / 1e6 / wall if busy_us else None
    launches = launch_split(torch, prof, n, exclude=ranged_names)
    print(f"21f: {engine.cfg.name}, {n} decode steps: wall "
          f"{wall * 1e3 / n:.1f} ms/step, device busy "
          + (f"{busy_us / n / 1e3:.2f} ms/step ({share:.1%})" if busy_us
             else "not measured (no device time in the trace)")
          + f"; {launches['port']:.0f} port kernels, "
          f"{launches['torch']:.0f} torch kernels, {launches['copies']:.0f} "
          f"copies a step")
    for e in top:
        print(f"  {e.key[:60]}: {e.self_device_time_total / n / 1e3:.3f} "
              f"ms/step, {e.count // n} calls/step")
    shares = kernel_shares(torch, prof, busy_us, n, "step")
    cpu = torch.autograd.DeviceType.CPU
    ranges = {}
    for name in ranged_names:
        evs = [e for e in averages(prof)
               if e.key == name and e.device_type == cpu]
        us = sum(e.device_time_total for e in evs)
        ranges[name] = {"ms_per_step": us / n / 1e3 if us else None,
                        "calls_per_step": sum(e.count for e in evs) // n}
    fmt_ms = lambda r: (f"{r['ms_per_step']:.3f} ms" if r["ms_per_step"]
                        else "not measured")
    print(f"  attention a step: local ring (plain torch) "
          f"{fmt_ms(ranges['ring_attend'])} over "
          f"{ranges['ring_attend']['calls_per_step']} layers; global "
          f"(KV scatter + K5) {fmt_ms(ranges['paged_layer'])} over "
          f"{ranges['paged_layer']['calls_per_step']} layers")
    return {"wall_ms_per_step": wall * 1e3 / n, "k2_k5": shares,
            "device_busy_ms_per_step": busy_us / n / 1e3 if busy_us else None,
            "device_busy_share": share, "launches_per_step": launches,
            "attention_ranges": ranges,
            "top": [[e.key, e.self_device_time_total / n / 1e3, e.count // n]
                    for e in top]}


def smoke_ring_spec(torch, ops):
    """21c: gemma3's smoke config (window 8, f32) with JAX's
    ``test_spec_equals_baseline_sliding_window`` setup (4 mixed requests,
    2 slots, max_len 32, page 8, 8 pages, ondemand), on the card and on
    the CPU. Exact: on the card, k=1 at 7 bits reproduces the baseline
    under the paper's Q_A (the S=1 verify isolates the ring rewind and
    the KV overwrite from the batch); with Q_A off (no activation
    quantizer to couple the verify's rows, H7), k=3 at 7 bits reproduces
    the baseline on the card and on the CPU, and the card's streams equal
    the CPU's. Measured: k=3 against the baseline under the paper's Q_A,
    and the card against the CPU there (H7, H1): the reference parts the
    same way on this draw (``tests/test_torch_dense_variants.py`` carries
    it into JAX's engine), and on JAX's draw k=3 equals the baseline.
    Every run completes and leaves no page in use."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.lns import LNSFormat
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.models.model import init_params, to_device
    from repro_torch.optim.madam import MadamConfig, lns_leaf_encoder
    from repro_torch.server.sampling import SamplingParams
    from repro_torch.serving import Engine, Request

    def requests(vocab, n=4, gen=10, seed=3):
        rng = np.random.default_rng(seed)
        out = []
        for i in range(n):
            sp = None if i % 2 == 0 else SamplingParams(
                temperature=0.9, top_k=0 if i % 4 == 1 else 8, seed=100 + i)
            prompt = rng.integers(0, vocab, (4 + (i % 3) * 3,)).tolist()
            out.append(Request(rid=i, prompt=prompt,
                               max_new_tokens=gen - (i % 4), sampling=sp))
        return out

    cfg = get_smoke_config("gemma3-12b")
    params = init_params(cfg, seed=0, device="cpu", leaf_fn=lns_leaf_encoder(
        MadamConfig(update_format=LNSFormat(8, 8))))
    paper = QuantConfig.lns_madam()
    quant = {"paper": paper, "no_qa": dataclasses.replace(paper, act=None)}
    kw = dict(num_slots=2, max_len=32, page_size=8, num_pages=8,
              prefix_cache=False, alloc_policy="ondemand")
    runs = [("cuda", "paper", 0), ("cuda", "paper", 1), ("cuda", "paper", 3),
            ("cuda", "no_qa", 0), ("cuda", "no_qa", 3), ("cpu", "paper", 0),
            ("cpu", "paper", 3), ("cpu", "no_qa", 0), ("cpu", "no_qa", 3)]
    got, cycles = {}, {}
    for dev, q, k in runs:
        spec = dict(speculate_k=k, draft_bitwidth=7) if k else {}
        eng = Engine(cfg, quant[q], to_device(params, dev), device=dev,
                     **kw, **spec)
        eng.run(requests(cfg.vocab_size))
        check(len(eng.finished) == 4 and eng.allocator.in_use == 0,
              f"21c {dev} {q} k={k}: {len(eng.finished)}/4 finished, "
              f"{eng.allocator.in_use} pages in use")
        check(eng.caches["period"]["pos0"]["k"].shape[2] == 8 + k,
              f"21c {dev} {q} k={k}: ring of "
              f"{eng.caches['period']['pos0']['k'].shape[2]} positions")
        got[dev, q, k] = streams(eng)
        cycles[dev, q, k] = eng.spec_cycles

    def parts(a, b):
        return [r for r in got[a] if got[a][r] != got[b][r]]

    def same_tokens(a, b):
        return sum(x == y for r in got[a]
                   for x, y in zip(got[a][r], got[b][r]))

    base = ("cuda", "paper", 0)
    check(not parts(("cuda", "paper", 1), base) and cycles[
        "cuda", "paper", 1] > 0,
          f"21c: k=1 streams part from the baseline's on the card at "
          f"{parts(('cuda', 'paper', 1), base)}")
    exact = [("cuda", "no_qa", 3), ("cpu", "no_qa", 0), ("cpu", "no_qa", 3)]
    for key in exact:
        check(not parts(key, ("cuda", "no_qa", 0)),
              f"21c: Q_A off, {key} parts from the card's baseline at "
              f"{parts(key, ('cuda', 'no_qa', 0))}")
    n_tok = sum(len(v) for v in got[base].values())
    measured = {
        "card_k3_vs_baseline": parts(("cuda", "paper", 3), base),
        "cpu_k3_vs_baseline": parts(("cpu", "paper", 3),
                                    ("cpu", "paper", 0)),
        "card_vs_cpu_baseline": parts(base, ("cpu", "paper", 0)),
        "card_k3_same_tokens": same_tokens(("cuda", "paper", 3), base),
        "card_vs_cpu_same_tokens": same_tokens(base, ("cpu", "paper", 0)),
        "tokens": n_tok}
    print(f"21c: gemma3-smoke rings (8 + k positions) and spec rewinds: on "
          f"the card k=1/B=7 equals the baseline (paper Q_A, "
          f"{cycles['cuda', 'paper', 1]} cycles); Q_A off, k=3/B=7 equals "
          f"the baseline on the card and the CPU and the card equals the "
          f"CPU (4/4 requests, {cycles['cuda', 'no_qa', 3]} cycles); no page "
          f"in use after any run. Paper Q_A, measured: k=3 parts from the "
          f"baseline at requests {measured['card_k3_vs_baseline']} on the "
          f"card ({measured['card_k3_same_tokens']}/{n_tok} tokens equal) "
          f"and {measured['cpu_k3_vs_baseline']} on the CPU; the card's "
          f"baseline parts from the CPU's at "
          f"{measured['card_vs_cpu_baseline']} "
          f"({measured['card_vs_cpu_same_tokens']}/{n_tok} tokens equal)")
    return {"exact": True, "cycles": {f"{d}_{q}_k{k}": v for (d, q, k), v
                                      in cycles.items()},
            "measured": measured}


def gemma3_train(torch, ops):
    """21e: one train step of gemma3-12b at full width, one period deep
    (6 layers: 5 local, 1 global), 4 x 256 tokens, remat on, then off."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.lns import is_lns_weight
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.steps import (batch_to_device, build_train_step,
                                            init_train_state)
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config("gemma3-12b"), num_layers=6)
    mcfg = MadamConfig()
    batch = batch_to_device(SyntheticLM(cfg, batch=4, seq=256).batch_at(0),
                            "cuda")
    rows = {}
    for remat in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(cfg, mcfg, seed=0, device="cuda")
        n_leaves = sum(is_lns_weight(x) and x.ndim >= 2
                       for _, x in leaves(state.params))
        step = build_train_step(cfg, QuantConfig.lns_madam(), mcfg,
                                remat=remat)
        try:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.monotonic()
            state, met = step(state, batch)
            loss = float(met["loss"])
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
        except torch.cuda.OutOfMemoryError:
            check(not remat, "21e: the remat step ran out of memory")
            rows["no_remat"] = {"fits": False}
            print("21e: gemma3 step without remat does not fit the card")
            break
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check(math.isfinite(loss), f"21e: loss {loss} (remat={remat})")
        check(counts["encode_pack"] > 0 and counts["qmatmul"] > 0
              and counts["qmatmul_decode"] > 0,
              f"21e: K1/K2 (wgmma) not launched: {counts}")
        check(counts["madam_step"] == n_leaves,
              f"21e: K3 launched {counts['madam_step']} times for "
              f"{n_leaves} packed leaves")
        rows["remat" if remat else "no_remat"] = {
            "fits": True, "loss": loss, "step_s": secs,
            "peak_gb": peak / 1e9, "launches": counts}
        print(f"21e: gemma3-12b 6 layers (5 local + 1 global) x 4 x 256 "
              f"tokens, remat={remat}: loss {loss:.4f}, step {secs:.2f}s "
              f"(first call), peak allocated {peak / 1e9:.2f} GB, launches "
              f"{counts}")
        del state, met
    return rows


def gemma3_draft_view(torch, ops, ref, engine):
    """21a: a 6-bit draft view of gemma3-12b's serving weights: 44 packed
    leaves (6 positions x 7 stacked projections, the embedding, the
    untied head) over ``K7_MAX_LEAVES`` = 16 leaves a launch is 3 K7
    launches; the qk-norm gains and every scale are the serving tree's own
    tensors, and every re-gridded leaf equals the plain version's words.
    Then each of the 3 launches is made twice more on the same leaves,
    the second time between two CUDA events (a launch re-grids ~4 GB of
    words, so the events' own cost is lost in it), beside the byte bound
    of the words read once and written once."""
    from repro_torch.core.lns import is_lns_weight
    from repro_torch.serving.spec import build_draft_params
    from repro_torch.tree import leaves
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    view = build_draft_params(engine.params, 6)
    torch.cuda.synchronize()
    n = ops.launch_counts()["requant_pack"]
    check(n == 3, f"21a: a gemma3 draft view took {n} K7 launches, not 3")
    src = dict(leaves(engine.params))
    regrid = []
    for path, leaf in leaves(view):
        old = src[path]
        shared = (leaf.scale is old.scale if hasattr(leaf, "scale")
                  else leaf is old)
        check(shared, f"21a: the draft view copied {path}")
        if is_lns_weight(leaf) and leaf.packed is not old.packed:
            want = ref.requant_pack(old.packed, old.fmt, leaf.fmt)
            check(torch.equal(leaf.packed, want),
                  f"21a: K7 {path} 8->6: {int((leaf.packed != want).sum())}"
                  f" words differ from the plain version")
            regrid.append((old.packed, old.fmt, leaf.fmt))
            del want
    del view
    words = sum(p.numel() for p, _, _ in regrid)
    ms = 0.0
    for i in range(0, len(regrid), ops.K7_MAX_LEAVES):
        part = regrid[i:i + ops.K7_MAX_LEAVES]
        args = ([p for p, _, _ in part], part[0][1], part[0][2])
        # a first call takes the outputs' memory from the driver; the
        # timed call reuses it from the caching allocator
        ops.requant_pack_many(*args)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = ops.requant_pack_many(*args)
        end.record()
        torch.cuda.synchronize()
        ms += start.elapsed_time(end)
        del out
    c = costs.requant_pack(words)
    b, by = bound_ms(c.bytes, c.ops, F32_FLOPS)
    print(f"21a: gemma3-12b draft view at 6 bits: 3 K7 launches over "
          f"{words / 1e9:.2f}e9 words, every word equal to the plain "
          f"version's, scales and f32 leaves shared; the launches "
          f"{ms:.3f} ms (CUDA events), bound {b:.3f} ms ({by}; "
          f"{b / ms:.1%})")
    return {"k7_launches": n, "words": words, "ms": ms, "bound_ms": b,
            "bound_by": by}


def k3_large_leaf(torch, ops, ref, R, C, what="21e's largest leaf"):
    """K3 at the largest leaf of a train step (21e: gemma3-12b's embedding
    and head, 1.0e9 16-bit words in int32; 22c: phi-3-vision's stacked
    up/gate, 16 x 3072 x 8192), bf16 gradients, against its plain
    version, computed a block of rows at a time: v' bit-equal, words
    equal away from the near-ties (``k34_check``'s rule). Timed with CUDA
    events around single launches: gigabytes of outputs a call are too
    much for a graph of repeats."""
    from repro_torch.core.lns import LNSFormat
    fmt, bits = LNSFormat(16, 2048), 16
    gen = torch.Generator(device="cuda").manual_seed(9)
    w, g, v = madam_inputs(torch, R, C, bits, torch.bfloat16, gen)
    bc = ref.bias_correction(0.999, 7)
    kw = dict(lr=2.0 ** -7, beta=0.999, eps=1e-30)
    times = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        kw_w, kv_w = ops.madam_step(w, g, v, bc, fmt, **kw)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    rows = max(1, (1 << 26) // C)
    ties = near_n = err = 0
    plain_ms = 0.0
    for i in range(0, R, rows):
        sl = slice(i, i + rows)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        pw, pv = ref.madam_step(w[sl], g[sl], v[sl], bc, fmt, **kw)
        end.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(end)
        check(torch.equal(kv_w[sl].view(torch.int32), pv.view(torch.int32)),
              f"K3 {R}x{C} rows {i}..: v' differs from the plain version")
        ws = w[sl]
        sign = 1 - 2 * ((ws >> (bits - 1)) & 1)
        _, _, target = ref.step_math(ws & fmt.max_code, sign, g[sl], v[sl],
                                     bc, gamma=fmt.gamma,
                                     max_code=fmt.max_code, **kw)
        frac = target - torch.floor(target)
        ulp = torch.abs(torch.nextafter(target, target + 1) - target)
        near = (frac - 0.5).abs() <= MADAM_TIE_ULPS * ulp
        diff = kw_w[sl] != pw
        bad = int((diff & ~near).sum())
        check(bad == 0, f"K3 {R}x{C} rows {i}..: {bad} words differ away "
              f"from a tie")
        ties += int(diff.sum())
        near_n += int(near.sum())
        err = max(err, int((kw_w[sl] - pw).abs().max()))
        del pw, pv, target, frac, ulp, near, diff, sign
    c = costs.madam_step(R * C, w.element_size(), g.element_size())
    b, by = bound_ms(c.bytes, c.ops, F32_FLOPS)
    ms = min(times)
    print(f"K3 madam_step {R}x{C} B=16 g bf16 ({what}): v' "
          f"equal, words differing at ties {ties} (near-tie {near_n}), "
          f"kernel {ms:.3f} ms (one launch, CUDA events), plain "
          f"{plain_ms:.3f} ms (in blocks of {rows} rows), bound {b:.3f} ms "
          f"({by}; {b / ms:.1%})")
    del w, g, v, kw_w, kv_w
    return dict(shape=[R, C], bits=bits, g_dtype="bfloat16", tie_words=ties,
                near_tie=near_n, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None)


def k6_variant(torch, ops, ref, B, V):
    """K6 greedy at a variant's decode batch ``B x V``: tokens equal to
    the plain version's, timed beside it and ``torch.argmax``."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    lg = k6_inputs(torch, B, V, gen)[0]
    kern = lambda: ops.fused_sample(lg, None, None)
    plain = lambda: ref.fused_sample(lg, None, None)
    check(torch.equal(kern(), plain()), f"K6 greedy {B}x{V}: tokens differ")
    c = costs.fused_sample(B, V, "greedy", lg.element_size())
    b, by = bound_ms(c.bytes, c.ops, F32_FLOPS)
    row = dict(shape=[B, V], case="greedy", max_abs_err=0,
               blocks=ops.fused_sample_plan(B, V)["blocks"],
               ms=cuda_ms(torch, kern), plain_ms=cuda_ms(torch, plain),
               library_ms=cuda_ms(torch, lambda: torch.argmax(lg, dim=-1)),
               bound_ms=b, bound_by=by)
    print(f"K6 fused_sample greedy {B}x{V} ({row['blocks']} blocks a row): "
          f"tokens equal, kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, argmax {row['library_ms']:.4f} ms, "
          f"bound {b:.5f} ms")
    return row


def dense_variants(torch, ops, ref, fmt, card):
    """Phase 21: the dense variants at full width on the card. Every K1
    and K2 call of 21a, 21d and 21e is recorded, and after them each
    shape is held against the plain version (K2's decode pass too, at
    the shapes that took the wgmma path)."""
    t0 = time.monotonic()
    marks = [("start", t0)]
    mark = lambda name: marks.append((name, time.monotonic()))
    print(f"phase 21 (dense variants) on {card}")
    out = {}
    with k1_shapes_seen(torch, ops) as k1_seen, \
            k2_shapes_seen(torch, ops) as k2_seen:
        row, engine = variant_serve(torch, ops, "gemma3-12b", SERVE_PAGED,
                                    "a paged")
        out["gemma3_paged"] = row
        out["gemma3_draft_view"] = gemma3_draft_view(torch, ops, ref,
                                                     engine)
        mark("21a paged")
        # 2 decode steps (4 before the recurrent slice)
        out["gemma3_logits"] = logits_check(torch, engine, steps=2)
        mark("21b")
        out["gemma3_profile"] = profile_variant(torch, engine)
        mark("21f")
        del engine
        row, engine = variant_serve(torch, ops, "gemma3-12b", SERVE_DENSE,
                                    "a dense")
        out["gemma3_dense"] = row
        del engine
        mark("21a dense")
        torch.cuda.empty_cache()
        out["smoke_ring_spec"] = smoke_ring_spec(torch, ops)
        mark("21c")
        for arch in ("granite-8b", "qwen2.5-32b"):
            row, engine = variant_serve(torch, ops, arch, VARIANT_SERVE,
                                        "d paged")
            out[arch] = row
            del engine
            mark(f"21d {arch}")
        torch.cuda.empty_cache()
        out["gemma3_train"] = gemma3_train(torch, ops)
        mark("21e")
    gc.collect()
    torch.cuda.empty_cache()
    # the kernels at the shapes these paths ran: K1 and K2 (timed at
    # gemma3's decode and 21e's shapes; every recorded shape checked),
    # K2's decode pass where the wgmma path ran, K3 at 21e's largest
    # leaf, K6 at gemma3's decode batch
    out["gemma3_k1"] = k1_check(torch, ops, ref, fmt, [
        (4, 3840), (4, 4096), (4, 15360), (1024, 3840), (1024, 15360)])
    out["k1_driven"] = k1_driven_check(torch, ops, ref, fmt, k1_seen)
    out["gemma3_k2"] = k2_check(torch, ops, ref, fmt, GEMMA3_DECODE_GEMMS)
    out["k2_driven"] = k2_driven_check(torch, ops, ref, fmt, k2_seen)
    wgmma = sorted({(M, K, N) for M, K, N, cdt, _ in k2_seen
                    if ops.qmatmul_plan(M, N, K, cdt)["path"] == "wgmma"})
    check(wgmma, "21e: no K2 call took the wgmma path")
    out["gemma3_k2_decode_pass"] = k2_decode_pass_check(torch, ops, ref,
                                                        fmt, wgmma)
    torch.cuda.empty_cache()
    out["gemma3_k3"] = k3_large_leaf(torch, ops, ref, 262144, 3840)
    torch.cuda.empty_cache()
    out["gemma3_k6"] = k6_variant(torch, ops, ref, 4, 262144)
    mark("21 kernels")
    torch.cuda.empty_cache()
    secs = time.monotonic() - t0
    parts = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    print(f"phase 21 took {secs:.1f}s ("
          + ", ".join(f"{k} {v:.1f}s" for k, v in parts.items()) + ")")
    out.update(seconds=secs, seconds_by_part=parts)
    return out


@contextlib.contextmanager
def k6_rows_seen(ops):
    """Record every K6 launch's rows (greedy and seeded), and the inputs
    and tokens of its seeded launches (the wrappers still count every
    launch themselves)."""
    seen = {"rows": collections.Counter(), "seeded": []}
    greedy, seeded = ops.fused_sample, ops.fused_sample_seeded

    def record(lg, *args, **kw):
        seen["rows"][lg.shape[0]] += 1
        return greedy(lg, *args, **kw)

    def record_seeded(lg, temp, seed, step, **kw):
        seen["rows"][lg.shape[0]] += 1
        out = seeded(lg, temp, seed, step, **kw)
        toks = out[0] if isinstance(out, tuple) else out
        seen["seeded"].append((lg.clone(), temp.copy(), seed.copy(),
                               step.copy(), toks.clone()))
        return out

    ops.fused_sample, ops.fused_sample_seeded = record, record_seeded
    try:
        yield seen
    finally:
        ops.fused_sample, ops.fused_sample_seeded = greedy, seeded


def patch_logits_check(torch, engine):
    """22b: one phi-3-vision forward at full width, ``PHI3V_LOGIT_LAYERS``
    deep (random packed 8-bit weights from seed 0, as the serve CLI draws
    them), over ``num_patches`` stub patches and ``PHI3V_TEXT`` text
    tokens (batch 1, 640 positions: K2 on its wgmma path), through the
    kernels, the plain versions, and the plain versions with an
    f64-accumulating GEMM (the noise floor): at every position the logits
    within ``LOGIT_RTOL`` of the plain version's max |logit|, and the
    greedy token equal where the plain version's top-2 margin exceeds
    that (phase 5's rule)."""
    import dataclasses
    from repro_torch.core.lns import LNSFormat
    from repro_torch.kernels import dispatch, ref
    from repro_torch.models.model import forward, init_params
    from repro_torch.models.stubs import vision_patches_stub
    from repro_torch.optim.madam import MadamConfig, lns_leaf_encoder
    cfg = dataclasses.replace(engine.cfg, num_layers=PHI3V_LOGIT_LAYERS)
    qcfg = engine.qcfg
    params = init_params(cfg, seed=0, device="cuda", leaf_fn=lns_leaf_encoder(
        MadamConfig(update_format=LNSFormat(8, 8))))
    gen = torch.Generator(device="cuda").manual_seed(22)
    patches = vision_patches_stub(gen, 1, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (1, PHI3V_TEXT), generator=gen,
                           device="cuda", dtype=torch.int32)
    n_pos = cfg.num_patches + PHI3V_TEXT

    def run():
        with torch.no_grad():
            lg = forward(params, tokens, cfg, qcfg,
                         patches=patches)[0].float()
        check(lg.shape == (n_pos, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()),
              f"22b: logits {tuple(lg.shape)} not finite or misshaped")
        return lg

    with plain_versions(dispatch, ref):
        plain = run()
        dispatch.qmatmul = qmatmul_f64
        floor_run = run()
    kern = run()
    top = float(plain.abs().max())
    tol = LOGIT_RTOL * top
    err = float((plain - kern).abs().max())
    floor = float((plain - floor_run).abs().max())
    check(err <= tol, f"22b: patch-prefix logits err {err} > {tol}")
    top2 = torch.topk(plain, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    same = plain.argmax(-1) == kern.argmax(-1)
    check(bool(same[clear].all()), f"22b: greedy tokens differ at "
          f"{int((~same & clear).sum())} positions beyond the margin")
    text_err = float((plain[cfg.num_patches:] - kern[cfg.num_patches:])
                     .abs().max())
    print(f"22b: phi-3-vision {cfg.num_layers} of "
          f"{engine.cfg.num_layers} layers, "
          f"{cfg.num_patches} stub patches + {PHI3V_TEXT} text tokens: "
          f"kernels vs plain max err {err / top:.4f} of max |logit| (text "
          f"positions {text_err / top:.4f}; limit {LOGIT_RTOL}); floor "
          f"(plain, f64 GEMM accumulation) {floor / top:.4f}; greedy tokens "
          f"checked at {int(clear.sum())} of {n_pos} positions")
    return {"positions": n_pos, "layers": cfg.num_layers,
            "max_rel_err": err / top, "text_max_rel_err": text_err / top,
            "floor_rel_err": floor / top, "margin_positions": int(clear.sum())}


def modality_train(torch, ops, arch, layers, batch, seq, tag, **cut):
    """22c/22e/23d/23e/24d: one train step of ``arch`` at full width,
    ``layers`` deep (``cut``: more config fields replaced, 24d's expert
    count),
    ``batch`` x ``seq`` text positions (phi-3-vision adds its 576 stub
    patches in front; musicgen's tokens are (B, S, 4)), remat on: a
    finite loss over the text positions, K1 and K2 launched and K3 once a
    packed leaf; the peak allocated memory printed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.lns import is_lns_weight
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.steps import (batch_to_device, build_train_step,
                                            init_train_state)
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, **cut)
    mcfg = MadamConfig()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch_np = SyntheticLM(cfg, batch=batch, seq=seq).batch_at(0)
    data = batch_to_device(batch_np, "cuda")
    state = init_train_state(cfg, mcfg, seed=0, device="cuda")
    n_leaves = sum(is_lns_weight(x) and x.ndim >= 2
                   for _, x in leaves(state.params))
    n_params = cfg.params_count()
    step = build_train_step(cfg, QuantConfig.lns_madam(), mcfg, remat=True)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    state, met = step(state, data)
    loss = float(met["loss"])
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(loss), f"{tag}: loss {loss}")
    check(counts["encode_pack"] > 0 and counts["qmatmul"] > 0,
          f"{tag}: K1/K2 not launched: {counts}")
    check(counts["madam_step"] == n_leaves,
          f"{tag}: K3 launched {counts['madam_step']} times for "
          f"{n_leaves} packed leaves")
    shapes = {k: list(v.shape) for k, v in batch_np.items()}
    where = " over the text positions" if "patches" in batch_np else ""
    print(f"{tag}: {arch} {layers} layers, batch {shapes}, remat on: loss "
          f"{loss:.4f}{where}, step {secs:.2f}s (first call), "
          f"{n_params / 1e9:.3f}e9 parameters, peak allocated "
          f"{peak / 1e9:.2f} GB ({peak / n_params:.1f} B a parameter), "
          f"launches {counts}")
    del state, met, data
    return {"layers": layers, "cut": cut, "batch": shapes, "loss": loss,
            "step_s": secs, "params": n_params, "peak_gb": peak / 1e9,
            "bytes_per_param": peak / n_params, "launches": counts,
            "packed_leaves": n_leaves}


def musicgen_seeded(torch, ops, ref, engine, k6_seen):
    """22d, seeded: one musicgen request at temperature 0.8 (seed 11)
    served alone twice replays token for token; in its K6 launches the
    four codebook rows of its slot carry pairwise different seeds
    (``codebook_seed``) and, rerun with ``noise_out``, draw pairwise
    different noise, equal to ``ref.gumbel_noise`` on the card, and the
    tokens the engine got."""
    import numpy as np
    from repro_torch.server.sampling import SamplingParams, codebook_seed
    from repro_torch.serving import Request, synthetic_trace
    K = engine.cfg.num_codebooks
    prompt = synthetic_trace(engine.cfg, requests=1, prompt_len=32,
                             gen_len=32, seed=5)[0].prompt
    sp = SamplingParams(temperature=0.8, seed=11)
    got = []
    for _ in range(2):
        engine.reset()
        k6_seen["seeded"].clear()
        engine.run([Request(rid=0, prompt=prompt, max_new_tokens=32,
                            sampling=sp)])
        got.append(engine.finished[0].generated)
    check(got[0] == got[1] and len(got[0]) == 32,
          f"22d seeded: the replay differs ({len(got[0])} tokens)")
    # the reruns below are recorded too: walk the engine's launches only
    launches = list(k6_seen["seeded"])
    check(launches, "22d seeded: no seeded K6 launch")
    distinct = 0
    for lg, temp, seed, step, toks in launches:
        rows = np.flatnonzero(temp > 0)
        check(len(rows) == K and len(set(seed[rows].tolist())) == K,
              f"22d seeded: the sampled slot's rows {rows} carry seeds "
              f"{seed[rows].tolist()}")
        check(np.array_equal(seed[rows], codebook_seed(
            np.full(K, sp.seed), np.arange(K))),
              "22d seeded: the seeds are not codebook_seed's")
        again, noise = ops.fused_sample_seeded(lg, temp, seed, step,
                                               noise_out=True)
        check(torch.equal(again, toks), "22d seeded: a rerun with noise_out "
              "gives other tokens")
        check(torch.equal(noise, ref.gumbel_noise(seed, step, lg.shape[1],
                                                  "cuda")),
              "22d seeded: noise_out differs from ref.gumbel_noise")
        for a in range(K):
            for b in range(a + 1, K):
                check(not torch.equal(noise[rows[a]], noise[rows[b]]),
                      f"22d seeded: codebooks {a} and {b} drew the same "
                      f"noise")
        distinct += 1
    print(f"22d seeded: musicgen-medium, one request at temperature 0.8 "
          f"served twice alone: 32/32 sample events replayed token for "
          f"token; in {distinct} seeded K6 launches its {K} codebooks drew "
          f"pairwise different noise (seeds {seed[rows].tolist()})")
    return {"replayed_tokens": len(got[0]), "seeded_launches": distinct}


def modality(torch, ops, ref, fmt, card):
    """Phase 22: the modality stubs at full width on the card. Every K1
    and K2 call of 22a-22e is recorded, and after them each shape is held
    against the plain version; K2 at both models' decode GEMMs and K6 at
    their decode batches are timed beside torch, and K3 runs at
    phi-3-vision's largest leaf."""
    t0 = time.monotonic()
    marks = [("start", t0)]
    mark = lambda name: marks.append((name, time.monotonic()))
    print(f"phase 22 (modality stubs) on {card}")
    out = {}
    with k1_shapes_seen(torch, ops) as k1_seen, \
            k2_shapes_seen(torch, ops) as k2_seen, \
            k6_rows_seen(ops) as k6_seen:
        row, engine = variant_serve(torch, ops, "phi-3-vision-4.2b",
                                    SERVE_PAGED, "22a paged", phase="22")
        out["phi3v_paged"] = row
        mark("22a")
        out["phi3v_patch_logits"] = patch_logits_check(torch, engine)
        del engine
        mark("22b")
        out["phi3v_train"] = modality_train(
            torch, ops, "phi-3-vision-4.2b", PHI3V_TRAIN_LAYERS, 2,
            PHI3V_TRAIN_SEQ, "22c")
        mark("22c")
        k6_seen["rows"].clear()
        row, engine = variant_serve(torch, ops, "musicgen-medium",
                                    SERVE_PAGED, "22d paged", phase="22")
        K = engine.cfg.num_codebooks
        # one K6 launch a forward (variant_serve): a decode step's takes
        # 4 slots x K codebooks rows, a prefill's its one slot's K
        rows = k6_seen["rows"]
        check(set(rows) == {K, 4 * K},
              f"22d: K6 launches by rows {dict(rows)}, not {K} (prefill) "
              f"and {4 * K} (decode)")
        gen = [len(t) for rs in engine.finished for t in rs.generated]
        check(set(gen) == {K}, f"22d: generated tokens of widths {set(gen)}")
        row["k6_rows"] = dict(k6_seen["rows"])
        out["musicgen_paged"] = row
        out["musicgen_seeded"] = musicgen_seeded(torch, ops, ref, engine,
                                                 k6_seen)
        del engine
        mark("22d")
        out["musicgen_train"] = modality_train(
            torch, ops, "musicgen-medium", 48, 4, MUSICGEN_TRAIN_SEQ, "22e")
        mark("22e")
    gc.collect()
    torch.cuda.empty_cache()
    out["k1_driven"] = k1_driven_check(torch, ops, ref, fmt, k1_seen)
    out["k2_driven"] = k2_driven_check(torch, ops, ref, fmt, k2_seen)
    out["decode_k1"] = k1_check(torch, ops, ref, fmt, [
        (4, 3072), (4, 8192), (4, 1536), (4, 6144)])
    out["decode_k2"] = k2_check(torch, ops, ref, fmt, PHI3V_DECODE_GEMMS
                                + MUSICGEN_DECODE_GEMMS)
    out["decode_k6"] = k6_check(torch, ops, ref, [(16, 2048), (4, 32064)])
    torch.cuda.empty_cache()
    out["phi3v_k3"] = k3_large_leaf(torch, ops, ref, PHI3V_TRAIN_LAYERS * 3072,
                                    8192, "22c's largest leaf, up/gate")
    torch.cuda.empty_cache()
    mark("22 kernels")
    secs = time.monotonic() - t0
    parts = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    print(f"phase 22 took {secs:.1f}s ("
          + ", ".join(f"{k} {v:.1f}s" for k, v in parts.items()) + ")")
    out.update(seconds=secs, seconds_by_part=parts)
    return out


# ---------------------------------------------------------------------------
# phase 23: the recurrent families (rwkv6-1.6b, zamba2-7b)


def state_bytes(engine):
    """Bytes of an engine's recurrent state: every layer cache without a
    cursor (rwkv's shifts and WKV state, mamba's conv tails and SSM
    state), all slots."""
    caches = engine.caches
    groups = list(caches.get("prefix", [])) \
        + list(caches.get("period", {}).values())
    return sum(v.nbytes for c in groups if "idx" not in c
               for v in c.values())


def recurrent_serve(torch, ops, arch, tag):
    """23a/23b: ``variant_serve``'s run and gates (K1 = K2 at every packed
    projection and the head, K5 once a shared-attention layer, K6 once a
    forward), and every prefill at the exact prompt length (no bucket:
    pads would enter the state); a model with no pageable layer (rwkv6)
    must keep the dense layout under ``--page-size``, with no allocator,
    as the JAX engine does. Prints the state's bytes beside the words'."""
    row, engine = variant_serve(torch, ops, arch, SERVE_PAGED, tag,
                                phase="23")
    argv = dict(zip(SERVE_PAGED[::2], SERVE_PAGED[1::2]))
    n_req, plen = int(argv["--requests"]), int(argv["--prompt-len"])
    check(engine.prefill_tokens == n_req * plen,
          f"{tag}: {engine.prefill_tokens} tokens prefilled for {n_req} "
          f"prompts of {plen}")
    if not k5_layers(engine.cfg):
        check(engine.page_size is None and engine.allocator is None,
              f"{tag}: --page-size built an allocator for a model with no "
              f"pageable layer")
    st = state_bytes(engine)
    row.update(state_bytes=st, state_mb_per_slot=st / engine.num_slots / 1e6,
               prefill_tokens=engine.prefill_tokens)
    print(f"{tag}: {arch} recurrent state {st / 1e6:.1f} MB "
          f"({st / engine.num_slots / 1e6:.2f} MB a slot, f32), "
          f"{engine.prefill_tokens} tokens prefilled at the exact prompt "
          f"lengths, layout {row['layout']}, allocator "
          f"{'none' if engine.allocator is None else 'built'}")
    return row, engine


def recurrent_logits(torch, arch):
    """23c: ``arch`` at full width, ``RECURRENT_LOGIT_LAYERS`` deep
    (random packed 8-bit weights from seed 0): phase 5's check (a 32-token
    prefill and 4 decode steps through the kernels against the plain
    versions, beside the f64-GEMM floor); then the training forward's
    chunked scans against a cached prefill's sequential steps over the
    same ``RECURRENT_SEQ_TOKENS`` tokens, both through the kernels: the
    last position's logits within ``LOGIT_RTOL`` of max |logit|, the
    greedy token equal where the top-2 margin exceeds that, printed
    beside the floor of a pure accumulation-order change (the cached
    prefill, plain versions against the f64 GEMM)."""
    import dataclasses
    import types
    from repro_torch.configs import get_config
    from repro_torch.core.lns import LNSFormat
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.kernels import dispatch, ref
    from repro_torch.models.model import forward, init_caches, init_params
    from repro_torch.optim.madam import MadamConfig, lns_leaf_encoder
    cfg = dataclasses.replace(get_config(arch),
                              num_layers=RECURRENT_LOGIT_LAYERS[arch])
    qcfg = QuantConfig.lns_madam()
    params = init_params(cfg, seed=0, device="cuda", leaf_fn=lns_leaf_encoder(
        MadamConfig(update_format=LNSFormat(8, 8))))
    print(f"23c: {arch} {cfg.num_layers} of {get_config(arch).num_layers} "
          f"layers, layer pattern {cfg.layer_pattern()}")
    out = {"layers": cfg.num_layers,
           "decode": logits_check(torch, types.SimpleNamespace(
               cfg=cfg, qcfg=qcfg, params=params))}
    n = RECURRENT_SEQ_TOKENS
    gen = torch.Generator(device="cuda").manual_seed(23)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device="cuda", dtype=torch.int32)
    bt = torch.arange(n // 16, dtype=torch.int32, device="cuda")[None]

    def chunked():
        with torch.no_grad():
            return forward(params, tokens, cfg, qcfg)[0, -1].float()

    def sequential():
        caches = init_caches(1, n, cfg, page_size=16, num_pages=n // 16,
                             device="cuda")
        with torch.no_grad():
            return forward(params, tokens, cfg, qcfg, caches=caches,
                           pos_offset=0, block_tables=bt)[0, -1].float()

    seq = sequential()
    train = chunked()
    with plain_versions(dispatch, ref):
        plain = sequential()
        dispatch.qmatmul = qmatmul_f64
        floor_run = sequential()
    for x in (seq, train):
        check(x.shape == (cfg.vocab_size,) and bool(torch.isfinite(x).all()),
              f"23c {arch}: logits {tuple(x.shape)} not finite or misshaped")
    top = float(seq.abs().max())
    tol = LOGIT_RTOL * top
    err = float((train - seq).abs().max())
    floor = float((plain - floor_run).abs().max())
    check(err <= tol, f"23c {arch}: chunked vs sequential err {err} > {tol}")
    top2 = torch.topk(seq, 2).values
    clear = float(top2[0] - top2[1]) > tol
    if clear:
        check(int(seq.argmax()) == int(train.argmax()),
              f"23c {arch}: chunked and sequential greedy tokens differ "
              f"beyond the margin")
    print(f"23c {arch}: chunked training forward vs cached sequential "
          f"prefill over {n} tokens, last position: max err "
          f"{err / top:.4f} of max |logit| (limit {LOGIT_RTOL}); floor "
          f"(plain, f64 GEMM accumulation) {floor / top:.4f}; greedy token "
          f"{'checked' if clear else 'not checked (margin under the limit)'}")
    out.update(chunked_vs_sequential_rel_err=err / top,
               floor_rel_err=floor / top, margin_checked=clear)
    del params
    return out


def recurrent(torch, ops, ref, fmt, card):
    """Phase 23: the recurrent families at full width on the card. Every
    K1 and K2 call of 23a-23e is recorded, and after them each shape is
    held against the plain version; K2 at both models' decode GEMMs and K6
    at their decode batches are timed beside torch, and K3 runs at each
    model's largest leaf."""
    t0 = time.monotonic()
    marks = [("start", t0)]
    mark = lambda name: marks.append((name, time.monotonic()))
    print(f"phase 23 (recurrent families) on {card}")
    out = {}
    with k1_shapes_seen(torch, ops) as k1_seen, \
            k2_shapes_seen(torch, ops) as k2_seen:
        out["rwkv6_serve"], engine = recurrent_serve(torch, ops,
                                                     "rwkv6-1.6b", "23a")
        del engine
        mark("23a")
        out["zamba2_serve"], engine = recurrent_serve(torch, ops,
                                                      "zamba2-7b", "23b")
        del engine
        mark("23b")
        gc.collect()
        torch.cuda.empty_cache()
        for arch in ("rwkv6-1.6b", "zamba2-7b"):
            out[f"{arch}_logits"] = recurrent_logits(torch, arch)
            gc.collect()
            torch.cuda.empty_cache()
        mark("23c")
        for arch, tag in (("rwkv6-1.6b", "23d"), ("zamba2-7b", "23e")):
            layers, batch, seq = RECURRENT_TRAIN[arch]
            out[f"{arch}_train"] = modality_train(torch, ops, arch, layers,
                                                  batch, seq, tag)
            gc.collect()
            torch.cuda.empty_cache()
            mark(tag)
    out["k1_driven"] = k1_driven_check(torch, ops, ref, fmt, k1_seen)
    out["k2_driven"] = k2_driven_check(torch, ops, ref, fmt, k2_seen)
    n64 = {N for _, _, N, _, _ in k2_seen}
    check({64, 112} <= n64, f"23: K2 never ran at N = 64 or 112: {n64}")
    out["decode_k2"] = k2_check(torch, ops, ref, fmt, RWKV_DECODE_GEMMS
                                + ZAMBA2_DECODE_GEMMS)
    out["decode_k6"] = k6_check(torch, ops, ref, [(4, 65536), (4, 32000)])
    torch.cuda.empty_cache()
    # the largest leaves: rwkv6's stacked ck (24 x 2048 x 7168), zamba2's
    # stacked z/x_proj at 33 layers (5 x 3584 x 7168)
    out["rwkv6_k3"] = k3_large_leaf(torch, ops, ref, 24 * 2048, 7168,
                                    "23d's largest leaf, ck")
    torch.cuda.empty_cache()
    out["zamba2_k3"] = k3_large_leaf(torch, ops, ref, 5 * 3584, 7168,
                                     "23e's largest leaf, z/x_proj")
    torch.cuda.empty_cache()
    mark("23 kernels")
    secs = time.monotonic() - t0
    parts = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    print(f"phase 23 took {secs:.1f}s ("
          + ", ".join(f"{k} {v:.1f}s" for k, v in parts.items()) + ")")
    out.update(seconds=secs, seconds_by_part=parts)
    return out


# ---------------------------------------------------------------------------
# phase 24: the mixtures of experts (deepseek-v3-671b, kimi-k2-1t-a32b)


@contextlib.contextmanager
def cut_config(arch, **cut):
    """While open, the serve CLI builds ``arch`` with ``cut``'s fields
    replaced (its module's ``get_config`` answers the cut config);
    yields that config."""
    import dataclasses
    from repro_torch.launch import serve as serve_mod
    real = serve_mod.get_config
    serve_mod.get_config = lambda a: (dataclasses.replace(real(a), **cut)
                                      if a == arch else real(a))
    try:
        yield dataclasses.replace(real(arch), **cut)
    finally:
        serve_mod.get_config = real


@contextlib.contextmanager
def routes_seen(ops=None):
    """Record every ``moe._router`` call's expert ids ``(T, K)`` (device
    tensors: no sync). With ``ops`` the list empties whenever the launch
    counts are reset, so after ``serve`` it holds the counted run's
    calls only."""
    from repro_torch.models import moe
    seen = []
    router = moe._router

    def spy(*a):
        out = router(*a)
        seen.append(out[1])
        return out

    moe._router = spy
    reset = ops.reset_launch_counts if ops is not None else None
    if ops is not None:
        def reset_too():
            seen.clear()
            reset()
        ops.reset_launch_counts = reset_too
    try:
        yield seen
    finally:
        moe._router = router
        if ops is not None:
            ops.reset_launch_counts = reset


def drop_shares(seen, cfg, slots):
    """The share of (token, k) assignments that capacity dropped, over the
    router calls of prefills (more than ``slots`` tokens) and of decode
    steps, with each call's capacity C."""
    from repro_torch.models.moe import _capacity, dropped
    tot = {"prefill": [0, 0, set()], "decode": [0, 0, set()]}
    for top_i in seen:
        kind = "decode" if top_i.shape[0] <= slots else "prefill"
        tot[kind][0] += dropped(top_i, cfg)
        tot[kind][1] += top_i.numel()
        tot[kind][2].add(_capacity(cfg, top_i.shape[0]))
    return {k: {"dropped": d, "assignments": n,
                "share": d / n if n else None, "capacity": sorted(c)}
            for k, (d, n, c) in tot.items()}


def moe_serve(torch, ops, arch, tag):
    """24a/24b: ``arch`` at full width, cut to ``MOE_SERVE_CUT``'s depth,
    through the serve CLI's engine with ``variant_serve``'s trace, warm-up
    and gates (every request completes; K1 = K2 once a packed projection
    a forward, the head included; K5 once an attention layer where the
    engine pages, 0 under MLA; K6 once a forward). deepseek's MLA must
    keep the dense latent cache under ``--page-size`` with no allocator.
    Prints the launches a forward and the share of (token, k)
    assignments capacity dropped at prefill and at decode."""
    from repro_torch.configs import get_config
    full = get_config(arch)
    with cut_config(arch, **MOE_SERVE_CUT[arch]) as cfg, \
            routes_seen(ops) as seen:
        print(f"{tag}: {arch} at full width, cut to {cfg.num_layers} of "
              f"{full.num_layers} layers (layer pattern "
              f"{cfg.layer_pattern()}), {cfg.params_count() / 1e9:.2f}e9 "
              f"of {full.params_count() / 1e9:.1f}e9 parameters")
        row, engine = variant_serve(torch, ops, arch, SERVE_PAGED, tag,
                                    phase="24")
        drops = drop_shares(seen, engine.cfg, engine.num_slots)
    fwd = engine.decode_steps + engine.prefills
    if cfg.use_mla:
        check(engine.page_size is None and engine.allocator is None,
              f"{tag}: --page-size paged an MLA model")
        groups = list(engine.caches.get("prefix", [])) \
            + list(engine.caches.get("period", {}).values())
        check(all("c_kv" in c and "kp" not in c for c in groups),
              f"{tag}: a layer cache is not the MLA latent cache")
    else:
        check(engine.page_size == 16 and engine.allocator is not None,
              f"{tag}: the engine did not page")
    per = {k: row["launches"][k] / fwd for k in ("encode_pack", "qmatmul",
                                                  "paged_attend",
                                                  "fused_sample")}
    row.update(cut=MOE_SERVE_CUT[arch], params=cfg.params_count(),
               launches_a_forward=per, dropped=drops)
    print(f"{tag}: {arch} launches a forward K1 {per['encode_pack']:.0f}, "
          f"K2 {per['qmatmul']:.0f}, K5 {per['paged_attend']:.0f}, K6 "
          f"{per['fused_sample']:.0f}; TTFT mean {row['ttft_mean_ms']:.1f} "
          f"ms, TPOT p50 {row['tpot_p50_ms']:.1f} ms; capacity dropped "
          + ", ".join(f"{k} {v['dropped']}/{v['assignments']} "
                      f"({v['share']:.1%}, C={v['capacity']})"
                      for k, v in drops.items() if v["assignments"])
          + f"; cache {'MLA latent, dense' if cfg.use_mla else 'paged'}")
    return row, engine


def route_apart(a, b):
    """(token, k) assignments of one router call whose expert the other
    call's token does not take."""
    K = a.shape[1]
    same = (a[:, :, None] == b[:, None, :]).any(-1).sum()
    return int(a.shape[0] * K - same)


def moe_logits(torch, arch):
    """24c: ``arch`` at full width, one dense and one MoE layer (random
    packed 8-bit weights from seed 0). Phase 5's run (a 32-token prefill
    and 4 greedy decode steps, kernels against plain versions and the
    f64-GEMM floor) with every router call recorded: the count of (token,
    k) routes on which the two paths part is printed by step, and every
    step whose routes agree is held to ``LOGIT_RTOL`` of max |logit|
    (a prefill's flipped route moves its token's rows; capacity couples
    the others). Then the cached form continues the training forward: a
    cached prefill of ``MOE_SEQ_TOKENS`` - 1 tokens and one decode step
    (deepseek: MLA's absorbed form from the latent cache; kimi: K5 over
    pages) against the training forward over all of them (MLA expanded,
    flash attention), with Q_A off the attention operands (the expanded
    form quantizes q, k and v, the absorbed form none) and a capacity
    that drops nothing: the dense layer alone (no route to part: the
    attention forms only) and both layers, the last position held to the
    same limit where its routes agree, beside the floor."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.lns import LNSFormat
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.kernels import dispatch, ref
    from repro_torch.models.model import forward, init_caches, init_params
    from repro_torch.optim.madam import MadamConfig, lns_leaf_encoder
    cfg = dataclasses.replace(get_config(arch), **MOE_LOGIT_CUT)
    qcfg = QuantConfig.lns_madam()
    params = init_params(cfg, seed=0, device="cuda", leaf_fn=lns_leaf_encoder(
        MadamConfig(update_format=LNSFormat(8, 8))))
    print(f"24c: {arch} {cfg.num_layers} layers, layer pattern "
          f"{cfg.layer_pattern()}")
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen,
                           device="cuda", dtype=torch.int32)
    bt = torch.arange(5, dtype=torch.int32, device="cuda")[None]

    def run(seq):
        caches = init_caches(1, 80, cfg, page_size=16, num_pages=5,
                             device="cuda")
        out, pos = [], 0
        with torch.no_grad():
            for toks in seq:
                lg = forward(params, toks, cfg, qcfg, caches=caches,
                             pos_offset=torch.tensor([pos], device="cuda"),
                             block_tables=bt)[:, -1].float()
                check(lg.shape == (1, cfg.vocab_size) and
                      bool(torch.isfinite(lg).all()),
                      f"24c {arch}: non-finite logits")
                out.append(lg)
                pos += toks.shape[1]
        return out

    seq = [prompt]
    with plain_versions(dispatch, ref):
        for _ in range(4):
            seq.append(run(seq)[-1].argmax(-1, keepdim=True).to(torch.int32))
        with routes_seen() as p_routes:
            plain = run(seq)
        dispatch.qmatmul = qmatmul_f64
        floor_run = run(seq)
    with routes_seen() as k_routes:
        kern = run(seq)
    apart = [route_apart(a, b) for a, b in zip(p_routes, k_routes)]
    per_step = len(apart) // len(seq)
    steps_apart = [sum(apart[j * per_step:(j + 1) * per_step])
                   for j in range(len(seq))]
    worst = floor = 0.0
    errs, held = [], 0
    for j, (p, k, f) in enumerate(zip(plain, kern, floor_run)):
        top = float(p.abs().max())
        err = float((p - k).abs().max()) / top
        errs.append(err)
        floor = max(floor, float((p - f).abs().max()) / top)
        if not steps_apart[j]:
            held += 1
            worst = max(worst, err)
            check(err <= LOGIT_RTOL, f"24c {arch}: step {j} logits err "
                  f"{err} of max |logit| > {LOGIT_RTOL} where the routes "
                  f"agree")
    print(f"24c {arch}: kernels vs plain over {len(seq)} steps: routes "
          f"apart {sum(apart)} of {sum(a.numel() for a in p_routes)} "
          f"(token, k) assignments (by step {steps_apart}); max err "
          f"{worst:.4f} of max |logit| over the {held} steps whose routes "
          f"agree (limit {LOGIT_RTOL}; by step "
          + ", ".join(f"{e:.4f}" for e in errs)
          + f"); floor (plain, f64 GEMM accumulation) {floor:.4f}")
    out = {"layers": cfg.num_layers, "routes_apart": apart,
           "routes": sum(a.numel() for a in p_routes),
           "routes_apart_by_step": steps_apart, "step_rel_err": errs,
           "steps_held": held, "max_rel_err_agreeing": worst,
           "floor_rel_err": floor}

    # the cached form continues the training forward: the same function
    # where Q_A leaves the attention operands alone (the expanded MLA form
    # quantizes q, k and v; the absorbed form none) and no route drops
    # (capacity E / K: a one-token decode step and a 64-token forward then
    # route a token alike)
    n = MOE_SEQ_TOKENS
    cont = dataclasses.replace(
        cfg, quantize_attention=False,
        capacity_factor=cfg.num_experts / cfg.experts_per_token)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device="cuda", dtype=torch.int32)
    bt_n = torch.arange(n // 16, dtype=torch.int32, device="cuda")[None]

    def continued(c):
        caches = init_caches(1, n, c, page_size=16, num_pages=n // 16,
                             device="cuda")
        with torch.no_grad():
            forward(params, tokens[:, :-1], c, qcfg, caches=caches,
                    pos_offset=0, block_tables=bt_n)
            return forward(params, tokens[:, -1:], c, qcfg, caches=caches,
                           pos_offset=n - 1,
                           block_tables=bt_n)[0, -1].float()

    def training(c):
        with torch.no_grad():
            return forward(params, tokens, c, qcfg)[0, -1].float()

    form = ("MLA expanded (flash attention) vs absorbed (latent cache)"
            if cfg.use_mla else "flash attention vs K5 over pages")
    # the dense layer alone (no route to part), then both layers
    for tag, c in (("dense layer", dataclasses.replace(cont, num_layers=1)),
                   ("both layers", cont)):
        with routes_seen() as c_routes:
            dec = continued(c)
        with routes_seen() as t_routes:
            train_lg = training(c)
        with plain_versions(dispatch, ref):
            plain_c = continued(c)
            dispatch.qmatmul = qmatmul_f64
            floor_c = continued(c)
        for x in (dec, train_lg):
            check(x.shape == (cfg.vocab_size,)
                  and bool(torch.isfinite(x).all()),
                  f"24c {arch}: logits {tuple(x.shape)} not finite or "
                  f"misshaped")
        # the last token's routes: the decode step's calls against the
        # last row of the training forward's, layer by layer
        last = [(a, b[-1:]) for a, b in zip(c_routes[len(t_routes):],
                                            t_routes)]
        gap = sum(route_apart(a, b) for a, b in last)
        top = float(dec.abs().max())
        err = float((train_lg - dec).abs().max()) / top
        floor = float((plain_c - floor_c).abs().max()) / top
        if gap == 0:
            check(err <= LOGIT_RTOL, f"24c {arch} {tag}: training forward "
                  f"vs cached decode err {err} > {LOGIT_RTOL}")
        print(f"24c {arch} {tag}: a cached prefill of {n - 1} tokens and "
              f"one decode step vs the training forward over {n} ({form}; "
              f"Q_A off the attention operands, capacity E/K), last "
              f"position: its routes apart {gap}; max err {err:.4f} of max "
              f"|logit| (limit {LOGIT_RTOL}"
              f"{'' if gap == 0 else ', not held: routes apart'}); floor "
              f"(plain, f64 GEMM accumulation) {floor:.4f}")
        key = "continued" if c is cont else "continued_dense"
        out.update({f"{key}_rel_err": err, f"{key}_routes_apart": gap,
                    f"{key}_floor": floor})
    del params
    return out


def mixtures(torch, ops, ref, fmt, card):
    """Phase 24: the mixtures of experts at full width on the card. Every
    K1 and K2 call of 24a-24d is recorded, and after them each shape is
    held against the plain version; K2 at both models' decode GEMMs and K6
    at both vocabularies are timed beside torch, and K3 runs at 24d's
    4-D expert leaf."""
    t0 = time.monotonic()
    marks = [("start", t0)]
    mark = lambda name: marks.append((name, time.monotonic()))
    print(f"phase 24 (mixtures of experts) on {card}")
    out = {}
    with k1_shapes_seen(torch, ops) as k1_seen, \
            k2_shapes_seen(torch, ops) as k2_seen:
        for arch, tag in (("deepseek-v3-671b", "24a"),
                          ("kimi-k2-1t-a32b", "24b")):
            out[f"{arch}_serve"], engine = moe_serve(torch, ops, arch, tag)
            del engine
            gc.collect()
            torch.cuda.empty_cache()
            mark(tag)
        for arch in ("deepseek-v3-671b", "kimi-k2-1t-a32b"):
            out[f"{arch}_logits"] = moe_logits(torch, arch)
            gc.collect()
            torch.cuda.empty_cache()
        mark("24c")
        arch, layers, batch, seq, cut = MOE_TRAIN
        out["deepseek_train"] = modality_train(torch, ops, arch, layers,
                                               batch, seq, "24d", **cut)
        gc.collect()
        torch.cuda.empty_cache()
        mark("24d")
    out["k1_driven"] = k1_driven_check(torch, ops, ref, fmt, k1_seen)
    out["k2_driven"] = k2_driven_check(torch, ops, ref, fmt, k2_seen)
    out["decode_k2"] = k2_check(torch, ops, ref, fmt, DEEPSEEK_DECODE_GEMMS
                                + KIMI_DECODE_GEMMS)
    out["decode_k6"] = k6_check(torch, ops, ref, [(4, 129280), (4, 163840)])
    torch.cuda.empty_cache()
    E = MOE_TRAIN[4]["num_experts"]
    out["expert_k3"] = k3_large_leaf(torch, ops, ref, E * 7168, 2048,
                                     f"24d's 4-D expert leaf w_up, 1 x {E} "
                                     f"x 7168 x 2048")
    torch.cuda.empty_cache()
    mark("24 kernels")
    secs = time.monotonic() - t0
    parts = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    print(f"phase 24 took {secs:.1f}s ("
          + ", ".join(f"{k} {v:.1f}s" for k, v in parts.items()) + ")")
    out.update(seconds=secs, seconds_by_part=parts)
    return out



# ---------------------------------------------------------------------------
# phase 25: mesh serving (``repro_torch.distributed``)

# 25a: the decode GEMMs the serving rules shard by columns (qwen2.5-32b's
# wq, wk/wv and up/gate; kimi-k2's wq, wk/wv and the dense layer's and
# shared expert's up/gate), each column block of m = 2 and 4 held to the
# matching columns of the whole call; the last row is a wgmma case
MESH_K2_GEMMS = [(4, 5120, 5120), (4, 5120, 1024), (4, 5120, 27648),
                 (4, 7168, 8192), (4, 7168, 1024), (4, 7168, 2048),
                 (256, 5120, 5120)]
# K5 by head group: qwen2.5-32b's decode (40 query heads over 8 KV heads,
# head_dim 128) and gemma3-12b's global layers (16 over 8 at 256)
MESH_K5_HEADS = [("qwen2.5-32b", (40, 8, 128)), ("gemma3-12b", K5_HD256)]
MESH_SPLITS = (2, 4)
# the shard shapes timed for the kernel table: qwen2.5-32b's up/gate
# column block and its decode head group at model = 4
MESH_K2_TIMED = [(4, 5120, 27648 // 4)]
MESH_K5_TIMED = [("qwen2.5-32b head group of 4: decode bf16 pool", 4, 1,
                  [33, 48, 61, 66], False, (10, 2, 128)),
                 ("qwen2.5-32b head group of 4: decode packed pool", 4, 1,
                  [33, 48, 61, 66], True, (10, 2, 128))]
# --mesh: the runs (arch, serve argv, mesh) on four cards
MESH_WORLD = 4
MESH_SMOLLM = SPEC_SERVE + ["--alloc-policy", "ondemand", "--speculate-k",
                            str(SPEC_K), "--draft-bitwidth", "6"]
MESH_RUNS = [
    ("25c", "smollm-135m", MESH_SMOLLM, "2,2", None),
    ("25d", "qwen2.5-32b", SERVE_PAGED, "1,4", None),
    # kimi-k2's dense layer and 8 of its 60 MoE layers: ~139e9 words,
    # more than one card holds
    ("25e", "kimi-k2-1t-a32b", SERVE_PAGED, "1,4", dict(num_layers=9)),
    # phase 24b's cut, beside its one-card streams
    ("25e2", "kimi-k2-1t-a32b", SERVE_PAGED, "1,4", dict(num_layers=3)),
]
# the runs whose one-card streams the parent computes first
MESH_ONE_CARD = ("25c", "25d", "25e2")
# --mesh-25c: 25c five times in one spawn, then once with the paged
# write's last-writer rule off (the write before H20's repair)
H20_RUNS = ([(f"25c.{i}", "smollm-135m", MESH_SMOLLM, "2,2", None)
             for i in range(1, 6)]
            + [("25c.old", "smollm-135m", MESH_SMOLLM, "2,2", None)])
MESH_TIMEOUT_S = 300
# phase 26: data-parallel training on (4, 1), each part beside one card's
# steps on the same global batches (batch is the global batch)
DP_RUNS = [
    ("26a", dict(arch="smollm-135m", batch=32, seq=256, steps=3, cli=True,
                 words=True)),
    ("26b", dict(arch="gemma3-12b", cut=dict(num_layers=6), batch=4,
                 seq=256, steps=2)),
    ("26c", dict(arch="deepseek-v3-671b", smoke=True, batch=8, seq=64,
                 steps=3, groups=4, words=True)),
]
# step 0: the forward's scales are global and K2's rows do not depend on
# M's split, so only the loss shares' sum and torch's batched attention
# GEMMs at another batch count reorder; later steps and grad norms as H11
DP_STEP0_RTOL = 1e-4
DP_GNORM_RTOL = 0.1

# phase 27 (mesh serving completed). 27a: the gateway on (2, 2) over
# smollm-135m at full width, paged on demand, k = 2, rank 0 serving
# loopback HTTP and the other ranks following; 8 streamed completions one
# after another (a row's tokens depend on what shares its batch, so each
# runs alone, as in the one-card replay), an idle gap, then a DELETE and a
# burst past the watermark. 27b/27c: rwkv6-1.6b and zamba2-7b at full
# width and depth on (1, 4), short prompts (a recurrent prefill is a step
# a position)
GATEWAY_ARGV = ["--arch", "smollm-135m", "--slots", "4", "--page-size",
                "16", "--alloc-policy", "ondemand", "--speculate-k", "2",
                "--draft-bitwidth", "6", "--max-len", "160",
                "--max-queue", "4"]
GATEWAY_MESH = "2,2"
GATEWAY_STREAMS = 8
GATEWAY_IDLE_S = 4.0
GATEWAY_EXIT_S = 120
RECURRENT_MESH_ARGV = ["--requests", "4", "--slots", "4", "--prompt-len",
                       "8", "--gen-len", "16", "--page-size", "16"]
MESH27_RUNS = [("27b", "rwkv6-1.6b", RECURRENT_MESH_ARGV, "1,4", None),
               ("27c", "zamba2-7b", RECURRENT_MESH_ARGV, "1,4", None)]
# 27's shard shapes at model = 4 (and 2): K2 on rwkv6's ck (2048 x 7168)
# and zamba2's shared up/gate (3584 x 14336) column blocks; K5 on
# zamba2's head groups (32 over 32 KV heads at 112); the blocks timed
MESH27_K2_GEMMS = [(4, 2048, 7168), (4, 3584, 14336)]
MESH27_K5_HEADS = [("zamba2-7b", K5_HD112)]
MESH27_K2_TIMED = [(4, 2048, 7168 // 4), (4, 3584, 14336 // 4)]
MESH27_K5_TIMED = [("zamba2 head group of 4: decode bf16 pool hd 112", 4, 1,
                    [33, 48, 61, 66], False, (8, 8, 112)),
                   ("zamba2 head group of 4: decode packed pool hd 112", 4,
                    1, [33, 48, 61, 66], True, (8, 8, 112))]
# the merged QKV check's activations: a decode step of 4 slots and a
# prefill of 8 positions
MERGED_QKV_X = [(4, 1), (1, 8)]


def dp_config(spec):
    """A phase-26 part's model config."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config(spec["arch"]) if spec.get("smoke")
           else get_config(spec["arch"]))
    return dataclasses.replace(cfg, **spec.get("cut", {}))


@contextlib.contextmanager
def dp_groups(n):
    """One card's MoE dispatch groups set to ``n`` (the reference of an
    (n, 1) data-parallel mesh, where each data shard is one group)."""
    from repro_torch.models import moe as moe_mod
    real = moe_mod._dp_groups
    if n:
        moe_mod._dp_groups = lambda: n
    try:
        yield
    finally:
        moe_mod._dp_groups = real


def dp_words(state):
    """The packed words of a train state, on the host, by leaf path."""
    from repro_torch.tree import leaves
    return {"/".join(map(str, p)): x.packed.cpu() for p, x in
            leaves(state.params) if hasattr(x, "packed")}


def dp_checksum(torch, state):
    """Position-weighted int64 sums of every packed word and of every
    second moment's bits (a chunk at a time; wrapping is fine): equal on
    two ranks whose states are equal."""
    from repro_torch.tree import leaves
    words = [x.packed for _, x in leaves(state.params) if hasattr(x, "packed")]
    moments = [v.to(torch.float32).contiguous().view(torch.int32)
               for _, v in leaves(state.opt.g2)]
    out = torch.zeros(2, dtype=torch.int64, device=words[0].device)
    for slot, parts in ((0, words), (1, moments)):
        for i, t in enumerate(parts):
            flat = t.reshape(-1)
            for lo in range(0, flat.numel(), 1 << 26):
                c = flat[lo:lo + (1 << 26)].long()
                w = (torch.arange(lo, lo + c.numel(), device=c.device)
                     % 65521 + 1 + i)
                out[slot] += (c * w).sum()
    return out


def dp_one_card(torch, ops, tag, spec, scratch):
    """Phase 26 on one card (card 0): the part's steps on the global
    batches; losses, grad norms, step times, peak; the words after the
    first step saved for the ranks to compare; one more step cut into
    stages (``dp_stages``)."""
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.steps import build_train_step, init_train_state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, mcfg = dp_config(spec), MadamConfig()
    data = SyntheticLM(cfg, batch=spec["batch"], seq=spec["seq"])
    rows = []
    with dp_groups(spec.get("groups")):
        state = init_train_state(cfg, mcfg, seed=0, device="cuda")
        step = build_train_step(cfg, QuantConfig.lns_madam(), mcfg)
        for i in range(spec["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, data.batch_at(i))
            loss = float(m["loss"])
            torch.cuda.synchronize()
            rows.append({"loss": loss, "grad_norm": float(m["grad_norm"]),
                         "step_ms": (time.perf_counter() - t0) * 1e3})
            if i == 0 and spec.get("words"):
                torch.save(dp_words(state), scratch / f"{tag}_one_card.pt")
        stages = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with dp_stages(torch, stages):
            state, m = step(state, data.batch_at(spec["steps"]))
            float(m["loss"])
        torch.cuda.synchronize()
        stages["step_ms"] = (time.perf_counter() - t0) * 1e3
    out = {"steps": rows, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "stages": stages}
    print(f"{tag} one card: {spec['arch']} {spec['batch']} x {spec['seq']}: "
          "losses " + " ".join(f"{r['loss']:.5f}" for r in rows)
          + ", grad norms " + " ".join(f"{r['grad_norm']:.4f}" for r in rows)
          + f", peak {out['peak_gb']:.2f} GB", flush=True)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_given_spy():
    """Count the K1 calls that take a given scale (``encode_pack(scale=)``,
    the data-parallel rank's global scale) while open."""
    from repro_torch.kernels import dispatch
    real = dispatch.encode_pack
    seen = [0]

    def spy(x, fmt, scale_axis=None, scale=None):
        if scale is not None:
            seen[0] += 1
        return real(x, fmt, scale_axis, scale)

    @contextlib.contextmanager
    def ctx():
        dispatch.encode_pack = spy
        try:
            yield seen
        finally:
            dispatch.encode_pack = real
    return ctx()


def dp_cli(torch, ops, tag, spec, scratch):
    """26a's main path: ``launch.train --mesh 4,1`` on this rank, the
    launch counts zeroed just before and read just after."""
    from repro_torch.launch.train import main as train_main
    argv = ["--arch", spec["arch"], "--mesh", f"{MESH_WORLD},1", "--steps",
            str(spec["steps"]), "--batch", str(spec["batch"]), "--seq",
            str(spec["seq"]), "--ckpt-dir", str(scratch / f"{tag}_ckpt")]
    with dp_given_spy() as given:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = train_main(argv)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    return {"losses": out["losses"], "wall_s": out["wall_s"],
            "tokens_per_s": out["tokens_per_s"],
            "failures_recovered": out["failures_recovered"],
            "launches": counts, "k1_given_scale_calls": given[0]}


@contextlib.contextmanager
def dp_profiled(torch, out):
    """A step under torch.profiler: NCCL's device time (the wait for the
    other ranks included), the other kernels' device time, the c10d
    calls' host time and count, into ``out``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ev = averages(prof)
    kernels = [e for e in ev if e.device_type == cuda]
    nccl = [e for e in kernels if e.key.startswith("ncclDevKernel")]
    host = [e for e in ev if e.device_type != cuda
            and e.key.startswith("c10d::")]
    out.update({
        "busy_ms": sum(e.self_device_time_total for e in kernels
                       if not e.key.startswith("nccl")) / 1e3,
        "nccl_ms": sum(e.self_device_time_total for e in nccl) / 1e3,
        "nccl_kernels": sum(e.count for e in nccl),
        "host_collective_ms": sum(e.cpu_time_total for e in host) / 1e3,
        "host_collective_calls": {e.key: e.count for e in host}})


@contextlib.contextmanager
def dp_stages(torch, out):
    """One step cut into stages at synchronized boundaries, with no
    profiler: the forward (``lm_loss``), the backward (up to the
    gradients' SUM reduce, or up to Q_G on one card), the SUM reduce, Q_G,
    and the rest (grad norm, K3, the loss read back), into ``out`` with
    the MAX reduce calls' host time and count. The stages add up to the
    step; the syncs cost a few device round trips."""
    from repro_torch.distributed import collectives
    from repro_torch.training import steps as steps_mod
    saved = (steps_mod.lm_loss, collectives.sum_tensors,
             steps_mod.quantize_grads, collectives.max_reduce)
    marks, host = [], [0.0, 0]

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    def lm_loss(*a, **k):
        y = saved[0](*a, **k)
        mark("forward")
        return y

    def sum_tensors(*a, **k):
        mark("backward")
        y = saved[1](*a, **k)
        mark("sum_reduce")
        return y

    def quantize_grads(*a, **k):
        if marks[-1][0] == "forward":
            mark("backward")
        y = saved[2](*a, **k)
        mark("q_g")
        return y

    def max_reduce(*a, **k):
        t = time.perf_counter()
        y = saved[3](*a, **k)
        host[0] += time.perf_counter() - t
        host[1] += 1
        return y

    (steps_mod.lm_loss, collectives.sum_tensors, steps_mod.quantize_grads,
     collectives.max_reduce) = (lm_loss, sum_tensors, quantize_grads,
                                max_reduce)
    mark("start")
    try:
        yield
        mark("update")
    finally:
        (steps_mod.lm_loss, collectives.sum_tensors,
         steps_mod.quantize_grads, collectives.max_reduce) = saved
    ms = collections.defaultdict(float)
    for (_, t0), (name, t1) in zip(marks, marks[1:]):
        ms[name] += (t1 - t0) * 1e3
    out.update(stages_ms=dict(ms), max_reduce_host_ms=host[0] * 1e3,
               max_reduce_calls=host[1])


def dp_part(torch, ops, tag, spec, scratch):
    """Phase 26 on this rank: (26a) the CLI run, then the part's steps on
    a (4, 1) mesh: per step the loss, grad norm, step time, collectives
    by kind, launches, the given-scale K1 calls and every rank's
    checksum (each step begun at a barrier); the words after step 1
    against one card's (rank 0, after the steps); one more step profiled
    (its time includes the profiler's) and one cut into stages
    (``dp_stages``); the peak."""
    import torch.distributed as dist
    from repro_torch.configs import get_rules
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import shard_ctx
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.steps import build_train_step, init_train_state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_part = time.monotonic()
    out = {"arch": spec["arch"], "rank": dist.get_rank()}
    if spec.get("cli"):
        out["cli"] = dp_cli(torch, ops, tag, spec, scratch)
        gc.collect()
        torch.cuda.empty_cache()
    mesh = make_host_mesh(MESH_WORLD, 1)
    cfg, mcfg = dp_config(spec), MadamConfig()
    data = SyntheticLM(cfg, batch=spec["batch"], seq=spec["seq"])
    rows, step1 = [], None
    with shard_ctx(mesh, get_rules(spec["arch"])), dp_given_spy() as given:
        state = init_train_state(cfg, mcfg, seed=0, device=mesh.device)
        step = build_train_step(cfg, QuantConfig.lns_madam(), mcfg)
        for i in range(spec["steps"] + 2):
            batch = data.batch_at(i)
            # every rank starts the step together, so its time holds no
            # other rank's work between steps
            dist.barrier()
            torch.cuda.synchronize()
            collectives.reset_counts()
            ops.reset_launch_counts()
            given[0] = 0
            prof = {}
            # two more steps: one profiled, one cut into stages
            extra = i == spec["steps"]
            staged = i == spec["steps"] + 1
            t0 = time.perf_counter()
            with (dp_profiled(torch, prof) if extra else
                  dp_stages(torch, prof) if staged
                  else contextlib.nullcontext()):
                state, m = step(state, batch)
                loss = float(m["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if extra:
                out["profile"] = dict(prof, step_ms=ms)
                continue
            if staged:
                out["stages"] = dict(prof, step_ms=ms)
                break
            row = {"loss": loss, "grad_norm": float(m["grad_norm"]),
                   "step_ms": ms, "collectives": collectives.counts(),
                   "collective_bytes": collectives.byte_counts(),
                   "launches": ops.launch_counts(),
                   "k1_given_scale_calls": given[0]}
            cs = dp_checksum(torch, state)
            every = torch.empty((MESH_WORLD, 2), dtype=torch.int64,
                                device=cs.device)
            (getattr(dist, "all_gather_single", None)
             or dist.all_gather_into_tensor)(every, cs[None])
            row["ranks_agree"] = bool((every == every[0]).all())
            rows.append(row)
            if i == 0 and spec.get("words") and dist.get_rank() == 0:
                step1 = dp_words(state)
    if step1 is not None:
        ref = torch.load(scratch / f"{tag}_one_card.pt")
        n = tot = 0
        sizes = None
        for k, w in ref.items():
            d = step1[k].long() - w.long()
            n += int((d != 0).sum())
            tot += d.numel()
            b = torch.bincount(d[d != 0].abs().clamp(max=33), minlength=34)
            sizes = b if sizes is None else sizes + b
        out["word_share"] = n / tot
        # how far apart: 1 code (a rounding tie), 32 (a gradient's sign
        # flipped at step 1: Madam moves 16 codes), 33 = more
        out["word_diff_sizes"] = {str(k): int(v) for k, v in
                                  enumerate(sizes.tolist()) if v}
    out["steps"] = rows
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.monotonic() - t_part
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_checks(tag, spec, one, ranks):
    """Phase 26's checks on every rank's rows against one card's."""
    r0 = ranks[0]
    for r in ranks:
        check(all(x["ranks_agree"] for x in r["steps"]),
              f"{tag} rank {r['rank']}: a rank's words or moments left the "
              f"others' after a step")
        check(all(x["loss"] == y["loss"] and x["grad_norm"] == y["grad_norm"]
                  for x, y in zip(r["steps"], r0["steps"])),
              f"{tag} rank {r['rank']}: its losses differ from rank 0's")
        for x in r["steps"]:
            check(x["launches"]["encode_pack"] > 0
                  and x["launches"]["qmatmul"] > 0
                  and x["k1_given_scale_calls"] > 0,
                  f"{tag}: K1 with a given scale or K2 not launched on a "
                  f"data-parallel step: {x['launches']}")
            check(x["collectives"]["max_reduce"] > 0
                  and x["collectives"]["sum"] > 0,
                  f"{tag}: a step made no MAX or SUM reduce: "
                  f"{x['collectives']}")
        if "cli" in r:
            c = r["cli"]
            check(c["failures_recovered"] == 0
                  and all(math.isfinite(v) for v in c["losses"]),
                  f"{tag}: the CLI run retried or lost its loss: {c}")
            check(c["launches"]["madam_step"] == 8 * spec["steps"]
                  and c["launches"]["encode_pack"] > 0
                  and c["launches"]["qmatmul"] > 0
                  and c["launches"]["qmatmul_decode"] > 0
                  and c["k1_given_scale_calls"] > 0,
                  f"{tag}: the CLI's main path launches {c['launches']}, "
                  f"given-scale K1 calls {c['k1_given_scale_calls']}")
    rel = [abs(x["loss"] - y["loss"]) / abs(y["loss"])
           for x, y in zip(r0["steps"], one["steps"])]
    grel = [abs(x["grad_norm"] - y["grad_norm"]) / abs(y["grad_norm"])
            for x, y in zip(r0["steps"], one["steps"])]
    check(rel[0] <= DP_STEP0_RTOL, f"{tag}: step-0 loss {rel[0]:.2e} from "
          f"one card's (limit {DP_STEP0_RTOL})")
    check(all(v <= TRAIN_LOSS_RTOL for v in rel), f"{tag}: losses {rel} "
          f"from one card's (limit {TRAIN_LOSS_RTOL})")
    check(all(v <= DP_GNORM_RTOL for v in grel), f"{tag}: grad norms {grel}"
          f" from one card's (limit {DP_GNORM_RTOL})")
    if spec.get("words"):
        check(r0["word_share"] <= TRAIN_WORD_SHARE,
              f"{tag}: {r0['word_share']:.2%} of words apart from one "
              f"card's after step 1")
    return {"loss_rel": rel, "grad_norm_rel": grel}


def shard_invariance(torch, ops, ref, fmt, tag="25a", gemms=MESH_K2_GEMMS,
                     heads_list=MESH_K5_HEADS, splits=MESH_SPLITS,
                     k2_timed=MESH_K2_TIMED, k5_timed=MESH_K5_TIMED):
    """25a (27's shapes with ``tag="27"``): K2 on each contiguous column
    block (m = 2, 4) of every ``gemms`` shape, f32 and bf16 out, must
    equal those columns of the whole call bit for bit; K5 on each head
    group of ``heads_list`` (bf16 and packed pools) must equal those
    heads of the whole call. Then the shard shapes the mesh runs are
    timed as phase 3 times K2 and K5 (the kernel table's shard rows)."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    rows = []
    for M, K, N in gemms:
        x = torch.randn((M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        pa, sa = ops.encode_pack(x, fmt)
        pb = torch.randint(0, 256, (K, N), generator=gen, device="cuda",
                           dtype=torch.uint8)
        sb = torch.exp2(torch.randint(-6, -2, (1, N), generator=gen,
                                      device="cuda").float())
        path = ops.qmatmul_plan(M, N, K)["path"]
        for odt in (torch.float32, torch.bfloat16):
            whole = ops.qmatmul(pa, pb, fmt, sa, sb, out_dtype=odt)
            for m in splits:
                w = N // m
                for r in range(m):
                    cols = slice(r * w, (r + 1) * w)
                    part = ops.qmatmul(pa, pb[:, cols].contiguous(), fmt, sa,
                                       sb[:, cols].contiguous(),
                                       out_dtype=odt)
                    check(torch.equal(part, whole[:, cols]),
                          f"{tag} K2 {M}x{K}x{N} ({path}) column block {r} of "
                          f"{m} ({odt}) differs from the whole call's")
        rows.append({"kernel": "qmatmul", "shape": [M, K, N], "path": path,
                     "splits": list(splits), "bitwise": True})
        print(f"{tag} K2 {M}x{K}x{N} ({path}): every column block of "
              f"m = 2, 4 equals the whole call's columns bit for bit (f32 "
              f"and bf16 out)")
    for arch, heads in heads_list:
        H, KV, HD = heads
        for packed in (False, True):
            q, kp, vp, ks, vs, bt, ln = k5_inputs(
                torch, 4, 1, [33, 48, 61, 66], packed, fmt, gen, heads)
            kw = dict(fmt=fmt if packed else None, softcap=None,
                      sm_scale=1 / math.sqrt(HD))
            whole = ops.paged_attend(q, kp, vp, ks, vs, bt, ln, **kw)
            for m in splits:
                for r in range(m):
                    hs = slice(r * H // m, (r + 1) * H // m)
                    gs = slice(r * KV // m, (r + 1) * KV // m)
                    part = lambda t: (None if t is None
                                      else t[:, :, gs].contiguous())
                    got = ops.paged_attend(q[:, :, hs].contiguous(),
                                           part(kp), part(vp), part(ks),
                                           part(vs), bt, ln, **kw)
                    check(torch.equal(got, whole[:, :, hs]),
                          f"{tag} K5 {arch} head group {r} of {m} "
                          f"({'packed' if packed else 'bf16'} pool) differs "
                          f"from the whole call's heads")
            rows.append({"kernel": "paged_attend", "arch": arch,
                         "heads": list(heads), "packed": packed,
                         "splits": list(splits), "bitwise": True})
            print(f"{tag} K5 {arch} {H}/{KV} heads at head_dim {HD} "
                  f"({'packed' if packed else 'bf16'} pool): every head "
                  f"group of m = 2, 4 equals the whole call's heads bit for "
                  f"bit")
    k2 = k2_check(torch, ops, ref, fmt, k2_timed)
    k5 = k5_check(torch, ops, ref, fmt, k5_timed)
    return {"invariance": rows, "qmatmul": k2, "paged_attend": k5}


def mesh_of_one(torch, ops, phase4_streams):
    """25b: ``Engine(mesh=)`` on a (1, 1) mesh (an NCCL world of one)
    serves phase 4's paged trace at smollm-135m's full width through the
    serve CLI's engine: every request completes and the streams equal
    phase 4's."""
    import torch.distributed as dist
    agg, engine, counts = serve(torch, SERVE_PAGED + ["--mesh", "1,1"], ops,
                                warm="short")
    try:
        check(engine._mesh is not None and dist.get_backend() == "nccl",
              f"25b: the engine runs no NCCL mesh ({dist.get_backend()})")
        got = streams(engine)
        check(agg["completed"] == 8 and got == phase4_streams,
              "25b: the (1, 1) mesh's streams differ from phase 4's")
        check(all(counts[k] > 0 for k in ("encode_pack", "qmatmul",
                                          "paged_attend", "fused_sample")),
              f"25b: a kernel was not launched on the mesh path: {counts}")
        row = {"completed": int(agg["completed"]), "launches": counts,
               "tpot_p50_ms": agg["tpot_p50_s"] * 1e3,
               "tokens_per_s": agg["tokens_per_s"],
               "decode_steps": engine.decode_steps, "streams_equal": True}
        print(f"25b: (1, 1) NCCL mesh served 8/8, streams equal phase 4's, "
              f"tpot p50 {row['tpot_p50_ms']:.2f} ms, launches {counts}")
        row["gateway"] = mesh_of_one_gateway(torch, ops, engine)
    finally:
        del engine
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    return row


def mesh_of_one_gateway(torch, ops, engine):
    """25b: the (1, 1) mesh's engine, reset, serves 3 streamed completions
    through ``launch.serve.run_http`` on 127.0.0.1:0 (the mesh gateway's
    path: the driver steps through the step broadcast, its numerics
    come from one, its stop is one), the client on a thread of this
    process, which then interrupts the process as Ctrl-C would. Every
    completion ends 'length', /health names the mesh, the run returns
    with no page in use and every kernel of the path launched."""
    import asyncio
    import signal
    import threading
    from repro_torch.launch.serve import run_http
    engine.reset()
    bodies = [{"prompt": list(range(1 + i, 17 + i)), "max_tokens": 8}
              for i in range(3)]
    box = {}

    def ready(host, port):
        box["addr"] = (host, port)

    def client():
        try:
            t_end = time.monotonic() + 60
            while "addr" not in box and time.monotonic() < t_end:
                time.sleep(0.01)
            host, port = box["addr"]

            async def session():
                res = [await sse_call(host, port, b) for b in bodies]
                health = json.loads((await http_call(host, port, "GET",
                                                     "/health"))[1])
                return res, health
            box["res"] = asyncio.run(session())
        finally:
            os.kill(os.getpid(), signal.SIGINT)

    thread = threading.Thread(target=client, daemon=True)
    prev = signal.getsignal(signal.SIGINT)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    thread.start()
    try:
        run_http(engine, "127.0.0.1:0", engine.cfg.name, 8, ready=ready)
    finally:
        signal.signal(signal.SIGINT, prev)
    thread.join(10)
    wall = time.monotonic() - t0
    counts = ops.launch_counts()
    check("res" in box, "25b: the gateway's client did not finish")
    res, health = box["res"]
    check(all(r["status"] == 200 and r["reason"] == "length"
              and len(r["tokens"]) == 8 for r in res),
          f"25b: a gateway completion on the (1, 1) mesh did not finish: "
          f"{[(r['status'], r['reason']) for r in res]}")
    check(health.get("mesh") == {"data": 1, "model": 1}
          and health.get("numerics", {}).get("weights", {}).get("elements"),
          f"25b: /health lacks the mesh or the numerics: {health}")
    check(engine.allocator.in_use == 0 and not engine.scheduler.running,
          "25b: the gateway's stop left pages or requests behind")
    check(all(counts[k] > 0 for k in ("encode_pack", "qmatmul",
                                      "paged_attend", "fused_sample")),
          f"25b: a kernel was not launched through the gateway: {counts}")
    print(f"25b: the (1, 1) mesh's gateway served 3 streams in "
          f"{wall:.2f}s, /health mesh {health['mesh']}, stopped with no "
          f"page in use, {engine.mesh_syncs} step broadcasts")
    return {"wall_s": wall, "launches": counts, "mesh": health["mesh"],
            "mesh_syncs": engine.mesh_syncs}


@contextlib.contextmanager
def logits_recorded(ops, path):
    """While open, every logits batch the engine samples (prefills and
    decode steps) is kept on the host, emptied at each launch-count reset
    (so after ``serve`` it holds the counted run's), and saved to
    ``path`` when the block ends."""
    from repro_torch.serving import engine as engine_mod
    import torch
    seen = []
    real = engine_mod.sample_logits

    def spy(logits, *a, **kw):
        seen.append(logits.detach().to(torch.float32).cpu())
        return real(logits, *a, **kw)

    engine_mod.sample_logits = spy
    reset = ops.reset_launch_counts

    def reset_too():
        seen.clear()
        reset()
    ops.reset_launch_counts = reset_too
    try:
        yield seen
    finally:
        engine_mod.sample_logits = real
        ops.reset_launch_counts = reset
        torch.save(list(seen), path)


def where_parted(torch, a_path, b_path):
    """The first sampled batch at which two runs' logits differ, and the
    first at which a row's argmax differs, with the max |gap| there."""
    a, b = torch.load(a_path), torch.load(b_path)
    out = {"batches": [len(a), len(b)], "first_differ": None,
           "first_argmax": None}
    for i, (x, y) in enumerate(zip(a, b)):
        if x.shape != y.shape:
            out["shape_apart"] = i
            break
        if out["first_differ"] is None and not torch.equal(x, y):
            out["first_differ"] = {"batch": i, "max_abs_gap": float(
                (x - y).abs().max()), "max_abs": float(x.abs().max())}
        if not torch.equal(x.argmax(-1), y.argmax(-1)):
            out["first_argmax"] = {"batch": i, "max_abs_gap": float(
                (x - y).abs().max())}
            break
    return out


@contextlib.contextmanager
def batch_digests():
    """While open, a digest of every logits batch the engine samples and
    the batch's argmax ids (the greedy rows' tokens), in order."""
    import hashlib
    import torch
    from repro_torch.serving import engine as engine_mod
    seen = []
    real = engine_mod.sample_logits

    def spy(logits, *a, **kw):
        host = logits.detach().contiguous().cpu()
        seen.append([hashlib.sha1(host.view(-1).view(torch.uint8).numpy()
                                  .tobytes()).hexdigest()[:16],
                     host.float().argmax(-1).reshape(-1).tolist()])
        return real(logits, *a, **kw)

    engine_mod.sample_logits = spy
    try:
        yield seen
    finally:
        engine_mod.sample_logits = real


def null_page_digest(torch, engine):
    """A digest of the null page (the pool's last page) of every paged
    pool of the engine, in tree order."""
    import hashlib
    from repro_torch.tree import leaves
    h = hashlib.sha1()
    for path, t in leaves(engine.caches):
        if path[-1] in ("kp", "vp", "kp_scale", "vp_scale"):
            page = t[:, -1] if t.dim() == 5 else t[-1]
            h.update(page.contiguous().view(-1).view(torch.uint8).cpu()
                     .numpy().tobytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def scatter_unordered(on):
    """With ``on``, the paged write takes every duplicate null-page target
    in the card's scatter order, as before H20's repair
    (``attention._last_writer`` keeps every write)."""
    from repro_torch.models import attention
    real = attention._last_writer
    if on:
        attention._last_writer = lambda target, keep: keep.clone()
    try:
        yield
    finally:
        attention._last_writer = real


def first_parting(a, b):
    """The first sampled batch at which two ranks' digests differ, with
    both batches' argmax ids, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x[0] != y[0]:
            return {"batch": i, "ids": [x[1], y[1]]}
    return None if len(a) == len(b) else {"batch": min(len(a), len(b))}


def one_card(torch, ops, tag, arch, argv, cut, scratch):
    """A one-card run (card 0) of a mesh run's trace, for its streams,
    TPOT and memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ctx = cut_config(arch, **cut) if cut else contextlib.nullcontext()
    rec = (logits_recorded(ops, scratch / f"{tag}_one_card.pt")
           if tag == "25e2" else contextlib.nullcontext())
    with ctx, rec:
        agg, engine, counts = serve(torch, ["--arch", arch] + argv, ops,
                                    warm="short")
    row = {"streams": streams(engine), "completed": int(agg["completed"]),
           "tpot_p50_ms": agg["tpot_p50_s"] * 1e3,
           "ttft_mean_ms": agg["ttft_mean_s"] * 1e3,
           "tokens_per_s": agg["tokens_per_s"],
           "weights_gb": packed_bytes(engine.params) / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"{tag} one card: {arch} {row['completed']} requests, tpot p50 "
          f"{row['tpot_p50_ms']:.2f} ms, weights {row['weights_gb']:.2f} GB,"
          f" peak {row['peak_gb']:.2f} GB")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return row


def profile_mesh_step(torch, engine, trace, ops, out_dir):
    """One decode step of a mesh engine with its 4 slots busy, under
    torch.profiler on every rank: the collectives it issues, the device
    time of NCCL's kernels (the time they wait for the other ranks
    included) and of every kernel, the host time of the collective calls,
    K2's and K5's launches; then 3 steps unprofiled for the wall time a
    step. Rank 0's trace goes to ``out_dir`` (gzipped Chrome JSON)."""
    from repro_torch.distributed import collectives
    engine.reset()
    reqs = trace()[:engine.num_slots]
    for r in reqs:
        r.max_new_tokens = 8
    if engine._root:
        for r in reqs:
            engine.submit(r)
    engine.step()            # admissions and the first decode
    engine.step()
    torch.cuda.synchronize()
    collectives.reset_counts()
    ops.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        engine.step()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in averages(prof) if e.device_type == cuda]
    # NCCL's kernels only (its "nccl:*" ranges repeat their time)
    nccl = [e for e in kernels if e.key.startswith("ncclDevKernel")]
    host = [e for e in averages(prof) if e.device_type != cuda
            and e.key.startswith("c10d::")]
    row = {"collectives": collectives.counts(),
           "collective_bytes": collectives.byte_counts(),
           "launches": ops.launch_counts(),
           "busy_ms": sum(e.self_device_time_total for e in kernels
                          if not e.key.startswith("nccl:")) / 1e3,
           "nccl_ms": sum(e.self_device_time_total for e in nccl) / 1e3,
           "nccl_kernels": sum(e.count for e in nccl),
           "nccl_by_name": {e.key[:60]: e.self_device_time_total / 1e3
                            for e in nccl},
           "host_collective_ms": sum(e.cpu_time_total for e in host) / 1e3,
           "host_collective_calls": {e.key: e.count for e in host}}
    if engine._root:
        import gzip
        raw = Path(out_dir) / "mesh_step_rank0.json"
        prof.export_chrome_trace(str(raw))
        dest = ROOT / "chiprun_out" / "mesh_step_rank0.trace.json.gz"
        dest.parent.mkdir(exist_ok=True)
        dest.write_bytes(gzip.compress(raw.read_bytes()))
        raw.unlink()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    row["step_wall_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    engine.run(())
    return row


def mesh_serve(torch, ops, tag, arch, argv, mesh, cut, scratch):
    """One mesh run on this rank through the serve CLI's engine: rank 0
    takes the trace (warmed by its first request for 2 tokens), every rank
    steps in lockstep. Returns this rank's streams, the TPOT, the words'
    GB and the peak, the launches and collectives a forward."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.serve import build_engine, parser
    from repro_torch.serving import synthetic_trace
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ctx = cut_config(arch, **cut) if cut else contextlib.nullcontext()
    h20 = tag.startswith("25c")
    with ctx as cfg, routes_seen(ops) as seen, \
            scatter_unordered(tag == "25c.old"):
        args = parser().parse_args(["--arch", arch] + argv + ["--mesh",
                                                                mesh])
        engine = build_engine(args)
        root = engine._root
        rec = (logits_recorded(ops, scratch / f"{tag}_mesh.pt")
               if tag == "25e2" and root else
               batch_digests() if h20 else contextlib.nullcontext())
        trace = lambda: synthetic_trace(engine.cfg, requests=args.requests,
                                        prompt_len=args.prompt_len,
                                        gen_len=args.gen_len, seed=args.seed)
        first = trace()[0]
        first.max_new_tokens = 2
        engine.run([first] if root else ())
        engine.reset()
        torch.cuda.synchronize()
        with rec as digests:
            ops.reset_launch_counts()
            collectives.reset_counts()
            agg = engine.run(trace() if root else ())
            torch.cuda.synchronize()
        counts = ops.launch_counts()
        null_page = null_page_digest(torch, engine) if h20 else None
        coll = collectives.counts()
        drops = (drop_shares(seen, engine.cfg, engine.num_slots)
                 if engine.cfg.num_experts else None)
    fwd = engine.decode_steps + engine.prefills
    row = {"arch": arch, "mesh": mesh, "rank": engine._mesh.rank,
           "completed": int(agg["completed"]), "streams": streams(engine),
           "tpot_p50_ms": agg["tpot_p50_s"] * 1e3,
           "ttft_mean_ms": agg["ttft_mean_s"] * 1e3,
           "tokens_per_s": agg["tokens_per_s"],
           "decode_steps": engine.decode_steps, "prefills": engine.prefills,
           "launches": counts, "collectives": coll,
           "launches_a_forward": {k: counts[k] / fwd for k in
                                  ("encode_pack", "qmatmul", "paged_attend",
                                   "fused_sample")},
           "collectives_a_forward": {k: v / fwd for k, v in coll.items()},
           "weights_gb": packed_bytes(engine.params) / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "dropped": drops, "cut": cut}
    if h20:
        row["digests"], row["null_page"] = digests, null_page
    if tag == "25d":
        row["profile"] = profile_mesh_step(torch, engine, trace, ops,
                                           scratch)
    row["seconds"] = time.monotonic() - t0
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return row


def mesh_rank(rank, world, port, out_dir, runs, dp_runs, bus=False):
    """One rank of ``--mesh``: torchrun's environment for this card, then
    every ``runs`` entry through :func:`mesh_serve` and every ``dp_runs``
    part through :func:`dp_part`; this rank's results go to
    ``out_dir/rank<r>.json``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    sys.path.insert(0, str(SRC))
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _build, ops
    torch.set_num_threads(1)      # one rank a card shares the host's cores
    _build.library()
    # a collective that never completes ends this rank (and the spawn
    # ends the others) after MESH_TIMEOUT_S, well inside the call's limit
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method="env://",
                            timeout=datetime.timedelta(
                                seconds=MESH_TIMEOUT_S))
    out = {}
    for tag, arch, argv, mesh, cut in runs:
        out[tag] = mesh_serve(torch, ops, tag, arch, argv, mesh, cut,
                              Path(out_dir))
        if rank == 0:
            r = out[tag]
            print(f"{tag} rank 0: {arch} mesh {mesh}: {r['completed']} "
                  f"requests, tpot p50 {r['tpot_p50_ms']:.2f} ms, weights "
                  f"{r['weights_gb']:.2f} GB, peak {r['peak_gb']:.2f} GB, "
                  f"launches a forward {r['launches_a_forward']}, "
                  f"collectives a forward {r['collectives_a_forward']} "
                  f"({r['seconds']:.1f}s)", flush=True)
    for tag, spec in dp_runs:
        out[tag] = dp_part(torch, ops, tag, spec, Path(out_dir))
        if rank == 0:
            r = out[tag]
            print(f"{tag} rank 0: {spec['arch']} on ({MESH_WORLD}, 1): "
                  "losses " + " ".join(f"{x['loss']:.5f}" for x in r["steps"])
                  + ", step ms " + " ".join(f"{x['step_ms']:.1f}"
                                           for x in r["steps"])
                  + f", collectives {r['steps'][-1]['collectives']}, peak "
                  f"{r['peak_gb']:.2f} GB ({r['seconds']:.1f}s)", flush=True)
    if bus:
        out["bus"] = bus_bandwidth(torch, dist, world)
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# phase 30 (``--mesh-long``): split-KV decode at 524,288 positions. 30a
# gemma3-12b: one card's unsplit decode (this process, card 0), then
# split-KV on (2, 2); 30b zamba2-7b on (1, 4): the head-parallel serving
# placement, then split-KV. Caches filled on the card a block at a time
LONG_SEQ = 524288
LONG_BLOCK = 4096
LONG_STEPS = 8
LONG_SEED = 0
LONG_TOKEN = 2          # the first token fed at every run
LONG_TIMEOUT_S = 900
LONG_RUNS = [("30a", "gemma3-12b", "2,2"), ("30b", "zamba2-7b", "1,4")]


def long_seed(key, which, block):
    """The generator seed of one ``LONG_BLOCK`` of one layer's K or V:
    a function of (``LONG_SEED``, layer, k/v, block) alone."""
    import zlib
    return (LONG_SEED * 1_000_003
            + zlib.crc32(f"{key}/{which}/{block}".encode())) % (1 << 62)


def long_draw(torch, key, which, block, kv, hd, dtype):
    """One block's values, every KV head: ``(LONG_BLOCK, kv, hd)``."""
    g = torch.Generator(device="cuda").manual_seed(
        long_seed(key, which, block))
    return (torch.randn((LONG_BLOCK, kv, hd), generator=g, device="cuda")
            * 0.5).to(dtype)


def long_fill(torch, cfg, caches):
    """Fill this rank's caches (built under the active mesh and rules):
    a dense cache's block of positions from the draws of the
    ``LONG_BLOCK`` blocks it overlaps, its KV head group; a ring (a
    ``local`` layer) with its own layer's draw of the last ring-size
    positions before the cursor, each at its slot ``p mod size``; every
    cursor ``LONG_SEQ - LONG_STEPS``; recurrent state stays zero."""
    from repro_torch.distributed.sharding import axis_index, axis_shards
    from repro_torch.tree import leaves
    idx = LONG_SEQ - LONG_STEPS
    prefix, _, period = cfg.layer_pattern()
    for path, t in leaves(caches):
        name = path[-1]
        if name == "idx":
            t.fill_(idx)
            continue
        if name not in ("k", "v"):
            continue
        kind = (prefix[path[1]] if path[0] == "prefix"
                else period[int(str(path[1])[3:])])
        stack = t if t.dim() == 5 else t[None]
        rows, L, kvl = stack.shape[1:4]
        assert rows == 1, "phase 30 runs one row"
        h0 = (axis_index("kv_heads") * kvl
              if kvl < cfg.num_kv_heads else 0)
        heads = slice(h0, h0 + kvl)
        for i in range(stack.shape[0]):
            key = "/".join(str(k) for k in path[:-1]) + f"/{i}"
            if kind == "local":
                span = range(idx - L, idx)
            else:
                lo = axis_index("kv_seq") * L if axis_shards("kv_seq") > 1 \
                    else 0
                span = range(lo, lo + L)
            for b in range(span.start // LONG_BLOCK,
                           (span.stop - 1) // LONG_BLOCK + 1):
                a, e = max(span.start, b * LONG_BLOCK), min(
                    span.stop, (b + 1) * LONG_BLOCK)
                if a >= e:
                    continue
                vals = long_draw(torch, key, name, b, cfg.num_kv_heads,
                                 cfg.head_dim, t.dtype)[
                    a - b * LONG_BLOCK:e - b * LONG_BLOCK, heads]
                if kind == "local":
                    slots = torch.arange(a, e, device="cuda") % L
                    stack[i, 0, slots] = vals
                else:
                    stack[i, 0, a - span.start:e - span.start] = vals


def cache_gb(caches):
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for _, t in leaves(caches)) / 1e9


def long_decode(torch, ops, cfg, params, caches, step, feed=None):
    """``LONG_STEPS`` greedy steps from ``LONG_TOKEN`` (K6 on each step's
    logits); with ``feed`` (another run's tokens) the step after t takes
    ``feed[t]``, so two runs' logits stay comparable. Returns the
    sampled tokens, the logits (host, f32), the step walls (ms), the
    launches of the steps, and the collectives of the second step."""
    from repro_torch.distributed import collectives
    from repro_torch.kernels import dispatch
    tok = torch.full((1, 1), LONG_TOKEN, dtype=torch.int32, device="cuda")
    out = {"tokens": [], "logits": [], "step_ms": []}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for t in range(LONG_STEPS):
        pos = torch.full((1,), LONG_SEQ - LONG_STEPS + t, dtype=torch.int32)
        if t == 1:
            collectives.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = step(params, caches, {"tokens": tok}, pos)
        nxt = dispatch.fused_sample(logits.float(), None, None)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if t == 1:
            out["collectives"] = collectives.counts()
            out["collective_bytes"] = collectives.byte_counts()
        check(logits.shape == (1, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              "phase 30: non-finite or misshapen logits")
        out["tokens"].append(int(nxt[0]))
        out["logits"].append(logits.float().cpu())
        tok = (torch.tensor([[feed[t]]], dtype=torch.int32, device="cuda")
               if feed is not None else nxt.reshape(1, 1).to(torch.int32))
    out["launches"] = ops.launch_counts()
    check(out["launches"]["fused_sample"] == LONG_STEPS
          and out["launches"]["qmatmul"] > 0
          and out["launches"]["encode_pack"] > 0,
          f"phase 30: K1, K2 and K6 must launch (K6 once a step): "
          f"{out['launches']}")
    out["tpot_p50_ms"] = sorted(out["step_ms"][1:])[(LONG_STEPS - 1) // 2]
    return out


def long_params(torch, cfg, shard=None):
    from repro_torch.core.lns import LNSFormat
    from repro_torch.models.model import init_params
    from repro_torch.optim.madam import MadamConfig, lns_leaf_encoder
    mcfg = MadamConfig(update_format=LNSFormat(bits=8, gamma=8))
    return init_params(cfg, seed=0, device="cuda",
                       leaf_fn=lns_leaf_encoder(mcfg), shard=shard)


def long_run(torch, ops, cfg, params, mesh, rules, feed=None):
    """One run: this rank's caches under ``mesh`` and ``rules`` (whole
    with no mesh), filled, then the greedy steps through
    ``build_decode_step``; the caches are freed after."""
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.distributed.sharding import shard_ctx
    from repro_torch.models.model import init_caches
    from repro_torch.training.steps import build_decode_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ctx = (shard_ctx(mesh, rules) if mesh is not None
           else contextlib.nullcontext())
    with ctx:
        caches = init_caches(1, LONG_SEQ, cfg, device="cuda")
        long_fill(torch, cfg, caches)
    step = build_decode_step(cfg, QuantConfig.lns_madam(), mesh=mesh,
                             rules=rules)
    fill_s = time.monotonic() - t0
    out = long_decode(torch, ops, cfg, params, caches, step, feed)
    out.update(cache_gb=cache_gb(caches), fill_s=fill_s,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               words_gb=packed_bytes(params) / 1e9)
    del caches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def long_rank(rank, world, port, out_dir, ref_tokens):
    """One rank of ``--mesh-long``: 30a's split run on (2, 2) on the one
    card's tokens, then 30b on (1, 4): the serving placement, then
    split-KV on its tokens. This rank's results go to
    ``out_dir/rank<r>.pt``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    sys.path.insert(0, str(SRC))
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config, get_rules
    from repro_torch.distributed.params_sharding import LocalShard
    from repro_torch.distributed.sharding import decode_rules, serving_rules
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    _build.library()
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method="env://",
                            timeout=datetime.timedelta(
                                seconds=LONG_TIMEOUT_S))
    out = {}
    for tag, arch, shape in LONG_RUNS:
        t0 = time.monotonic()
        cfg = get_config(arch)
        mesh = make_host_mesh(*(int(x) for x in shape.split(",")))
        split = decode_rules(cfg, mesh, 1, get_rules(arch))
        serve = serving_rules(cfg, mesh)
        # the weights' placement is the serving rules' under both
        params = long_params(torch, cfg, LocalShard(mesh, split))
        with k2_shapes_seen(torch, ops) as seen:
            if tag == "30b":
                out["30b_serve"] = long_run(torch, ops, cfg, params, mesh,
                                            serve)
                ref_tokens = out["30b_serve"]["tokens"]
            out[tag] = long_run(torch, ops, cfg, params, mesh, split,
                                feed=ref_tokens)
        out[tag]["k2_shapes"] = [[m, k, n] for (m, k, n, _, _) in seen]
        out[tag]["seconds"] = time.monotonic() - t0
        if rank == 0:
            r = out[tag]
            print(f"{tag} rank 0: {arch} split-KV on ({shape}): tpot p50 "
                  f"{r['tpot_p50_ms']:.2f} ms, cache {r['cache_gb']:.2f} "
                  f"GB, peak {r['peak_gb']:.2f} GB a rank, collectives a "
                  f"step {r['collectives']} ({r['seconds']:.1f}s)",
                  flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def long_compare(torch, tag, ref, got):
    """A split run against its reference run on the same tokens: logits
    within ``LOGIT_RTOL`` of max |logit| at every step, the greedy token
    equal wherever the reference's top-2 margin exceeds that; the first
    closer step is returned."""
    worst, near, steps = 0.0, None, []
    for t, (p, k) in enumerate(zip(ref["logits"], got["logits"])):
        top = float(p.abs().max())
        tol = LOGIT_RTOL * top
        err = float((p - k).abs().max())
        worst = max(worst, err / top)
        check(err <= tol, f"{tag} step {t}: logits err {err} > {tol}")
        top2 = torch.topk(p, 2, dim=-1).values
        gap = float(top2[0, 0] - top2[0, 1])
        steps.append({"max_abs_err": err, "max_abs": top, "top2_gap": gap,
                      "mean_abs_err": float((p - k).abs().mean()),
                      "token_equal": ref["tokens"][t] == got["tokens"][t]})
        if gap > tol:
            check(ref["tokens"][t] == got["tokens"][t],
                  f"{tag} step {t}: greedy token {got['tokens'][t]} differs "
                  f"from the reference's {ref['tokens'][t]} beyond the "
                  f"margin")
        elif near is None:
            near = t
    return {"max_rel_err": worst, "first_near_tie": near,
            "tokens_equal": ref["tokens"] == got["tokens"],
            "per_step": steps}


def long_k2_rows(torch, ops, ref, fmt, shapes):
    """K2 at the M = 1 shapes a run recorded (distinct), beside its plain
    version and ``torch.matmul``."""
    return k2_check(torch, ops, ref, fmt, [tuple(s) for s in
                                           sorted(set(map(tuple, shapes)))])


def long_main(torch, card):
    """``--mesh-long``: phase 30 on four cards of one host."""
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.core.lns import LNSFormat
    from repro_torch.kernels import _build, ops, ref
    n = torch.cuda.device_count()
    check(n >= MESH_WORLD, f"--mesh-long needs {MESH_WORLD} cards, "
          f"{n} are visible")
    t_start = time.monotonic()
    _build.build()
    _build.library()
    scratch = ROOT / "build" / "mesh_long"
    scratch.mkdir(parents=True, exist_ok=True)
    marks = [("build", time.monotonic())]
    cfg = get_config("gemma3-12b")
    params = long_params(torch, cfg)
    with k2_shapes_seen(torch, ops) as seen:
        one = long_run(torch, ops, cfg, params, None, None)
    one["k2_shapes"] = [[m, k, n] for (m, k, n, _, _) in seen]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"30a one card: gemma3-12b unsplit at {LONG_SEQ} positions: tpot "
          f"p50 {one['tpot_p50_ms']:.2f} ms, cache {one['cache_gb']:.2f} "
          f"GB, peak {one['peak_gb']:.2f} GB, tokens {one['tokens']}",
          flush=True)
    zcfg = get_config("zamba2-7b")
    dense = sum(k == "shared_attn" for k in zcfg.layer_pattern()[0]) + \
        zcfg.layer_pattern()[1] * sum(k == "shared_attn" for k in
                                      zcfg.layer_pattern()[2])
    zamba_gb = (dense * 2 * LONG_SEQ * zcfg.num_kv_heads * zcfg.head_dim
                * 2 / 1e9)
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"30b one card: not run, zamba2-7b's {dense} shared-block caches "
          f"at {LONG_SEQ} positions take {zamba_gb:.1f} GB, more than one "
          f"card's {card_gb:.1f} GB", flush=True)
    marks.append(("30a one card", time.monotonic()))
    os.environ["OMP_NUM_THREADS"] = "1"
    mp.start_processes(long_rank, args=(MESH_WORLD, free_port(),
                                        str(scratch), one["tokens"]),
                       nprocs=MESH_WORLD, join=True, start_method="spawn")
    marks.append(("ranks", time.monotonic()))
    ranks = [torch.load(scratch / f"rank{r}.pt") for r in range(MESH_WORLD)]
    res = {"card": card, "one_card": {k: v for k, v in one.items()
                                      if k != "logits"}}
    for tag, arch, shape in LONG_RUNS:
        rows = [rk[tag] for rk in ranks]
        for r, row in enumerate(rows):
            check(row["tokens"] == rows[0]["tokens"],
                  f"{tag}: rank {r}'s tokens differ from rank 0's")
        base = one if tag == "30a" else ranks[0]["30b_serve"]
        if tag == "30b":
            for r, rk in enumerate(ranks):
                check(rk["30b_serve"]["tokens"] == base["tokens"],
                      f"30b serve: rank {r}'s tokens differ from rank 0's")
        cmp = long_compare(torch, tag, base, rows[0])
        line = {"tag": tag, "arch": arch, "mesh": shape,
                "positions": LONG_SEQ, "steps": LONG_STEPS,
                "tokens": rows[0]["tokens"],
                "reference_tokens": base["tokens"], **cmp,
                "tpot_p50_ms": [r["tpot_p50_ms"] for r in rows],
                "step_ms": rows[0]["step_ms"],
                "cache_gb": [r["cache_gb"] for r in rows],
                "peak_gb": [r["peak_gb"] for r in rows],
                "words_gb": [r["words_gb"] for r in rows],
                "fill_s": rows[0]["fill_s"],
                "collectives_a_step": rows[0]["collectives"],
                "collective_bytes_a_step": rows[0]["collective_bytes"],
                "launches": rows[0]["launches"],
                "reference": {k: base[k] for k in (
                    "tpot_p50_ms", "step_ms", "cache_gb", "peak_gb",
                    "words_gb", "launches", "collectives",
                    "collective_bytes")
                    if k in base},
                "ranks_agree": True}
        res[tag] = line
        what = "one card" if tag == "30a" else "(1, 4) serving placement"
        print(f"{tag}: {arch} split-KV on ({shape}) at {LONG_SEQ} positions:"
              f" tokens {line['tokens']} ({what}: {base['tokens']}), "
              f"logits within {cmp['max_rel_err']:.4f} of max |logit| "
              f"(limit {LOGIT_RTOL}), first step under the margin "
              f"{cmp['first_near_tie']}; tpot p50 "
              f"{line['tpot_p50_ms'][0]:.2f} ms ({what} "
              f"{base['tpot_p50_ms']:.2f} ms); cache "
              f"{line['cache_gb'][0]:.2f} GB a rank ({what} "
              f"{base['cache_gb']:.2f}); peak "
              f"{[round(x, 2) for x in line['peak_gb']]} GB ({what} "
              f"{base['peak_gb']:.2f}); merge collectives a step "
              f"{line['collectives_a_step']}, bytes "
              f"{line['collective_bytes_a_step']['bytes']}", flush=True)
        for t, st in enumerate(cmp["per_step"]):
            print(f"{tag} step {t}: max |logit| {st['max_abs']:.4f}, "
                  f"reference top-2 gap {st['top2_gap']:.4f}, max abs err "
                  f"{st['max_abs_err']:.4f} (mean {st['mean_abs_err']:.5f}),"
                  f" token equal {st['token_equal']}")
        print(json.dumps({k: v for k, v in line.items()
                          if k not in ("collective_bytes_a_step",
                                       "per_step")}))
    marks.append(("checks", time.monotonic()))
    fmt = LNSFormat(8, 8)
    res["k2_long"] = {
        "gemma3-12b one card": long_k2_rows(torch, ops, ref, fmt,
                                            one["k2_shapes"]),
        "zamba2-7b split rank 0": long_k2_rows(
            torch, ops, ref, fmt, ranks[0]["30b"]["k2_shapes"])}
    res["k2_launches_a_step"] = {
        "gemma3-12b one card": one["launches"]["qmatmul"] / LONG_STEPS,
        "gemma3-12b split": ranks[0]["30a"]["launches"]["qmatmul"]
        / LONG_STEPS,
        "zamba2-7b split": ranks[0]["30b"]["launches"]["qmatmul"]
        / LONG_STEPS}
    res["k6_long"] = [k6_variant(torch, ops, ref, 1, V)
                      for V in (cfg.vocab_size, zcfg.vocab_size)]
    marks.append(("kernels", time.monotonic()))
    res["seconds_by_phase"] = {b[0]: b[1] - a[1]
                               for a, b in zip(marks, marks[1:])}
    res["seconds"] = time.monotonic() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_mesh_long.json").write_text(
        json.dumps(res, indent=1))
    print(f"chip_smoke --mesh-long took {res['seconds']:.1f}s: "
          + ", ".join(f"{k} {v:.1f}s"
                      for k, v in res["seconds_by_phase"].items()))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


# ---------------------------------------------------------------------------
# phase 31 (``--mesh-tp``): JAX's (data, model) placement for prefill and
# training (``sharding.data_rules``: the rows over the data axis, the
# weights on the serving rules, a column-parallel leaf holding a rank's
# columns). Each part's one-card reference runs first in this process on
# card 0, from the same seed and batches; then one NCCL rank a card
# (spawned) runs every part on its meshes. 31a: smollm-135m at full width
# and depth, a prefill of 8 x 4096 tokens on (2, 2) and (4, 1). 31b: lns8
# training, every rank drawing its shard from seed 0: smollm-135m at full
# width and depth, 32 x 256 a step, on (1, 4) and (2, 2) (then one
# observed step, K4, on (1, 4)); granite-8b at full width, 12 of its 36
# layers, on (1, 4): one card trains the reference step (~2.8e9
# parameters at 18.1-20.6 B each, ~1.5e9 a rank). Held with phase 26's
# bounds; prefill logits within LOGIT_RTOL of max |logit|, argmax equal
TP_PREFILL = dict(arch="smollm-135m", rows=8, seq=4096,
                  meshes=((2, 2), (4, 1)))
TP_TRAIN = [
    ("31b1", dict(arch="smollm-135m", batch=32, seq=256,
                  meshes=((1, 4), (2, 2)), observed=(1, 4))),
    ("31b2", dict(arch="granite-8b", cut=dict(num_layers=12), batch=8,
                  seq=256, meshes=((1, 4),), word_layers=1)),
]
TP_STEPS = 3
TP_TIMEOUT_S = 600
# K3/K4 at the largest column shards 31b steps: granite's up/gate (12
# layers x 4096 rows, 14336 / 4 columns) and smollm's up/gate at m = 4
TP_K34 = [(12 * 4096, 14336 // 4), (30 * 576, 1536 // 4)]


def tp_serve_params(torch, cfg, shard=None):
    from repro_torch.core.lns import LNSFormat
    from repro_torch.models.model import init_params
    from repro_torch.optim.madam import MadamConfig, lns_leaf_encoder
    mcfg = MadamConfig(update_format=LNSFormat(bits=8, gamma=8))
    return init_params(cfg, seed=0, device="cuda",
                       leaf_fn=lns_leaf_encoder(mcfg), shard=shard)


def tp_prefill(torch, ops, params, cfg, mesh=None, rules=None):
    """31a's prefill on this card (a rank's rows under ``mesh``): the
    first call's last-position logits (host, f32), wall, launches and
    collectives (counts zeroed just before), then a second call's wall
    (warm: a mesh's first collectives also set up NCCL's communicators);
    the peak."""
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.distributed import collectives
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.steps import build_prefill_step
    batch = SyntheticLM(cfg, batch=TP_PREFILL["rows"],
                        seq=TP_PREFILL["seq"]).batch_at(0)
    step = build_prefill_step(cfg, QuantConfig.lns_madam(), mesh=mesh,
                              rules=rules)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    collectives.reset_counts()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    out = {"logits": logits.float().cpu(), "first_wall_ms": first,
           "launches": ops.launch_counts(),
           "collectives": collectives.counts()}
    del logits
    t0 = time.perf_counter()
    step(params, batch)
    torch.cuda.synchronize()
    out.update(wall_ms=(time.perf_counter() - t0) * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(bool(torch.isfinite(out["logits"]).all())
          and out["logits"].shape[-1] == cfg.vocab_size,
          "31a: non-finite or misshapen prefill logits")
    check(out["launches"]["encode_pack"] > 0 and out["launches"]["qmatmul"]
          > 0, f"31a: K1 and K2 must launch on the prefill: "
          f"{out['launches']}")
    return out


def tp_words(state, layers=None):
    """The packed words by leaf path on the host (16-bit codes as int16:
    equal exactly where the words are), a stacked leaf's first ``layers``
    layers only where given."""
    from repro_torch.tree import leaves
    out = {}
    for p, x in leaves(state.params):
        if hasattr(x, "packed"):
            w = x.packed
            if layers is not None and p[0] == "period":
                w = w[:layers]
            out["/".join(map(str, p))] = w.short().cpu()
    return out


def tp_one_card(torch, ops, tag, spec, scratch):
    """31b on card 0: the part's steps from seed 0 on the same global
    batches; losses, grad norms, step walls, launches, the peak; the words
    after the first step saved for the ranks."""
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.steps import build_train_step, init_train_state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, mcfg = dp_config(spec), MadamConfig()
    data = SyntheticLM(cfg, batch=spec["batch"], seq=spec["seq"])
    state = init_train_state(cfg, mcfg, seed=0, device="cuda")
    step = build_train_step(cfg, QuantConfig.lns_madam(), mcfg)
    rows = []
    for i in range(TP_STEPS):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, data.batch_at(i))
        loss = float(m["loss"])
        torch.cuda.synchronize()
        rows.append({"loss": loss, "grad_norm": float(m["grad_norm"]),
                     "step_ms": (time.perf_counter() - t0) * 1e3,
                     "launches": ops.launch_counts()})
        if i == 0:
            torch.save(tp_words(state, spec.get("word_layers")),
                       scratch / f"{tag}_one_card.pt")
    out = {"steps": rows, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "layers": cfg.num_layers}
    print(f"{tag} one card: {spec['arch']} {cfg.num_layers} layers, "
          f"{spec['batch']} x {spec['seq']}: losses "
          + " ".join(f"{r['loss']:.5f}" for r in rows) + ", grad norms "
          + " ".join(f"{r['grad_norm']:.4f}" for r in rows) + ", step ms "
          + " ".join(f"{r['step_ms']:.1f}" for r in rows)
          + f", peak {out['peak_gb']:.2f} GB", flush=True)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_checksums(torch, state, split):
    """``dp_checksum``'s two sums over the whole leaves and over the
    split ones apart: ``(whole words, whole moments, split words, split
    moments)``."""
    from repro_torch.tree import leaves
    parts = [[], [], [], []]
    for (p, x), (_, ax) in zip(leaves(state.params), leaves(split)):
        if not hasattr(x, "packed"):
            continue
        base = 2 if ax else 0
        v = state.opt.g2
        for k in p:
            v = v[k]
        parts[base].append(x.packed)
        parts[base + 1].append(v.to(torch.float32).contiguous().view(
            torch.int32))
    # (under train_rules every packed leaf of gemma3 may be split)
    dev = next(ts[0].device for ts in parts if ts)
    out = torch.zeros(4, dtype=torch.int64, device=dev)
    for slot, ts in enumerate(parts):
        for i, t in enumerate(ts):
            flat = t.reshape(-1)
            for lo in range(0, flat.numel(), 1 << 26):
                c = flat[lo:lo + (1 << 26)].long()
                w = (torch.arange(lo, lo + c.numel(), device=c.device)
                     % 65521 + 1 + i)
                out[slot] += (c * w).sum()
    return out


def tp_word_share(torch, words, ref_path, split, coords):
    """This rank's share of the words-apart count against one card's
    (``tp_words`` of both): each split leaf's block (columns, rows or
    vocabulary, whichever dim is split) on the ranks of data coordinate
    0, each whole leaf on rank (0, 0) only, so the ranks' sums cover
    every word once."""
    ref = torch.load(ref_path, mmap=True)
    n = tot = 0
    sizes = collections.Counter()
    for k, w in words.items():
        whole = not split[k]
        if coords.get("data", 0) != 0 or (whole and coords["model"] != 0):
            continue
        r = ref[k]
        if r.shape != w.shape:      # the rank's block of the split dim
            d = next(i for i, (a, b) in enumerate(zip(w.shape, r.shape))
                     if a != b)
            c = w.shape[d]
            r = r.narrow(d, coords["model"] * c, c)
        d = (w.int() - r.int()).abs()
        n += int((d != 0).sum())
        tot += d.numel()
        for v, c in zip(*torch.unique(d[d != 0].clamp(max=33),
                                      return_counts=True)):
            sizes[str(int(v))] += int(c)
    return {"apart": n, "total": tot, "sizes": dict(sizes)}


def tp_part(torch, ops, tag, spec, shape, scratch, rules_fn=None):
    """31b (32 with ``rules_fn=train_rules``) on this rank on ``shape``:
    the rank's shard drawn from seed 0 under ``rules_fn(cfg, mesh, batch)``
    (default ``data_rules``), the part's steps (each begun at a barrier,
    the counts zeroed just before), per step the loss, grad norm, wall,
    launches, collectives and every rank's checksums; the words after the
    first step against one card's (unless the part's reference is a
    forward, ``spec["forward_ref"]``); K2's shapes and calls on the second
    step; under ``rules_fn`` step 0's row-block SUMs (``rp_row_sum``); the
    draw's seconds and peak; the peak."""
    import torch.distributed as dist
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.distributed import collectives
    from repro_torch.distributed.params_sharding import LocalShard, split_axes
    from repro_torch.distributed.sharding import data_rules, shard_ctx
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.madam import MadamConfig
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.steps import build_train_step, init_train_state
    from repro_torch.tree import leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_part = time.monotonic()
    cfg, mcfg = dp_config(spec), MadamConfig()
    mesh = make_host_mesh(*shape)
    rules = (rules_fn or data_rules)(cfg, mesh, spec["batch"])
    data = SyntheticLM(cfg, batch=spec["batch"], seq=spec["seq"])
    out = {"rank": dist.get_rank(), "coords": dict(mesh.coords), "steps": []}
    observed = spec.get("observed") == shape
    with shard_ctx(mesh, rules), dp_given_spy() as given:
        t0 = time.perf_counter()
        state = init_train_state(cfg, mcfg, seed=0, device=mesh.device,
                                 shard=LocalShard(mesh, rules))
        torch.cuda.synchronize()
        out["draw_s"] = time.perf_counter() - t0
        out["draw_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        split = split_axes(state.params, mesh, rules)
        split_by = {"/".join(map(str, p)): bool(a)
                    for p, a in leaves(split)}
        out["split_leaves"] = sorted(k for k, v in split_by.items() if v)
        step = build_train_step(cfg, QuantConfig.lns_madam(), mcfg)
        for i in range(TP_STEPS + (1 if observed else 0)):
            if i == TP_STEPS:
                step = build_train_step(cfg, QuantConfig.lns_madam(), mcfg,
                                        numerics=True)
            batch = data.batch_at(i)
            dist.barrier()
            torch.cuda.synchronize()
            collectives.reset_counts()
            ops.reset_launch_counts()
            given[0] = 0
            ctx = (k2_shapes_seen(torch, ops) if i == 1
                   else contextlib.nullcontext())
            spy = (rp_row_spy(torch) if rules_fn is not None and i == 0
                   else contextlib.nullcontext())
            t0 = time.perf_counter()
            with ctx as seen, spy as rows_seen:
                state, m = step(state, batch)
                loss = float(m["loss"])
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            row = {"loss": loss, "grad_norm": float(m["grad_norm"]),
                   "step_ms": ms, "collectives": collectives.counts(),
                   "collective_bytes": collectives.byte_counts(),
                   "launches": ops.launch_counts(),
                   "k1_given_scale_calls": given[0]}
            if seen is not None:
                out["k2_shapes"] = sorted({(M, K, N) for (M, K, N, _, _)
                                           in seen})
                out["k2_calls"] = {f"{M}x{K}x{N}": n for (M, K, N, _, _), n
                                   in seen.items()}
            cs = tp_checksums(torch, state, split)
            every = torch.empty((mesh.size, 4), dtype=torch.int64,
                                device=cs.device)
            (getattr(dist, "all_gather_single", None)
             or dist.all_gather_into_tensor)(every, cs[None])
            model = [r for r in range(mesh.size)
                     if r % shape[1] == out["rank"] % shape[1]]
            row["whole_agree"] = bool((every[:, :2] == every[0, :2]).all())
            row["split_agree"] = bool((every[model, 2:] == cs[2:]).all())
            if i == TP_STEPS:
                row["numerics_leaves"] = len(m["numerics"]["update"])
                row["numerics"] = {
                    k: {kk: float(vv) for kk, vv in st.items()}
                    for k, st in m["numerics"]["update"].items()}
                out["observed"] = row
            else:
                out["steps"].append(row)
            if rows_seen is not None:
                out["row_sum"] = rp_row_sum(torch, rows_seen, shape)
            if i == 0 and not spec.get("forward_ref"):
                out["words"] = tp_word_share(
                    torch, tp_words(state, spec.get("word_layers")),
                    scratch / f"{tag}_one_card.pt", split_by,
                    dict(mesh.coords))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.monotonic() - t_part
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_rank(rank, world, port, out_dir):
    """One rank of ``--mesh-tp``: 31a on each of its meshes (the rank's
    shard of the 8-bit serving words from seed 0), then every 31b part on
    each of its meshes; this rank's results go to
    ``out_dir/rank<r>.pt``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    sys.path.insert(0, str(SRC))
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed.params_sharding import LocalShard
    from repro_torch.distributed.sharding import data_rules
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    _build.library()
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method="env://",
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    out = {"31a": {}}
    cfg = get_config(TP_PREFILL["arch"])
    for shape in TP_PREFILL["meshes"]:
        mesh = make_host_mesh(*shape)
        rules = data_rules(cfg, mesh, TP_PREFILL["rows"])
        params = tp_serve_params(torch, cfg, LocalShard(mesh, rules))
        dist.barrier()
        with k2_shapes_seen(torch, ops) as seen, \
                k1_shapes_seen(torch, ops) as k1_seen, \
                dp_given_spy() as given:
            r = tp_prefill(torch, ops, params, cfg, mesh, rules)
        r["k2_shapes"] = sorted({(M, K, N) for (M, K, N, _, _) in seen})
        r["k1_shapes"] = sorted({(R, C) for (R, C, _, _) in k1_seen})
        r["k1_given_scale_calls"] = given[0]
        r["coords"] = dict(mesh.coords)
        out["31a"][f"{shape[0]},{shape[1]}"] = r
        if rank == 0:
            print(f"31a rank 0: {TP_PREFILL['arch']} prefill on {shape}: "
                  f"wall {r['wall_ms']:.1f} ms (first call "
                  f"{r['first_wall_ms']:.1f}), peak {r['peak_gb']:.2f} GB,"
                  f" collectives {r['collectives']}", flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    scratch = Path(out_dir)
    for tag, spec in TP_TRAIN:
        for shape in spec["meshes"]:
            key = f"{tag} {shape[0]},{shape[1]}"
            out[key] = tp_part(torch, ops, tag, spec, shape, scratch)
            if rank == 0:
                r = out[key]
                print(f"{key} rank 0: {spec['arch']}: losses "
                      + " ".join(f"{x['loss']:.5f}" for x in r["steps"])
                      + ", step ms " + " ".join(f"{x['step_ms']:.1f}"
                                               for x in r["steps"])
                      + f", collectives {r['steps'][-1]['collectives']}, "
                      f"peak {r['peak_gb']:.2f} GB ({r['seconds']:.1f}s)",
                      flush=True)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def tp_prefill_checks(torch, one, ranks):
    """31a: every rank's rows against one card's: argmax equal, logits
    within LOGIT_RTOL of max |logit|; bit equality printed."""
    rows_a = TP_PREFILL["rows"]
    res = {}
    for key in ranks[0]["31a"]:
        data = int(key.split(",")[0])
        per = rows_a // data
        worst, equal, lines = 0.0, True, []
        for rk in ranks:
            r = rk["31a"][key]
            d = r["coords"]["data"]
            want = one["logits"][d * per:(d + 1) * per]
            got = r["logits"]
            top = float(want.abs().max())
            err = float((got - want).abs().max())
            worst = max(worst, err / top)
            equal &= bool(torch.equal(got, want))
            check(err <= LOGIT_RTOL * top,
                  f"31a {key}: logits {err} apart, limit {LOGIT_RTOL * top}")
            top2 = torch.topk(want, 2, dim=-1).values
            gap = float((top2[:, 0] - top2[:, 1]).min())
            check(torch.equal(got.argmax(-1), want.argmax(-1)),
                  f"31a {key}: argmax differs from one card's (smallest "
                  f"top-2 gap {gap})")
            lines.append(gap)
        r0 = ranks[0]["31a"][key]
        res[key] = {"max_rel_err": worst, "bit_equal": equal,
                    "min_top2_gap": min(lines),
                    "peak_gb": [rk["31a"][key]["peak_gb"] for rk in ranks],
                    "wall_ms": [rk["31a"][key]["wall_ms"] for rk in ranks],
                    "first_wall_ms": [rk["31a"][key]["first_wall_ms"]
                                      for rk in ranks],
                    "collectives": r0["collectives"],
                    "launches": r0["launches"],
                    "k1_given_scale_calls": r0["k1_given_scale_calls"],
                    "k2_shapes": r0["k2_shapes"],
                    "k1_shapes": r0["k1_shapes"]}
        print(f"31a {key}: {TP_PREFILL['arch']} prefill "
              f"{TP_PREFILL['rows']} x {TP_PREFILL['seq']}: argmax equal, "
              f"logits within {worst:.2e} of max |logit| (limit "
              f"{LOGIT_RTOL}), bit-equal to one card: {equal}; peak a rank "
              f"{max(res[key]['peak_gb']):.2f} GB (one card "
              f"{one['peak_gb']:.2f}), wall {max(res[key]['wall_ms']):.1f} "
              f"ms (one card {one['wall_ms']:.1f}), collectives "
              f"{r0['collectives']}", flush=True)
    return res


def tp_train_checks(tag, key, one, ranks, gathers=True, fwd=None):
    """31b on one mesh: every rank's losses and grad norms equal rank
    0's, the whole leaves on every rank and each split leaf on its data
    group equal after every step, phase 26's bounds against one card,
    the words after step 1 within TRAIN_WORD_SHARE, K1/K2/K3 launched.
    ``gathers=False`` (phase 32, JAX's training placement) requires that
    a step gather nothing: the heads' output and the MLP's hidden state
    enter their row blocks as they are. ``fwd`` (32c, whose training
    state one card cannot hold) is one card's forward
    (``rp_one_card_forward``) in place of ``one``'s steps: step 0 within
    DP_STEP0_RTOL of the range of its sound orders (``rp_step0_band``),
    every loss and grad norm finite, the peak a rank under 80 GB."""
    r0 = ranks[0]
    for r in ranks:
        check(all(x["whole_agree"] and x["split_agree"]
                  for x in r["steps"]),
              f"{key} rank {r['rank']}: a whole leaf or a shard left its "
              f"copies after a step")
        check([(x["loss"], x["grad_norm"]) for x in r["steps"]]
              == [(x["loss"], x["grad_norm"]) for x in r0["steps"]],
              f"{key} rank {r['rank']}: its losses differ from rank 0's")
        for x in r["steps"]:
            check(x["launches"]["encode_pack"] > 0
                  and x["launches"]["qmatmul"] > 0
                  and x["launches"]["madam_step"] > 0,
                  f"{key}: K1, K2 or K3 not launched on a step: "
                  f"{x['launches']}")
            check((x["collectives"]["gather"] > 0) == gathers
                  and x["collectives"]["sum"] > 0,
                  f"{key}: a step's gathers or SUMs are not the "
                  f"placement's: {x['collectives']}")
    out = {"losses": [x["loss"] for x in r0["steps"]],
           "grad_norms": [x["grad_norm"] for x in r0["steps"]],
           "step_ms": [[x["step_ms"] for x in r["steps"]] for r in ranks],
           "peak_gb": [r["peak_gb"] for r in ranks],
           "collectives_a_step": r0["steps"][-1]["collectives"],
           "collective_bytes_a_step": r0["steps"][-1]["collective_bytes"],
           "launches_a_step": r0["steps"][-1]["launches"],
           "k1_given_scale_calls": r0["steps"][-1]["k1_given_scale_calls"],
           "split_leaves": r0["split_leaves"],
           "k2_shapes": r0.get("k2_shapes"),
           "k2_calls": r0.get("k2_calls"),
           "draw_s": max(r["draw_s"] for r in ranks),
           "draw_peak_gb": max(r["draw_peak_gb"] for r in ranks),
           "seconds": max(r["seconds"] for r in ranks)}
    if fwd is None:
        rel = [abs(x["loss"] - y["loss"]) / abs(y["loss"])
               for x, y in zip(r0["steps"], one["steps"])]
        grel = [abs(x["grad_norm"] - y["grad_norm"]) / abs(y["grad_norm"])
                for x, y in zip(r0["steps"], one["steps"])]
        check(rel[0] <= DP_STEP0_RTOL, f"{key}: step-0 loss {rel[0]:.2e} "
              f"from one card's (limit {DP_STEP0_RTOL})")
        check(all(v <= TRAIN_LOSS_RTOL for v in rel), f"{key}: losses "
              f"{rel} from one card's (limit {TRAIN_LOSS_RTOL})")
        check(all(v <= DP_GNORM_RTOL for v in grel), f"{key}: grad norms "
              f"{grel} from one card's (limit {DP_GNORM_RTOL})")
        apart = sum(r["words"]["apart"] for r in ranks)
        total = sum(r["words"]["total"] for r in ranks)
        sizes = collections.Counter()
        for r in ranks:
            sizes.update(r["words"]["sizes"])
        share = apart / total
        check(share <= TRAIN_WORD_SHARE, f"{key}: {share:.2%} of words "
              f"apart from one card's after step 1")
        out.update({"loss_rel": rel, "grad_norm_rel": grel,
                    "word_share": share, "words_compared": total,
                    "word_diff_sizes": dict(sizes),
                    "one_card": {k: one[k] for k in ("peak_gb", "layers")},
                    "one_card_step_ms": [x["step_ms"]
                                         for x in one["steps"]]})
        ref = (" (one card " + " ".join(f"{x['loss']:.5f}"
                                        for x in one["steps"])
               + f"), loss rel {max(rel):.2e}, grad norm rel "
               f"{max(grel):.2e}, words apart after step 1 {share:.3%} of "
               f"{total} ({dict(sizes)})")
        peak = f" (one card {one['peak_gb']:.2f}, {one['layers']} layers)"
        walls = (" (one card " + " ".join(
            f"{v:.1f}" for v in out["one_card_step_ms"]) + ")")
    else:
        check(all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"])
                  for x in r0["steps"]), f"{key}: a loss or grad norm is "
              f"not finite: "
              f"{[(x['loss'], x['grad_norm']) for x in r0['steps']]}")
        for r in ranks:
            check(r["peak_gb"] < 80.0, f"{key} rank {r['rank']}: peak "
                  f"{r['peak_gb']:.2f} GB")
        loss0 = r0["steps"][0]["loss"]
        rel0 = abs(loss0 - fwd["loss"]) / abs(fwd["loss"])
        outside = rp_step0_band(loss0, fwd)
        check(outside <= DP_STEP0_RTOL, f"{key}: step-0 loss {loss0} lies "
              f"{outside:.2e} outside one card's sound orders "
              f"{fwd['loss']}, {fwd['emulated']} (limit {DP_STEP0_RTOL})")
        out.update({"loss_rel_step0": rel0, "step0_outside": outside,
                    "control_outside": {m: rp_step0_band(v, fwd)
                                        for m, v in fwd["control"].items()}})
        ref = (f" (one card's forward {fwd['loss']:.5f}: step 0 rel "
               f"{rel0:.2e}, {outside:.2e} outside its sound orders "
               + str({m: round(v, 6) for m, v in fwd["emulated"].items()})
               + f", limit {DP_STEP0_RTOL}; the bf16 control "
               f"{out['control_outside']} outside), grad norms "
               + " ".join(f"{v:.4f}" for v in out["grad_norms"]))
        peak = f" (draw peak {out['draw_peak_gb']:.2f})"
        walls = ""
    if "observed" in r0:
        obs = [r["observed"] for r in ranks]
        check(all(o["numerics"] == obs[0]["numerics"] for o in obs)
              and obs[0]["launches"]["madam_step_stats"] > 0
              and obs[0]["numerics_leaves"]
              == obs[0]["launches"]["madam_step_stats"],
              f"{key}: the observed step's stats differ across ranks or K4 "
              f"did not step every packed leaf: {obs[0]['launches']}")
        out["observed"] = {k: obs[0][k] for k in ("loss", "step_ms",
                                                  "launches",
                                                  "numerics_leaves")}
    print(f"{key}: {r0['steps'][0]['launches']} a step; losses "
          + " ".join(f"{v:.5f}" for v in out["losses"]) + ref
          + f"; peak a rank {max(out['peak_gb']):.2f} GB" + peak
          + ", step ms rank 0 "
          + " ".join(f"{v:.1f}" for v in out["step_ms"][0]) + walls
          + f", collectives a step {out['collectives_a_step']}, bytes "
          f"{out['collective_bytes_a_step']['bytes']}", flush=True)
    return out


def tp_kernel_rows(torch, ops, ref, fmt, res):
    """The shards 31 ran: K2 at every column block 31a and 31b launched
    (M, K, N) beside its plain version and torch.matmul bf16; K1 with a
    given scale at the (2, 2) runs' activation shapes (the scale MAX-
    reduced over the data group); K3 and K4 at the largest column
    shards (``TP_K34``)."""
    from repro_torch.configs import get_config
    blocks = set()
    for key, part in list(res["31b"].items()) + [
            (k, v) for k, v in res["31a"].items()]:
        arch = (TP_PREFILL["arch"] if key in res["31a"] else
                dict(TP_TRAIN)[key.split()[0]]["arch"])
        m = int(key.split()[-1].split(",")[1])
        if m == 1:
            continue
        cfg = get_config(arch)
        widths = {cfg.d_ff // m}
        if cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0:
            widths |= {cfg.num_heads * cfg.head_dim // m,
                       cfg.num_kv_heads * cfg.head_dim // m}
        blocks |= {tuple(s) for s in part["k2_shapes"] or []
                   if s[2] in widths}
    k2 = k2_check(torch, ops, ref, fmt, sorted(blocks))
    k1_shapes = sorted({tuple(s) for s in res["31a"]["2,2"]["k1_shapes"]}
                       | {(4096, 576), (4096, 1536)})[:3]
    k1 = k1_given_check(torch, ops, ref, fmt, k1_shapes)
    k34 = k34_check(torch, ops, ref, [(R, C, 16, 2048, torch.bfloat16)
                                      for R, C in TP_K34])
    return {"qmatmul": k2, "encode_pack": k1, **k34}


def tp_main(torch, card):
    """``--mesh-tp``: phase 31 on four cards of one host."""
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.core.lns import LNSFormat
    from repro_torch.kernels import _build, ops, ref
    n = torch.cuda.device_count()
    check(n >= MESH_WORLD, f"--mesh-tp needs {MESH_WORLD} cards, {n} are "
          f"visible")
    t_start = time.monotonic()
    _build.build()
    _build.library()
    scratch = ROOT / "build" / "mesh_tp"
    scratch.mkdir(parents=True, exist_ok=True)
    marks = [("build", time.monotonic())]
    cfg = get_config(TP_PREFILL["arch"])
    params = tp_serve_params(torch, cfg)
    one_a = tp_prefill(torch, ops, params, cfg)
    del params
    print(f"31a one card: {TP_PREFILL['arch']} prefill {TP_PREFILL['rows']}"
          f" x {TP_PREFILL['seq']}: wall {one_a['wall_ms']:.1f} ms (first "
          f"call {one_a['first_wall_ms']:.1f}), peak {one_a['peak_gb']:.2f} "
          f"GB, launches {one_a['launches']}", flush=True)
    one_b = {tag: tp_one_card(torch, ops, tag, spec, scratch)
             for tag, spec in TP_TRAIN}
    marks.append(("one card", time.monotonic()))
    os.environ["OMP_NUM_THREADS"] = "1"
    mp.start_processes(tp_rank, args=(MESH_WORLD, free_port(),
                                      str(scratch)),
                       nprocs=MESH_WORLD, join=True, start_method="spawn")
    marks.append(("ranks", time.monotonic()))
    ranks = [torch.load(scratch / f"rank{r}.pt") for r in range(MESH_WORLD)]
    res = {"card": card, "31a": tp_prefill_checks(torch, one_a, ranks),
           "31a_one_card": {k: v for k, v in one_a.items()
                            if k != "logits"},
           "31b": {}}
    for tag, spec in TP_TRAIN:
        for shape in spec["meshes"]:
            key = f"{tag} {shape[0]},{shape[1]}"
            res["31b"][key] = tp_train_checks(
                tag, key, one_b[tag], [rk[key] for rk in ranks])
    marks.append(("checks", time.monotonic()))
    fmt = LNSFormat(8, 8)
    rows = tp_kernel_rows(torch, ops, ref, fmt, res)
    res["kernels"] = rows
    marks.append(("kernels", time.monotonic()))
    # the kernel line: each row's launches are a step's on every rank (a
    # rank's count; the ranks launch alike), on the (1, 4) granite part
    # for K2/K3, the (2, 2) smollm part for K1's given scale, and the
    # observed step for K4
    g = res["31b"]["31b2 1,4"]["launches_a_step"]
    s22 = res["31b"]["31b1 2,2"]
    obs = res["31b"]["31b1 1,4"]["observed"]["launches"]
    kernels = []
    for name, src, tpu, rws, launched in (
            ("qmatmul_colshard", "lns_qmatmul.cu", "lns_qmatmul.py:48",
             rows["qmatmul"], g["qmatmul"]),
            ("encode_pack_given_scale", "lns_quantize.cu",
             "lns_quantize.py:80", rows["encode_pack"],
             s22["k1_given_scale_calls"]),
            ("madam_step_shard", "madam_update.cu", "madam_update.py:231",
             rows["madam_step"], g["madam_step"]),
            ("madam_step_stats_shard", "madam_update.cu",
             "madam_update.py:291", rows["madam_step_stats"],
             obs["madam_step_stats"])):
        r = rws[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}", "launches": launched,
            "max_abs_err": max(x["max_abs_err"] for x in rws),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    res["seconds_by_phase"] = {b[0]: b[1] - a[1]
                               for a, b in zip(marks, marks[1:])}
    res["seconds"] = time.monotonic() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_mesh_tp.json").write_text(
        json.dumps(res, indent=1, default=str))
    print(f"chip_smoke --mesh-tp took {res['seconds']:.1f}s: "
          + ", ".join(f"{k} {v:.1f}s"
                      for k, v in res["seconds_by_phase"].items()))
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


# ---------------------------------------------------------------------------
# phase 32 (``--mesh-rp``): JAX's training placement for the dense family
# (``sharding.train_rules``): beside phase 31's column blocks, ``wo`` and
# ``down`` hold a rank's rows (their partial products SUM-reduced over the
# model group) and the embedding, an untied head and the logits a rank's
# vocabulary block. lns8, TP_STEPS steps, every rank drawing its shard from
# seed 0 (``init_train_state(shard=LocalShard(...))``). One card's
# references run first in this process on card 0; then one NCCL rank a
# card. 32a: gemma3-12b at full width, 6 of 48 layers (21e's depth), 4 x
# 256, on (1, 4) and (2, 2): its untied 262,144-word head split by
# vocabulary, qk-norm, local and global layers. 32b: granite-8b at full
# width, 12 of 36 layers, 8 x 256, on (1, 4) (31b2's part; then an
# observed step, K4). Both held to one card with phase 26's bounds. 32c:
# granite-8b at full width and depth (36 layers, ~8.05e9 parameters: one
# card cannot hold its training state), 8 x 256, on (1, 4): the step-0
# loss within DP_STEP0_RTOL of the range of one card's forward-only
# ``lm_loss`` at full depth (``torch.no_grad``, the same int32 words) in
# its sound orders, then the ranks agree after every step and the losses
# and grad norms stay finite. Every part: the row blocks' SUM on step 0
# (``rp_row_sum``). Then on card 0: K2 at every row block and vocabulary
# block the parts launched, K1 with a given scale at the row blocks'
# inputs, K3 at the largest row shard (32c's ``down``) and vocab shard
# (32a's ``tok`` on (1, 4)), K4 at 32b's row shard
RP_TRAIN = [
    ("32a", dict(arch="gemma3-12b", cut=dict(num_layers=6), batch=4,
                 seq=256, meshes=((1, 4), (2, 2)), word_layers=1)),
    ("32b", dict(arch="granite-8b", cut=dict(num_layers=12), batch=8,
                 seq=256, meshes=((1, 4),), word_layers=1,
                 observed=(1, 4))),
]
RP_FULL = ("32c", dict(arch="granite-8b", batch=8, seq=256, meshes=((1, 4),),
                       forward_ref=True))
RP_TIMEOUT_S = 900
# 32c's one card computes its forward in these orders besides the plain
# one: each as m model ranks compute it (``rp_emulated``)
RP_ORDERS = (2, 4, 8)
# the row blocks' SUM, checked where it happens: step 0's first ``wo`` and
# ``down`` row-parallel calls on every rank (``rp_row_spy``), the mesh's SUM
# against the rank-order f32 sum of the partials recomputed from the rank's
# own inputs, within RP_SUM_RTOL of its max |value|. A sound SUM differs
# only in the f32 order of m terms (on H100s: at most 1.11e-7); the
# control, the same partials rounded to bf16 before their sum (a partial
# product left in the compute dtype: 3.98e-3-6.65e-3), must fail the same
# limit
RP_SUM_RTOL = 1e-5
RP_ROW_EQS = {"bse,ed->bsd": ("wo", "attn_out"),
              "bsf,fd->bsd": ("down", "act_ff")}
# K3 at the largest row shard (granite's 36 stacked ``down`` rows at m = 4)
# and vocab shard (gemma3's embedding rows at m = 4); K4 at the row shard
# 32b's observed step steps (12 stacked ``down`` rows at m = 4)
RP_K3 = [(36 * 14336 // 4, 4096), (262144 // 4, 3840),
         (12 * 14336 // 4, 4096)]


@contextlib.contextmanager
def rp_emulated(torch, m, partial_dtype=None):
    """One card computing as ``m`` model ranks under ``train_rules``
    compute: each row-parallel GEMM (``wo``'s and ``down``'s contraction)
    as ``m`` row blocks, each encoded with the whole input's Q_A scale,
    their partials (f32, or ``partial_dtype``) summed in rank order and
    rounded once; the head as ``m`` vocabulary blocks. The same words,
    another order of the same sums."""
    from repro_torch.core import quantizer as qz
    from repro_torch.core.lns import LNSWeight, is_lns_weight
    from repro_torch.models import attention, layers, model
    real = qz.qeinsum
    pdt = partial_dtype or torch.float32

    def cut(w, dim, lo, hi):
        if is_lns_weight(w):
            sc = w.scale if dim == 0 else w.scale[:, lo:hi]
            return LNSWeight(w.packed.narrow(dim, lo, hi - lo), sc, w.fmt)
        return w.narrow(dim, lo, hi - lo)

    def blocked(eq, x, w, cfg, **kw):
        if eq in RP_ROW_EQS:
            c = x.shape[-1] // m
            stat = qz.act_stat(x, cfg)
            if stat is None and cfg is not None and cfg.is_quantized:
                stat = qz._stat(x, cfg.act, cfg.act_scale_axis)
            y = None
            for i in range(m):
                part = real(eq, x[..., i * c:(i + 1) * c],
                            cut(w, 0, i * c, (i + 1) * c), cfg, x_stat=stat,
                            out_dtype=pdt)
                y = part if y is None else y + part
            return y.to(x.dtype)
        if eq == "bsd,dv->bsv":
            c = w.shape[-1] // m
            return torch.cat([real(eq, x, cut(w, 1, i * c, (i + 1) * c), cfg,
                                   **kw) for i in range(m)], dim=-1)
        return real(eq, x, w, cfg, **kw)

    mods = (attention, layers, model)
    for mod in mods:
        mod.qeinsum = blocked
    try:
        yield
    finally:
        for mod in mods:
            mod.qeinsum = real


def rp_one_card_forward(torch, spec, orders, controls):
    """A part's one-card forward on card 0: the words drawn from seed 0 as
    ``init_train_state`` draws them (no second moments), then
    ``lm_loss`` on the first batch under ``torch.no_grad``, whole and as
    ``m`` model ranks compute it for each ``m`` of ``orders``
    (``rp_emulated``), and for each ``m`` of ``controls`` with the row
    blocks' partials rounded to bf16 before their sum: the losses (32c's
    reference), the plain forward's wall, each order's relative distance
    from the plain loss (``floor``), the draw's seconds, the peak."""
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.models.model import init_params, lm_loss
    from repro_torch.optim.madam import MadamConfig, lns_leaf_encoder
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.steps import batch_to_device
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dp_config(spec)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda",
                         leaf_fn=lns_leaf_encoder(MadamConfig()))
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    batch = batch_to_device(SyntheticLM(cfg, batch=spec["batch"],
                                        seq=spec["seq"]).batch_at(0), "cuda")
    qcfg = QuantConfig.lns_madam()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss = float(lm_loss(params, batch, cfg, qcfg))
        ms_ = (time.perf_counter() - t0) * 1e3
        emulated, control = {}, {}
        for m in orders:
            with rp_emulated(torch, m):
                emulated[m] = float(lm_loss(params, batch, cfg, qcfg))
        for m in controls:
            with rp_emulated(torch, m, torch.bfloat16):
                control[m] = float(lm_loss(params, batch, cfg, qcfg))
    floor = {m: abs(v - loss) / abs(loss) for m, v in emulated.items()}
    out = {"loss": loss, "forward_ms": ms_, "emulated": emulated,
           "floor": floor, "control": control,
           "control_rel": {m: abs(v - loss) / abs(loss)
                           for m, v in control.items()},
           "draw_s": draw_s, "layers": cfg.num_layers,
           "params": cfg.params_count(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    check(all(math.isfinite(v) for v in [loss, *emulated.values()]),
          f"{spec['arch']} one card: a forward's loss is not finite: "
          f"{loss}, {emulated}")
    print(f"{spec['arch']} {cfg.num_layers} layers one card, forward only, "
          f"{spec['batch']} x {spec['seq']}: loss {loss:.6f}, "
          f"{ms_:.1f} ms; the same words as m model ranks compute them: "
          + ", ".join(f"m = {m} {emulated[m]:.6f} ({floor[m]:.2e} apart)"
                      for m in orders)
          + "; with bf16 partials (the control): "
          + ", ".join(f"m = {m} {control[m]:.6f} "
                      f"({out['control_rel'][m]:.2e} apart)"
                      for m in controls)
          + f"; draw {draw_s:.1f} s, peak {out['peak_gb']:.2f} GB",
          flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rp_step0_band(loss, fwd):
    """How far ``loss`` lies outside the range of one card's sound orders
    of the same forward (the plain one and each ``rp_emulated`` order), in
    units of the plain loss; 0 inside it."""
    sound = [fwd["loss"], *fwd["emulated"].values()]
    return max(min(sound) - loss, loss - max(sound), 0.0) / abs(fwd["loss"])


@contextlib.contextmanager
def rp_row_spy(torch):
    """Step 0's first row-parallel ``wo`` and ``down`` calls on this rank:
    the rank's input columns, its row block of the weight, the Q_A scale
    and the partial's dtype that ``attention``/``layers.qeinsum`` were
    given, and the tensor ``collectives.sum_forward`` made of the
    partial. Yields ``{name: {...}}``."""
    from repro_torch.core.lns import LNSWeight, is_lns_weight
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import axis_group
    from repro_torch.models import attention, layers
    real_q, real_sum = attention.qeinsum, collectives.sum_forward
    seen, pending = {}, []

    def spy_q(eq, x, w, cfg, **kw):
        y = real_q(eq, x, w, cfg, **kw)
        name, axis = RP_ROW_EQS.get(eq, (None, None))
        if (name is not None and name not in seen and is_lns_weight(w)
                and axis_group(axis) is not None):
            stat = kw.get("x_stat")
            seen[name] = {"x": x.detach().clone(),
                          "w": LNSWeight(w.packed.clone(), w.scale.clone(),
                                         w.fmt),
                          "stat": None if stat is None else stat.clone(),
                          "partial_dtype": str(y.dtype)}
            pending.append(name)
        return y

    def spy_sum(x, group):
        y = real_sum(x, group)
        if pending:
            seen[pending.pop()]["sum"] = y.detach().float().clone()
        return y

    attention.qeinsum = layers.qeinsum = spy_q
    collectives.sum_forward = spy_sum
    try:
        yield seen
    finally:
        attention.qeinsum = layers.qeinsum = real_q
        collectives.sum_forward = real_sum


def rp_row_sum(torch, seen, shape):
    """This rank's row-block SUM check (every rank calls it together):
    for ``wo`` and ``down``, the partial recomputed in f32 from the rank's
    captured input, row block and Q_A scale; the model group's partials
    (gathered outside the counted collectives) summed in rank order, the
    reference; the mesh's SUM's max distance from it and the control's
    (the partials rounded to bf16, then summed), each over the reference's
    max |value|."""
    import torch.distributed as dist
    from repro_torch.core.quantizer import QuantConfig, qeinsum
    qcfg = QuantConfig.lns_madam()
    rank, m = dist.get_rank(), shape[1]
    group = [rank - rank % m + j for j in range(m)]
    out = {}
    for eq, (name, _) in RP_ROW_EQS.items():
        c = seen.get(name)
        if c is None or "sum" not in c:
            out[name] = None
            continue
        with torch.no_grad():
            p = qeinsum(eq, c["x"], c["w"], qcfg, x_stat=c["stat"],
                        out_dtype=torch.float32).contiguous()
        parts = [torch.empty_like(p) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, p)
        parts = [parts[j] for j in group]
        want, ctl = parts[0].clone(), parts[0].to(torch.bfloat16)
        for q in parts[1:]:
            want = want + q
            ctl = (ctl.float() + q.to(torch.bfloat16).float()).to(
                torch.bfloat16)
        top = float(want.abs().max())
        out[name] = {
            "rel": float((c["sum"] - want).abs().max()) / top,
            "rel_control": float((ctl.float() - want).abs().max()) / top,
            "bit_equal": bool(torch.equal(c["sum"], want)),
            "partial_dtype": c["partial_dtype"],
            "mkn": [p.numel() // p.shape[-1], c["x"].shape[-1], p.shape[-1]]}
    return out


def rp_row_checks(key, ranks):
    """Every rank's row-block SUMs (``rp_row_sum``) within RP_SUM_RTOL of
    the rank-order f32 sum, from f32 partials; the control beyond it on
    every rank, or the check could not see bf16 partials."""
    out = {}
    for name, _ in RP_ROW_EQS.values():
        got = [r["row_sum"][name] for r in ranks]
        check(all(g is not None for g in got), f"{key}: {name}'s row-block "
              f"call or its SUM was not seen on step 0")
        for r, g in zip(ranks, got):
            check(g["partial_dtype"] == "torch.float32",
                  f"{key} rank {r['rank']}: {name}'s partials are "
                  f"{g['partial_dtype']}, not f32")
            check(g["rel"] <= RP_SUM_RTOL,
                  f"{key} rank {r['rank']}: {name}'s SUM {g['rel']:.2e} "
                  f"from the rank-order f32 sum (limit {RP_SUM_RTOL})")
            check(g["rel_control"] > RP_SUM_RTOL,
                  f"{key} rank {r['rank']}: the control (bf16 partials) is "
                  f"{g['rel_control']:.2e} from the f32 sum, within the "
                  f"limit {RP_SUM_RTOL}: the check cannot see it")
        out[name] = {"rel": max(g["rel"] for g in got),
                     "rel_control": min(g["rel_control"] for g in got),
                     "bit_equal": all(g["bit_equal"] for g in got),
                     "mkn": got[0]["mkn"]}
        mkn = "x".join(map(str, out[name]["mkn"]))
        print(f"{key}: {name}'s row-block SUM ({mkn} a rank) "
              f"{out[name]['rel']:.2e} of max |value| from the "
              f"rank-order f32 sum (bit-equal on every rank: "
              f"{out[name]['bit_equal']}); the control, bf16 partials, "
              f"{out[name]['rel_control']:.2e}; limit {RP_SUM_RTOL}",
              flush=True)
    return out


def rp_rank(rank, world, port, out_dir):
    """One rank of ``--mesh-rp``: every phase-32 part on each of its
    meshes under ``train_rules``; this rank's results go to
    ``out_dir/rank<r>.pt``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    sys.path.insert(0, str(SRC))
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import train_rules
    from repro_torch.kernels import _build, ops
    torch.set_num_threads(1)
    _build.library()
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method="env://",
                            timeout=datetime.timedelta(seconds=RP_TIMEOUT_S))
    out = {}
    scratch = Path(out_dir)
    for tag, spec in RP_TRAIN + [RP_FULL]:
        for shape in spec["meshes"]:
            key = f"{tag} {shape[0]},{shape[1]}"
            out[key] = tp_part(torch, ops, tag, spec, shape, scratch,
                               rules_fn=train_rules)
            if rank == 0:
                r = out[key]
                print(f"{key} rank 0: {spec['arch']}: losses "
                      + " ".join(f"{x['loss']:.5f}" for x in r["steps"])
                      + ", step ms " + " ".join(f"{x['step_ms']:.1f}"
                                               for x in r["steps"])
                      + f", collectives {r['steps'][-1]['collectives']}, "
                      f"draw {r['draw_s']:.1f} s (peak "
                      f"{r['draw_peak_gb']:.2f} GB), peak "
                      f"{r['peak_gb']:.2f} GB ({r['seconds']:.1f}s)",
                      flush=True)
    torch.save(out, scratch / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def rp_blocks(res):
    """The K2 shapes phase 32's parts launched that are a rank's row
    block (the contraction split: ``wo``'s heads or ``down``'s hidden
    rows at m) or vocabulary block (the head's columns), each with its
    calls a step on rank 0 (twice over: forward and recompute)."""
    from repro_torch.configs import get_config
    rows, vocab = {}, {}
    for key, part in res.items():
        tag, mesh = key.split()
        arch = dict(RP_TRAIN + [RP_FULL])[tag]["arch"]
        m = int(mesh.split(",")[1])
        cfg = get_config(arch)
        inner = {cfg.d_ff // m, cfg.num_heads * cfg.head_dim // m}
        for s, n in (part.get("k2_calls") or {}).items():
            M, K, N = map(int, s.split("x"))
            if N == cfg.d_model and K in inner:
                rows[(M, K, N)] = rows.get((M, K, N), 0) + n
            elif N == cfg.vocab_size // m:
                vocab[(M, K, N)] = vocab.get((M, K, N), 0) + n
    return rows, vocab


def rp_main(torch, card):
    """``--mesh-rp``: phase 32 on four cards of one host."""
    import torch.multiprocessing as mp
    from repro_torch.core.lns import LNSFormat
    from repro_torch.kernels import _build, ops, ref
    n = torch.cuda.device_count()
    check(n >= MESH_WORLD, f"--mesh-rp needs {MESH_WORLD} cards, {n} are "
          f"visible")
    t_start = time.monotonic()
    _build.build()
    _build.library()
    scratch = ROOT / "build" / "mesh_rp"
    scratch.mkdir(parents=True, exist_ok=True)
    marks = [("build", time.monotonic())]
    # each part's forward in its meshes' orders and as their bf16
    # control; 32c's in RP_ORDERS too, the range its step 0 is held to
    fwd = {}
    for tag, spec in RP_TRAIN + [RP_FULL]:
        ms = sorted({s[1] for s in spec["meshes"]})
        orders = sorted(set(ms) | (set(RP_ORDERS) if spec.get("forward_ref")
                                   else set()))
        fwd[tag] = rp_one_card_forward(torch, spec, orders, ms)
    one = {tag: tp_one_card(torch, ops, tag, spec, scratch)
           for tag, spec in RP_TRAIN}
    marks.append(("one card", time.monotonic()))
    os.environ["OMP_NUM_THREADS"] = "1"
    mp.start_processes(rp_rank, args=(MESH_WORLD, free_port(),
                                      str(scratch)),
                       nprocs=MESH_WORLD, join=True, start_method="spawn")
    marks.append(("ranks", time.monotonic()))
    ranks = [torch.load(scratch / f"rank{r}.pt") for r in range(MESH_WORLD)]
    res = {"card": card, "32": {}}
    for tag, spec in RP_TRAIN + [RP_FULL]:
        for shape in spec["meshes"]:
            key = f"{tag} {shape[0]},{shape[1]}"
            part = [rk[key] for rk in ranks]
            res["32"][key] = tp_train_checks(
                tag, key, one.get(tag), part, gathers=False,
                fwd=fwd[tag] if spec.get("forward_ref") else None)
            res["32"][key]["one_card_forward"] = fwd[tag]
            res["32"][key]["row_sum"] = rp_row_checks(key, part)
    tag_c, spec_c = RP_FULL
    shape_c = spec_c["meshes"][0]
    key_c = f"{tag_c} {shape_c[0]},{shape_c[1]}"
    marks.append(("checks", time.monotonic()))
    fmt = LNSFormat(8, 8)
    rows, vocab = rp_blocks(res["32"])
    check(rows and vocab, f"--mesh-rp: no row block ({rows}) or no vocab "
          f"block ({vocab}) launched")
    k2_rows = k2_check(torch, ops, ref, fmt, sorted(rows))
    k2_vocab = k2_check(torch, ops, ref, fmt, sorted(vocab))
    # K1 with a given scale at 32c's row blocks' inputs (the shapes the
    # kernel line's launches count)
    k1 = k1_given_check(torch, ops, ref, fmt, sorted(
        {tuple(map(int, s.split("x")[:2]))
         for s in res["32"][key_c]["k2_calls"] or {}
         if tuple(map(int, s.split("x"))) in rows}))
    k34 = k34_check(torch, ops, ref, [(R, C, 16, 2048, torch.bfloat16)
                                      for R, C in RP_K3])
    k3, k4 = k34["madam_step"], k34["madam_step_stats"]
    res["kernels"] = {"qmatmul_rows": k2_rows, "qmatmul_vocab": k2_vocab,
                      "encode_pack": k1, "madam_step": k3,
                      "madam_step_stats": k4,
                      "row_block_calls": {"x".join(map(str, k)): v
                                          for k, v in rows.items()},
                      "vocab_block_calls": {"x".join(map(str, k)): v
                                            for k, v in vocab.items()}}
    marks.append(("kernels", time.monotonic()))
    # the kernel line: launches a step on every rank of 32c (granite-8b at
    # full depth on (1, 4)) for K1's given scale, K2's row blocks and K3;
    # 32a's (1, 4) step for K2's vocabulary blocks (granite's head is tied:
    # the fake-quant leg, no K2); 32b's observed step for K4
    full = res["32"][key_c]
    k1_row = max((r for r in k1 if r["scale_axis"] is None),
                 key=lambda r: r["shape"][0] * r["shape"][1])
    g_calls = sum(n for s, n in (full["k2_calls"] or {}).items()
                  if tuple(map(int, s.split("x"))) in rows)
    a14 = res["32"]["32a 1,4"]
    a_calls = sum(n for s, n in (a14["k2_calls"] or {}).items()
                  if tuple(map(int, s.split("x"))) in vocab)
    kernels = []
    for name, src, tpu, rws, launched, r in (
            ("encode_pack_given_scale_rowblock", "lns_quantize.cu",
             "lns_quantize.py:80", k1, full["k1_given_scale_calls"], k1_row),
            ("qmatmul_rowblock", "lns_qmatmul.cu", "lns_qmatmul.py:48",
             k2_rows, g_calls, k2_rows[-1]),
            ("qmatmul_vocabblock", "lns_qmatmul.cu", "lns_qmatmul.py:48",
             k2_vocab, a_calls, k2_vocab[-1]),
            ("madam_step_rowshard", "madam_update.cu", "madam_update.py:231",
             k3[:1], full["launches_a_step"]["madam_step"], k3[0]),
            ("madam_step_vocabshard", "madam_update.cu",
             "madam_update.py:231", k3[1:2],
             a14["launches_a_step"]["madam_step"], k3[1]),
            ("madam_step_stats_rowshard", "madam_update.cu",
             "madam_update.py:291", k4[2:],
             res["32"]["32b 1,4"]["observed"]["launches"]["madam_step_stats"],
             k4[2])):
        check(launched > 0, f"--mesh-rp: {name} launched no time on the "
              f"main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}", "launches": launched,
            "max_abs_err": max(x["max_abs_err"] for x in rws),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    res["seconds_by_phase"] = {b[0]: b[1] - a[1]
                               for a, b in zip(marks, marks[1:])}
    res["seconds"] = time.monotonic() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_mesh_rp.json").write_text(
        json.dumps(res, indent=1, default=str))
    print(f"chip_smoke --mesh-rp took {res['seconds']:.1f}s: "
          + ", ".join(f"{k} {v:.1f}s"
                      for k, v in res["seconds_by_phase"].items()))
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


# ---------------------------------------------------------------------------
# phase 28: the dry run (``launch.dryrun``) held to the card. 28a:
# smollm-135m at full width and depth in three cells, each traced on
# ``meta`` (in processes of their own, started after the build: they take
# host time only) and run once on card 0 under the same cost mode;
# arguments, FLOPs and bytes must be equal, the step's peak within
# DRY_PEAK_RTOL of the allocator's. 28b (``--mesh``): qwen2.5-32b decode on
# (1, 4) and smollm-135m's (4, 1) train step dry-run on the fake backend,
# held to 25d's and 26a's words and collective counters
DRY_CELLS = [("train", 4096, 8), ("prefill", 8192, 4), ("decode", 32768, 32)]
DRY_PEAK_RTOL = 0.10
DRY_CHILD = r"""
import json, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
kind, seq, batch = json.loads(sys.argv[2])
t0 = time.monotonic()
rep = dryrun.measure(*dryrun.cell_step(
    get_config("smollm-135m"), ShapeSpec(kind, seq, batch, kind), None,
    None))
rep["trace_s"] = time.monotonic() - t0
open(sys.argv[1], "w").write(json.dumps(rep))
"""
# all-gather and SUM all-reduce sizes of 28b's bus bandwidth
BUS_SIZES_MB = (1, 16, 256)
# 28b: 25d's profiled decode step (its slots) and 26a's global batch
DRY_MESH_DECODE = ("qwen2.5-32b", 4, 64)
DRY_MESH_TRAIN = ("smollm-135m", 32, 256)


def dry_start(cells=DRY_CELLS):
    """28a's meta traces, one process a cell (no card), started now;
    :func:`dry_check` collects them. Each is killed if still running when
    this process exits."""
    import atexit
    out = ROOT / "build" / "dry"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = {}
    for cell in cells:
        path = out / f"{cell[0]}.json"
        path.unlink(missing_ok=True)
        procs[cell[0]] = (subprocess.Popen(
            [sys.executable, "-c", DRY_CHILD, str(path), json.dumps(cell)],
            env=env, cwd=ROOT), path)
    atexit.register(lambda: [p.kill() for p, _ in procs.values()
                             if p.poll() is None])
    return procs


def dry_check(torch, procs):
    """28a: each cell run once on card 0 under the cost mode, beside its
    meta trace; then once more outside the mode, its wall beside the
    roofline's max(T_compute, T_memory)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun, roofline
    cfg = get_config("smollm-135m")
    rows = {}
    for kind, seq, batch in DRY_CELLS:
        spec = ShapeSpec(kind, seq, batch, kind)
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        args, run = dryrun.cell_step(cfg, spec, None, None, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        card = dryrun.measure(args, run)
        torch.cuda.synchronize()
        mode_s = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated() - before
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        del out, args, run
        proc, path = procs[kind]
        check(proc.wait(timeout=600) == 0, f"28a {kind}: the meta trace "
              f"failed (exit {proc.returncode})")
        meta = json.loads(path.read_text())
        t_c = meta["flops"] / roofline.PEAK_FLOPS * 1e3
        t_m = meta["bytes"] / roofline.HBM_BW * 1e3
        row = {"shape": [batch, seq], "meta": meta, "card": card,
               "card_peak_bytes": peak, "card_mode_s": mode_s,
               "wall_ms": wall_ms, "t_compute_ms": t_c, "t_memory_ms": t_m,
               "model_peak_rel_err": meta["memory"]["peak_bytes"] / peak - 1}
        rows[kind] = row
        for k in ("argument_size_in_bytes", "output_size_in_bytes"):
            check(meta["memory"][k] == card["memory"][k],
                  f"28a {kind}: {k} {meta['memory'][k]} on meta, "
                  f"{card['memory'][k]} on the card")
        for k in ("flops", "bytes"):
            check(meta[k] == card[k], f"28a {kind}: {k} {meta[k]} on meta, "
                  f"{card[k]} on the card")
        check(abs(row["model_peak_rel_err"]) <= DRY_PEAK_RTOL,
              f"28a {kind}: modelled peak {meta['memory']['peak_bytes']} vs "
              f"max_memory_allocated {peak} "
              f"({row['model_peak_rel_err']:+.1%})")
        print(f"28a smollm-135m {kind} {batch}x{seq}: arguments "
              f"{meta['memory']['argument_size_in_bytes'] / 1e9:.3f} GB, "
              f"FLOPs {meta['flops']:.6g} and bytes {meta['bytes']:.6g} "
              f"equal on meta and the card ({meta['aten_ops']} aten ops, "
              f"{sum(r['calls'] for r in meta['kernels'].values())} kernel "
              f"calls); peak {meta['memory']['peak_bytes'] / 1e9:.3f} GB "
              f"modelled vs {peak / 1e9:.3f} GB max_memory_allocated "
              f"({row['model_peak_rel_err']:+.2%}); an unmodelled call "
              f"{wall_ms:.1f} ms beside max(T_compute {t_c:.2f}, T_memory "
              f"{t_m:.2f}) ms = {wall_ms / max(t_c, t_m):.2f}x (meta trace "
              f"{meta['trace_s']:.1f} s, the mode's run on the card "
              f"{mode_s:.1f} s)", flush=True)
    props = torch.cuda.get_device_properties(0)
    print(f"28a: card 0 total_memory {props.total_memory} bytes "
          f"(launch.roofline.HBM_BYTES {roofline.HBM_BYTES})")
    rows["total_memory"] = props.total_memory
    return rows


def bus_bandwidth(torch, dist, world):
    """28b on every rank: all-gather and SUM all-reduce of BUS_SIZES_MB
    (the gathered output's size), bus bandwidth as nccl-tests counts it
    ((n-1)/n of the bytes an all-gather moves, 2 (n-1)/n an
    all-reduce), CUDA events around 10 calls after 3."""
    out = {}
    for mb in BUS_SIZES_MB:
        n = mb * (1 << 20) // 4
        full = torch.empty(n, dtype=torch.float32, device="cuda")
        part = torch.ones(n // world, dtype=torch.float32, device="cuda")
        calls = {"all-gather": (lambda: dist.all_gather_into_tensor(
                     full, part), (world - 1) / world),
                 "all-reduce": (lambda: dist.all_reduce(full),
                                2 * (world - 1) / world)}
        for kind, (fn, factor) in calls.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            dist.barrier()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(10):
                fn()
            end.record()
            torch.cuda.synchronize()
            s = start.elapsed_time(end) / 10 / 1e3
            out[f"{kind} {mb} MB"] = {"s": s, "bus_bps": n * 4 / s * factor}
        del full, part
    return out


def dry_mesh(torch, ranks):
    """28b in the parent (no card): qwen2.5-32b decode on (1, 4) at full
    depth and smollm-135m's data-parallel step on (4, 1), dry-run on the
    fake backend, held to 25d's words and profiled step and to 26a's last
    step."""
    from repro_torch.configs import ShapeSpec, get_config, get_rules
    from repro_torch.distributed.sharding import serving_rules, shard_ctx
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import NVLINK_BW
    out = {}
    arch, slots, seq = DRY_MESH_DECODE
    cfg = get_config(arch)
    t0 = time.monotonic()
    with dryrun.meta_mesh({"data": 1, "model": MESH_WORLD},
                          MESH_WORLD) as mesh:
        rules = serving_rules(cfg, mesh)
        with shard_ctx(mesh, rules):
            args, run = dryrun.cell_step(
                cfg, ShapeSpec("d", seq, slots, "decode"), mesh, rules)
            rep = dryrun.measure(args, run)
        words = packed_bytes(args[0])
    prof = [rk["25d"]["profile"] for rk in ranks]
    measured = [rk["25d"]["weights_gb"] for rk in ranks]
    kinds = ("all-gather", "all-reduce")
    dry_bytes = {k: rep["collectives"]["bytes"].get(k, 0) for k in kinds}
    card_bytes = [{k: p["collective_bytes"]["bytes"].get(k, 0)
                   for k in kinds} for p in prof]
    out["25d"] = {"words_gb": words / 1e9, "card_words_gb": measured,
                  "collectives": rep["collective_calls"],
                  "card_collectives": [p["collectives"] for p in prof],
                  "bytes": dry_bytes, "card_bytes": card_bytes,
                  "peak_gb": rep["memory"]["peak_bytes"] / 1e9,
                  "trace_s": time.monotonic() - t0}
    for r, (w, p, b) in enumerate(zip(measured, prof, card_bytes)):
        check(abs(words / 1e9 - w) < 1e-9,
              f"28b: qwen2.5-32b words a rank {words / 1e9} GB modelled, "
              f"{w} GB on rank {r} (25d)")
        for k in ("gather", "max_reduce"):
            check(rep["collective_calls"][k] == p["collectives"][k],
                  f"28b: qwen2.5-32b {k} a step {rep['collective_calls']} "
                  f"modelled, {p['collectives']} on rank {r} (25d)")
        check(b == dry_bytes, f"28b: qwen2.5-32b collective bytes a step "
              f"{dry_bytes} modelled, {b} on rank {r} (25d)")
    print(f"28b qwen2.5-32b decode on (1, {MESH_WORLD}) dry-run: "
          f"{words / 1e9:.2f} GB of words a rank (25d: "
          f"{[round(w, 2) for w in measured]}), collectives a step "
          f"{rep['collective_calls']} and bytes {dry_bytes} equal 25d's "
          f"profiled step ({out['25d']['trace_s']:.1f} s)", flush=True)
    arch, batch, seq = DRY_MESH_TRAIN
    cfg = get_config(arch)
    t0 = time.monotonic()
    with dryrun.meta_mesh({"data": MESH_WORLD, "model": 1},
                          MESH_WORLD) as mesh:
        rules = get_rules(arch)
        with shard_ctx(mesh, rules):
            rep = dryrun.measure(*dryrun.cell_step(
                cfg, ShapeSpec("t", seq, batch, "train"), mesh, rules))
    steps = [rk["26a"]["steps"][-1] for rk in ranks]
    dry_bytes = rep["collectives"]["bytes"]
    out["26a"] = {"collectives": rep["collective_calls"],
                  "card_collectives": [x["collectives"] for x in steps],
                  "bytes": dry_bytes,
                  "card_bytes": [x["collective_bytes"]["bytes"]
                                 for x in steps],
                  "trace_s": time.monotonic() - t0}
    for r, x in enumerate(steps):
        check(x["collectives"] == rep["collective_calls"],
              f"28b: smollm (4, 1) step collectives {rep['collective_calls']}"
              f" modelled, {x['collectives']} on rank {r} (26a)")
        check(x["collective_bytes"]["bytes"] == dry_bytes,
              f"28b: smollm (4, 1) step bytes {dry_bytes} modelled, "
              f"{x['collective_bytes']['bytes']} on rank {r} (26a)")
    print(f"28b smollm-135m train on ({MESH_WORLD}, 1) dry-run: collectives "
          f"a step {rep['collective_calls']} and bytes {dry_bytes} equal "
          f"26a's last step ({out['26a']['trace_s']:.1f} s)", flush=True)
    bus = [rk["bus"] for rk in ranks]
    out["bus"] = bus
    for key in bus[0]:
        bps = [b[key]["bus_bps"] for b in bus]
        print(f"28b {key} on {MESH_WORLD} cards: bus bandwidth "
              f"{min(bps) / 1e9:.1f}-{max(bps) / 1e9:.1f} GB/s a rank "
              f"(launch.roofline.NVLINK_BW {NVLINK_BW / 1e9:.0f} GB/s)",
              flush=True)
    return out


def h20_line(tag, rows, one):
    """25c's replicas (ROADMAP H20): for each rank, whether its streams
    are rank 0's and one card's, the first sampled batch at which it
    parts from its data replica (ranks 0/2, 1/3) and from rank 0, and
    whether the replicas' null pages are equal."""
    one_streams = {str(k): v for k, v in one["streams"].items()}
    line = {"tag": tag, "null_pages": [r["null_page"] for r in rows],
            "streams_equal_rank0": [r["streams"] == rows[0]["streams"]
                                    for r in rows],
            "streams_equal_one_card": [r["streams"] == one_streams
                                       for r in rows],
            "batches": [len(r["digests"]) for r in rows],
            "replica_parts": [first_parting(rows[r]["digests"],
                                            rows[r ^ 2]["digests"])
                              for r in range(len(rows))],
            "rank0_parts": [first_parting(rows[0]["digests"],
                                          r["digests"]) for r in rows]}
    line["replica_null_pages_equal"] = [
        rows[r]["null_page"] == rows[r ^ 2]["null_page"]
        for r in range(len(rows))]
    print(f"{tag}: streams equal rank 0's {line['streams_equal_rank0']}, "
          f"one card's {line['streams_equal_one_card']}; replicas' null "
          f"pages equal {line['replica_null_pages_equal']}; first batch "
          f"where a rank parts from its replica "
          f"{[p and p['batch'] for p in line['replica_parts']]} (of "
          f"{line['batches']})", flush=True)
    return line


def mesh_main(torch, card, parts=("25", "26", "27")):
    """``--mesh``: phases 25c-e, 26 and 27 on four cards of one host
    (``--mesh-train``: phase 26 alone, ``--mesh-serve``: 27 alone,
    ``--mesh-25c``: 25c five times and ``25c.old``)."""
    import torch.multiprocessing as mp
    n = torch.cuda.device_count()
    check(n >= MESH_WORLD, f"--mesh needs {MESH_WORLD} cards, "
          f"{n} are visible")
    from repro_torch.kernels import _build, ops
    t_start = time.monotonic()
    _build.build()
    _build.library()
    scratch = ROOT / "build" / "mesh"
    scratch.mkdir(parents=True, exist_ok=True)
    marks = [("build", time.monotonic())]
    runs = ((MESH_RUNS if "25" in parts else [])
            + (H20_RUNS if "25c" in parts else [])
            + (MESH27_RUNS if "27" in parts else []))
    dp_runs = DP_RUNS if "26" in parts else []
    # 26's one-card steps first, on a fresh cache: gemma3's staged step
    # (26b) took card 0 to 7.5 GB of its end after 25's serve runs
    dp_one = {tag: dp_one_card(torch, ops, tag, spec, scratch)
              for tag, spec in dp_runs}
    marks.append(("26 one card", time.monotonic()))
    one = {}
    for tag, arch, argv, mesh, cut in runs:
        if tag in MESH_ONE_CARD or tag.startswith("27") or tag == "25c.1":
            one[tag] = one_card(torch, ops, tag, arch, argv, cut, scratch)
        elif tag.startswith("25c."):       # the same trace: run once
            one[tag] = one["25c.1"]
    marks.append(("one card", time.monotonic()))
    shards27 = gw_ref = None
    if "27" in parts:
        from repro_torch.core.lns import LNSFormat
        from repro_torch.kernels import ref as plain
        shards27 = shard_invariance(
            torch, ops, plain, LNSFormat(8, 8), tag="27",
            gemms=MESH27_K2_GEMMS, heads_list=MESH27_K5_HEADS,
            k2_timed=MESH27_K2_TIMED, k5_timed=MESH27_K5_TIMED)
        shards27["merged_qkv"] = merged_qkv_check(torch)
        gw_ref = gateway_reference(torch, ops)
        marks.append(("27 one card", time.monotonic()))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"26: card 0 holds {torch.cuda.memory_reserved() / 1e9:.2f} GB "
          f"reserved before the ranks start", flush=True)
    # as torchrun does: one intra-op thread a rank (the ranks share the
    # host's cores; read when each rank imports torch); expandable
    # segments, so a rank's gemma3 step (26b) is not refused for the
    # cache's fragments after the earlier parts
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    dry = "25" in parts and "26" in parts     # 28b
    mp.start_processes(mesh_rank, args=(MESH_WORLD, free_port(),
                                        str(scratch), runs, dp_runs, dry),
                       nprocs=MESH_WORLD, join=True, start_method="spawn")
    marks.append(("ranks", time.monotonic()))
    ranks = [json.loads((scratch / f"rank{r}.json").read_text())
             for r in range(MESH_WORLD)]
    res = {"card": card, "one_card": one, "ranks": ranks,
           "dp_one_card": dp_one}
    if "27" in parts:
        res["27a"] = gateway_mesh(torch, scratch, gw_ref)
        print(json.dumps({k: v for k, v in res["27a"].items()
                          if k != "numerics"}))
        res["27_shards"] = shards27
        marks.append(("27a ranks", time.monotonic()))
    for tag, arch, argv, mesh, cut in runs:
        rows = [rk[tag] for rk in ranks]
        n_req = int(argv[argv.index("--requests") + 1])
        if tag.startswith("25c"):
            res.setdefault("h20", {})[tag] = h20_line(tag, rows, one[tag])
        if tag == "25c.old":    # the write before the repair: reported
            continue
        for r in rows:
            check(r["completed"] == n_req, f"{tag} rank {r['rank']}: "
                  f"{r['completed']}/{n_req} requests completed")
            check(r["streams"] == rows[0]["streams"],
                  f"{tag}: rank {r['rank']}'s streams differ from rank 0's")
        line = {"tag": tag, "arch": arch, "mesh": mesh, "cut": cut,
                "completed": rows[0]["completed"],
                "tpot_p50_ms": rows[0]["tpot_p50_ms"],
                "tokens_per_s": rows[0]["tokens_per_s"],
                "weights_gb": [r["weights_gb"] for r in rows],
                "peak_gb": [r["peak_gb"] for r in rows],
                "launches_a_forward": [r["launches_a_forward"]
                                       for r in rows],
                "collectives_a_forward": rows[0]["collectives_a_forward"],
                "dropped": rows[0]["dropped"]}
        if tag in one:
            line["one_card"] = {k: one[tag][k] for k in (
                "tpot_p50_ms", "tokens_per_s", "weights_gb", "peak_gb")}
            line["streams_equal"] = rows[0]["streams"] == {
                str(k): v for k, v in one[tag]["streams"].items()}
            if tag == "25e2":
                if line["streams_equal"]:
                    print(f"{tag}: the (1, 4) mesh's streams equal one "
                          f"card's (phase 24b's run)")
                else:
                    line["parted"] = where_parted(
                        torch, scratch / f"{tag}_one_card.pt",
                        scratch / f"{tag}_mesh.pt")
                    print(f"{tag}: the streams part from one card's (not "
                          f"claimed equal): {line['parted']}")
            else:
                check(line["streams_equal"], f"{tag}: the mesh's streams "
                      f"differ from one card's")
        if tag == "25d":
            line["profile"] = [r["profile"] for r in rows]
        if tag.startswith("27"):
            line["ttft_mean_ms"] = rows[0]["ttft_mean_ms"]
            line["one_card"]["ttft_mean_ms"] = one[tag]["ttft_mean_ms"]
            line["launches_a_forward"] = rows[0]["launches_a_forward"]
            print(f"{tag}: {arch} on (1, 4): streams equal one card's, tpot "
                  f"p50 {line['tpot_p50_ms']:.2f} ms (one card "
                  f"{one[tag]['tpot_p50_ms']:.2f} ms), ttft mean "
                  f"{line['ttft_mean_ms']:.1f} ms (one card "
                  f"{one[tag]['ttft_mean_ms']:.1f} ms), collectives a "
                  f"forward {line['collectives_a_forward']}, peak a rank "
                  f"{[round(x, 2) for x in line['peak_gb']]} GB (one card "
                  f"{one[tag]['peak_gb']:.2f} GB)")
        res[tag] = line
        print(json.dumps(line))
    for tag, spec in dp_runs:
        rows = [rk[tag] for rk in ranks]
        cmp = dp_checks(tag, spec, dp_one[tag], rows)
        r0 = rows[0]
        line = {"tag": tag, "arch": spec["arch"], "mesh": f"{MESH_WORLD},1",
                "global_batch": [spec["batch"], spec["seq"]],
                "losses": [x["loss"] for x in r0["steps"]],
                "one_card_losses": [x["loss"] for x in
                                    dp_one[tag]["steps"]],
                "grad_norms": [x["grad_norm"] for x in r0["steps"]],
                "one_card_grad_norms": [x["grad_norm"] for x in
                                        dp_one[tag]["steps"]],
                **cmp,
                "step_ms": [[x["step_ms"] for x in r["steps"]]
                            for r in rows],
                "one_card_step_ms": [x["step_ms"] for x in
                                     dp_one[tag]["steps"]],
                "collectives_a_step": r0["steps"][-1]["collectives"],
                "launches_a_step": r0["steps"][-1]["launches"],
                "k1_given_scale_calls_a_step":
                    r0["steps"][-1]["k1_given_scale_calls"],
                "profile": [r["profile"] for r in rows],
                "stages": [r["stages"] for r in rows],
                "one_card_stages": dp_one[tag]["stages"],
                "peak_gb": [r["peak_gb"] for r in rows],
                "one_card_peak_gb": dp_one[tag]["peak_gb"],
                "word_share": r0.get("word_share"),
                "word_diff_sizes": r0.get("word_diff_sizes"),
                "ranks_agree": True}
        if "cli" in r0:
            line["cli"] = {k: r0["cli"][k] for k in (
                "losses", "wall_s", "tokens_per_s", "launches",
                "k1_given_scale_calls")}
        res[tag] = line
        print(json.dumps(line))
    marks.append(("checks", time.monotonic()))
    if dry:
        res["28b"] = dry_mesh(torch, ranks)
        marks.append(("28b", time.monotonic()))
    res["seconds_by_phase"] = {b[0]: b[1] - a[1]
                               for a, b in zip(marks, marks[1:])}
    res["seconds"] = time.monotonic() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = ("chip_smoke_mesh.json" if len(parts) > 1 else
            {"26": "chip_smoke_mesh_train.json",
             "27": "chip_smoke_mesh_serve.json",
             "25c": "chip_smoke_mesh_h20.json"}[parts[0]])
    (out_dir / name).write_text(json.dumps(res, indent=1))
    print(f"chip_smoke --mesh took {res['seconds']:.1f}s: "
          + ", ".join(f"{k} {v:.1f}s"
                      for k, v in res["seconds_by_phase"].items()))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


# ---------------------------------------------------------------------------
# phase 27: mesh serving completed (the gateway on a mesh, the recurrent
# families tensor-parallel)


def merged_qkv_check(torch):
    """27c: zamba2-7b's LoRA-merged shared QKV at full width (random packed
    ``wq``/``wk``/``wv`` and one occurrence's ``lora_a``/``lora_b`` of
    rank 128). ``_lora_qkv`` on each rank's ``qkv_out`` column blocks (m
    = 4) must give one card's merged weights restricted to those heads,
    bit for bit; then the dense (fake-quant, cuBLAS) GEMM on a block is
    compared with those columns of the whole GEMM at ``MERGED_QKV_X``'s
    shapes, which decides ``params_sharding.kept_whole``: where a block
    sums in another order, the port merges and projects at the whole
    width on every rank."""
    from repro_torch.configs import get_config
    from repro_torch.core.lns import LNSFormat, LNSWeight
    from repro_torch.core.quantizer import QuantConfig, qeinsum
    from repro_torch.distributed.sharding import serving_rules, shard_ctx
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import _lora_qkv
    cfg = get_config("zamba2-7b")
    fmt = LNSFormat(8, 8)
    gen = torch.Generator(device="cuda").manual_seed(27)
    d, r = cfg.d_model, cfg.shared_block_lora_rank
    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim

    def packed(K, N, scale):
        return LNSWeight(torch.randint(0, 256, (K, N), generator=gen,
                                       device="cuda", dtype=torch.uint8),
                         torch.full((1, N), scale, device="cuda"), fmt)

    attn = {"wq": packed(d, q_dim, 2.0 ** -4),
            "wk": packed(d, kv_dim, 2.0 ** -4),
            "wv": packed(d, kv_dim, 2.0 ** -4)}
    bp = {"lora_a": packed(d, r, 2.0 ** -4),
          "lora_b": packed(r, q_dim + 2 * kv_dim, 2.0 ** -6)}
    qcfg = QuantConfig.lns_madam()
    whole = _lora_qkv(attn, bp, cfg)
    xs = {(B, S): torch.randn((B, S, d), generator=gen, device="cuda").to(
        cfg.compute_dtype) for B, S in MERGED_QKV_X}
    ys = {k: {bs: qeinsum("bsd,de->bse", x, whole[k], qcfg)
              for bs, x in xs.items()} for k in ("wq", "wk", "wv")}
    m = 4
    merged_equal, gemm_equal = True, {f"{B}x{S}": True for B, S in xs}
    for rank in range(m):
        mesh = Mesh({"data": 1, "model": m}, rank, "cuda")
        block = dict(attn)
        for k in ("wq", "wk", "wv"):
            w = attn[k]
            n = w.packed.shape[1] // m
            cols = slice(rank * n, (rank + 1) * n)
            block[k] = LNSWeight(w.packed[:, cols].contiguous(),
                                 w.scale[:, cols].contiguous(), fmt)
        with shard_ctx(mesh, serving_rules(cfg, mesh)):
            got = _lora_qkv(block, bp, cfg)
        for k in ("wq", "wk", "wv"):
            n = whole[k].shape[1] // m
            cols = slice(rank * n, (rank + 1) * n)
            merged_equal &= torch.equal(got[k], whole[k][:, cols])
            for (B, S), x in xs.items():
                y = qeinsum("bsd,de->bse", x, got[k], qcfg)
                gemm_equal[f"{B}x{S}"] &= torch.equal(y, ys[k][(B, S)][
                    ..., cols])
    check(merged_equal, "27c: a rank's LoRA-merged QKV block differs from "
          "one card's merged weights restricted to its heads")
    out = {"merged_blocks_bitwise": merged_equal,
           "gemm_blocks_bitwise": gemm_equal,
           "rule": "whole width on every rank (params_sharding.kept_whole)"}
    print(f"27c merged QKV (zamba2-7b, lora rank {r}, model = {m}): every "
          f"rank's merged block equals one card's columns bit for bit; the "
          f"dense GEMM on a block equals the whole GEMM's columns "
          f"{gemm_equal} (so the port merges and projects at the whole "
          f"width and keeps the rank's heads)")
    return out


def gateway_bodies(cfg):
    """27a's completions: greedy and seeded interleaved, two sharing a
    prompt (the second reuses the first's pages)."""
    import numpy as np
    rng = np.random.default_rng(27)
    out = []
    for i in range(GATEWAY_STREAMS):
        prompt = rng.integers(1, cfg.vocab_size, (8 + 2 * i,)).tolist()
        if i == 4:
            prompt = out[1]["prompt"]
        body = {"prompt": prompt, "max_tokens": 8 + 2 * (i % 3)}
        if i % 2:
            body.update(temperature=0.8, top_k=50, seed=2700 + i)
        out.append(body)
    return out


def gateway_reference(torch, ops):
    """27a's one-card replay on card 0: the gateway's engine built from
    the same argv, each body parsed as the gateway parses it and run to
    its end before the next; the streams, the numerics snapshot and the
    TPOT."""
    from repro_torch.launch.serve import build_engine, parser
    from repro_torch.server.protocol import parse_completion
    from repro_torch.serving import Request
    engine = build_engine(parser().parse_args(GATEWAY_ARGV))
    bodies = gateway_bodies(engine.cfg)
    tpot = []
    for i, b in enumerate(bodies):
        c = parse_completion(json.dumps(b).encode())
        agg = engine.run([Request(rid=i, prompt=c.prompt,
                                  max_new_tokens=c.max_tokens,
                                  sampling=c.sampling)])
        tpot.append(agg["tpot_p50_s"] * 1e3)
    out = {"bodies": bodies, "streams": streams(engine),
           "numerics": engine.numerics_snapshot(), "tpot_ms": tpot,
           "launches_k7": ops.launch_counts().get("requant_pack", 0)}
    print(f"27a one card: {len(bodies)} completions replayed one after "
          f"another, tpot p50 {[round(t, 2) for t in tpot]} ms")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def gateway_rank(rank, world, port, out_dir):
    """One rank of 27a: torchrun's environment for this card, the
    gateway's engine from ``GATEWAY_ARGV`` on the (2, 2) mesh, then
    ``launch.serve.run_http`` (rank 0 serves loopback HTTP on port 0 and
    writes its address to ``out_dir/addr``; the others follow) until the
    parent's SIGINT stops it; this rank's results go to
    ``out_dir/gw_rank<r>.json``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    sys.path.insert(0, str(SRC))
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.serve import build_engine, parser, run_http
    torch.set_num_threads(1)
    _build.library()
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method="env://",
                            timeout=datetime.timedelta(
                                seconds=MESH_TIMEOUT_S))
    args = parser().parse_args(GATEWAY_ARGV + ["--mesh", GATEWAY_MESH])
    engine = build_engine(args)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()

    def ready(host, p):
        tmp = Path(out_dir) / "addr.tmp"
        tmp.write_text(f"{host}:{p}")
        tmp.rename(Path(out_dir) / "addr")

    t0 = time.monotonic()
    run_http(engine, "127.0.0.1:0", engine.cfg.name, args.max_queue,
             ready=ready)
    out = {"rank": rank, "free_pages": engine.allocator.available,
           "num_pages": engine.num_pages,
           "running": len(engine.scheduler.running),
           "queued": len(engine.queue), "mesh_syncs": engine.mesh_syncs,
           "mesh_sync_s": engine.mesh_sync_s,
           "decode_steps": engine.decode_steps,
           "spec_cycles": engine.spec_cycles, "prefills": engine.prefills,
           "launches": ops.launch_counts(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.monotonic() - t0}
    (Path(out_dir) / f"gw_rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def gateway_client(host, port, bodies, max_queue):
    """27a's client session over loopback: the bodies streamed one after
    another, ``/metrics.json`` around an idle gap of ``GATEWAY_IDLE_S``,
    then a stream DELETEd after 4 frames and ``max_queue`` long streams
    with one more POST past the watermark; then ``/health``, ``/metrics``
    and ``/metrics.json`` once no request is live."""
    import asyncio

    async def session():
        res = {"streams": []}
        for b in bodies:
            res["streams"].append(await sse_call(host, port, b))
        stats = lambda: http_call(host, port, "GET", "/metrics.json")
        res["idle_before"] = json.loads((await stats())[1])
        t0 = time.monotonic()
        await asyncio.sleep(GATEWAY_IDLE_S)
        res["idle_after"] = json.loads((await stats())[1])
        res["idle_s"] = time.monotonic() - t0
        long = {"prompt": bodies[0]["prompt"], "max_tokens": 48}
        res["deleted"] = await sse_call(host, port, long, delete_after=4)
        burst = [asyncio.ensure_future(sse_call(
            host, port, {**long, "max_tokens": 24}))
            for _ in range(max_queue)]
        t_end = time.monotonic() + 60
        while time.monotonic() < t_end:
            if json.loads((await stats())[1])["inflight"] >= max_queue:
                break
            await asyncio.sleep(0.005)
        res["over"] = await http_call(host, port, "POST", "/v1/completions",
                                      long)
        res["burst"] = await asyncio.gather(*burst)
        t_end = time.monotonic() + 60
        while time.monotonic() < t_end:
            st = json.loads((await stats())[1])
            if (st["running"] == 0 and st["queued"] == 0 and
                    st["kv_pages_available"] == st["kv_pages_total"]):
                break
            await asyncio.sleep(0.02)
        res["stats"] = st
        res["health"] = json.loads((await http_call(host, port, "GET",
                                                    "/health"))[1])
        res["metrics"] = (await http_call(host, port, "GET",
                                          "/metrics"))[1].decode()
        return res

    return asyncio.run(session())


def gateway_mesh(torch, scratch, ref):
    """27a on four cards: one NCCL rank a card (spawned) runs
    :func:`gateway_rank`; this process is the HTTP client
    (:func:`gateway_client`), then passes SIGINT to every rank as torchrun
    does and waits for each to exit. Checked: the 8 streams equal the
    one-card replay's, the DELETE ends ``aborted``, 429 past the
    watermark, ``/health``'s mesh and whole-tree numerics (the weights'
    exactly, the draft view's mean error within 1e-5 relative), the mesh
    label in ``/metrics``, the ranks stepping through the idle gap, every
    rank's pages back and every rank's exit code 0."""
    import signal
    import torch.multiprocessing as mp
    gdir = scratch / "gateway"
    if gdir.exists():
        for f in gdir.iterdir():
            f.unlink()
    gdir.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    ctx = mp.start_processes(gateway_rank, args=(MESH_WORLD, free_port(),
                                                 str(gdir)),
                             nprocs=MESH_WORLD, join=False,
                             start_method="spawn")
    try:
        t_end = time.monotonic() + MESH_TIMEOUT_S
        while not (gdir / "addr").exists():
            check(time.monotonic() < t_end, "27a: the gateway never listened")
            check(all(p.exitcode is None for p in ctx.processes),
                  "27a: a rank ended before the gateway listened")
            time.sleep(0.05)
        host, port = (gdir / "addr").read_text().rsplit(":", 1)
        t_listen = time.monotonic() - t0
        max_queue = int(GATEWAY_ARGV[GATEWAY_ARGV.index("--max-queue") + 1])
        res = gateway_client(host, int(port), ref["bodies"], max_queue)
    finally:
        for p in ctx.processes:
            if p.exitcode is None:
                os.kill(p.pid, signal.SIGINT)
        t_stop = time.monotonic()
        t_end = t_stop + GATEWAY_EXIT_S
        codes = []
        for p in ctx.processes:
            p.join(max(t_end - time.monotonic(), 0.1))
            if p.exitcode is None:
                p.kill()
                p.join()
            codes.append(p.exitcode)
        stop_s = time.monotonic() - t_stop
    check(codes == [0] * MESH_WORLD, f"27a: the ranks exited {codes} after "
          f"SIGINT ({stop_s:.1f}s)")
    ranks = [json.loads((gdir / f"gw_rank{r}.json").read_text())
             for r in range(MESH_WORLD)]
    for i, s in enumerate(res["streams"]):
        check(s["status"] == 200 and s["reason"] == "length",
              f"27a: stream {i} got {s['status']} {s['reason']}")
    got = {i: s["tokens"] for i, s in enumerate(res["streams"])}
    check(got == ref["streams"], f"27a: the gateway's streams on the mesh "
          f"differ from one card's replay: "
          f"{[i for i in got if got[i] != ref['streams'].get(i)]}")
    d = res["deleted"]
    check(d["reason"] == "aborted" and 4 <= len(d["tokens"]) < 48,
          f"27a: the DELETE ended {d['reason']} after {len(d['tokens'])} "
          f"tokens")
    check(res["over"][0] == 429, f"27a: past the watermark got "
          f"{res['over'][0]}, not 429")
    check(all(s["status"] == 200 and s["reason"] == "length"
              for s in res["burst"]), "27a: a burst stream did not finish")
    health = res["health"]
    check(health.get("mesh") == {"data": 2, "model": 2},
          f"27a: /health's mesh is {health.get('mesh')}")
    num, want = health.get("numerics", {}), ref["numerics"]
    check(num.get("weights") == want["weights"],
          f"27a: /health's weights numerics {num.get('weights')} are not "
          f"one card's {want['weights']}")
    dr, wdr = num.get("draft_requant", {}), want.get("draft_requant", {})
    check(dr.keys() == wdr.keys() and all(
        abs(dr[b]["rel_err_mean"] - wdr[b]["rel_err_mean"])
        <= 1e-5 * abs(wdr[b]["rel_err_mean"]) and
        {k: v for k, v in dr[b].items() if k != "rel_err_mean"} ==
        {k: v for k, v in wdr[b].items() if k != "rel_err_mean"}
        for b in wdr), f"27a: /health's draft numerics {dr} are not one "
        f"card's {wdr}")
    check('mesh="data=2,model=2"' in res["metrics"],
          "27a: /metrics' build_info lacks the mesh label")
    a, b = res["idle_before"], res["idle_after"]
    syncs = b["mesh_syncs"] - a["mesh_syncs"]
    per_s = syncs / res["idle_s"]
    host_us = (b["mesh_sync_s"] - a["mesh_sync_s"]) / max(syncs, 1) * 1e6
    check(syncs > 0, "27a: the ranks did not step through the idle gap")
    for r in ranks:
        check(r["free_pages"] == r["num_pages"] and r["running"] == 0
              and r["queued"] == 0, f"27a rank {r['rank']}: "
              f"{r['free_pages']}/{r['num_pages']} pages free, "
              f"{r['running']} running after the stop")
        check(r["mesh_syncs"] == ranks[0]["mesh_syncs"],
              f"27a rank {r['rank']} took {r['mesh_syncs']} broadcasts, "
              f"rank 0 {ranks[0]['mesh_syncs']}")
    launches = ranks[0]["launches"]
    check(all(launches.get(k, 0) > 0 for k in (
        "encode_pack", "qmatmul", "paged_attend", "fused_sample",
        "requant_pack")), f"27a: a kernel of the path did not launch: "
        f"{launches}")
    line = {"tag": "27a", "arch": "smollm-135m", "mesh": GATEWAY_MESH,
            "streams_equal": True, "streams": len(got),
            "first_frame_ms": [s["first_frame_s"] * 1e3
                               for s in res["streams"]],
            "deleted_after": len(d["tokens"]), "over_status": res["over"][0],
            "health_mesh": health["mesh"], "numerics": num,
            "idle_s": res["idle_s"], "idle_broadcasts": syncs,
            "broadcasts_per_s": per_s, "broadcast_host_us": host_us,
            "listen_s": t_listen, "stop_s": stop_s, "exit_codes": codes,
            "launches": launches,
            "tpot_p50_ms": res["stats"]["tpot_p50_s"] * 1e3,
            "ttft_mean_ms": res["stats"]["ttft_mean_s"] * 1e3,
            "one_card_tpot_ms": ref["tpot_ms"],
            "peak_gb": [r["peak_gb"] for r in ranks],
            "mesh_syncs": [r["mesh_syncs"] for r in ranks],
            "pages_back": True}
    print(f"27a: the gateway on (2, 2) served {len(got)} streams equal to "
          f"one card's replay, DELETE after {len(d['tokens'])} tokens "
          f"'aborted', 429 past the watermark, /health mesh "
          f"{health['mesh']} and numerics equal to one card's; idle "
          f"{res['idle_s']:.1f}s: {syncs} broadcasts ({per_s:.1f}/s, "
          f"{host_us:.0f} us of rank 0's host each); every rank's pages "
          f"back, exit codes {codes} {stop_s:.1f}s after SIGINT; the "
          f"gateway's tpot p50 {line['tpot_p50_ms']:.2f} ms, ttft mean "
          f"{line['ttft_mean_ms']:.1f} ms; peak "
          f"{[round(r['peak_gb'], 2) for r in ranks]} GB; launches "
          f"{launches}")
    return line


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] in ("--mesh", "--mesh-train",
                                              "--mesh-serve", "--mesh-25c",
                                              "--mesh-long", "--mesh-tp",
                                              "--mesh-rp"):
        # this process runs one card's large steps and serve runs one
        # after another on card 0 before the ranks start (and the ranks
        # inherit it): segments that grow keep its cache from fragmenting
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    import torch

    t_start = time.monotonic()
    sweeps = {"--k1-sweep": k1_sweep, "--k2-sweep": k2_sweep,
              "--k1-given": k1_given_check,
              "--k6-sweep": k6_sweep, "--k8-sweep": k8_sweep,
              "--serving": online_serving,
              "--obs": lambda torch, ops, ref, fmt: observability(
                  torch, ops, card.stdout.strip()),
              "--dense-variants": lambda torch, ops, ref, fmt: {
                  "paged_attend_hd256": k5_check(torch, ops, ref, fmt,
                                                 K5_HD256_CASES),
                  **dense_variants(torch, ops, ref, fmt,
                                   card.stdout.strip())},
              "--modality": lambda torch, ops, ref, fmt: {
                  "paged_attend_hd96": k5_check(torch, ops, ref, fmt,
                                                K5_HD96_CASES),
                  **modality(torch, ops, ref, fmt, card.stdout.strip())},
              "--recurrent": lambda torch, ops, ref, fmt: {
                  "paged_attend_hd112": k5_check(torch, ops, ref, fmt,
                                                 K5_HD112_CASES),
                  **recurrent(torch, ops, ref, fmt, card.stdout.strip())},
              "--moe": lambda torch, ops, ref, fmt: {
                  "paged_attend_kimi": k5_check(torch, ops, ref, fmt,
                                                K5_KIMI_CASES),
                  **mixtures(torch, ops, ref, fmt, card.stdout.strip())}}
    sweep = len(sys.argv) == 2 and sys.argv[1] in sweeps
    meshed = {"--mesh": ("25", "26", "27"), "--mesh-train": ("26",),
              "--mesh-serve": ("27",), "--mesh-25c": ("25c",),
              "--mesh-long": ("30",), "--mesh-tp": ("31",),
              "--mesh-rp": ("32",)}.get(
                  sys.argv[1] if len(sys.argv) == 2 else None)
    if sys.argv[1:] and not (sweep or meshed):
        print(f"usage: {Path(__file__).name} [--k1-sweep | --k1-given | "
              f"--k2-sweep | --k6-sweep | --k8-sweep | --serving | --obs | "
              f"--dense-variants | --modality | --recurrent | --moe | "
              f"--mesh | --mesh-train | --mesh-serve | --mesh-25c | "
              f"--mesh-long | --mesh-tp | --mesh-rp]", file=sys.stderr)
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
    if meshed:
        for line in card.stdout.strip().splitlines()[1:]:
            print(line)
        if meshed == ("30",):
            return long_main(torch, card.stdout.strip())
        if meshed == ("31",):
            return tp_main(torch, card.stdout.strip())
        if meshed == ("32",):
            return rp_main(torch, card.stdout.strip())
        return mesh_main(torch, card.stdout.strip(), meshed)

    from repro_torch.core.lns import LNSFormat
    from repro_torch.kernels import _build, ops, ref

    t0 = time.monotonic()
    _build.build(ptxas_verbose=True)
    _build.library()
    build_s = time.monotonic() - t0
    print(f"kernels built and loaded in {build_s:.1f}s")

    fmt = LNSFormat(8, 8)
    # 28a's meta traces run on the host beside phases 3-25
    dry_procs = None if sweep else dry_start()
    if sweep:
        name = sys.argv[1][2:].replace("-", "_")
        rows = sweeps[sys.argv[1]](torch, ops, ref, fmt)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / f"{name}.json").write_text(json.dumps(
            {"card": card.stdout.strip(), "rows": rows}, indent=1))
        return 0
    # each phase's seconds, printed at the end (the run must stay inside
    # its time limit, so the next cut knows where the time goes)
    marks = [("build", time.monotonic())]
    mark = lambda name: marks.append((name, time.monotonic()))
    # serving shapes (M = 4 decode, 32 prefill), then the training step's
    # M = 8 x 256 = 2048
    k1 = k1_check(torch, ops, ref, fmt, [(4, 576), (4, 1536), (32, 576),
                                         (32, 1536), (2048, 576),
                                         (2048, 1536)])
    k1_edge_calls = k1_edges(torch, ops, ref, fmt)
    k1_launch = k1_one_launch(torch, ops, fmt)
    k1_given = k1_given_check(torch, ops, ref, fmt)
    mark("3 K1")
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
    mark("3 K2")
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
         (8, 2, 128), {"PAGE": 32, "pool": torch.float32})]
        + K5_HD256_CASES + K5_HD96_CASES + K5_HD112_CASES + K5_KIMI_CASES)
    k6 = k6_check(torch, ops, ref)
    sampler = sampler_check(torch, ops, ref)
    k7 = k7_check(torch, ops, ref)

    mark("3 K3-K7")
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

    mark("4")
    logits = logits_check(torch, engine)
    prof = profile_decode(torch, engine, ops)
    del engine, deng
    torch.cuda.empty_cache()

    mark("5-6")
    train = train_run(torch, ops)
    setup = train_setup(torch)
    numerics = numerics_step(torch, ops, setup)
    step_cmp = train_step_check(torch, setup)
    train_prof = profile_train(torch, setup)
    del setup
    torch.cuda.empty_cache()

    mark("7-10")
    spec_runs, spec_engine = spec_serve(torch, ops)
    mark("11")
    smoke = smoke_spec(torch)
    mark("12")
    spec_prof = profile_spec(torch, spec_engine,
                             prof["wall_ms_per_step"])
    del spec_engine
    mark("13")
    coupling = verify_coupling(torch, ops)
    k2_seen_ctx.__exit__(None, None, None)
    torch.cuda.empty_cache()
    mark("14")
    k2_driven = k2_driven_check(torch, ops, ref, fmt, k2_seen)

    mark("K2 driven")
    k8, k8_luts, table10, k8_counts, k8_rate_inputs = k8_check(
        torch, ops, ref, fmt, [(m, k, n) for m in (4, 2048) for k, n in gemms])
    mark("15")
    # K9 at phase 3's leaves with int32 codes, the embedding once with
    # int16 codes (JAX's madam_update_pallas takes int16) and B=8 in uint8
    i32, i16, u8 = torch.int32, torch.int16, torch.uint8
    k9, k9_counts = k9_check(torch, ops, ref, [
        (49152, 576, 16, 2048, bf16, i32), (17280, 576, 16, 2048, bf16, i32),
        (17280, 1536, 16, 2048, bf16, i32), (46080, 576, 16, 2048, bf16, i32),
        (17280, 192, 16, 2048, bf16, i32), (49152, 576, 16, 2048, bf16, i16),
        (17280, 576, 8, 8, torch.float32, u8)])
    mark("16")
    approx = approx_train(torch, ops, train_setup(torch))
    torch.cuda.empty_cache()
    mark("17")
    paper = baselines(torch, ops, ref, fmt, train_prof)
    torch.cuda.empty_cache()
    mark("18")
    online = online_serving(torch, ops, ref, fmt)
    torch.cuda.empty_cache()
    mark("19")
    observed = observability(torch, ops, card.stdout.strip())
    torch.cuda.empty_cache()
    mark("20")
    variants = dense_variants(torch, ops, ref, fmt, card.stdout.strip())
    mark("21")
    torch.cuda.empty_cache()
    modal = modality(torch, ops, ref, fmt, card.stdout.strip())
    mark("22")
    torch.cuda.empty_cache()
    recur = recurrent(torch, ops, ref, fmt, card.stdout.strip())
    mark("23")
    torch.cuda.empty_cache()
    mixture = mixtures(torch, ops, ref, fmt, card.stdout.strip())
    mark("24")
    torch.cuda.empty_cache()
    shards = shard_invariance(torch, ops, ref, fmt)
    mark("25a")
    one_mesh = mesh_of_one(torch, ops, paged["streams"])
    mark("25b")
    torch.cuda.empty_cache()
    dry = dry_check(torch, dry_procs)
    mark("28a")

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
    # the shard shapes a (data, model) mesh runs (25a's timed rows); their
    # launches are the (1, 1) mesh run's (25b), where a shard is the whole
    for name, base, src, tpu, rows in (
            ("qmatmul_colshard", "qmatmul", "lns_qmatmul.cu",
             "lns_qmatmul.py:48", shards["qmatmul"]),
            ("paged_attend_headgroup", "paged_attend", "paged_attend.cu",
             "paged_attend.py:172", shards["paged_attend"])):
        r = rows[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": one_mesh["launches"][base],
            "max_abs_err": max(x["max_abs_err"] for x in rows),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "bound_share": r["bound_ms"] / r["ms"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    phases = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    full = {"card": card.stdout.strip(), "build_s": build_s,
            "kernels": kernels,
            "qmatmul_decode": k2_decode, "qmatmul_driven": k2_driven,
            "encode_pack_edge_calls": k1_edge_calls,
            "encode_pack_one_launch": k1_launch,
            "encode_pack_given_scale": k1_given,
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
            "dense_variants": variants, "modality": modal,
            "recurrent": recur, "moe": mixture,
            "mesh": {"shards": shards, "mesh_of_one": one_mesh},
            "dry_run": dry,
            "serve_paged": paged, "serve_dense": dense,
            "logits": logits, "profile": prof, "train": train,
            "numerics": numerics, "train_step": step_cmp,
            "train_profile": train_prof,
            "spec": {"runs": spec_runs, "smoke": smoke,
                     "profile": spec_prof, "verify_coupling": coupling},
            "seconds_by_phase": phases,
            "seconds": time.monotonic() - t_start, "device": device}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(full, indent=1))
    print("phases took: " + ", ".join(f"{k} {v:.1f}s"
                                      for k, v in phases.items()))
    print(f"chip_smoke took {full['seconds']:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
