// K2: packed-LNS GEMM, decode in the kernel, f32 accumulation, fused
// scales and output cast.
//
// Replaces the TPU kernel src/repro/kernels/lns_qmatmul.py
// `lns_qmatmul_pallas` (body `_kernel`, pallas_call at :74), together with
// the row/column scale epilogue of its wrapper `ops.lns_qmatmul`. The TPU
// body decodes each VMEM tile to bf16 and feeds the MXU; here the decoded
// bf16 tiles feed the tensor cores.
//
// out[m, n] = (sum_k dec(A[m, k]) * dec(B[k, n])) * sa[m] * sb[n]
// dec(w) = +-2^(-(w & max_code)/gamma), rounded to the compute dtype, equal
// to the plain version's bit for bit (see Dec). A zero word decodes to
// +1.0, so out-of-range elements are masked to 0 after decoding, never
// padded. Two calls give the same bits: no atomics touch a sum.
//
// Three paths; `ops.qmatmul_plan` picks one from (M, compute dtype):
//
// (a) skinny M, bf16 (M < 256: decode M = slots, verify M = B*k, prefill
//     buckets). Bound by the weight bytes (2*M flops a weight byte, far
//     below the ~295 where tensor cores bind) and, at 0.1-0.9 MB a GEMM,
//     by latency. A warp takes 1..6 16-deep K steps of 32 columns: lane
//     (g, t) loads 4-byte words of weight rows 4t..4t+3 (32 contiguous
//     bytes a row per 8 lanes), all before decoding any, decodes them in
//     registers and runs
//     mma.sync m16n8k16 bf16 -> f32 with the weights as the 16-row operand
//     and the activation rows (padded to 8 or 16, masked) as the 8-column
//     one: out^T = B^T A^T. The k order inside a step is permuted (logical
//     2t,2t+1,2t+8,2t+9 -> physical 4t..4t+3) identically on both
//     operands, so a lane's four weight rows fill its fragments without a
//     transpose. The 8 (or 4) warps of a block sum in shared memory in warp
//     order. Where K is too deep for one block (K=1536), K splits over the
//     grid in 4-warp blocks:
//     partials go to an f32 workspace [splits, M, N], and the last block
//     to finish an output tile (an arrival counter it resets itself) sums
//     them in split order. The scales (acc*sa, then *sb) and one rounding
//     to the output dtype end either way. The weights decode by ALU where
//     the format allows (see Dec). The block shape and the split come
//     from `chip_smoke.py --k2-sweep` (PERF.md): split-K at K=576 is
//     slower.
// (b) large M, bf16 (M >= 256: the training step's 2048). Tensor cores.
//     A decode pass writes both operands once as bf16, K-major (B
//     transposed through shared memory), zero-padded to whole tiles; then
//     a GEMM of 128x128 output tiles, two warpgroups of 64 rows, 64-deep K
//     stages: 16-byte cp.async copies land the tiles in the 128-byte
//     swizzled layout wgmma reads in a 5-stage ring, three stages ahead,
//     and wgmma.mma_async m64n128k16 runs on each stage with the previous
//     stage's group still in flight.
//     The epilogue applies the scales, rounds, stages the tile in shared
//     memory and writes whole rows with 16-byte stores. Decoding inside
//     the GEMM's tiles, as the TPU kernel does, decodes A N/128 times and B
//     M/128 times; a first design that did so was slower at every M=2048
//     shape (PERF.md), while decoding once costs two extra passes over
//     operands of ~1-3 MB, mostly in L2. The decode pass is a kernel of
//     its own (launch count `qmatmul_decode`). Bound at M=2048: the output
//     write (bytes); the GEMM's per-tile prologue and epilogue are not yet
//     overlapped with other tiles.
// (c) f32 compute dtype (the smoke config; ROADMAP H3): exact f32 FMAs on
//     CUDA cores, no TF32 anywhere (16x64 tiles, 32-deep K steps).
#include "common.cuh"

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ void build_bf16_table(uint16_t* tab, int max_code,
                                                 float gamma, int tid,
                                                 int nthreads) {
  for (int i = tid; i <= max_code; i += nthreads) {
    const __nv_bfloat16 v =
        __float2bfloat16_rn(exp2f(-static_cast<float>(i) / gamma));
    tab[i] = *reinterpret_cast<const uint16_t*>(&v);
  }
}

// Decoding four byte words at once into two bf16 pairs (bytes 0,1 and 2,3,
// the lower byte in the lower half). Two ways; the skinny path's wrapper
// chooses (the decode pass always reads the table, which measured faster
// there, PERF.md):
// * ARITH (gamma <= 8 and every result a normal bf16): code c = q*gamma + r
//   decodes to the bits of 2^(-r/gamma) (whose high byte is 0x3F for every
//   r < gamma <= 8: the value lies in (0.5, 1]) minus q in the exponent
//   field, the sign in bit 15. The low bytes of the gamma base values sit
//   in two registers and one byte permute looks up two of them. Pure ALU:
//   no shared-memory traffic; the skinny path runs 7-13% faster with it
//   than with the table (`chip_smoke.py --k2-sweep`, PERF.md). Equal to
//   the table bit for bit wherever it is used (chip_smoke.py checks every
//   code of every accepted format).
// * otherwise the 2^(B-1)-entry table in shared memory.
struct Dec {
  const uint16_t* tab;
  uint32_t L0, L1;     // low bytes of the bits of 2^(-r/gamma), r = 0..7
  uint32_t mc4, rmask4, qmask4;
  int lg, sshift, max_code;
};

__device__ __forceinline__ Dec make_dec(const uint16_t* tab, int bits,
                                        int gamma) {
  Dec D;
  D.tab = tab;
  D.max_code = (1 << (bits - 1)) - 1;
  D.sshift = bits - 1;
  D.lg = 31 - __clz(gamma);
  D.mc4 = static_cast<uint32_t>(D.max_code) * 0x01010101u;
  D.rmask4 = static_cast<uint32_t>(gamma - 1) * 0x01010101u;
  D.qmask4 = static_cast<uint32_t>(D.max_code >> D.lg) * 0x01010101u;
  D.L0 = D.L1 = 0u;
  if (gamma <= 8) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r < gamma) D.L0 |= static_cast<uint32_t>(tab[r] & 0xffu) << (8 * r);
      if (r + 4 < gamma) D.L1 |= static_cast<uint32_t>(tab[r + 4] & 0xffu) << (8 * r);
    }
  }
  return D;
}

// prmt.b32 as PTX defines it; __byte_perm masks its selector first, which
// costs an instruction the selectors here (every nibble < 8) do not need
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

template <bool ARITH>
__device__ __forceinline__ void dec4(const Dec& D, uint32_t W, uint32_t& p01,
                                     uint32_t& p23) {
  if (ARITH) {
    const uint32_t c4 = W & D.mc4;
    const uint32_t r4 = c4 & D.rmask4;
    const uint32_t q4 = (c4 >> D.lg) & D.qmask4;
    const uint32_t s4 = (W >> D.sshift) & 0x01010101u;
    // base bits, minus q in the exponent field, plus the sign in bit 15
    // (two multiply-adds a pair: no lane borrows, as every base exceeds q)
    const uint32_t v01 = (prmt(D.L0, D.L1, r4) & 0x00ff00ffu) | 0x3f003f00u;
    const uint32_t v23 = (prmt(D.L0, D.L1, r4 >> 16) & 0x00ff00ffu) | 0x3f003f00u;
    p01 = v01 - prmt(q4, 0u, 0x4140) * 128u + prmt(s4, 0u, 0x4140) * 0x8000u;
    p23 = v23 - prmt(q4, 0u, 0x4342) * 128u + prmt(s4, 0u, 0x4342) * 0x8000u;
  } else {
    uint32_t h[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t w = (W >> (8 * e)) & 0xffu;
      h[e] = D.tab[w & D.max_code] | (((w >> D.sshift) & 1u) << 15);
    }
    p01 = h[0] | (h[1] << 16);
    p23 = h[2] | (h[3] << 16);
  }
}

__device__ __forceinline__ void store_out(void* out, int out_dt, long long i,
                                          float v) {
  if (out_dt == DT_BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

__device__ __forceinline__ float scaled(float v, const float* sa,
                                        const float* sb, int m, int n) {
  if (sa != nullptr) v = v * sa[m];
  if (sb != nullptr) v = v * sb[n];
  return v;
}

// ------------------------------------------------- (a) skinny, split-K mma

#define SK_MAX_STEPS 6  // K steps a warp: the plan gives 1..6
#define SK_NW 32  // columns of a block: 8 lane groups x 4 bytes
#define SK_MAX_TILES 65536
// one arrival counter per output tile of the skinny grid; zero at load, and
// the last-arriving block of a tile sets it back to 0, so a call leaves the
// array as it found it (calls on one stream never overlap)
__device__ unsigned int sk_arrivals[SK_MAX_TILES];

// A block: W warps on 32 columns and 8*MT8 rows, each warp `steps` 16-deep
// K steps; lane (g, t) loads the 4-byte words of weight rows 4t..4t+3 at
// columns 4g..4g+3, which fill its fragments of two m16n8k16 products.
// MT8: 8-row activation tiles (1 or 2; 32-row tiles ran slower at M=32).
template <int W, int MT8, bool ALN, bool ARITH>
__global__ void __launch_bounds__(W * 32)
qmatmul_skinny_kernel(const uint8_t* __restrict__ A,
                      const uint8_t* __restrict__ B,
                      const float* __restrict__ sa,
                      const float* __restrict__ sb, void* __restrict__ out,
                      int out_dt, float* __restrict__ ws, int M, int N, int K,
                      int bits, int gamma, int steps) {
  __shared__ uint16_t tab[128];
  __shared__ float part[W][8 * MT8][SK_NW];
  __shared__ unsigned int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  build_bf16_table(tab, (1 << (bits - 1)) - 1, static_cast<float>(gamma), tid,
                   W * 32);

  const int n0 = blockIdx.x * SK_NW + g * 4;  // this lane's columns
  const int mb = blockIdx.z * 8 * MT8;
  const int kstep0 = (blockIdx.y * W + warp) * steps;

  // issue every load of this warp's K slice before decoding any
  uint32_t wv[SK_MAX_STEPS][4];
  uint32_t av[SK_MAX_STEPS][MT8];
#pragma unroll
  for (int s = 0; s < SK_MAX_STEPS; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = (kstep0 + s) * 16 + 4 * t + j;
      const bool ok = s < steps && k < K;
      const uint8_t* p = B + static_cast<long long>(k) * N + n0;
      uint32_t word = 0u;
      if (ALN) {
        if (ok && n0 < N) word = __ldg(reinterpret_cast<const unsigned int*>(p));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ok && n0 + e < N) word |= static_cast<uint32_t>(__ldg(p + e)) << (8 * e);
      }
      wv[s][j] = word;
    }
    // the activation rows: u32 at A[m][k0 + 4t .. 4t + 3], m = mb + 8*mt + g
#pragma unroll
    for (int mt = 0; mt < MT8; ++mt) {
      const int m = mb + 8 * mt + g;
      const int k = (kstep0 + s) * 16 + 4 * t;
      uint32_t word = 0u;
      if (s < steps && m < M) {
        const uint8_t* p = A + static_cast<long long>(m) * K + k;
        if (ALN && k + 3 < K) {
          word = __ldg(reinterpret_cast<const unsigned int*>(p));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k + e < K) word |= static_cast<uint32_t>(__ldg(p + e)) << (8 * e);
        }
      }
      av[s][mt] = word;
    }
  }
  __syncthreads();
  const Dec D = make_dec(tab, bits, gamma);

  float acc[2][MT8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int mt = 0; mt < MT8; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][mt][c] = 0.f;

#pragma unroll
  for (int s = 0; s < SK_MAX_STEPS; ++s) {
    if (s >= steps) break;
    const int kb = (kstep0 + s) * 16 + 4 * t;  // physical k of byte 0
    // activation fragments, masked to 0 (a zero word decodes to +1.0):
    // rows m >= M and k >= K. Masking one operand zeroes the product.
    const uint32_t kmask = (kb + 0 < K ? 0x0000ffffu : 0u) |
                           (kb + 1 < K ? 0xffff0000u : 0u);
    const uint32_t kmask2 = (kb + 2 < K ? 0x0000ffffu : 0u) |
                            (kb + 3 < K ? 0xffff0000u : 0u);
    uint32_t bf[MT8][2];
#pragma unroll
    for (int mt = 0; mt < MT8; ++mt) {
      const uint32_t mok = mb + 8 * mt + g < M ? 0xffffffffu : 0u;
      dec4<ARITH>(D, av[s][mt], bf[mt][0], bf[mt][1]);
      bf[mt][0] &= mok & kmask;
      bf[mt][1] &= mok & kmask2;
    }
    // rows 0,1 and 2,3 interleaved byte by byte: [r0.b, r1.b, r0.b+1, r1.b+1]
    uint32_t a01[2][2], a23[2][2];
    dec4<ARITH>(D, __byte_perm(wv[s][0], wv[s][1], 0x5140), a01[0][0], a01[0][1]);
    dec4<ARITH>(D, __byte_perm(wv[s][0], wv[s][1], 0x7362), a01[1][0], a01[1][1]);
    dec4<ARITH>(D, __byte_perm(wv[s][2], wv[s][3], 0x5140), a23[0][0], a23[0][1]);
    dec4<ARITH>(D, __byte_perm(wv[s][2], wv[s][3], 0x7362), a23[1][0], a23[1][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // tile i: bytes 2i (n_lo) and 2i+1 (n_hi)
#pragma unroll
      for (int mt = 0; mt < MT8; ++mt) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[i][mt][0]), "+f"(acc[i][mt][1]), "+f"(acc[i][mt][2]),
              "+f"(acc[i][mt][3])
            : "r"(a01[i][0]), "r"(a01[i][1]), "r"(a23[i][0]), "r"(a23[i][1]),
              "r"(bf[mt][0]), "r"(bf[mt][1]));
      }
    }
  }

  // C fragment: rows are columns n (g -> 4g+2i, g+8 -> 4g+2i+1), columns
  // are rows m (2t, 2t+1); the four warps' partials meet in shared memory
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int mt = 0; mt < MT8; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        part[warp][8 * mt + 2 * t + (c & 1)][g * 4 + 2 * i + (c >> 1)] = acc[i][mt][c];
  __syncthreads();
  // the block's sum in warp order; one split: the scaled result, else the
  // split's partial
  const int splits = gridDim.y;
  const int rows = min(8 * MT8, M - mb);
  const int nbase = blockIdx.x * SK_NW;
  const long long MN = static_cast<long long>(M) * N;
  for (int e = tid; e < rows * SK_NW; e += W * 32) {
    const int r = e / SK_NW, c = e % SK_NW;
    const int mm = mb + r, nn = nbase + c;
    if (nn >= N) continue;
    float v = part[0][r][c];
#pragma unroll
    for (int w = 1; w < W; ++w) v = v + part[w][r][c];
    const long long o = static_cast<long long>(mm) * N + nn;
    if (splits == 1)
      store_out(out, out_dt, o, scaled(v, sa, sb, mm, nn));
    else
      ws[blockIdx.y * MN + o] = v;
  }
  if (splits == 1) return;
  // the last block to finish this output tile sums the partials in split
  // order (deterministic), scales and casts, and resets the counter. Each
  // thread takes 4 adjacent columns (16-byte loads when aligned), so the
  // loads of all splits are in flight together.
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0)
    last = atomicAdd(&sk_arrivals[tile], 1u) == static_cast<unsigned int>(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < rows * (SK_NW / 4); e += W * 32) {
    const int mm = mb + e / (SK_NW / 4), nn = nbase + 4 * (e % (SK_NW / 4));
    if (nn >= N) continue;
    const long long o = static_cast<long long>(mm) * N + nn;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (ALN) {
#pragma unroll 8
      for (int s = 0; s < splits; ++s) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(ws + s * MN + o));
        v[0] = v[0] + p.x; v[1] = v[1] + p.y; v[2] = v[2] + p.z; v[3] = v[3] + p.w;
      }
    } else {
#pragma unroll 8
      for (int s = 0; s < splits; ++s)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (nn + c < N) v[c] = v[c] + __ldcg(ws + s * MN + o + c);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (nn + c < N) store_out(out, out_dt, o + c, scaled(v[c], sa, sb, mm, nn + c));
  }
  if (tid == 0) sk_arrivals[tile] = 0u;
}

// ---------------------------------------------- (b) large M, wgmma, bf16

#define WG_BM 128
#define WG_BN 128
#define WG_BK 64
#define WG_THREADS 256
#define WG_STAGES 5
#define WG_AHEAD 3   // K blocks in flight ahead of the one multiplied
// K-major tiles in the 128-byte swizzle wgmma reads fastest: a row is the
// 64 K values of one m (or n), 128 bytes; 16-byte chunk c of row r sits at
// chunk c ^ (r % 8); 8 rows make a 1024-byte atom (SBO), and tiles start
// on 1024-byte boundaries
#define WG_SBO 1024
#define WG_TILE (WG_BM * WG_BK * 2)            // bytes of one bf16 tile
#define WG_SMEM (WG_STAGES * 2 * WG_TILE + 1024)  // + alignment slack
// the decode pass: 64 x 64 blocks of the operands
#define DC_T 64
#define DC_THREADS 256

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a wgmma shared-memory descriptor: start address, the (unused for
// swizzled K-major) leading offset 16 bytes, SBO, 128-byte swizzle mode
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(WG_SBO >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

#define WG_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24), WG_ACC8(32),
        WG_ACC8(40), WG_ACC8(48), WG_ACC8(56)
      : "l"(da), "l"(db), "r"(1));
}

// The decode pass: A (M,K) -> Ad (Mp,Kp) and B (K,N) -> Bt (Np,Kp), bf16,
// both K-major (B transposed through shared memory), zero past M, N and K
// (a zero bf16 is 0, unlike a zero word), Mp and Np multiples of 128 and
// Kp of 64, so the GEMM below loads whole tiles and masks nothing. One
// block decodes one 64x64 block of A (blocks [0, nA)) or of B (the rest).
__global__ void __launch_bounds__(DC_THREADS)
qmatmul_decode_kernel(const uint8_t* __restrict__ A,
                      const uint8_t* __restrict__ B, uint16_t* __restrict__ Ad,
                      uint16_t* __restrict__ Bt, int M, int N, int K, int Kp,
                      int nA, int bits, int gamma, int aligned) {
  __shared__ uint16_t tab[128];
  __shared__ uint8_t tile[DC_T][DC_T + 4];  // B block [k][n]
  const int tid = threadIdx.x;
  // the GEMM may start its prologue now; it waits for this grid's writes
  // before it reads them (programmatic dependent launch)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  build_bf16_table(tab, (1 << (bits - 1)) - 1, static_cast<float>(gamma), tid,
                   DC_THREADS);
  const int kblocks = Kp / DC_T;
  const bool is_a = static_cast<int>(blockIdx.x) < nA;
  const int blk = is_a ? blockIdx.x : blockIdx.x - nA;
  const int r0 = (blk / kblocks) * DC_T;  // rows of A / columns of B
  const int k0 = (blk % kblocks) * DC_T;
  uint32_t w[2][2];  // two items of 8 words: [item][word]
  if (is_a) {
    // an item is 8 k of one row: 64 rows x 8 chunks, two a thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int it = tid + i * DC_THREADS;
      const int m = r0 + it / 8, k = k0 + (it % 8) * 8;
      uint32_t v[2] = {0u, 0u};
      if (m < M) {
        const uint8_t* p = A + static_cast<long long>(m) * K + k;
        if (aligned && (K & 7) == 0 && k + 8 <= K) {
          const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
          v[0] = x.x;
          v[1] = x.y;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (k + e < K) v[e / 4] |= static_cast<uint32_t>(__ldg(p + e)) << (8 * (e % 4));
        }
      }
      w[i][0] = v[0];
      w[i][1] = v[1];
    }
  } else {
    // the B block, k rows of 64 columns, through shared memory
#pragma unroll
    for (int i = 0; i < DC_T * DC_T / 4 / DC_THREADS; ++i) {
      const int it = tid + i * DC_THREADS;
      const int k = k0 + it / (DC_T / 4), n = r0 + (it % (DC_T / 4)) * 4;
      uint32_t v = 0u;
      if (k < K) {
        const uint8_t* p = B + static_cast<long long>(k) * N + n;
        if (aligned && (N & 3) == 0 && n + 4 <= N) {
          v = __ldg(reinterpret_cast<const unsigned int*>(p));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < N) v |= static_cast<uint32_t>(__ldg(p + e)) << (8 * e);
        }
      }
      *reinterpret_cast<uint32_t*>(&tile[it / (DC_T / 4)][(it % (DC_T / 4)) * 4]) = v;
    }
  }
  __syncthreads();
  const Dec D = make_dec(tab, bits, gamma);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int it = tid + i * DC_THREADS;
    const int r = it / 8, c = it % 8;  // output row (m or n), 8-k chunk
    uint32_t x0, x1;
    if (is_a) {
      x0 = w[i][0];
      x1 = w[i][1];
    } else {
      // column r of the block, k = 8c .. 8c+7
      x0 = x1 = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x0 |= static_cast<uint32_t>(tile[8 * c + e][r]) << (8 * e);
        x1 |= static_cast<uint32_t>(tile[8 * c + 4 + e][r]) << (8 * e);
      }
    }
    uint4 v;
    dec4<false>(D, x0, v.x, v.y);
    dec4<false>(D, x1, v.z, v.w);
    const int row = r0 + r, k = k0 + 8 * c;
    const bool rok = row < (is_a ? M : N);
    uint32_t* e4 = &v.x;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      e4[j] &= (rok && k + 2 * j < K ? 0x0000ffffu : 0u) |
               (rok && k + 2 * j + 1 < K ? 0xffff0000u : 0u);
    uint16_t* dst = (is_a ? Ad : Bt) + static_cast<long long>(row) * Kp + k;
    *reinterpret_cast<uint4*>(dst) = v;
  }
}

// the scaled accumulators of one 128x128 tile -> out (OB bytes an element):
// through shared memory (the stage buffers, free by now) so each warp
// writes whole rows with 16-byte stores
template <int OB>
__device__ __forceinline__ void wg_epilogue(uint8_t* smem, const float* d,
                                            const float* sam, const float* sbn,
                                            void* out, int M, int N, int m0,
                                            int n0, int rbase, int cbase,
                                            int tid) {
  constexpr int RS = WG_BN * OB + 16;  // padded tile row, bytes
  constexpr int CH = WG_BN * OB / 16;  // 16-byte pieces of a row
  static_assert(WG_SMEM - 1024 >= WG_BM * RS, "the output tile fits in the stages");
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int h = (i / 2) & 1;
    const int r = rbase - m0 + 8 * h;
    const int c = cbase - n0 + (i / 4) * 8;
    const float v0 = d[i] * sam[h] * sbn[2 * (i / 4)];
    const float v1 = d[i + 1] * sam[h] * sbn[2 * (i / 4) + 1];
    if (OB == 2) {
      __nv_bfloat162 p;
      p.x = __float2bfloat16_rn(v0);
      p.y = __float2bfloat16_rn(v1);
      *reinterpret_cast<__nv_bfloat162*>(smem + r * RS + c * 2) = p;
    } else {
      *reinterpret_cast<float2*>(smem + r * RS + c * 4) = make_float2(v0, v1);
    }
  }
  __syncthreads();
  const bool vec = (static_cast<long long>(N) * OB) % 16 == 0;
#pragma unroll 4
  for (int i = 0; i < WG_BM * CH / WG_THREADS; ++i) {
    const int e = tid + i * WG_THREADS;
    const int r = e / CH, c = (e % CH) * (16 / OB);
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    uint8_t* dst = static_cast<uint8_t*>(out) + (static_cast<long long>(m) * N + n) * OB;
    const uint8_t* src = smem + r * RS + c * OB;
    if (vec && n + 16 / OB <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 16 / OB && n + j < N; ++j)
#pragma unroll
        for (int b = 0; b < OB; ++b) dst[j * OB + b] = src[j * OB + b];
    }
  }
}

// stage K block kb of the decoded operands: each 16-byte chunk is 8 k of
// one row; 8 lanes take 4 rows x 2 chunks (32 contiguous global bytes a
// row; the swizzle spreads them over 8 shared-memory slots)
__device__ __forceinline__ void wg_load(uint8_t* st, const uint16_t* Ad,
                                        const uint16_t* Bt, int Kp, int m0,
                                        int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < WG_BM * WG_BK / 8 / WG_THREADS; ++i) {
    const int it = tid + i * WG_THREADS;
    const int r = (it >> 5) * 4 + ((it >> 1) & 3);
    const int c = (it & 1) | (((it >> 3) & 3) << 1);
    const int so = r * 128 + ((c ^ (r & 7)) << 4);
    cp_async16(st + so, Ad + static_cast<long long>(m0 + r) * Kp + k0 + 8 * c);
    cp_async16(st + WG_TILE + so, Bt + static_cast<long long>(n0 + r) * Kp + k0 + 8 * c);
  }
}

__global__ void __launch_bounds__(WG_THREADS)
qmatmul_wgmma_kernel(const uint16_t* __restrict__ Ad,
                     const uint16_t* __restrict__ Bt,
                     const float* __restrict__ sa,
                     const float* __restrict__ sb, void* __restrict__ out,
                     int out_dt, int M, int N, int Kp) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * WG_BN;
  const int nk = Kp / WG_BK;

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  // this thread's output rows and columns, and their scales, read before
  // the first store (loads after a store to `out` could not be hoisted)
  const int wi = (tid % 128) / 32, lane = tid % 32;
  const int rbase = m0 + wg * 64 + wi * 16 + lane / 4;
  const int cbase = n0 + 2 * (lane % 4);
  float sam[2], sbn[32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    sam[h] = (sa != nullptr && rbase + 8 * h < M) ? sa[rbase + 8 * h] : 1.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int n = cbase + (j / 2) * 8 + (j & 1);
    sbn[j] = (sb != nullptr && n < N) ? sb[n] : 1.f;
  }

  // the decode pass's writes are complete and visible past this point
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // a ring of WG_STAGES stages, loads WG_AHEAD K blocks ahead; one wgmma
  // group stays in flight, so a slot is refilled two blocks after use
  static_assert(WG_AHEAD + 2 <= WG_STAGES, "a slot in use is never refilled");
#pragma unroll
  for (int s = 0; s < WG_AHEAD; ++s) {
    if (s < nk)
      wg_load(smem + s * 2 * WG_TILE, Ad, Bt, Kp, m0, n0, s * WG_BK, tid);
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait<WG_AHEAD - 1>();  // this thread's copies of stage kb
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // everyone's copies landed; stage kb - 2 is free
    if (kb + WG_AHEAD < nk)
      wg_load(smem + ((kb + WG_AHEAD) % WG_STAGES) * 2 * WG_TILE, Ad, Bt, Kp,
              m0, n0, (kb + WG_AHEAD) * WG_BK, tid);
    cp_async_commit();
    const uint8_t* st = smem + (kb % WG_STAGES) * 2 * WG_TILE;
    const uint8_t* at = st + wg * 64 * 128;  // this warpgroup's 64 rows
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < WG_BK / 16; ++j)
      // a 16-deep step is 32 bytes along the (swizzled) row
      wgmma_m64n128k16(d, wg_desc(at + j * 32), wg_desc(st + WG_TILE + j * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  __syncthreads();  // every warpgroup is done with the stages

  // accumulator layout: n8 block i/4; (i%4): rows +0/+8, columns 2c/2c+1.
  // The scales in the plain order (acc*sa, then *sb; 1.0 where absent is
  // exact), one rounding to the output dtype.
  if (out_dt == DT_BF16)
    wg_epilogue<2>(smem, d, sam, sbn, out, M, N, m0, n0, rbase, cbase, tid);
  else
    wg_epilogue<4>(smem, d, sam, sbn, out, M, N, m0, n0, rbase, cbase, tid);
}

// ------------------------------------------------ (c) f32 compute dtype

#define F_BM 16
#define F_BN 64
#define F_BK 32
#define F_THREADS 256

__global__ void __launch_bounds__(F_THREADS)
qmatmul_f32_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
                   const float* __restrict__ sa, const float* __restrict__ sb,
                   void* __restrict__ out, int out_dt, int M, int N, int K,
                   int bits, float gamma) {
  __shared__ float table[128];
  __shared__ float As[F_BK][F_BM + 1];
  __shared__ float Bs[F_BK][F_BN];
  const int tid = threadIdx.x;
  const int max_code = (1 << (bits - 1)) - 1;
  const int sign_shift = bits - 1;
  if (tid <= max_code) table[tid] = exp2f(-static_cast<float>(tid) / gamma);
  const int m0 = blockIdx.y * F_BM;
  const int n0 = blockIdx.x * F_BN;
  const int tx = tid % F_BN;        // output column in the tile
  const int ty = tid / F_BN;        // rows ty*4 .. ty*4+3
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += F_BK) {
    for (int i = tid; i < F_BM * F_BK; i += F_THREADS) {
      const int r = i / F_BK, c = i % F_BK;
      const int gm = m0 + r, gk = k0 + c;
      float v = 0.f;
      if (gm < M && gk < K) {
        const unsigned w = A[static_cast<long long>(gm) * K + gk];
        const float t = table[w & max_code];
        v = ((w >> sign_shift) & 1u) ? -t : t;
      }
      As[c][r] = v;
    }
    for (int i = tid; i < F_BK * F_BN; i += F_THREADS) {
      const int r = i / F_BN, c = i % F_BN;
      const int gk = k0 + r, gn = n0 + c;
      float v = 0.f;
      if (gk < K && gn < N) {
        const unsigned w = B[static_cast<long long>(gk) * N + gn];
        const float t = table[w & max_code];
        v = ((w >> sign_shift) & 1u) ? -t : t;
      }
      Bs[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      const float b = Bs[kk][tx];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(As[kk][ty * 4 + j], b, acc[j]);
    }
    __syncthreads();
  }

  const int gn = n0 + tx;
  if (gn >= N) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gm = m0 + ty * 4 + j;
    if (gm >= M) continue;
    store_out(out, out_dt, static_cast<long long>(gm) * N + gn,
              scaled(acc[j], sa, sb, gm, gn));
  }
}

// ------------------------------------------------------------ entry points

// The wgmma path's decode pass (its own launch count, `qmatmul_decode`):
// A (M,K) and B (K,N) -> Ad (Mp,Kp) and Bt (Np,Kp), bf16 K-major, at ws.
REPRO_EXPORT int repro_qmatmul_decode(const uint8_t* A, const uint8_t* B,
                                      uint16_t* ws, int M, int N, int K,
                                      int bits, int gamma, int aligned,
                                      void* stream) {
  if (M == 0 || N == 0) return 0;
  const int Mp = (M + WG_BM - 1) / WG_BM * WG_BM;
  const int Np = (N + WG_BN - 1) / WG_BN * WG_BN;
  const int Kp = (K + WG_BK - 1) / WG_BK * WG_BK;
  uint16_t* Bt = ws + static_cast<long long>(Mp) * Kp;
  const int nA = (Mp / DC_T) * (Kp / DC_T);
  const int nB = (Np / DC_T) * (Kp / DC_T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  qmatmul_decode_kernel<<<nA + nB, DC_THREADS, 0, st>>>(
      A, B, ws, Bt, M, N, K, Kp, nA, bits, gamma, aligned);
  return static_cast<int>(cudaGetLastError());
}

// path: 0 skinny (A, B packed words; splits, steps, warps, mt8 used; ws
// holds the partials when splits > 1), 1 wgmma (A, B: the decode pass's
// Ad and Bt, launched just before on the same stream; K is the packed K),
// 2 f32. arith: the skinny path's ALU decode (see Dec).
REPRO_EXPORT int repro_qmatmul(const uint8_t* A, const uint8_t* B,
                               const float* sa, const float* sb, void* out,
                               int out_dt, float* ws, int M, int N, int K,
                               int bits, int gamma, int path, int splits,
                               int steps, int warps, int mt8, int aligned,
                               int arith, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 2) {
    const dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
    qmatmul_f32_kernel<<<grid, F_THREADS, 0, st>>>(
        A, B, sa, sb, out, out_dt, M, N, K, bits, static_cast<float>(gamma));
  } else if (path == 1) {
    const int Mp = (M + WG_BM - 1) / WG_BM * WG_BM;
    const int Np = (N + WG_BN - 1) / WG_BN * WG_BN;
    const int Kp = (K + WG_BK - 1) / WG_BK * WG_BK;
    cudaError_t e = cudaFuncSetAttribute(
        qmatmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WG_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    // launched as a programmatic dependent of the decode pass: its blocks
    // read their scales while the decode pass drains
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(Np / WG_BN, Mp / WG_BM);
    cfg.blockDim = dim3(WG_THREADS);
    cfg.dynamicSmemBytes = WG_SMEM;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, qmatmul_wgmma_kernel,
                           reinterpret_cast<const uint16_t*>(A),
                           reinterpret_cast<const uint16_t*>(B), sa, sb, out,
                           out_dt, M, N, Kp);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    if (steps < 1 || steps > SK_MAX_STEPS || (warps != 4 && warps != 8))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + SK_NW - 1) / SK_NW, splits,
                    (M + 8 * mt8 - 1) / (8 * mt8));
    if (static_cast<long long>(grid.x) * grid.z > SK_MAX_TILES)
      return static_cast<int>(cudaErrorInvalidValue);
#define SKINNY(W, T, AL, AR)                                                \
  qmatmul_skinny_kernel<W, T, AL, AR><<<grid, W * 32, 0, st>>>(             \
      A, B, sa, sb, out, out_dt, ws, M, N, K, bits, gamma, steps)
#define SKINNY_2(W, T)                                                      \
  if (aligned) {                                                            \
    if (arith) SKINNY(W, T, true, true); else SKINNY(W, T, true, false);    \
  } else {                                                                  \
    if (arith) SKINNY(W, T, false, true); else SKINNY(W, T, false, false);  \
  }
    if (warps == 8) {
      if (mt8 == 1) {
        SKINNY_2(8, 1)
      } else {
        SKINNY_2(8, 2)
      }
    } else {
      if (mt8 == 1) {
        SKINNY_2(4, 1)
      } else {
        SKINNY_2(4, 2)
      }
    }
#undef SKINNY_2
#undef SKINNY
  }
  return static_cast<int>(cudaGetLastError());
}
