// K8: the bit-exact Fig.-6 LNS dot-product datapath on packed words.
//
// Replaces the TPU kernel src/repro/kernels/lns_matmul.py
// `lns_matmul_pallas` (body `_kernel`, conversion `_datapath_terms`,
// pallas_call at :125).
//
// Per product of words a (row of A) and b (column of B), B-bit words with
// the sign in the MSB and the exponent code below it:
//   m = code_a + code_b,  q = min(m >> log2(gamma), 31),  r = m & (gamma-1)
//   exact:  v = lut[r] >> q                 lut = remainder_lut_neg_int
//   hybrid: v = ((lut[r >> b_l] * (gamma + 2^b_l - (r & (2^b_l-1)))) >> b) >> q
//                                           lut = remainder_lut_neg_shifted_int
//   term = (sign_a xor sign_b) ? -v : v
// Each block_k slice of K sums its terms in int32 (the adder tree), then the
// accumulator takes the slice sum and saturates to +-(2^23 - 1) (the 24-bit
// collector). A partial last slice is one slice. Integer arithmetic only:
// the output equals the plain version bit for bit.
//
// Bound on the H100: operations, the shared-memory load rate. A term
// depends only on m and the two signs, so each block's prologue builds a
// table of the whole signed term by the datapath's own arithmetic (at
// either LUT kind and any LUT size): T[m + 256 (sa + sb)] for m <= 2
// max_code, negated where sa + sb = 1 (768 entries). The staged words
// become byte offsets (code + 256 sign) * 4 REPL, so a product is an add,
// one shared-memory load and an accumulate. REPL copies of the table, one
// per lane (mod REPL), interleaved: with REPL = 32 lane l always reads bank
// l and a warp's 32 lookups never conflict (98 KB); REPL = 1 trades
// conflicts for a 3 KB table and a cheaper prologue (`ops.py` picks, and
// `chip_smoke.py --k8-sweep` times both).
//
// Tiles: "wide" 128 x 64 outputs a block of 16 x 16 threads, 8 x 4 each;
// "mid" 64 x 64, 4 x 4 each (twice the tiles where wide ones would leave
// SMs idle); "skinny" 4 x 256 a block of 128 threads, 4 x 2 each
// (decode's M = 4).
// Words are staged through shared memory 16 K-columns at a time, 4 bytes a
// load where rows and pointers allow (bytes otherwise), the next chunk's
// loads issued before the current chunk's products. No padding: rows,
// columns and K columns past the edges are masked.
//
// Split-K (where the tiles do not fill the card): splits take whole
// block_k slices. A split does not know the accumulator it starts from, so
// it carries its slices' collector as a function of it: after slice sums
// b_1..b_j, acc -> clamp(acc + c, lo, hi) with c = sum b, and lo, hi the
// images of -S and +S (each step clamps lo + b and hi + b to [-S, S]; the
// family of such maps is closed under composition). It writes (c, lo, hi)
// to the workspace; the last block of the tile to arrive (a self-resetting
// counter, no atomics on the output) applies the splits' maps to 0 in K
// order, which replays the collector over every slice in K order exactly.
#include "common.cuh"

#define LM_KC 16
#define LM_TAB 768  // 256 x (sa + sb in {0, 1, 2})
#define LM_SAT24 ((1 << 23) - 1)
#define LM_MAX_TILES 65536

// one arrival counter per output tile of a split grid; zero at load, and
// the last-arriving block of a tile sets it back to 0 (calls on one stream
// never overlap)
__device__ unsigned int k8_arrivals[LM_MAX_TILES];

__device__ __forceinline__ int sat24(int v) {
  return min(max(v, -LM_SAT24), LM_SAT24);
}

// the datapath's magnitude for m = code_a + code_b
__device__ __forceinline__ int term(int m, const int32_t* __restrict__ lut,
                                    int b, int b_l) {
  const int gamma = 1 << b;
  const unsigned q = static_cast<unsigned>(min(m >> b, 31));
  const int r = m & (gamma - 1);
  unsigned v;
  if (b_l >= 0) {
    const unsigned t = static_cast<unsigned>(lut[r >> b_l]) *
                       static_cast<unsigned>(gamma + (1 << b_l) -
                                             (r & ((1 << b_l) - 1)));
    v = (t >> b) >> q;
  } else {
    v = static_cast<unsigned>(lut[r]) >> q;
  }
  return static_cast<int>(v);
}

// a word's byte offset into the table: (code + 256 sign) * 4 REPL
template <int REPL>
__device__ __forceinline__ int word_off(unsigned w, int max_code,
                                        int sign_shift) {
  return ((static_cast<int>(w) & max_code) +
          (static_cast<int>((w >> sign_shift) & 1u) << 8)) * (4 * REPL);
}

template <int TM, int TN, int TY, int TX, int REPL, bool SPLIT>
__global__ void __launch_bounds__(TY * TX)
lns_matmul_kernel(const uint8_t* __restrict__ pa,
                  const uint8_t* __restrict__ pb,
                  const int32_t* __restrict__ lut, int32_t* __restrict__ out,
                  int32_t* __restrict__ ws, int M, int N, int K, int bits,
                  int b, int b_l, int block_k, int slices_per_split,
                  int aligned) {
  constexpr int NT = TY * TX, BM = TM * TY, BN = TN * TX;
  constexpr int A_U32 = BM * LM_KC / 4, B_U32 = LM_KC * BN / 4;
  constexpr int A_PT = (A_U32 + NT - 1) / NT, B_PT = (B_U32 + NT - 1) / NT;
  extern __shared__ __align__(16) int32_t lm_smem[];
  int32_t* tab = lm_smem;                    // LM_TAB * REPL
  int32_t* sa = tab + LM_TAB * REPL;         // [LM_KC][BM] byte offsets
  int32_t* sb = sa + LM_KC * BM;             // [LM_KC][BN]
  __shared__ unsigned int last;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int max_code = (1 << (bits - 1)) - 1;
  const int sign_shift = bits - 1;

  // the signed term table, REPL interleaved copies
  for (int w = tid; w < LM_TAB * REPL / (REPL >= 4 ? 4 : 1); w += NT) {
    const int e = REPL >= 4 ? (4 * w) / REPL : w;
    const int m = e & 255, s = e >> 8;
    int v = m <= 2 * max_code ? term(m, lut, b, b_l) : 0;
    if (s == 1) v = -v;
    if (REPL >= 4)
      reinterpret_cast<int4*>(tab)[w] = make_int4(v, v, v, v);
    else
      tab[w] = v;
  }
  const char* tabc = reinterpret_cast<const char*>(tab) +
                     4 * (REPL > 1 ? lane % REPL : 0);

  // K range of this split, in whole block_k slices
  const int slice0 = blockIdx.z * slices_per_split;
  const int k_begin = slice0 * block_k;
  const int k_stop = min(K, (slice0 + slices_per_split) * block_k);

  // staging: u32 = 4 neighbouring words (A: 4 k of one row; B: 4 columns
  // of one k). Fast where the 16-column chunk is whole and 4-byte aligned.
  uint32_t ra[A_PT], rb[B_PT];
  auto load = [&](int kc, int kn) {
    const bool fast = aligned && kn == LM_KC;
#pragma unroll
    for (int p = 0; p < A_PT; ++p) {
      const int e = tid + p * NT;
      const int row = e % BM, kq = e / BM, gr = row0 + row;
      uint32_t u = 0;
      if (e < A_U32 && gr < M) {
        const uint8_t* src = pa + static_cast<long long>(gr) * K + kc + 4 * kq;
        if (fast) {
          u = *reinterpret_cast<const uint32_t*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (4 * kq + j < kn) u |= static_cast<uint32_t>(src[j]) << (8 * j);
        }
      }
      ra[p] = u;
    }
#pragma unroll
    for (int p = 0; p < B_PT; ++p) {
      const int e = tid + p * NT;
      const int kk = e / (BN / 4), cq = e % (BN / 4), gc = col0 + 4 * cq;
      uint32_t u = 0;
      if (e < B_U32 && kk < kn) {
        const uint8_t* src = pb + static_cast<long long>(kc + kk) * N + gc;
        if (fast && gc + 3 < N) {
          u = *reinterpret_cast<const uint32_t*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gc + j < N) u |= static_cast<uint32_t>(src[j]) << (8 * j);
        }
      }
      rb[p] = u;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int p = 0; p < A_PT; ++p) {
      const int e = tid + p * NT;
      if (e >= A_U32) continue;
      const int row = e % BM, kq = e / BM;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sa[(4 * kq + j) * BM + row] =
            word_off<REPL>((ra[p] >> (8 * j)) & 0xffu, max_code, sign_shift);
    }
#pragma unroll
    for (int p = 0; p < B_PT; ++p) {
      const int e = tid + p * NT;
      if (e >= B_U32) continue;
      const int kk = e / (BN / 4), cq = e % (BN / 4);
      int4 o;
      o.x = word_off<REPL>(rb[p] & 0xffu, max_code, sign_shift);
      o.y = word_off<REPL>((rb[p] >> 8) & 0xffu, max_code, sign_shift);
      o.z = word_off<REPL>((rb[p] >> 16) & 0xffu, max_code, sign_shift);
      o.w = word_off<REPL>(rb[p] >> 24, max_code, sign_shift);
      reinterpret_cast<int4*>(sb + kk * BN)[cq] = o;
    }
  };

  int blk[TM][TN], acc[TM][TN], lo[TM][TN], hi[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      blk[i][j] = 0;
      acc[i][j] = 0;  // SPLIT: c, the sum of the slice sums
      lo[i][j] = -LM_SAT24;
      hi[i][j] = LM_SAT24;
    }

  auto products = [&](int k) {
    __align__(16) int av[TM];
    __align__(16) int bv[TN];
#pragma unroll
    for (int i = 0; i < TM; i += 4)
      *reinterpret_cast<int4*>(&av[i]) =
          *reinterpret_cast<const int4*>(sa + k * BM + ty * TM + i);
    if constexpr (TN == 2) {
      *reinterpret_cast<int2*>(&bv[0]) =
          *reinterpret_cast<const int2*>(sb + k * BN + tx * TN);
    } else {
#pragma unroll
      for (int j = 0; j < TN; j += 4)
        *reinterpret_cast<int4*>(&bv[j]) =
            *reinterpret_cast<const int4*>(sb + k * BN + tx * TN + j);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        blk[i][j] += *reinterpret_cast<const int*>(tabc + (av[i] + bv[j]));
  };

  // chunks of <= LM_KC columns that never cross a slice boundary
  auto slice_end = [&](int k) {
    return min(k_stop, k_begin + ((k - k_begin) / block_k + 1) * block_k);
  };
  int kc = k_begin;
  int kn = min(LM_KC, slice_end(kc) - kc);
  if (kc < k_stop) load(kc, kn);
  while (kc < k_stop) {
    __syncthreads();  // the last chunk is read (and the table built)
    store();
    __syncthreads();
    const int s_end = slice_end(kc);
    const int kc_next = kc + kn;
    const int kn_next =
        kc_next < k_stop ? min(LM_KC, slice_end(kc_next) - kc_next) : 0;
    if (kn_next > 0) load(kc_next, kn_next);  // in flight over the products
    if (kn == LM_KC) {
#pragma unroll 4
      for (int k = 0; k < LM_KC; ++k) products(k);
    } else {
      for (int k = 0; k < kn; ++k) products(k);
    }
    if (kc_next == s_end) {  // the slice ends: the collector takes it
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if (SPLIT) {
            acc[i][j] += blk[i][j];
            lo[i][j] = sat24(lo[i][j] + blk[i][j]);
            hi[i][j] = sat24(hi[i][j] + blk[i][j]);
          } else {
            acc[i][j] = sat24(acc[i][j] + blk[i][j]);
          }
          blk[i][j] = 0;
        }
    }
    kc = kc_next;
    kn = kn_next;
  }

  const long long MN = static_cast<long long>(M) * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc >= N) continue;
      const long long o = static_cast<long long>(gr) * N + gc;
      if (SPLIT) {
        int32_t* w = ws + 3 * blockIdx.z * MN + o;
        w[0] = acc[i][j];
        w[MN] = lo[i][j];
        w[2 * MN] = hi[i][j];
      } else {
        out[o] = acc[i][j];
      }
    }
  }
  if (!SPLIT) return;
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0)
    last = atomicAdd(&k8_arrivals[tile], 1u) == gridDim.z - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc >= N) continue;
      const long long o = static_cast<long long>(gr) * N + gc;
      int v = 0;
#pragma unroll 4
      for (unsigned s = 0; s < gridDim.z; ++s) {
        const int32_t* w = ws + 3 * s * MN + o;
        v = min(max(v + __ldcg(w), __ldcg(w + MN)), __ldcg(w + 2 * MN));
      }
      out[o] = v;
    }
  }
  if (tid == 0) k8_arrivals[tile] = 0u;
}

template <int TM, int TN, int TY, int TX, int REPL, bool SPLIT>
static int launch(const uint8_t* pa, const uint8_t* pb, const int32_t* lut,
                  int32_t* out, int32_t* ws, int M, int N, int K, int bits,
                  int b, int b_l, int block_k, int splits,
                  int slices_per_split, int aligned, cudaStream_t s) {
  constexpr int BM = TM * TY, BN = TN * TX;
  const size_t smem = (static_cast<size_t>(LM_TAB) * REPL +
                       LM_KC * (BM + BN)) * sizeof(int32_t);
  auto kern = lns_matmul_kernel<TM, TN, TY, TX, REPL, SPLIT>;
  static bool attr = false;  // once per instantiation
  if (!attr && smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  attr = true;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kern<<<grid, TY * TX, smem, s>>>(pa, pb, lut, out, ws, M, N, K, bits, b,
                                   b_l, block_k, slices_per_split, aligned);
  return static_cast<int>(cudaGetLastError());
}

// wide tiles never split (their split variant needs ~240 registers a
// thread, one block an SM: slower at every shape the sweep timed)
template <int TM, int TN, int TY, int TX, bool CAN_SPLIT>
static int launch_cfg(int repl, const uint8_t* pa, const uint8_t* pb,
                      const int32_t* lut, int32_t* out, int32_t* ws, int M,
                      int N, int K, int bits, int b, int b_l, int block_k,
                      int splits, int per, int aligned, cudaStream_t s) {
  if (splits > 1 && !CAN_SPLIT) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (CAN_SPLIT) {
    if (splits > 1)
      return repl == 32
          ? launch<TM, TN, TY, TX, 32, true>(pa, pb, lut, out, ws, M, N, K,
                                             bits, b, b_l, block_k, splits,
                                             per, aligned, s)
          : launch<TM, TN, TY, TX, 1, true>(pa, pb, lut, out, ws, M, N, K,
                                            bits, b, b_l, block_k, splits,
                                            per, aligned, s);
  }
  return repl == 32
      ? launch<TM, TN, TY, TX, 32, false>(pa, pb, lut, out, ws, M, N, K, bits,
                                          b, b_l, block_k, 1, per, aligned, s)
      : launch<TM, TN, TY, TX, 1, false>(pa, pb, lut, out, ws, M, N, K, bits,
                                         b, b_l, block_k, 1, per, aligned, s);
}

// b = log2(gamma); b_l = the Mitchell LSBs of the hybrid, or -1 for the
// exact LUT. cfg 0 = wide tiles (no split), 1 = skinny, 2 = mid; repl 1 or
// 32; splits
// blocks share each tile's K, slices_per_split block_k slices each, with a
// workspace of 3 * splits * M * N int32 when splits > 1. The wrapper bounds
// gamma, frac_bits, block_k and each split's K so no int32 overflows, and
// the LUT to 256 entries.
REPRO_EXPORT int repro_lns_matmul(const uint8_t* pa, const uint8_t* pb,
                                  const int32_t* lut, int32_t* out,
                                  int32_t* ws, int M, int N, int K, int bits,
                                  int b, int b_l, int block_k, int cfg,
                                  int repl, int splits, int slices_per_split,
                                  int aligned, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (repl != 1 && repl != 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cfg == 0)
    return launch_cfg<8, 4, 16, 16, false>(repl, pa, pb, lut, out, ws, M, N,
                                           K, bits, b, b_l, block_k, splits,
                                           slices_per_split, aligned, s);
  if (cfg == 1)
    return launch_cfg<4, 2, 1, 128, true>(repl, pa, pb, lut, out, ws, M, N, K,
                                          bits, b, b_l, block_k, splits,
                                          slices_per_split, aligned, s);
  return launch_cfg<4, 4, 16, 16, true>(repl, pa, pb, lut, out, ws, M, N, K,
                                        bits, b, b_l, block_k, splits,
                                        slices_per_split, aligned, s);
}
