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
// collector). A partial last slice is one slice. The `min` before the shift
// stays: a shift by 32 or more is undefined in CUDA. Every shifted value is
// non-negative, so the unsigned shifts here are the reference's logical ones.
// The LUT comes from the host (the numpy tables of core/conversion.py) and
// sits in shared memory; byte words give m <= 254, so at most 256 entries.
// Integer arithmetic only: the output equals the plain version bit for bit.
//
// Bound on the H100: operations. A term's magnitude depends only on m, so
// the function needs per product an add, one shared-memory load of a
// 255-entry term table, a sign apply and an accumulate (at every LUT size),
// against one byte per operand read once and 4 bytes per output: at
// 2048x576x1536 the 1.8e9 products need ~0.22 ms of the shared-memory
// load rate (32 per SM per clock) and 15 MB of HBM traffic. This kernel
// evaluates the datapath per product instead (~10 instructions).
// Design: a 64x64 output tile per block of 16x16 threads, 4x4 outputs each
// (rows ty+16i, columns tx+16j). The words of A and B are staged through
// shared memory 16 K-columns at a time; each thread decodes its 4+4 words
// once per column and forms its 16 products, so staging is amortised 16x.
// No padding: rows, columns and K columns past the edges are masked. A
// 255-entry table of the whole term (a pure function of m) and a split-K
// grid for the skinny decode shapes are later speed work.
#include "common.cuh"

#define LM_TILE 64
#define LM_THREADS 256
#define LM_KC 16
#define LM_LUT 256
#define LM_SAT24 ((1 << 23) - 1)

template <bool kHybrid>
__global__ void __launch_bounds__(LM_THREADS)
lns_matmul_kernel(const uint8_t* __restrict__ pa,
                  const uint8_t* __restrict__ pb,
                  const int32_t* __restrict__ lut_g, int n_lut,
                  int32_t* __restrict__ out, int M, int N, int K, int bits,
                  int b, int b_l, int block_k) {
  __shared__ int32_t lut[LM_LUT];
  // [k][row] and [k][col]; the +1 spreads the A tile's column writes over
  // the banks
  __shared__ int32_t sa[LM_KC][LM_TILE + 1];
  __shared__ int32_t sb[LM_KC][LM_TILE + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * LM_TILE, col0 = blockIdx.x * LM_TILE;
  for (int i = threadIdx.x; i < n_lut; i += LM_THREADS) lut[i] = lut_g[i];

  const int max_code = (1 << (bits - 1)) - 1;
  const int sign_shift = bits - 1;
  const int gamma = 1 << b;
  const int r_mask = gamma - 1;
  const int lsb_mask = kHybrid ? (1 << b_l) - 1 : 0;
  const int mitchell_base = kHybrid ? gamma + (1 << b_l) : 0;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += block_k) {
    const int k_end = min(k0 + block_k, K);
    int blk[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) blk[i][j] = 0;

    for (int kc = k0; kc < k_end; kc += LM_KC) {
      const int kn = min(LM_KC, k_end - kc);
      __syncthreads();  // the last pass is done reading (and the LUT is in)
      for (int e = threadIdx.x; e < LM_KC * LM_TILE; e += LM_THREADS) {
        // A: 16 neighbouring threads read 16 neighbouring bytes of a row
        const int ar = e / LM_KC, ak = e % LM_KC;
        const int gr = row0 + ar;
        sa[ak][ar] = (gr < M && ak < kn)
                         ? pa[static_cast<long long>(gr) * K + kc + ak] : 0;
        // B: 64 neighbouring threads read 64 neighbouring bytes of a row
        const int bk = e / LM_TILE, bc = e % LM_TILE;
        const int gc = col0 + bc;
        sb[bk][bc] = (gc < N && bk < kn)
                         ? pb[static_cast<long long>(kc + bk) * N + gc] : 0;
      }
      __syncthreads();
      for (int k = 0; k < kn; ++k) {
        int ca[4], na[4], cb[4], nb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int w = sa[k][ty + 16 * i];
          ca[i] = w & max_code;
          na[i] = (w >> sign_shift) & 1;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int w = sb[k][tx + 16 * j];
          cb[j] = w & max_code;
          nb[j] = (w >> sign_shift) & 1;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int m = ca[i] + cb[j];
            const unsigned q = static_cast<unsigned>(min(m >> b, 31));
            const int r = m & r_mask;
            unsigned v;
            if (kHybrid) {
              const unsigned t = static_cast<unsigned>(lut[r >> b_l]) *
                                 static_cast<unsigned>(mitchell_base -
                                                       (r & lsb_mask));
              v = (t >> b) >> q;
            } else {
              v = static_cast<unsigned>(lut[r]) >> q;
            }
            const int sv = static_cast<int>(v);
            blk[i][j] += (na[i] ^ nb[j]) ? -sv : sv;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = min(max(acc[i][j] + blk[i][j], -LM_SAT24), LM_SAT24);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < N) out[static_cast<long long>(gr) * N + gc] = acc[i][j];
    }
  }
}

// b = log2(gamma); b_l = the Mitchell LSBs of the hybrid, or -1 for the
// exact LUT. The wrapper bounds gamma, frac_bits and block_k so that no
// int32 product or block sum overflows, and n_lut to 256.
REPRO_EXPORT int repro_lns_matmul(const uint8_t* pa, const uint8_t* pb,
                                  const int32_t* lut, int n_lut, int32_t* out,
                                  int M, int N, int K, int bits, int b,
                                  int b_l, int block_k, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + LM_TILE - 1) / LM_TILE, (M + LM_TILE - 1) / LM_TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_l < 0)
    lns_matmul_kernel<false><<<grid, LM_THREADS, 0, s>>>(
        pa, pb, lut, n_lut, out, M, N, K, bits, b, b_l, block_k);
  else
    lns_matmul_kernel<true><<<grid, LM_THREADS, 0, s>>>(
        pa, pb, lut, n_lut, out, M, N, K, bits, b, b_l, block_k);
  return static_cast<int>(cudaGetLastError());
}
