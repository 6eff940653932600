// K2: packed-LNS GEMM, decode in the tile, f32 accumulation, fused scales.
//
// Replaces the TPU kernel src/repro/kernels/lns_qmatmul.py
// `lns_qmatmul_pallas` (body `_kernel`, pallas_call at :74), together with
// the row/column scale epilogue of its wrapper `ops.lns_qmatmul`.
//
// out[m, n] = (sum_k dec(A[m, k]) * dec(B[k, n])) * sa[m] * sb[n]
// dec(w) = +-2^(-(w & max_code)/gamma), rounded to the compute dtype.
//
// Bound on the H100: bytes. On the serving path M is the decode batch (4)
// or a prefill bucket (32), so the GEMM does 2*M flops per weight byte:
// far below the ~295 flops/byte where tensor cores would bind. The 1-byte
// LNS words halve the weight bytes of bf16, which is the whole point of the
// format on this path. Design: 16x64 output tiles, 32-deep K steps; the u8
// tiles are read coalesced and decoded on their way into shared memory
// through a per-block table of the 2^(B-1) magnitudes (128 entries at B=8),
// each rounded to the compute dtype as the plain version rounds; products
// of two bf16 values are exact in f32, so plain f32 FMAs reproduce a bf16
// tensor-core product with f32 accumulation. Ragged M, N and K are masked
// (out-of-range words decode to 0), never padded. Tensor cores (mma/wgmma)
// and a split-K for the skinny decode shapes are later work.
#include "common.cuh"

#define BM 16
#define BN 64
#define BK 32
#define THREADS 256

__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
               const float* __restrict__ sa, const float* __restrict__ sb,
               float* __restrict__ out, int M, int N, int K, int bits,
               float gamma, int dt) {
  __shared__ float table[128];
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int max_code = (1 << (bits - 1)) - 1;
  const int sign_shift = bits - 1;
  if (tid <= max_code) table[tid] = round_to(exp2f(-static_cast<float>(tid) / gamma), dt);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = tid % BN;        // output column in the tile
  const int ty = tid / BN;        // rows ty*4 .. ty*4+3
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      float v = 0.f;
      if (gm < M && gk < K) {
        const unsigned w = A[static_cast<long long>(gm) * K + gk];
        const float t = table[w & max_code];
        v = ((w >> sign_shift) & 1u) ? -t : t;
      }
      As[c][r] = v;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
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
    for (int kk = 0; kk < BK; ++kk) {
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
    float v = acc[j];
    if (sa != nullptr) v = v * sa[gm];
    if (sb != nullptr) v = v * sb[gn];
    out[static_cast<long long>(gm) * N + gn] = v;
  }
}

REPRO_EXPORT int repro_qmatmul(const uint8_t* A, const uint8_t* B,
                               const float* sa, const float* sb, float* out,
                               int M, int N, int K, int bits, int gamma,
                               int dt, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmatmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, sa, sb, out, M, N, K, bits, static_cast<float>(gamma), dt);
  return static_cast<int>(cudaGetLastError());
}
