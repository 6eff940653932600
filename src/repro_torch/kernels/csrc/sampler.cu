// K6: fused sampler epilogue, scale -> gumbel add -> first-max-wins argmax.
//
// Replaces the TPU kernel src/repro/kernels/sampler.py
// `fused_sample_pallas` (body `_kernel`, pallas_call at :86).
//
// Per row b: token = argmax(logits[b]) (first maximum wins), or, when
// gumbel noise is given and temp[b] > 0,
// argmax(logits[b] / max(temp[b], 1e-6) + gumbel[b]).
//
// Bound on the H100: bytes. One pass over a (B, V) f32 row block (and the
// noise when sampling): 4 x 49152 x 4 B = 0.79 MB at decode, ~0.2 us at
// 3.35 TB/s, so a launch costs more than the data. Design: one block per
// row; each thread scans a strided slice keeping (max, first index), then
// a warp-shuffle and shared-memory reduction that prefers the larger value
// and, on a tie, the smaller index. The noise is an input (drawn by the
// caller from a per-request generator), so the kernel and its plain
// version see the same numbers and agree token for token: the scaling is
// IEEE division then addition, as in the plain version.
#include <math.h>

#include "common.cuh"

#define THREADS 512

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(THREADS)
fused_sample_kernel(const float* __restrict__ logits,
                    const float* __restrict__ gumbel,
                    const float* __restrict__ temp, int* __restrict__ out,
                    int V) {
  __shared__ float sv[THREADS / 32];
  __shared__ int si[THREADS / 32];
  const int b = blockIdx.x;
  const float* row = logits + static_cast<long long>(b) * V;
  const float* grow = gumbel != nullptr ? gumbel + static_cast<long long>(b) * V : nullptr;
  const float t = grow != nullptr ? temp[b] : 0.f;
  const bool sample = grow != nullptr && t > 0.f;
  const float tt = fmaxf(t, 1e-6f);

  float best = -INFINITY;
  int bidx = V;  // sentinel: loses every tie against a real index
  for (int i = threadIdx.x; i < V; i += THREADS) {
    float v = row[i];
    if (sample) v = v / tt + grow[i];
    if (bidx == V || v > best) {
      best = v;
      bidx = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
    take_better(best, bidx, ov, oi);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = bidx;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < THREADS / 32 ? sv[lane] : -INFINITY;
    bidx = lane < THREADS / 32 ? si[lane] : V;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
      take_better(best, bidx, ov, oi);
    }
    if (lane == 0) out[b] = bidx < V ? bidx : 0;
  }
}

REPRO_EXPORT int repro_fused_sample(const float* logits, const float* gumbel,
                                    const float* temp, int* out, int B, int V,
                                    void* stream) {
  if (B == 0) return 0;
  fused_sample_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, gumbel, temp, out, V);
  return static_cast<int>(cudaGetLastError());
}
