// K1: fused Q_log encode + pack (LNS words, sign in the MSB).
//
// Replaces the TPU kernel src/repro/kernels/lns_quantize.py
// `lns_quantize_pallas` (body `_kernel`, pallas_call at :103).
//
// code = clip(floor(-log2(max(|x|/s, FLT_MIN)) * gamma + 0.5), 0, max_code)
// word = (x < 0) << (bits-1) | code,  one uint8 per element.
//
// Bound on the H100: bytes. Each element is read once (2 B bf16 or 4 B
// f32) and written once (1 B), against ~10 flops; at the serving shapes
// (M x 576 or M x 1536, M = 4..32) the whole call moves under 100 KB, so
// launch latency, not the 3.35 TB/s, sets its time. Design: one thread
// per element in a grid-stride loop, coalesced along the row; the per-row
// scale (a power of two, computed by a torch reduction before the launch
// as the TPU wrapper does) is read through L1. The arithmetic keeps the
// plain version's order of operations (IEEE division, log2f, no fused
// multiply-add) so the words agree except where f32 log2 rounds an exponent
// that sits within an ulp of a half-integer.
#include <float.h>

#include "common.cuh"

__global__ void encode_pack_kernel(const void* __restrict__ x, int dt,
                                   const float* __restrict__ scale,
                                   uint8_t* __restrict__ out, long long R,
                                   long long C, int bits, float gamma,
                                   float max_code) {
  const long long n = R * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float xv = load_f32(x, dt, i);
    const float s = scale[i / C];
    const unsigned neg = xv < 0.f ? 1u : 0u;
    const float mag = fabsf(xv) / s;
    float e = -log2f(fmaxf(mag, FLT_MIN)) * gamma;
    e = floorf(e + 0.5f);
    e = fminf(fmaxf(e, 0.f), max_code);
    out[i] = static_cast<uint8_t>((neg << (bits - 1)) | static_cast<unsigned>(e));
  }
}

REPRO_EXPORT int repro_encode_pack(const void* x, int dt, const float* scale,
                                   uint8_t* out, long long R, long long C,
                                   int bits, int gamma, void* stream) {
  const long long n = R * C;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  const float max_code = static_cast<float>((1 << (bits - 1)) - 1);
  encode_pack_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, dt, scale, out, R, C, bits, static_cast<float>(gamma), max_code);
  return static_cast<int>(cudaGetLastError());
}
