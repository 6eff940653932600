// K7: integer re-grid of packed LNS words from src bits to dst bits.
//
// Replaces the TPU kernel src/repro/kernels/lns_quantize.py
// `lns_requant_pallas` (body `_requant_kernel`, pallas_call at :68), whose
// body is `core/lns.py::lns_requant_packed`.
//
// sign = (w >> (src_bits-1)) & 1,  c = w & src_max
// upscale   (mul > 0): c' = c * mul            (mul = gamma_dst / gamma_src)
// downscale (mul = 0): c' = (c + div/2) / div  (div = gamma_src / gamma_dst;
//                      floor(c/div + 1/2), ties away from zero, c >= 0)
// word' = sign << (dst_bits-1) | min(c', dst_max),  one uint8 per element.
//
// Integer arithmetic only, so it is bit-equal to the plain version.
//
// Bound on the H100: bytes. One byte in and one out per element, a few
// integer ops on it; a draft view of smollm-135m moves 2 x 134.5M bytes,
// 0.080 ms at 3.35 TB/s. Design: one thread per word in a grid-stride
// loop over the flattened contiguous words, coalesced; no tiling and no
// padding (the TPU kernel pads to 256 x 256 tiles and slices the pad off).
// Wider loads (16 B a thread) are later work.
#include "common.cuh"

__global__ void requant_kernel(const uint8_t* __restrict__ in,
                               uint8_t* __restrict__ out, long long n,
                               int src_bits, int dst_bits, int mul, int div,
                               int dst_max) {
  const unsigned src_max = (1u << (src_bits - 1)) - 1u;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const unsigned w = in[i];
    const unsigned sign = (w >> (src_bits - 1)) & 1u;
    int c = static_cast<int>(w & src_max);
    c = mul ? c * mul : (c + div / 2) / div;
    if (c > dst_max) c = dst_max;
    out[i] = static_cast<uint8_t>((sign << (dst_bits - 1)) |
                                  static_cast<unsigned>(c));
  }
}

REPRO_EXPORT int repro_requant_pack(const uint8_t* in, uint8_t* out,
                                    long long n, int src_bits, int dst_bits,
                                    int mul, int div, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  const int dst_max = (1 << (dst_bits - 1)) - 1;
  requant_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      in, out, n, src_bits, dst_bits, mul, div, dst_max);
  return static_cast<int>(cudaGetLastError());
}
