// K7: integer re-grid of packed LNS words from src bits to dst bits, for up
// to K7_MAX_LEAVES leaves that share (src, dst) in one launch.
//
// Replaces the TPU kernel src/repro/kernels/lns_quantize.py
// `lns_requant_pallas` (body `_requant_kernel`, pallas_call at :68), whose
// body is `core/lns.py::lns_requant_packed`.
//
// sign = (w >> (src_bits-1)) & 1,  c = w & src_max
// upscale   (gamma_dst >= gamma_src, mul = 2^s): c' = c * mul
// downscale (div = gamma_src / gamma_dst = 2^s): c' = (c + div/2) / div
//           = (c >> s) + ((c >> (s-1)) & 1)   (floor(c/div + 1/2), c >= 0)
// word' = sign << (dst_bits-1) | min(c', dst_max),  one uint8 per element.
//
// Integer arithmetic only, so it is bit-equal to the plain version.
//
// Bound on the H100: bytes. One byte in and one out per element, a few
// integer ops on it; a draft view of smollm-135m moves 2 x 134.5M bytes,
// 0.080 ms at 3.35 TB/s. Design: one launch for the whole view. A leaf is
// cut into 16-byte units on its input's 16-byte grid; the units of all the
// leaves are numbered one after the other (prefix sums in a by-value
// table), and one thread takes one unit: a `uint4` load, the re-grid of
// its four 32-bit words four bytes at a time in registers (SIMD within a
// register: every byte holds a code <= 127, so no add or compare carries
// into its neighbour), and a `uint4` store. A unit that the leaf covers
// only in part (a head before the first 16-byte boundary of a misaligned
// slice, a tail that is not a multiple of 16) takes the same arithmetic a
// byte at a time. The wrapper places each output on its input's 16-byte
// residue, so both sides of a unit are aligned alike.
#include "common.cuh"

#define K7_MAX_LEAVES 16

struct RequantTable {
  const uint8_t* in[K7_MAX_LEAVES];
  uint8_t* out[K7_MAX_LEAVES];
  long long n[K7_MAX_LEAVES];
  long long start[K7_MAX_LEAVES + 1];  // first unit of each leaf; total last
  int count;
};

struct Regrid {
  unsigned src_shift;  // src_bits - 1: the sign bit
  unsigned dst_shift;  // dst_bits - 1
  unsigned cmask4;     // src_max in every byte
  unsigned dmax4;      // dst_max in every byte
  unsigned thr4;       // upscale: the largest code that does not saturate
  unsigned keep4;      // downscale: 0xFF >> s in every byte
  int up;              // 1: multiply by 2^s, 0: divide by 2^s rounding
  int s;               // upscale 0..7, downscale 1..8
};

// 0xFF in every byte where a > b; both hold values <= 0x7F in every byte
__device__ __forceinline__ unsigned gt_mask4(unsigned a, unsigned b) {
  const unsigned d = ((a | 0x80808080u) - b - 0x01010101u) & 0x80808080u;
  return (d >> 7) * 0xFFu;
}

__device__ __forceinline__ unsigned regrid4(unsigned w, const Regrid& g) {
  const unsigned sign = (w >> g.src_shift) & 0x01010101u;
  const unsigned c = w & g.cmask4;
  unsigned r;
  if (g.up) {
    const unsigned sat = gt_mask4(c, g.thr4);
    r = (sat & g.dmax4) | ((c & ~sat) << g.s);
  } else {
    r = ((c >> g.s) & g.keep4) + ((c >> (g.s - 1)) & 0x01010101u);
    const unsigned sat = gt_mask4(r, g.dmax4);
    r = (sat & g.dmax4) | (r & ~sat);
  }
  return (sign << g.dst_shift) | r;
}

__global__ void requant_kernel(const __grid_constant__ RequantTable t,
                               const Regrid g) {
  const long long u = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (u >= t.start[t.count]) return;
  int l = 0;
  while (l + 1 < t.count && u >= t.start[l + 1]) ++l;
  const uint8_t* in = t.in[l];
  uint8_t* out = t.out[l];
  const long long n = t.n[l];
  const long long head = static_cast<long long>(
      reinterpret_cast<uintptr_t>(in) & 15u);
  const long long lo = (u - t.start[l]) * 16 - head;  // leaf byte offsets
  const long long hi = lo + 16;
  if (lo >= 0 && hi <= n) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(in + lo));
    uint4 o;
    o.x = regrid4(w.x, g);
    o.y = regrid4(w.y, g);
    o.z = regrid4(w.z, g);
    o.w = regrid4(w.w, g);
    *reinterpret_cast<uint4*>(out + lo) = o;
  } else {
    for (long long i = lo < 0 ? 0 : lo; i < (hi < n ? hi : n); ++i)
      out[i] = static_cast<uint8_t>(regrid4(in[i], g));
  }
}

// ins/outs/ns: host arrays of `count` leaves (pointers as integers, byte
// counts); each out must sit on its in's 16-byte residue. up/s: the
// re-grid by 2^s (upscale s in 0..7, downscale s in 1..8, larger shifts
// clamped by the caller give the same words).
REPRO_EXPORT int repro_requant_pack(const long long* ins,
                                    const long long* outs,
                                    const long long* ns, int count,
                                    int src_bits, int dst_bits, int up, int s,
                                    int threads, void* stream) {
  if (count < 1 || count > K7_MAX_LEAVES || src_bits < 2 || src_bits > 8 ||
      dst_bits < 2 || dst_bits > 8 || s < (up ? 0 : 1) || s > (up ? 7 : 8) ||
      threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  RequantTable t = {};
  t.count = count;
  for (int l = 0; l < count; ++l) {
    if (ns[l] < 0 || ((ins[l] - outs[l]) & 15))
      return static_cast<int>(cudaErrorInvalidValue);
    t.in[l] = reinterpret_cast<const uint8_t*>(ins[l]);
    t.out[l] = reinterpret_cast<uint8_t*>(outs[l]);
    t.n[l] = ns[l];
    const long long units = ns[l] ? ((ins[l] & 15) + ns[l] + 15) / 16 : 0;
    t.start[l + 1] = t.start[l] + units;
  }
  const long long total = t.start[count];
  if (total == 0) return 0;
  const unsigned src_max = (1u << (src_bits - 1)) - 1u;
  const unsigned dst_max = (1u << (dst_bits - 1)) - 1u;
  Regrid g;
  g.src_shift = src_bits - 1;
  g.dst_shift = dst_bits - 1;
  g.cmask4 = src_max * 0x01010101u;
  g.dmax4 = dst_max * 0x01010101u;
  g.thr4 = (dst_max >> s) * 0x01010101u;
  g.keep4 = (0xFFu >> s) * 0x01010101u;
  g.up = up;
  g.s = s;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  requant_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(t, g);
  return static_cast<int>(cudaGetLastError());
}
