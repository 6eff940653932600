// K1: Q_log encode + pack (LNS words, sign in the MSB), with its own
// pow2-absmax scale, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/lns_quantize.py
// `lns_quantize_pallas` (body `_kernel`, pallas_call at :103) together with
// the scale reduction its wrapper runs before it in jnp
// (src/repro/kernels/ops.py `quantize_pack`).
//
// s    = exp2(ceil(log2(max(absmax, FLT_MIN))))    per tensor, or per row
// code = clip(floor(-log2(max(|x|/s, FLT_MIN)) * gamma + 0.5), 0, max_code)
// word = (x < 0) << (bits-1) | code,  one uint8 per element.
//
// Bound on the H100: bytes. Each element is read once (2 B bf16 or 4 B
// f32) and written once (1 B), against ~15 instructions; at the serving
// shapes (4..32 x 576/1536) the call moves under 100 KB and launch latency
// sets its time, at the training shape (2048 x 1536 bf16) 9.4 MB.
//
// Design, per tensor: a grid of at most one block per SM (all resident).
// Each block copies its contiguous chunk of x into shared memory with
// 16-byte cp.async (what does not fit is read from global memory twice),
// reduces the chunk's absmax, and meets the other blocks at a grid barrier
// built from a self-resetting arrival counter and a generation word (as
// K2's split-K counter; calls on one stream never overlap). The maxima
// meet in one of two slots by generation parity; the last block to arrive
// zeroes the other slot for the next call. Each block then finalizes the
// scale itself (the same f32 calls, in the same order, as torch's CUDA
// chain in core/lns.py `pow2_scale`) and encodes its chunk from shared
// memory: x is read from HBM once. Small inputs (up to `one_block`
// elements, set by the wrapper) take one block and no barrier. No cooperative launch, so the kernel is captured
// into CUDA graphs like any other. Per row: one warp per row, its max by
// shuffles, the row read again for the encode (L1/L2 hits); no barrier.
//
// The max runs on |x|'s bit patterns as unsigned integers: for
// non-negative floats the order is the same, any NaN lies above +inf (so
// the max propagates NaN as torch.amax does), and the result is exact in
// any order. Clamps pass NaN through as torch.clamp_min does. The encode
// keeps the plain version's order of operations under -fmad=false; where s
// is a normal power of two, |x| * (1/s) is the same IEEE result as |x| / s
// (the reciprocal is exact), so the divide is skipped.
//
// A given scale (the TPU kernel's own contract: `scale` is an input of
// shape (R, 1), or (1, 1) for the tensor) skips the absmax pass: per tensor
// a grid-stride encode of 16-byte vectors under the one scale, per row the
// per-row kernel with the max taken from `given` instead of the row. The
// scale rows are written out as in the self-scaled call. This is what a
// data-parallel rank runs: its scale is the max over every rank's rows.
#include <float.h>

#include "common.cuh"

#define K1_MAX_THREADS 1024
#define K1_SMEM_MAX (200 * 1024)
#define K1_ROW_THREADS 256      // per row: 8 warps, one row each
#define K1_GIVEN_BLOCKS_PER_SM 4

// grid barrier state: arrivals, generation, two max slots (by generation
// parity); zero at load, left so after every call
__device__ unsigned int k1_count;
__device__ unsigned int k1_gen;
__device__ unsigned int k1_max[2];

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <typename T> struct K1Elem;
template <> struct K1Elem<float> {
  static constexpr int VEC = 4;  // elements in 16 bytes
  __device__ static float f32(float v) { return v; }
  __device__ static float lane(const uint4& v, int i) {
    return __uint_as_float((&v.x)[i]);
  }
};
template <> struct K1Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static float f32(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static float lane(const uint4& v, int i) {
    const unsigned int w = (&v.x)[i >> 1];
    return __uint_as_float(((i & 1) ? (w >> 16) : (w & 0xffffu)) << 16);
  }
};

__device__ __forceinline__ unsigned int abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ float clamp_tiny(float v) {
  return v < FLT_MIN ? FLT_MIN : v;  // NaN stays NaN
}

// torch: exp2(ceil(log2(clamp_min(amax, tiny)))), amax NaN -> NaN
__device__ __forceinline__ float pow2_scale(unsigned int amax_bits) {
  return exp2f(ceilf(log2f(clamp_tiny(__uint_as_float(amax_bits)))));
}

struct K1Enc {
  float s, inv, gamma, max_code;
  int bits;
  bool pow2;
  __device__ K1Enc(float s_, int bits_, float gamma_)
      : s(s_), inv(1.0f / s_), gamma(gamma_),
        max_code(static_cast<float>((1 << (bits_ - 1)) - 1)), bits(bits_) {
    const unsigned int b = __float_as_uint(s_);
    pow2 = (b & 0x007fffffu) == 0u && b >= 0x00800000u && b < 0x7f800000u;
  }
  __device__ __forceinline__ unsigned int word(float xv) const {
    const unsigned int neg = xv < 0.f ? 1u : 0u;
    const float mag = pow2 ? fabsf(xv) * inv : fabsf(xv) / s;
    const float e = -log2f(clamp_tiny(mag)) * gamma + 0.5f;
    // floor, clip to [0, max_code] (NaN -> 0, as torch's cast on CUDA) and
    // cast: clipping first commutes with floor (max_code is an integer),
    // and a round-toward-zero add of 2^23 then leaves floor(t) in the low
    // mantissa bits, on the FMA pipe instead of FRND and F2I
    const float t = fminf(fmaxf(e, 0.f), max_code);
    const unsigned int code = __float_as_uint(__fadd_rz(t, 8388608.f)) - 0x4B000000u;
    return (neg << (bits - 1)) | code;
  }
};

// encode one 16-byte vector and store its VEC bytes (VEC-byte aligned)
template <typename T>
__device__ __forceinline__ void encode_vec(const uint4& v, const K1Enc& enc,
                                           uint8_t* out) {
  constexpr int VEC = K1Elem<T>::VEC;
  unsigned int w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    w[i >> 2] |= enc.word(K1Elem<T>::lane(v, i)) << (8 * (i & 3));
  if (VEC == 8)
    *reinterpret_cast<uint2*>(out) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<unsigned int*>(out) = w[0];
}

template <typename T>
__device__ __forceinline__ unsigned int vec_absmax(const uint4& v) {
  unsigned int m = 0u;
#pragma unroll
  for (int i = 0; i < K1Elem<T>::VEC; ++i)
    m = max(m, abs_bits(K1Elem<T>::lane(v, i)));
  return m;
}

__device__ __forceinline__ unsigned int block_max(unsigned int m,
                                                  unsigned int* red) {
  m = __reduce_max_sync(0xffffffffu, m);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
  }
  return m;  // valid in warp 0
}

// ------------------------------------------------------------ per tensor

template <typename T>
__global__ void __launch_bounds__(K1_MAX_THREADS)
k1_tensor_kernel(const T* __restrict__ x, uint8_t* __restrict__ out,
                 float* __restrict__ srow, long long n, long long R,
                 long long chunk, long long cache, int bits, float gamma,
                 int aligned) {
  constexpr int VEC = K1Elem<T>::VEC;
  extern __shared__ __align__(16) unsigned char k1_smem[];
  T* tile = reinterpret_cast<T*>(k1_smem);
  __shared__ unsigned int red[K1_MAX_THREADS / 32];
  __shared__ unsigned int amax_s;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long lo = blockIdx.x * chunk;
  const long long len = max(min(lo + chunk, n) - lo, 0LL);
  const long long ncache = min(len, cache);
  // vectors of the cached part (chunk and cache are whole vectors, so
  // only the last block has a scalar tail)
  const long long nv = aligned ? ncache / VEC : 0;
  const T* xb = x + lo;

  for (long long v = tid; v < nv; v += nt) {
    const unsigned int dst = static_cast<unsigned int>(
        __cvta_generic_to_shared(tile + v * VEC));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                 "l"(xb + v * VEC) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  unsigned int m = 0u;
  for (long long i = nv * VEC + tid; i < ncache; i += nt) {
    tile[i] = xb[i];
    m = max(m, abs_bits(K1Elem<T>::f32(xb[i])));
  }
  for (long long i = ncache + tid; i < len; i += nt)  // past the cache
    m = max(m, abs_bits(K1Elem<T>::f32(xb[i])));
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  for (long long v = tid; v < nv; v += nt)
    m = max(m, vec_absmax<T>(reinterpret_cast<const uint4*>(tile)[v]));
  m = block_max(m, red);

  if (tid == 0) {
    if (gridDim.x > 1) {
      const unsigned int gen = ld_acquire(&k1_gen);
      atomicMax(&k1_max[gen & 1u], m);
      __threadfence();
      if (atomicAdd(&k1_count, 1u) == gridDim.x - 1) {
        k1_count = 0u;
        k1_max[(gen + 1u) & 1u] = 0u;  // the next call's slot
        __threadfence();
        atomicAdd(&k1_gen, 1u);
      } else {
        while (ld_acquire(&k1_gen) == gen) __nanosleep(64);
      }
      m = ld_acquire(&k1_max[gen & 1u]);
    }
    amax_s = m;
  }
  __syncthreads();
  const K1Enc enc(pow2_scale(amax_s), bits, gamma);
  for (long long r = static_cast<long long>(blockIdx.x) * nt + tid; r < R;
       r += static_cast<long long>(gridDim.x) * nt)
    srow[r] = enc.s;

  uint8_t* ob = out + lo;
  for (long long v = tid; v < nv; v += nt)
    encode_vec<T>(reinterpret_cast<const uint4*>(tile)[v], enc, ob + v * VEC);
  for (long long i = nv * VEC + tid; i < ncache; i += nt)
    ob[i] = static_cast<uint8_t>(enc.word(K1Elem<T>::f32(tile[i])));
  for (long long i = ncache + tid; i < len; i += nt)
    ob[i] = static_cast<uint8_t>(enc.word(K1Elem<T>::f32(xb[i])));
}

// --------------------------------------------------------------- per row

template <typename T>
__global__ void __launch_bounds__(K1_ROW_THREADS)
k1_row_kernel(const T* __restrict__ x, const float* __restrict__ given,
              uint8_t* __restrict__ out, float* __restrict__ srow,
              long long R, long long C, int bits, float gamma, int vec_ok) {
  constexpr int VEC = K1Elem<T>::VEC;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) *
                            (K1_ROW_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* xr = x + row * C;
  uint8_t* orow = out + row * C;
  const long long nv = vec_ok ? C / VEC : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(xr);
  float s;
  if (given != nullptr) {
    s = given[row];
  } else {
    unsigned int m = 0u;
    for (long long v = lane; v < nv; v += 32) m = max(m, vec_absmax<T>(xv[v]));
    for (long long i = nv * VEC + lane; i < C; i += 32)
      m = max(m, abs_bits(K1Elem<T>::f32(xr[i])));
    m = __reduce_max_sync(0xffffffffu, m);
    s = pow2_scale(m);
  }
  const K1Enc enc(s, bits, gamma);
  if (lane == 0) srow[row] = enc.s;
  for (long long v = lane; v < nv; v += 32)
    encode_vec<T>(xv[v], enc, orow + v * VEC);
  for (long long i = nv * VEC + lane; i < C; i += 32)
    orow[i] = static_cast<uint8_t>(enc.word(K1Elem<T>::f32(xr[i])));
}

// ------------------------------------------------- per tensor, given scale

template <typename T>
__global__ void __launch_bounds__(K1_MAX_THREADS)
k1_given_kernel(const T* __restrict__ x, const float* __restrict__ given,
                uint8_t* __restrict__ out, float* __restrict__ srow,
                long long n, long long R, int bits, float gamma, int aligned) {
  constexpr int VEC = K1Elem<T>::VEC;
  const K1Enc enc(given[0], bits, gamma);
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long nt = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = tid; r < R; r += nt) srow[r] = enc.s;
  const long long nv = aligned ? n / VEC : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (long long v = tid; v < nv; v += nt)
    encode_vec<T>(xv[v], enc, out + v * VEC);
  for (long long i = nv * VEC + tid; i < n; i += nt)
    out[i] = static_cast<uint8_t>(enc.word(K1Elem<T>::f32(x[i])));
}

// ----------------------------------------------------------------- entry

template <typename T>
static int launch(const void* x, int per_row, const float* given,
                  uint8_t* out, float* srow, long long R, long long C,
                  int bits, int gamma, int threads, long long one_block,
                  long long min_chunk, cudaStream_t s) {
  constexpr int VEC = K1Elem<T>::VEC;
  const T* xt = static_cast<const T*>(x);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (per_row) {
    const int vec_ok = aligned && (C * static_cast<long long>(sizeof(T))) % 16 == 0;
    const long long blocks = (R + K1_ROW_THREADS / 32 - 1) / (K1_ROW_THREADS / 32);
    k1_row_kernel<T><<<static_cast<unsigned>(blocks), K1_ROW_THREADS, 0, s>>>(
        xt, given, out, srow, R, C, bits, static_cast<float>(gamma), vec_ok);
    return static_cast<int>(cudaGetLastError());
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(k1_tensor_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         K1_SMEM_MAX);
  }
  const long long n = R * C;
  if (given != nullptr) {
    long long nb = (n / VEC + threads - 1) / threads;
    if (nb < 1) nb = 1;
    if (nb > static_cast<long long>(sms) * K1_GIVEN_BLOCKS_PER_SM)
      nb = static_cast<long long>(sms) * K1_GIVEN_BLOCKS_PER_SM;
    k1_given_kernel<T><<<static_cast<unsigned>(nb), threads, 0, s>>>(
        xt, given, out, srow, n, R, bits, static_cast<float>(gamma),
        aligned ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
  }
  long long nb = n <= one_block ? 1 : (n + min_chunk - 1) / min_chunk;
  if (nb > sms) nb = sms;  // one block per SM: every block is resident
  long long chunk = (n + nb - 1) / nb;
  chunk = (chunk + VEC - 1) / VEC * VEC;
  nb = (n + chunk - 1) / chunk;
  long long cache = K1_SMEM_MAX / static_cast<long long>(sizeof(T));
  if (cache > chunk) cache = chunk;
  const size_t smem = static_cast<size_t>(cache) * sizeof(T);
  k1_tensor_kernel<T><<<static_cast<unsigned>(nb), threads, smem, s>>>(
      xt, out, srow, n, R, chunk, cache, bits, static_cast<float>(gamma),
      aligned ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// x: R x C, f32 or bf16 (dt); per_row: one scale a row (scale_axis=0), else
// one for the tensor; given: null (the kernel takes the absmax scale) or the
// scales to encode against, R f32 per row or 1 per tensor; out: R x C uint8
// words; srow: R f32 scales. Per
// tensor: `threads` a block (a multiple of 32, <= 1024); one block up to
// `one_block` elements, above that one block a `min_chunk` elements up to
// one a SM.
REPRO_EXPORT int repro_encode_pack(const void* x, int dt, int per_row,
                                   const float* given, uint8_t* out,
                                   float* srow, long long R,
                                   long long C, int bits, int gamma,
                                   int threads, long long one_block,
                                   long long min_chunk, void* stream) {
  if (R == 0 || C == 0) return 0;
  if (threads % 32 || threads < 32 || threads > K1_MAX_THREADS || min_chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == DT_BF16)
    return launch<__nv_bfloat16>(x, per_row, given, out, srow, R, C, bits,
                                 gamma, threads, one_block, min_chunk, s);
  return launch<float>(x, per_row, given, out, srow, R, C, bits, gamma,
                       threads, one_block, min_chunk, s);
}
