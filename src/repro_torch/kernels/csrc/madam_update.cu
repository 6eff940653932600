// K3 and K4: the fused LNS-Madam update (Algorithm 1) on packed words;
// K9: the same update on an unpacked (code, sign) leaf.
//
// Replaces the TPU kernels src/repro/kernels/madam_update.py
// `madam_update_packed_pallas` (K3, body `_packed_kernel`, math
// `_step_math`), `madam_update_packed_stats_pallas` (K4, body
// `_packed_stats_kernel`, epilogue `madam_stats_vec`) and
// `madam_update_pallas` (K9, body `_kernel`, pallas_call at :204).
//
// Per element, with bc = 1 - beta^count computed once on the host in f32:
//   v'     = (1-beta)*g*g + beta*v
//   g*     = g * rsqrt(v'/bc + eps)
//   target = code + (lr*gamma) * g* * sign
//   code'  = clip(floor(target + 0.5), 0, max_code), sign bit kept
// K4 also sums, per block, the stat slots of `madam_stats_vec`:
//   0 sat_lo  #(floor(target+0.5) < 0)        3 qerr_sum  sum |2^(-(code'-target)/gamma) - 1|
//   1 sat_hi  #(floor(target+0.5) > max_code) 4 code_sum  sum code'
//   2 dead    #(code' == code, target != code) 5 req_hi   #((code'+r/2)/r > dst_max)
// into a (blocks, 8) f64 buffer; the wrapper sums its rows in a fixed
// order afterwards, with no atomics, so the totals are the same run to run.
// The counts and code_sum are integers in each block (exact); qerr_sum is
// an f32 sum within the block.
//
// All three kernels call one device function, `step_math`, so they cannot
// drift apart. It keeps the plain version's order of operations, and the build
// passes -fmad=false so no multiply-add is contracted where the plain
// version rounds twice. The reciprocal square root is `rsqrtf`, the
// function `torch.rsqrt` runs on a CUDA float tensor (ATen's rsqrt kernel
// calls `::rsqrt`, whose float overload is `rsqrtf`, an approximation
// within 2 ulp, not the correctly rounded 1/sqrtf): so the kernel's g*
// matches the plain version on the card bit for bit.
//
// Bound on the H100: bytes. At B=16 an element reads a 4-byte int32 word,
// a 2-byte bf16 gradient and a 4-byte f32 v, and writes 4 + 4 bytes: 18
// bytes against ~15 flops, far below the ~20 flops/byte where the f32
// units would bind. Design: no padding (the TPU pads to 256x256 tiles only
// because Pallas needs it); one thread per element in a grid-stride loop
// over the flattened leaf, neighbouring threads on neighbouring words so
// every load and store is coalesced, the ragged tail masked by the loop
// bound. Vector loads and a persistent grid are later work. K9 reads a
// code (1, 2 or 4 bytes) and a 1-byte sign where K3 reads one word, and
// writes the code back in its own dtype: at int16 codes and f32 g that is
// 2+1+4+4 in and 2+4 out, 17 bytes an element, bytes-bound as K3.
#include "common.cuh"

#define MADAM_THREADS 256
#define MADAM_STAT_WIDTH 8

struct MadamArgs {
  float bc, one_minus_beta, beta, eps, lr_gamma, gamma, max_code;
  int bits;
};

__device__ __forceinline__ float step_math(float code, float sign, float g,
                                           float v, const MadamArgs& a,
                                           float* new_v, float* target) {
  const float nv = a.one_minus_beta * g * g + a.beta * v;
  const float gstar = g * rsqrtf(nv / a.bc + a.eps);
  const float t = code + a.lr_gamma * gstar * sign;
  *new_v = nv;
  *target = t;
  return fminf(fmaxf(floorf(t + 0.5f), 0.f), a.max_code);
}

__device__ __forceinline__ unsigned load_word(const void* w, int wdt,
                                              long long i) {
  if (wdt == DT_U8) return static_cast<const uint8_t*>(w)[i];
  return static_cast<unsigned>(static_cast<const int32_t*>(w)[i]);
}

__device__ __forceinline__ void store_word(void* w, int wdt, long long i,
                                           unsigned word) {
  if (wdt == DT_U8) static_cast<uint8_t*>(w)[i] = static_cast<uint8_t>(word);
  else static_cast<int32_t*>(w)[i] = static_cast<int32_t>(word);
}

// one element: reads (word, g, v), writes (word', v'); returns code, target
// and code' for the stats epilogue
__device__ __forceinline__ void update_one(
    const void* w, int wdt, const void* g, int gdt, const float* v,
    void* w_out, float* v_out, long long i, const MadamArgs& a, float* code,
    float* target, float* new_code) {
  const unsigned word = load_word(w, wdt, i);
  const unsigned max_code = (1u << (a.bits - 1)) - 1u;
  const unsigned sign_bit = (word >> (a.bits - 1)) & 1u;
  *code = static_cast<float>(word & max_code);
  float nv;
  *new_code = step_math(*code, sign_bit ? -1.f : 1.f, load_f32(g, gdt, i),
                        v[i], a, &nv, target);
  store_word(w_out, wdt, i,
             (sign_bit << (a.bits - 1)) | static_cast<unsigned>(*new_code));
  v_out[i] = nv;
}

__global__ void __launch_bounds__(MADAM_THREADS)
madam_step_kernel(const void* __restrict__ w, int wdt,
                  const void* __restrict__ g, int gdt,
                  const float* __restrict__ v, void* __restrict__ w_out,
                  float* __restrict__ v_out, long long n, MadamArgs a) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float code, target, new_code;
    update_one(w, wdt, g, gdt, v, w_out, v_out, i, a, &code, &target,
               &new_code);
  }
}

__device__ __forceinline__ float load_code(const void* c, int cdt,
                                           long long i) {
  if (cdt == DT_U8) return static_cast<float>(static_cast<const uint8_t*>(c)[i]);
  if (cdt == DT_I16) return static_cast<float>(static_cast<const int16_t*>(c)[i]);
  return static_cast<float>(static_cast<const int32_t*>(c)[i]);
}

__device__ __forceinline__ void store_code(void* c, int cdt, long long i,
                                           float code) {
  const int v = static_cast<int>(code);  // in [0, max_code]: fits the dtype
  if (cdt == DT_U8) static_cast<uint8_t*>(c)[i] = static_cast<uint8_t>(v);
  else if (cdt == DT_I16) static_cast<int16_t*>(c)[i] = static_cast<int16_t>(v);
  else static_cast<int32_t*>(c)[i] = v;
}

// K9: one thread per element, grid-stride, no padding (as K3)
__global__ void __launch_bounds__(MADAM_THREADS)
madam_step_unpacked_kernel(const void* __restrict__ code, int cdt,
                           const int8_t* __restrict__ sign,
                           const void* __restrict__ g, int gdt,
                           const float* __restrict__ v,
                           void* __restrict__ code_out,
                           float* __restrict__ v_out, long long n,
                           MadamArgs a) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float nv, target;
    const float nc = step_math(load_code(code, cdt, i),
                               static_cast<float>(sign[i]),
                               load_f32(g, gdt, i), v[i], a, &nv, &target);
    store_code(code_out, cdt, i, nc);
    v_out[i] = nv;
  }
}

__device__ __forceinline__ unsigned long long warp_sum_u64(unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(MADAM_THREADS)
madam_step_stats_kernel(const void* __restrict__ w, int wdt,
                        const void* __restrict__ g, int gdt,
                        const float* __restrict__ v, void* __restrict__ w_out,
                        float* __restrict__ v_out, long long n, MadamArgs a,
                        int ratio, int dst_max, double* __restrict__ partials) {
  // counts: sat_lo, sat_hi, dead, code_sum, req_hi
  unsigned long long cnt[5] = {0ull, 0ull, 0ull, 0ull, 0ull};
  float qerr = 0.f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float code, target, new_code;
    update_one(w, wdt, g, gdt, v, w_out, v_out, i, a, &code, &target,
               &new_code);
    const float rounded = floorf(target + 0.5f);
    cnt[0] += rounded < 0.f;
    cnt[1] += rounded > a.max_code;
    cnt[2] += (new_code == code) && (target != code);
    const float d = new_code - target;
    qerr += fabsf(exp2f(-d / a.gamma) - 1.f);
    const int nc = static_cast<int>(new_code);
    cnt[3] += static_cast<unsigned long long>(nc);
    if (ratio > 0) cnt[4] += (nc + ratio / 2) / ratio > dst_max;
  }
  __shared__ unsigned long long s_cnt[MADAM_THREADS / 32][5];
  __shared__ float s_qerr[MADAM_THREADS / 32];
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < 5; ++k) cnt[k] = warp_sum_u64(cnt[k]);
  qerr = warp_sum(qerr);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 5; ++k) s_cnt[wid][k] = cnt[k];
    s_qerr[wid] = qerr;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long tot[5] = {0ull, 0ull, 0ull, 0ull, 0ull};
    float q = 0.f;
    for (int j = 0; j < MADAM_THREADS / 32; ++j) {
      for (int k = 0; k < 5; ++k) tot[k] += s_cnt[j][k];
      q += s_qerr[j];
    }
    double* out = partials + static_cast<long long>(blockIdx.x) * MADAM_STAT_WIDTH;
    out[0] = static_cast<double>(tot[0]);
    out[1] = static_cast<double>(tot[1]);
    out[2] = static_cast<double>(tot[2]);
    out[3] = static_cast<double>(q);
    out[4] = static_cast<double>(tot[3]);
    out[5] = static_cast<double>(tot[4]);
    out[6] = 0.0;
    out[7] = 0.0;
  }
}

static MadamArgs make_args(int bits, int gamma, float bc, float one_minus_beta,
                           float beta, float eps, float lr_gamma) {
  MadamArgs a;
  a.bc = bc;
  a.one_minus_beta = one_minus_beta;
  a.beta = beta;
  a.eps = eps;
  a.lr_gamma = lr_gamma;
  a.gamma = static_cast<float>(gamma);
  a.max_code = static_cast<float>((1 << (bits - 1)) - 1);
  a.bits = bits;
  return a;
}

// `blocks` comes from the wrapper, which sizes the K4 partials buffer by it
REPRO_EXPORT int repro_madam_step(const void* w, int wdt, const void* g,
                                  int gdt, const float* v, void* w_out,
                                  float* v_out, long long n, int bits,
                                  int gamma, float bc, float one_minus_beta,
                                  float beta, float eps, float lr_gamma,
                                  int blocks, void* stream) {
  if (n == 0) return 0;
  const MadamArgs a = make_args(bits, gamma, bc, one_minus_beta, beta, eps,
                                lr_gamma);
  madam_step_kernel<<<blocks, MADAM_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      w, wdt, g, gdt, v, w_out, v_out, n, a);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int repro_madam_step_stats(
    const void* w, int wdt, const void* g, int gdt, const float* v,
    void* w_out, float* v_out, long long n, int bits, int gamma, float bc,
    float one_minus_beta, float beta, float eps, float lr_gamma, int ratio,
    int dst_max, double* partials, int blocks, void* stream) {
  if (n == 0) return 0;
  const MadamArgs a = make_args(bits, gamma, bc, one_minus_beta, beta, eps,
                                lr_gamma);
  madam_step_stats_kernel<<<blocks, MADAM_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      w, wdt, g, gdt, v, w_out, v_out, n, a, ratio, dst_max, partials);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int repro_madam_step_unpacked(
    const void* code, int cdt, const int8_t* sign, const void* g, int gdt,
    const float* v, void* code_out, float* v_out, long long n, int bits,
    int gamma, float bc, float one_minus_beta, float beta, float eps,
    float lr_gamma, int blocks, void* stream) {
  if (n == 0) return 0;
  const MadamArgs a = make_args(bits, gamma, bc, one_minus_beta, beta, eps,
                                lr_gamma);
  madam_step_unpacked_kernel<<<blocks, MADAM_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      code, cdt, sign, g, gdt, v, code_out, v_out, n, a);
  return static_cast<int>(cudaGetLastError());
}
