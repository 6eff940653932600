// K6: fused sampler epilogue, scale -> gumbel add -> first-max-wins argmax.
//
// Replaces the TPU kernel src/repro/kernels/sampler.py
// `fused_sample_pallas` (body `_kernel`, pallas_call at :86).
//
// Per row b: token = argmax(logits[b]) (first maximum wins), or, where the
// row samples (temp[b] > 0), argmax(logits[b] / max(temp[b], 1e-6) + g[b]).
// Three modes, one kernel template:
//   greedy   no noise, no temperature;
//   noise-in g is an input (B, V) and temp a device vector: exactly what
//            `fused_sample_pallas` computes, so JAX's noise can be fed in;
//   seeded   g is drawn in registers from (seed, step, token id) by a
//            counter-based hash (below); per-row temp, seed and step arrive
//            by value in the launch (`SampleRows`, at most K6_MAX_ROWS
//            rows), so a step makes no host-to-device copy. `noise_out`,
//            when given, receives the noise of every row.
//
// The noise: key = mix32(mix32(seed) ^ step) per row, then for token i
// h = mix32(mix32(key ^ i) + key), u = ((h >> 9) + 0.5) * 2^-23 (exact in
// f32, strictly inside (0, 1)), g = -logf(-logf(u)). mix32 is a 32-bit
// xor-shift-multiply finalizer; `ref.gumbel_noise` computes the same bits
// on int64 tensors.
//
// Bound on the H100: bytes. One pass over a (B, V) f32 row block (twice
// with noise in, noise out written once): 4 x 49152 x 4 B = 0.79 MB at
// decode, ~0.2 us at 3.35 TB/s, so a launch costs more than the data.
// Design: a row is split over a thread-block cluster (blocks_per_row
// blocks, up to 16, so B = 4 rows reach 64 SMs rather than 4). Each block
// scans its chunk with 16-byte loads (scalar loads for a head that is not
// 16-byte aligned and for the tail) keeping (max, first index), and
// reduces by warp shuffles and shared memory. Each block then pushes its
// partial into block 0's shared memory (distributed shared memory; a
// relaxed cluster arrive at the start, waited on before the push, makes
// sure block 0 has started), one cluster barrier later block 0's first
// warp merges the partials by shuffles. The merge prefers the larger value
// and, on a tie, the smaller index, so the argmax is exact under any split
// (nothing is summed). No workspace, no counter: safe under CUDA-graph
// capture. The scaling is the IEEE division then addition of the plain
// version, so tokens agree exactly.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define K6_MAX_ROWS 64

enum { K6_GREEDY = 0, K6_NOISE_IN = 1, K6_SEEDED = 2 };

struct SampleRows {
  float temp[K6_MAX_ROWS];
  unsigned seed[K6_MAX_ROWS];
  int step[K6_MAX_ROWS];
};

__device__ __forceinline__ unsigned mix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float gumbel_at(unsigned key, int i) {
  const unsigned h = mix32(mix32(key ^ static_cast<unsigned>(i)) + key);
  const float u = (__uint2float_rn(h >> 9) + 0.5f) * 0x1p-23f;
  return -logf(-logf(u));
}

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

struct RowState {
  const float* lg;   // the row's logits
  const float* g;    // its noise (noise-in mode)
  float* nout;       // where its noise goes (seeded mode, may be null)
  float tt;          // max(temp, 1e-6)
  unsigned key;      // seeded mode
  bool sample;       // temp > 0
  bool draw;         // seeded and (sampling or writing the noise)
};

template <int MODE>
__device__ __forceinline__ float score(const RowState& r, int i, float x,
                                       float g_in) {
  float g = 0.f;
  if (MODE == K6_NOISE_IN) g = g_in;
  if (MODE == K6_SEEDED && r.draw) {
    g = gumbel_at(r.key, i);
    if (r.nout != nullptr) r.nout[i] = g;
  }
  return r.sample ? x / r.tt + g : x;
}

template <int MODE>
__device__ __forceinline__ void visit(const RowState& r, int i, float& best,
                                      int& bidx) {
  const float g_in = (MODE == K6_NOISE_IN && r.sample) ? r.g[i] : 0.f;
  take_better(best, bidx, score<MODE>(r, i, r.lg[i], g_in), i);
}

template <int MODE>
__global__ void __launch_bounds__(1024)
fused_sample_kernel(const float* __restrict__ logits,
                    const float* __restrict__ gumbel,
                    const float* __restrict__ temp, float* __restrict__ noise_out,
                    int* __restrict__ out, int V, int chunk,
                    const __grid_constant__ SampleRows rows) {
  __shared__ float sv[32];
  __shared__ int si[32];
  __shared__ float part_v[16];  // block 0: the partial of each block
  __shared__ int part_i[16];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.y;
  const int rank = static_cast<int>(cluster.block_rank());
  const long long off = static_cast<long long>(b) * V;
  // first phase of the cluster barrier: arrive now, wait before writing
  // into block 0's shared memory (every block of the cluster has started)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  RowState r;
  r.lg = logits + off;
  r.g = MODE == K6_NOISE_IN ? gumbel + off : nullptr;
  r.nout = (MODE == K6_SEEDED && noise_out != nullptr) ? noise_out + off
                                                        : nullptr;
  float t = 0.f;
  r.key = 0u;
  if (MODE == K6_NOISE_IN) t = temp[b];
  if (MODE == K6_SEEDED) {
    t = rows.temp[b];
    r.key = mix32(mix32(rows.seed[b]) ^ static_cast<unsigned>(rows.step[b]));
  }
  r.sample = MODE != K6_GREEDY && t > 0.f;
  r.draw = MODE == K6_SEEDED && (r.sample || r.nout != nullptr);
  r.tt = fmaxf(t, 1e-6f);

  const int lo = min(V, rank * chunk);
  const int hi = min(V, lo + chunk);
  float best = -INFINITY;
  int bidx = V;  // sentinel: loses every tie against a real index

  // 16-byte loads where every array this row touches starts its chunk on
  // the same 16-byte residue (rows of contiguous tensors do)
  const uintptr_t al = reinterpret_cast<uintptr_t>(r.lg + lo) & 15u;
  bool vec = true;
  if (r.g != nullptr) vec &= (reinterpret_cast<uintptr_t>(r.g + lo) & 15u) == al;
  if (r.nout != nullptr)
    vec &= (reinterpret_cast<uintptr_t>(r.nout + lo) & 15u) == al;
  int head = vec ? static_cast<int>(((16u - al) & 15u) / 4u) : hi - lo;
  head = min(head, hi - lo);
  const int v0 = lo + head;
  const int n4 = (hi - v0) / 4;
  for (int i = lo + threadIdx.x; i < v0; i += blockDim.x)
    visit<MODE>(r, i, best, bidx);
  const float4* l4 = reinterpret_cast<const float4*>(r.lg + v0);
  const float4* g4 =
      reinterpret_cast<const float4*>((MODE == K6_NOISE_IN ? r.g : r.lg) + v0);
#pragma unroll 4
  for (int j = threadIdx.x; j < n4; j += blockDim.x) {
    const float4 x = __ldg(l4 + j);
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    if (MODE == K6_NOISE_IN && r.sample) g = __ldg(g4 + j);
    const int i = v0 + 4 * j;
    float4 s;
    if (MODE == K6_SEEDED && r.draw) {
      g = make_float4(gumbel_at(r.key, i), gumbel_at(r.key, i + 1),
                      gumbel_at(r.key, i + 2), gumbel_at(r.key, i + 3));
      if (r.nout != nullptr) reinterpret_cast<float4*>(r.nout + v0)[j] = g;
    }
    if (r.sample) {
      s = make_float4(x.x / r.tt + g.x, x.y / r.tt + g.y, x.z / r.tt + g.z,
                      x.w / r.tt + g.w);
    } else {
      s = x;
    }
    take_better(best, bidx, s.x, i);
    take_better(best, bidx, s.y, i + 1);
    take_better(best, bidx, s.z, i + 2);
    take_better(best, bidx, s.w, i + 3);
  }
  for (int i = v0 + 4 * n4 + threadIdx.x; i < hi; i += blockDim.x)
    visit<MODE>(r, i, best, bidx);

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
    take_better(best, bidx, ov, oi);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = bidx;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < warps ? sv[lane] : -INFINITY;
    bidx = lane < warps ? si[lane] : V;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
      take_better(best, bidx, ov, oi);
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x == 0) {  // push this block's partial into block 0
    *cluster.map_shared_rank(&part_v[rank], 0) = best;
    *cluster.map_shared_rank(&part_i[rank], 0) = bidx;
  }
  cluster.sync();  // release the pushes; block 0 acquires them
  if (rank == 0 && warp == 0) {
    const int n = static_cast<int>(cluster.num_blocks());
    best = lane < n ? part_v[lane] : -INFINITY;
    bidx = lane < n ? part_i[lane] : V;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
      take_better(best, bidx, ov, oi);
    }
    if (lane == 0) out[b] = bidx < V ? bidx : 0;
  }
}

template <int MODE>
static cudaError_t launch(const float* logits, const float* gumbel,
                          const float* temp, float* noise_out, int* out, int B,
                          int V, const SampleRows& rows, int blocks_per_row,
                          int threads, cudaStream_t stream) {
  int chunk = (V + blocks_per_row - 1) / blocks_per_row;
  chunk = (chunk + 3) & ~3;  // every chunk starts on the row's 16-byte residue
  if (blocks_per_row > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_sample_kernel<MODE>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_per_row, B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks_per_row;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fused_sample_kernel<MODE>, logits, gumbel,
                            temp, noise_out, out, V, chunk, rows);
}

// rows: null (greedy, or noise-in when gumbel is given), or a host
// SampleRows for the seeded mode (B <= K6_MAX_ROWS). blocks_per_row: the
// cluster size, a power of two up to 16; threads a multiple of 32 up to
// 1024.
REPRO_EXPORT int repro_fused_sample(const float* logits, const float* gumbel,
                                    const float* temp, const void* rows,
                                    float* noise_out, int* out, int B, int V,
                                    int blocks_per_row, int threads,
                                    void* stream) {
  if (B == 0) return 0;
  if (B < 0 || B > 65535 || V <= 0 || threads < 32 || threads > 1024 ||
      threads % 32 || blocks_per_row < 1 || blocks_per_row > 16 ||
      (blocks_per_row & (blocks_per_row - 1)) ||
      (rows != nullptr && (B > K6_MAX_ROWS || gumbel != nullptr)) ||
      (gumbel != nullptr && temp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  SampleRows r = {};
  if (rows != nullptr) r = *static_cast<const SampleRows*>(rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (rows != nullptr)
    e = launch<K6_SEEDED>(logits, nullptr, nullptr, noise_out, out, B, V, r,
                          blocks_per_row, threads, s);
  else if (gumbel != nullptr)
    e = launch<K6_NOISE_IN>(logits, gumbel, temp, nullptr, out, B, V, r,
                            blocks_per_row, threads, s);
  else
    e = launch<K6_GREEDY>(logits, nullptr, nullptr, nullptr, out, B, V, r,
                          blocks_per_row, threads, s);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
