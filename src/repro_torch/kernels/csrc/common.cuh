// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel has a plain C entry point (bound with ctypes): pointers and
// the CUDA stream arrive as void*, sizes as long long / int, and the entry
// point returns cudaGetLastError() right after its launch so the Python
// wrapper can raise on a launch that was refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// element types, as the wrappers in ops.py number them
enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_U8 = 3, DT_I32 = 4, DT_I16 = 5 };

__device__ __forceinline__ float load_f32(const void* p, int dt, long long i) {
  if (dt == DT_BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// round an f32 to the compute dtype and back (identity for f32)
__device__ __forceinline__ float round_to(float v, int dt) {
  if (dt == DT_BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
