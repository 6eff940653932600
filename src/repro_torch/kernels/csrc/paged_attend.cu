// K5: GQA attention over a block-paged KV pool (decode and suffix prefill).
//
// Replaces the TPU kernel src/repro/kernels/paged_attend.py
// `paged_attend_pallas` (body `_kernel`, pallas_call at :214).
//
// q (B, S, H, hd) attends over the pages block_table[b, :] names in pools
// (P, page, KV, hd); query s of row b sits at position lengths[b] - S + s
// and sees positions <= its own (causal). Optional tanh softcap. Pools are
// bf16/f32, or packed LNS words (uint8) with (P, page, KV, 1) scales.
// f32 out.
//
// Bound on the H100: bytes. Decode reads each resident KV position once
// per layer (2 * KV * hd elements) and does ~4*H*hd flops on it: ~2 flops
// per byte. Design: one block per (row b, kv head g, tile of 16 query rows);
// the rep = H/KV query heads of a group ride the same block, so each K/V
// page is read from device memory once per group and decoded (LNS words
// times their scale) once into shared memory, where all of the group's
// query rows read it. Each warp owns 4 query rows; each lane holds hd/32 of
// a row's dims, so a logit is a lane-partial dot plus a warp reduction, and
// the online-softmax state (m, l, acc) lives in registers across pages.
// Pages load synchronously; cp.async double buffering, as the TPU kernel's
// two-deep DMA ring does, is later work. Masked positions are skipped,
// which is exact: position 0 is visible to every query (lengths >= S).
#include "common.cuh"

#define ROWS_PER_WARP 4
#define WARPS 4
#define ROWS_PER_BLOCK (ROWS_PER_WARP * WARPS)

// HD = 32 * DPL, or 16 with DPL = 1 and lanes 16..31 idle (the smoke
// config's head_dim)
template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
paged_attend_kernel(const void* __restrict__ q, int q_dt,
                    const void* __restrict__ kp, const void* __restrict__ vp,
                    int kv_dt, const void* __restrict__ ks,
                    const void* __restrict__ vs, int s_dt,
                    const int* __restrict__ block_table,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int S, int H, int KV, int page, int max_pages, int bits,
                    float gamma, float softcap, float sm_scale) {
  constexpr int DPL = (HD + 31) / 32;  // dims per lane
  extern __shared__ float smem[];
  float* Ks = smem;                // [page][HD]
  float* Vs = smem + page * HD;    // [page][HD]

  const int b = blockIdx.x / KV;
  const int g = blockIdx.x % KV;
  const int rep = H / KV;
  const int nrows = S * rep;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool lane_on = HD % 32 == 0 || lane < HD;  // holds a dim
  const int ln = lengths[b];
  int n_pages = (ln + page - 1) / page;
  if (n_pages > max_pages) n_pages = max_pages;

  // this warp's query rows: row index i = s * rep + r -> head g * rep + r
  float qv[ROWS_PER_WARP][DPL], acc[ROWS_PER_WARP][DPL];
  float m[ROWS_PER_WARP], l[ROWS_PER_WARP];
  int qpos[ROWS_PER_WARP];
  bool live[ROWS_PER_WARP];
  long long obase[ROWS_PER_WARP];
#pragma unroll
  for (int j = 0; j < ROWS_PER_WARP; ++j) {
    const int i = blockIdx.y * ROWS_PER_BLOCK + warp * ROWS_PER_WARP + j;
    m[j] = -1e30f;
    l[j] = 0.f;
    qpos[j] = -1;  // no row: every position is masked
    live[j] = i < nrows;
    obase[j] = 0;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[j][d] = 0.f, qv[j][d] = 0.f;
    if (live[j]) {
      const int s = i / rep, h = g * rep + i % rep;
      qpos[j] = ln - S + s;
      obase[j] = ((static_cast<long long>(b) * S + s) * H + h) * HD;
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        if (lane_on) qv[j][d] = load_f32(q, q_dt, obase[j] + d * 32 + lane);
    }
  }
  const int max_code = (1 << (bits - 1)) - 1;

  for (int pi = 0; pi < n_pages; ++pi) {
    const long long pg = block_table[static_cast<long long>(b) * max_pages + pi];
    // stage the page's K and V of head group g, decoded to f32
    for (int e = threadIdx.x; e < page * HD; e += WARPS * 32) {
      const int p = e / HD, d = e % HD;
      const long long row = (pg * page + p) * KV + g;
      const long long idx = row * HD + d;
      float kf, vf;
      if (kv_dt == DT_U8) {
        const unsigned kw = static_cast<const uint8_t*>(kp)[idx];
        const unsigned vw = static_cast<const uint8_t*>(vp)[idx];
        const float km = exp2f(-static_cast<float>(kw & max_code) / gamma);
        const float vm = exp2f(-static_cast<float>(vw & max_code) / gamma);
        kf = (((kw >> (bits - 1)) & 1u) ? -km : km) * load_f32(ks, s_dt, row);
        vf = (((vw >> (bits - 1)) & 1u) ? -vm : vm) * load_f32(vs, s_dt, row);
      } else {
        kf = load_f32(kp, kv_dt, idx);
        vf = load_f32(vp, kv_dt, idx);
      }
      Ks[e] = kf;
      Vs[e] = vf;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ROWS_PER_WARP; ++j) {
      const int last = qpos[j] - pi * page;  // last visible offset in page
      const int np = last + 1 < page ? last + 1 : page;
      for (int p = 0; p < np; ++p) {
        float part = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d)
          if (lane_on) part = fmaf(qv[j][d], Ks[p * HD + d * 32 + lane], part);
        float sc = warp_sum(part) * sm_scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        const float m_new = fmaxf(m[j], sc);
        const float corr = expf(m[j] - m_new);
        const float pe = expf(sc - m_new);
        l[j] = corr * l[j] + pe;
#pragma unroll
        for (int d = 0; d < DPL; ++d)
          if (lane_on) acc[j][d] = fmaf(pe, Vs[p * HD + d * 32 + lane], corr * acc[j][d]);
        m[j] = m_new;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < ROWS_PER_WARP; ++j) {
    if (!live[j]) continue;
    const float den = fmaxf(l[j], 1e-30f);
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      if (lane_on) out[obase[j] + d * 32 + lane] = acc[j][d] / den;
  }
}

REPRO_EXPORT int repro_paged_attend(
    const void* q, int q_dt, const void* kp, const void* vp, int kv_dt,
    const void* ks, const void* vs, int s_dt, const int* block_table,
    const int* lengths, float* out, int B, int S, int H, int KV, int hd,
    int page, int max_pages, int bits, int gamma, float softcap,
    float sm_scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  const int nrows = S * (H / KV);
  const dim3 grid(B * KV, (nrows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  const size_t smem = 2 * static_cast<size_t>(page) * hd * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(HD)                                                           \
  paged_attend_kernel<HD><<<grid, WARPS * 32, smem, st>>>(                   \
      q, q_dt, kp, vp, kv_dt, ks, vs, s_dt, block_table, lengths, out, S, H, \
      KV, page, max_pages, bits, static_cast<float>(gamma), softcap, sm_scale)
  switch (hd) {
    case 16: LAUNCH(16); break;
    case 32: LAUNCH(32); break;
    case 64: LAUNCH(64); break;
    case 128: LAUNCH(128); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
