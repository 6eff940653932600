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
// Bound on the H100: bytes and, at the serving trace's lengths, latency.
// Decode reads each resident KV position once per layer (2 * KV * hd
// elements) and does ~4*H*hd flops on it: ~2 flops per byte; a step's rows
// hold at most 6 pages of 16 positions, so the kernel is a few
// microseconds of dependent steps unless every warp works. Design: one
// block per (row b, kv head g, tile of 4 query rows); the rep = H/KV query
// heads of a group ride the same block, so each page is read once per
// group and tile.
// * The four warps split the visible pages (warp w takes pages w, w+4, ...)
//   and each keeps its own online-softmax state (m, l, acc) for all of the
//   block's rows; at the end the four states merge through shared memory
//   by the log-sum-exp rule in fixed warp order (deterministic). A warp
//   with no visible position keeps m at the -1e30 sentinel and merges as
//   an exact no-op (its weight expf(-1e30 - M) is 0).
// * Lanes over positions for the logits: a chunk is one page of P <= 32
//   positions (or 32), and the 32 / P lanes of a position split the
//   hd-long dot products of every query row with its K row, read from
//   shared memory in 16-byte pieces (rows padded by 16 bytes, so the 8
//   lanes of a 16-byte phase hit distinct banks); then one max and one sum
//   reduction per chunk, all rows interleaved. The P.V update maps lanes
//   over dims and reads the weights four positions at a time from shared
//   memory.
// * Pages are staged raw (u8 or bf16 or f32) with 16-byte cp.async, double
//   buffered per warp: the warp's next page (and its scales, and the page
//   ids, read before the length is known) are in flight while it attends
//   this one. Where two stages a warp do not fit in shared memory (f32
//   pools of long pages: head_dim 256 at page 16, 128 at page 32, 64 at
//   page 64), one stage does, filled after the page in it is used.
//   Packed words decode through a 2^(B-1)-entry exp2f table in
//   shared memory (bit-equal to exp2f per element) times the row's scale,
//   in the plain version's order.
// Instantiated at head_dim 16, 32, 64, 96, 112, 128 and 256. In P.V lane
// l holds dims d * 32 + l (d < DPL = ceil(HD / 32)) of each row, guarded
// by `d * 32 + l < HD` (folded away where 32 divides HD): at 16 and 112
// the last group is partial. 96 is
// phi-3-vision's: 3 x 32, so every lane holds 3 dims of each row, and a
// row is 6 (u8), 12 (bf16) or 24 (f32) 16-byte pieces, which the SUB =
// 32 / P lanes of a position cover as pieces sh, sh + SUB, ... (at page
// 16, SUB = 2: 3, 6 or 12 each). 112 is zamba2's shared attention: DPL =
// 4 with lanes 16-31 of the fourth group idle, a row 7 (u8), 14 (bf16)
// or 28 (f32) pieces, and padded row strides of 128, 240 and 464 bytes.
// 256 is gemma3's global layers: a lane holds 8 dims of each of the 4
// rows' accumulators, and a bf16 K row is 32 16-byte pieces.
// Splitting one row's KV over several blocks (flash-decoding) is not done:
// at the trace's lengths (<= 96 positions, <= 6 pages) one block per group
// holds enough pages for its four warps. Masked positions are skipped,
// which is exact: position 0 is visible to every query (lengths >= S).
#include "common.cuh"

#define WARPS 4
#define MAX_ROWS 4
#define WTS ((MAX_ROWS + 1) * 32)  // a warp's P.V weights and scales

enum { KV_BF16 = 0, KV_F32 = 1, KV_U8 = 2 };

template <int KIND>
struct KvElem {
  static constexpr int bytes = KIND == KV_F32 ? 4 : (KIND == KV_BF16 ? 2 : 1);
};

// the E = 16 / elem values of one 16-byte piece of a raw row
template <int KIND>
__device__ __forceinline__ void kv_piece(const uint4 raw, float* v,
                                         const float* tab, int max_code,
                                         int sshift, float scale) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if (KIND == KV_F32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
  } else if (KIND == KV_BF16) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = __uint_as_float((i & 1) ? (w[i / 2] & 0xffff0000u) : (w[i / 2] << 16));
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const unsigned b = (w[i / 4] >> (8 * (i % 4))) & 0xffu;
      const float t = tab[b & max_code];
      v[i] = (((b >> sshift) & 1u) ? -t : t) * scale;
    }
  }
}

// element d of a raw row
template <int KIND>
__device__ __forceinline__ float kv_value(const uint8_t* row, int d,
                                          const float* tab, int max_code,
                                          int sshift, float scale) {
  if (KIND == KV_F32) return reinterpret_cast<const float*>(row)[d];
  if (KIND == KV_BF16)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[d]);
  const unsigned w = row[d];
  const float t = tab[w & max_code];
  return (((w >> sshift) & 1u) ? -t : t) * scale;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

template <int HD, int KIND, int ROWS>
__global__ void __launch_bounds__(WARPS * 32)
paged_attend_kernel(const void* __restrict__ q, int q_dt,
                    const void* __restrict__ kp, const void* __restrict__ vp,
                    const void* __restrict__ ks, const void* __restrict__ vs,
                    int s_dt, const int* __restrict__ block_table,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int S, int H, int KV, int page, int max_pages, int bits,
                    float gamma, float softcap, float sm_scale, int nbuf) {
  constexpr int DPL = (HD + 31) / 32;           // dims per lane in P.V
  constexpr int RB = HD * KvElem<KIND>::bytes;  // bytes of a raw row
  constexpr int RS = RB + 16;                   // padded row stride
  extern __shared__ __align__(16) uint8_t smem[];
  float* tab = reinterpret_cast<float*>(smem);            // [128]
  float* qs = tab + 128;                                   // [ROWS][HD]
  float* wts = qs + MAX_ROWS * HD;                         // [WARPS][ROWS + 1][32]
  uint8_t* pages = smem + (128 + MAX_ROWS * HD + WARPS * WTS) * 4;  // [WARPS][nbuf][2][page][RS]
  const int stage_bytes = 2 * page * RS;                   // K then V

  const int b = blockIdx.x / KV;
  const int g = blockIdx.x % KV;
  const int rep = H / KV;
  const int nrows = S * rep;
  const int row0 = blockIdx.y * ROWS;
  const int nr = min(ROWS, nrows - row0);  // live rows of this block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ln = lengths[b];
  int n_pages = (ln + page - 1) / page;
  if (n_pages > max_pages) n_pages = max_pages;
  const int max_code = (1 << (bits - 1)) - 1;
  const int sshift = bits - 1;

  if (KIND == KV_U8)
    for (int i = threadIdx.x; i <= max_code; i += WARPS * 32)
      tab[i] = exp2f(-static_cast<float>(i) / gamma);
#pragma unroll
  for (int u = 0; u < (ROWS * HD + WARPS * 32 - 1) / (WARPS * 32); ++u) {
    const int e = threadIdx.x + u * WARPS * 32;
    if (e >= nr * HD) break;
    const int j = e / HD, d = e % HD;
    const int i = row0 + j;
    const int s = i / rep, h = g * rep + i % rep;
    qs[e] = load_f32(q, q_dt, ((static_cast<long long>(b) * S + s) * H + h) * HD + d);
  }
  // query row j sits at ln - S + s; the block's last row sees the most
  const int qpos_last = ln - S + (row0 + nr - 1) / rep;

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    m[j] = -1e30f;
    l[j] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[j][d] = 0.f;
  }

  uint8_t* mine = pages + warp * nbuf * stage_bytes;
  const int chunks = RB / 16;  // 16-byte pieces of a row
  // this warp's pages (w, w+4, ...): lane i holds the id of its i-th, read
  // before the length is known, so the first copy waits on one load
  const long long bt_row = static_cast<long long>(b) * max_pages;
  const int my_pg = warp + WARPS * lane < max_pages ? block_table[bt_row + warp + WARPS * lane] : 0;
  auto page_id = [&](int pi, int i) -> long long {
    const int v = __shfl_sync(0xffffffffu, my_pg, i & 31);
    return i < 32 ? v : block_table[bt_row + pi];
  };
  // a chunk is P positions: the page, when it is a power of two below 32
  // (the SUB = 32 / P lanes of position pl = lane % P split its dot
  // products), else 32 (lanes past the page idle)
  const int P = (page >= 32 || 32 % page) ? 32 : page;
  const int SUB = 32 / P;
  const int pl = lane % P, sh = lane / P;
  constexpr int E = 16 / KvElem<KIND>::bytes;  // values in a 16-byte piece
  // the packed pool's scales of the lane's position in a page's first chunk
  auto scale_of = [&](const void* sc, long long pg) -> float {
    return load_f32(sc, s_dt, (pg * page + (pl < page ? pl : 0)) * KV + g);
  };
  auto stage = [&](long long pg, int buf) {
    uint8_t* dk = mine + buf * stage_bytes;
    uint8_t* dv = dk + page * RS;
    for (int c = lane; c < page * chunks; c += 32) {
      const int p = c / chunks, off = (c % chunks) * 16;
      const long long src = ((pg * page + p) * KV + g) * RB + off;
      cp_async16(dk + p * RS + off, static_cast<const uint8_t*>(kp) + src);
      cp_async16(dv + p * RS + off, static_cast<const uint8_t*>(vp) + src);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  __syncthreads();  // table and q rows

  long long pg = warp < n_pages ? page_id(warp, 0) : 0;
  float ks_cur = 1.f, vs_cur = 1.f;
  if (warp < n_pages) {
    stage(pg, 0);
    if (KIND == KV_U8) ks_cur = scale_of(ks, pg), vs_cur = scale_of(vs, pg);
  }
  int it = 0;
  for (int pi = warp; pi < n_pages; pi += WARPS, ++it) {
    const bool more = pi + WARPS < n_pages;
    const long long pg_next = more ? page_id(pi + WARPS, it + 1) : 0;
    float ks_next = 1.f, vs_next = 1.f;
    if (more && KIND == KV_U8)
      ks_next = scale_of(ks, pg_next), vs_next = scale_of(vs, pg_next);
    if (more && nbuf == 2) {
      stage(pg_next, (it + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncwarp();
    const uint8_t* kb = mine + (it & (nbuf - 1)) * stage_bytes;
    const uint8_t* vb = kb + page * RS;
    for (int p0 = 0; p0 < page; p0 += P) {
      const int first = pi * page + p0;  // absolute position of the chunk
      if (first > qpos_last) break;
      const int cnt = min(P, page - p0);
      const bool on = pl < cnt;
      float kscale = ks_cur, vscale = vs_cur;
      if (KIND == KV_U8 && p0 > 0) {
        const long long srow = (pg * page + p0 + (on ? pl : 0)) * KV + g;
        kscale = load_f32(ks, s_dt, srow);
        vscale = load_f32(vs, s_dt, srow);
      }
      // logits: the SUB lanes of position pl split its K row's 16-byte
      // pieces, two partial sums each (shorter dependent chains), then
      // combine by shuffles
      float part[ROWS], part2[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) part[j] = part2[j] = 0.f;
      if (on) {
        const uint8_t* krow = kb + (p0 + pl) * RS;
        for (int c = sh; c < RB / 16; c += 2 * SUB) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int cc = c + u * SUB;
            if (cc >= RB / 16) break;
            float kv[E];
            kv_piece<KIND>(*reinterpret_cast<const uint4*>(krow + cc * 16), kv,
                           tab, max_code, sshift, kscale);
#pragma unroll
            for (int e = 0; e < E; e += 4) {
#pragma unroll
              for (int j = 0; j < ROWS; ++j) {
                if (j >= nr) break;
                const float4 qq = *reinterpret_cast<const float4*>(qs + j * HD + cc * E + e);
                float& acc_p = u ? part2[j] : part[j];
                acc_p = fmaf(qq.x, kv[e], acc_p);
                acc_p = fmaf(qq.y, kv[e + 1], acc_p);
                acc_p = fmaf(qq.z, kv[e + 2], acc_p);
                acc_p = fmaf(qq.w, kv[e + 3], acc_p);
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < ROWS; ++j) part[j] = part[j] + part2[j];
      for (int o = P; o < 32; o <<= 1)
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
          part[j] = part[j] + __shfl_xor_sync(0xffffffffu, part[j], o);
      // online softmax, the reductions of all rows interleaved; lanes of a
      // position hold the same values, so reducing over P lanes suffices
      float sc[ROWS], pe[ROWS];
      bool live[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int qpos = ln - S + (row0 + j) / rep;
        live[j] = j < nr && first <= qpos;  // some position visible here
        const bool vis = live[j] && on && first + pl <= qpos;
        sc[j] = part[j] * sm_scale;
        if (softcap > 0.f) sc[j] = softcap * tanhf(sc[j] / softcap);
        pe[j] = vis ? sc[j] : -1e30f;
      }
      for (int o = 1; o < P; o <<= 1)
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
          pe[j] = fmaxf(pe[j], __shfl_xor_sync(0xffffffffu, pe[j], o));
      float corr[ROWS], ps[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int qpos = ln - S + (row0 + j) / rep;
        const bool vis = live[j] && on && first + pl <= qpos;
        const float m_new = live[j] ? fmaxf(m[j], pe[j]) : m[j];
        corr[j] = expf(m[j] - m_new);
        m[j] = m_new;
        pe[j] = vis ? expf(sc[j] - m_new) : 0.f;
        ps[j] = pe[j];
      }
      for (int o = 1; o < P; o <<= 1)
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
          ps[j] = ps[j] + __shfl_xor_sync(0xffffffffu, ps[j], o);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        if (!live[j]) continue;
        l[j] = corr[j] * l[j] + ps[j];
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[j][d] = corr[j] * acc[j][d];
      }
      // P.V over the positions some row of the block sees: the weights and
      // scales go through this warp's shared memory, four positions a read
      float* w = wts + warp * WTS;
      if (sh == 0) {
#pragma unroll
        for (int j = 0; j < ROWS; ++j) w[j * 32 + pl] = pe[j];
        w[ROWS * 32 + pl] = vscale;
      }
      __syncwarp();
      const int nvis = min(cnt, qpos_last - first + 1);
      for (int pp = 0; pp < nvis; pp += 4) {
        float4 w4[ROWS];
#pragma unroll
        for (int j = 0; j < ROWS; ++j) w4[j] = *reinterpret_cast<const float4*>(w + j * 32 + pp);
        const float4 s4 = *reinterpret_cast<const float4*>(w + ROWS * 32 + pp);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (pp + q >= nvis) break;  // rows past the length are never read
          const uint8_t* vrow = vb + (p0 + pp + q) * RS;
          const float vsc = (&s4.x)[q];
          float v[DPL];
#pragma unroll
          for (int d = 0; d < DPL; ++d)
            v[d] = (HD % 32 == 0 || d * 32 + lane < HD)
                       ? kv_value<KIND>(vrow, d * 32 + lane, tab, max_code, sshift, vsc)
                       : 0.f;
#pragma unroll
          for (int j = 0; j < ROWS; ++j) {
            if (j >= nr) break;
            const float wq = (&w4[j].x)[q];
#pragma unroll
            for (int d = 0; d < DPL; ++d) acc[j][d] = fmaf(wq, v[d], acc[j][d]);
          }
        }
      }
      __syncwarp();  // the next chunk rewrites the weights
    }
    __syncwarp();  // every lane is done with this stage before it refills
    if (more && nbuf == 1) stage(pg_next, 0);
    pg = pg_next, ks_cur = ks_next, vs_cur = vs_next;
  }

  // merge the four warps' states in warp order
  __syncthreads();
  float* mm = reinterpret_cast<float*>(pages);  // [WARPS][ROWS]
  float* ll = mm + WARPS * ROWS;                // [WARPS][ROWS]
  float* aa = ll + WARPS * ROWS;                // [WARPS][ROWS][HD]
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    if (j >= nr) continue;
    if (lane == 0) {
      mm[warp * ROWS + j] = m[j];
      ll[warp * ROWS + j] = l[j];
    }
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      if (HD % 32 == 0 || d * 32 + lane < HD)
        aa[(warp * ROWS + j) * HD + d * 32 + lane] = acc[j][d];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < (ROWS * HD + WARPS * 32 - 1) / (WARPS * 32); ++u) {
    const int e = threadIdx.x + u * WARPS * 32;
    if (e >= nr * HD) break;
    const int j = e / HD, d = e % HD;
    float mx = mm[j];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, mm[w * ROWS + j]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(mm[w * ROWS + j] - mx);
      den = den + ll[w * ROWS + j] * f;
      num = num + aa[(w * ROWS + j) * HD + d] * f;
    }
    const int i = row0 + j;
    const int s = i / rep, h = g * rep + i % rep;
    out[((static_cast<long long>(b) * S + s) * H + h) * HD + d] =
        num / fmaxf(den, 1e-30f);
  }
}

// dynamic shared memory of one launch with nbuf (1 or 2) stages a warp
// (the wrapper takes 2 where it fits the card's 227 KB, else 1)
REPRO_EXPORT long long repro_paged_attend_smem(int hd, int kv_dt, int page,
                                               int nbuf) {
  const int elem = kv_dt == DT_U8 ? 1 : (kv_dt == DT_BF16 ? 2 : 4);
  const long long rs = hd * elem + 16;
  const long long pages = static_cast<long long>(WARPS) * nbuf * 2 * page * rs;
  const long long merge = (2LL * WARPS * MAX_ROWS + WARPS * MAX_ROWS * hd) * 4;
  return (128 + MAX_ROWS * hd + WARPS * WTS) * 4 + (pages > merge ? pages : merge);
}

REPRO_EXPORT int repro_paged_attend(
    const void* q, int q_dt, const void* kp, const void* vp, int kv_dt,
    const void* ks, const void* vs, int s_dt, const int* block_table,
    const int* lengths, float* out, int B, int S, int H, int KV, int hd,
    int page, int max_pages, int bits, int gamma, float softcap,
    float sm_scale, int nbuf, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (nbuf != 1 && nbuf != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int nrows = S * (H / KV);
  const dim3 grid(B * KV, (nrows + MAX_ROWS - 1) / MAX_ROWS);
  const size_t smem = static_cast<size_t>(repro_paged_attend_smem(hd, kv_dt, page, nbuf));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define LAUNCH(HD, KIND, R)                                                  \
  {                                                                          \
    auto kern = paged_attend_kernel<HD, KIND, R>;                            \
    err = cudaFuncSetAttribute(kern,                                         \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                               static_cast<int>(smem));                      \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
    kern<<<grid, WARPS * 32, smem, st>>>(                                    \
        q, q_dt, kp, vp, ks, vs, s_dt, block_table, lengths, out, S, H, KV,  \
        page, max_pages, bits, static_cast<float>(gamma), softcap,           \
        sm_scale, nbuf);                                                     \
  }
#define BY_ROWS(HD, KIND) LAUNCH(HD, KIND, MAX_ROWS)
#define BY_KIND(HD)                                        \
  if (kv_dt == DT_U8) BY_ROWS(HD, KV_U8)                   \
  else if (kv_dt == DT_BF16) BY_ROWS(HD, KV_BF16)          \
  else BY_ROWS(HD, KV_F32)
  switch (hd) {
    case 16: BY_KIND(16); break;
    case 32: BY_KIND(32); break;
    case 64: BY_KIND(64); break;
    case 96: BY_KIND(96); break;
    case 112: BY_KIND(112); break;
    case 128: BY_KIND(128); break;
    case 256: BY_KIND(256); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BY_KIND
#undef BY_ROWS
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
