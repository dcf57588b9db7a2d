// Shared pieces of the attention kernels (csrc/flash_attention.cu): the
// launch parameters, the masks, and the shared-memory layout and online-
// softmax tile update of the CUDA-core flash kernel (flash_fwd_kernel).
// The decode kernels' routine is decode_split.cuh.
//
// Every float operation of the update is an explicit round-to-nearest
// intrinsic (__fmaf_rn, __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn): nvcc
// cannot contract them differently in two kernels that inline the same
// code, which is what keeps the paged decode bit-equal to the contiguous
// seq_pos decode at block_k == page_size (decode_split.cuh does the same).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace attn {

// Masked scores hold -1e30, not -inf, exactly as the JAX package's kernel
// (kernels/flash_attention.py NEG_INF): a tile that is wholly masked at
// the start of a row then gives m = -1e30 and p = exp(0) = 1, and the next
// live tile's alpha = exp(-1e30 - m) = 0 wipes that.
constexpr float kNegInf = -1e30f;

// One CTA: 8 warps; each warp owns 4 query rows of a pass, so a pass
// covers 32 rows of the query block.  K and V tiles are staged through
// shared memory 32 keys at a time (as f32, one padding column so the
// lane-per-key score loop reads without bank conflicts).
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerPass = kWarps * kRowsPerWarp;
constexpr int kChunk = 32;

// Order of the integer launch parameters (ATTN_PARAMS in
// repro_torch/kernels/flash_attention.py).
enum Param {
  kB, kH, kHkv, kSq, kD, kBlockQ, kBlockK, kMq, kMk, kKind, kWindow, kOff,
  kS0, kKvBlocks, kSkArr, kLowering, kDom, kDomW, kDomOff, kHasPos,
  kNumParams
};

enum Kind { kCausal = 0, kLocal = 1, kFull = 2 };
// kMma reads its extents operand like kPrefetchLut: the table is built on
// the device by core/mma.py row_extents_chain (membership matmuls).
enum Lowering { kClosedForm = 0, kPrefetchLut = 1, kBounding = 2, kMma = 3 };
// Membership of a key block under the bounding lowering: every block,
// the causal triangle, or the band of a BandDomain.
enum Dom { kDomAll = 0, kDomTriangular = 1, kDomBand = 2 };

// One rank's query-block band of a sharded launch (the tile paths' kShard
// instantiations; kernels/flash_attention.py RowBand.c_params): band row l
// is global row row_lo + l ("rows", part 1), or the causal snake's
// (l / 2) 2D + (rank if l is even, else 2D - 1 - rank) ("zigzag", part 2;
// core/shard.py _zz_global_row).
struct RowShard {
  int part, row_lo, rank, two_d;
  __device__ __forceinline__ int global(int l) const {
    if (part == 2)
      return (l / 2) * two_d + ((l & 1) == 0 ? rank : two_d - 1 - rank);
    return row_lo + l;
  }
};

inline RowShard make_row_shard(const long long* a) {
  RowShard r;
  r.part = (int)a[0];
  r.row_lo = (int)a[1];
  r.rank = (int)a[2];
  r.two_d = (int)a[3];
  return r;
}

struct AttnParams {
  int b, h, hkv, sq, d, block_q, block_k, m_q, m_k, kind, window, off, s0,
      kv_blocks, sk_arr, lowering, dom, dom_w, dom_off, has_pos;
  float scale;
};

inline AttnParams make_params(const long long* a, float scale) {
  AttnParams p;
  p.b = (int)a[kB];
  p.h = (int)a[kH];
  p.hkv = (int)a[kHkv];
  p.sq = (int)a[kSq];
  p.d = (int)a[kD];
  p.block_q = (int)a[kBlockQ];
  p.block_k = (int)a[kBlockK];
  p.m_q = (int)a[kMq];
  p.m_k = (int)a[kMk];
  p.kind = (int)a[kKind];
  p.window = (int)a[kWindow];
  p.off = (int)a[kOff];
  p.s0 = (int)a[kS0];
  p.kv_blocks = (int)a[kKvBlocks];
  p.sk_arr = (int)a[kSkArr];
  p.lowering = (int)a[kLowering];
  p.dom = (int)a[kDom];
  p.dom_w = (int)a[kDomW];
  p.dom_off = (int)a[kDomOff];
  p.has_pos = (int)a[kHasPos];
  p.scale = scale;
  return p;
}

// Dynamic shared memory of one CTA: the pre-scaled query rows of a pass,
// one K or V chunk, and the scores (then probabilities) of the pass's rows
// over one key tile.
__host__ __device__ inline size_t smem_floats(int d, int block_k) {
  return (size_t)kRowsPerPass * d + (size_t)kChunk * (d + 1) +
         (size_t)kRowsPerPass * block_k;
}

struct Smem {
  float* q;   // kRowsPerPass x d
  float* kv;  // kChunk x (d + 1)
  float* s;   // kRowsPerPass x block_k
};

__device__ __forceinline__ Smem smem_layout(float* base, int d) {
  Smem sm;
  sm.q = base;
  sm.kv = base + (size_t)kRowsPerPass * d;
  sm.s = sm.kv + (size_t)kChunk * (d + 1);
  return sm;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

constexpr float kLog2e = 1.4426950408889634f;

// e^x as 2^(x log2 e) on the SFU (ex2.approx: relative error ~2^-22,
// denormal results flushed to 0; exactly 1 at x = 0, and 0 at
// -1e30 - m).
__device__ __forceinline__ float exp_f32(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmul_rn(x, kLog2e)));
  return y;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

// Online-softmax state of the rows a warp owns in one pass (every lane
// holds the whole m and l, and the acc columns lane + 32 i).
template <int DPL>
struct RowState {
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      m[r] = kNegInf;
      l[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;
    }
  }
};

// Stage rows [c0, c0 + nk) of a (block_k, d) tile into sm.kv as f32.
template <typename T>
__device__ __forceinline__ void stage_chunk(const Smem& sm,
                                            const T* __restrict__ tile, int c0,
                                            int nk, int d) {
  const T* src = tile + (size_t)c0 * d;
  for (int e = threadIdx.x; e < nk * d; e += kThreads) {
    const int j = e / d;
    sm.kv[j * (d + 1) + (e - j * d)] = to_f32(src[e]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The masks of the JAX package's _attn_tile_update: whether key position
// kpos is live for query position qpos.  kind causal / local compare the
// two positions; with seq_pos (has_pos) keys past pos are masked, and
// under kind full a nonzero window also masks keys at or before
// pos - window.  Every flash kernel and both decode kernels test keys here.
__device__ __forceinline__ bool key_live(const AttnParams& p, int qpos,
                                         int kpos, int pos) {
  bool live = true;
  if (p.kind != kFull) {
    live = kpos <= qpos;
    if (p.kind == kLocal) live = live && kpos > qpos - p.window;
  }
  if (p.has_pos) {
    bool pm = kpos <= pos;
    if (p.kind == kFull && p.window) pm = pm && kpos > pos - p.window;
    live = live && pm;
  }
  return live;
}

// Whether every key of [kmin, kmax] is live for every query of
// [qmin, qmax]: each mask keeps a key range that moves up with the query,
// so the two corners decide.
__device__ __forceinline__ bool keys_all_live(const AttnParams& p, int qmin,
                                              int qmax, int kmin, int kmax,
                                              int pos) {
  return key_live(p, qmin, kmax, pos) && key_live(p, qmax, kmin, pos);
}

// One online-softmax step over key tile kb for the rows of the current
// pass (the JAX package's _attn_tile_update):
//
//   s      = q k^T             (q pre-scaled f32, k f32; d-sequential fma)
//   s      = where(mask, s, -1e30)
//   m_new  = max(m, rowmax(s));  p = exp(s - m_new);  alpha = exp(m - m_new)
//   l      = alpha l + rowsum(p);  acc = acc alpha + p v
//
// mask: key_live() of the key position and the query position
// qpos0 + row0 + i.  kt and vt point at the tile's (block_k, d) rows.  Called
// by every thread of the CTA (it synchronises); rows >= nrows compute
// nothing that is stored.
template <typename T, int DPL>
__device__ __forceinline__ void tile_update(const AttnParams& p, const Smem& sm,
                                            const T* __restrict__ kt,
                                            const T* __restrict__ vt, int kb,
                                            int qpos0, int nrows, int pos,
                                            RowState<DPL>& st) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = p.d, bk = p.block_k;
  const int row_base = warp * kRowsPerWarp;
  const bool busy = row_base < nrows;

  // -- scores, one key per lane, staged 32 keys at a time ----------------
  for (int c0 = 0; c0 < bk; c0 += kChunk) {
    const int nk = min(kChunk, bk - c0);
    __syncthreads();  // the previous chunk's readers are done
    stage_chunk(sm, kt, c0, nk, d);
    __syncthreads();
    if (busy && lane < nk) {
      float s[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.0f;
      const float* krow = sm.kv + lane * (d + 1);
      const float* qrow = sm.q + (size_t)row_base * d;
      for (int dd = 0; dd < d; ++dd) {
        const float kd = krow[dd];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          s[r] = __fmaf_rn(qrow[r * d + dd], kd, s[r]);
      }
      const int kpos = kb * bk + c0 + lane;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const bool live = key_live(p, qpos0 + row_base + r, kpos, pos);
        sm.s[(size_t)(row_base + r) * bk + c0 + lane] = live ? s[r] : kNegInf;
      }
    }
  }
  __syncthreads();

  // -- row statistics; probabilities replace the scores in place ---------
  // Lane L owns keys L, L + 32, ...: the same lane wrote them above.
  float alpha[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    alpha[r] = 1.0f;
    if (!busy) continue;
    float* srow = sm.s + (size_t)(row_base + r) * bk;
    float mx = -INFINITY;
    for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, srow[j]);
    const float m_new = fmaxf(st.m[r], warp_max(mx));
    float sum = 0.0f;
    for (int j = lane; j < bk; j += 32) {
      const float pj = expf(__fsub_rn(srow[j], m_new));
      srow[j] = pj;
      sum = __fadd_rn(sum, pj);
    }
    sum = warp_sum(sum);
    alpha[r] = expf(__fsub_rn(st.m[r], m_new));
    st.l[r] = __fadd_rn(__fmul_rn(alpha[r], st.l[r]), sum);
    st.m[r] = m_new;
  }

  // -- p v, the acc columns lane + 32 i, staged 32 keys at a time ---------
  float pv[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) pv[r][i] = 0.0f;
  for (int c0 = 0; c0 < bk; c0 += kChunk) {
    const int nk = min(kChunk, bk - c0);
    __syncthreads();  // the probabilities are written; sm.kv is free
    stage_chunk(sm, vt, c0, nk, d);
    __syncthreads();
    if (!busy) continue;
    for (int j = 0; j < nk; ++j) {
      const float* vrow = sm.kv + j * (d + 1);
      float vj[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int dd = lane + 32 * i;
        vj[i] = dd < d ? vrow[dd] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = sm.s[(size_t)(row_base + r) * bk + c0 + j];
#pragma unroll
        for (int i = 0; i < DPL; ++i) pv[r][i] = __fmaf_rn(pj, vj[i], pv[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      st.acc[r][i] = __fmaf_rn(st.acc[r][i], alpha[r], pv[r][i]);
}

// Load the pre-scaled f32 query rows [row0, row0 + nrows) of a query block
// (rows of d values starting at q_block) into sm.q; rows past nrows are 0.
template <typename T>
__device__ __forceinline__ void load_q(const Smem& sm,
                                       const T* __restrict__ q_block, int row0,
                                       int nrows, int d, float scale) {
  __syncthreads();  // the previous pass's readers of sm.q are done
  const T* src = q_block + (size_t)row0 * d;
  for (int e = threadIdx.x; e < kRowsPerPass * d; e += kThreads)
    sm.q[e] = e < nrows * d ? __fmul_rn(to_f32(src[e]), scale) : 0.0f;
  __syncthreads();
}

// out = acc / l (l == 0 -> 1) for the warp's rows of the pass.
template <typename T, int DPL>
__device__ __forceinline__ void store_rows(T* __restrict__ o_block, int row0,
                                           int nrows, int d,
                                           const RowState<DPL>& st) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = warp * kRowsPerWarp + r;
    if (i >= nrows) continue;
    const float l = st.l[r] == 0.0f ? 1.0f : st.l[r];
    T* dst = o_block + (size_t)(row0 + i) * d;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int dd = lane + 32 * c;
      if (dd < d) dst[dd] = from_f32<T>(__fdiv_rn(st.acc[r][c], l));
    }
  }
}

}  // namespace attn
