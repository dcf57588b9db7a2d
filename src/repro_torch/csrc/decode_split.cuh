// The split-K single-token decode routine that both decode kernels of
// csrc/flash_attention.cu run: flash_decode_kernel (contiguous caches,
// B4's seq_pos decode) and paged_decode_kernel (the paged pool, B5).
// Each front end hands it a tile-address functor; everything that decides
// the float result -- which keys a worker takes, the order of every sum,
// the merges -- lives here, so paged decode is bit-equal to contiguous
// decode at block_k == page_size.
//
// What it computes (the JAX package's _attn_kernel at block_q = 1 through
// seq_pos, and _paged_attn_kernel): for each (slot, q head) one query
// attends over key blocks [start, end] (end = pos // block_k, start =
// max(pos - window + 1, 0) // block_k with a window); keys past pos, or at
// or before pos - window, are masked; out = acc / l (l == 0 -> 1).
//
// What bounds it on an H100: bytes.  Each visited K/V row is 2 d values,
// against 4 d flops per q head, far below the card's 67 TFLOP/s f32 over
// 3.35 TB/s.  So the design reads each K/V byte once per kv head and keeps
// enough of them in flight:
//
//   * one CTA per (slot, kv head, head chunk, split): the CTA serves the
//     whole GQA group (up to kMaxGroup q heads; a larger group runs in
//     chunks of kMaxGroup), so every q head of the group reads the rows the
//     CTA loads once, in 16-byte loads (or element loads when the rows are
//     not 16-byte aligned: the same values land in the same lanes);
//   * split j covers key blocks [j T, j T + T - 1] intersected with
//     [start, end], T = split_blocks(block_k) = kSplitKeys / block_k (at
//     least 1).  The rule depends only on the key block, block_k, pos and
//     the window, never on the table's width, the batch, the grid or the
//     SM count; splits outside [start / T, end / T] exit at once;
//   * inside a CTA, warp w takes batches of kpw * kR keys (kpw = 32 / lpk
//     keys a load, lpk lanes covering a row), batch b of the warp starting
//     at key (b kWarps + w) kpw kR of the split; each warp keeps its own
//     online state (m, l, acc) and updates it once per batch (one max, one
//     rescale); keys that are masked, past the split or outside the domain
//     are not loaded and add nothing (a warp with no live key keeps m =
//     -1e30, l = 0, acc = 0, and so merges to nothing: no (-inf) - (-inf));
//   * the warps merge through shared memory in warp order, the splits in
//     split order, both as M = max m_i, c_i = exp(m_i - M), l = sum c_i
//     l_i, acc = sum c_i acc_i.  With one live split the CTA writes out
//     directly (the merge of one part is that part, bit for bit); else it
//     stores its part, and the last CTA of the (slot, kv head, chunk) to
//     arrive (__threadfence, then an atomic counter) merges every part and
//     resets the counter to 0 for the next call: one launch per call.
//
// The rows of a batch load straight into registers, all issued before
// the first use; streaming them through a cp.async ring in shared memory
// (async_ring.cuh) was measured at gemma3-12b's decode shape and gained
// nothing, so the routine keeps no ring.  Every float operation is an
// explicit round-to-nearest intrinsic (see attention_common.cuh) or, for
// the batch loop's exp, the SFU's ex2.approx (exp_f32), so the two front
// ends cannot be contracted differently.  Key positions stay below 2^24
// (the wrappers refuse more): the key block comes from an f32 quotient.
#pragma once

#include <cstdint>

#include "attention_common.cuh"

namespace attn {
namespace dec {

constexpr int kSplitKeys = 256;  // keys per split (the span of T blocks)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 8;     // q heads one CTA serves at most

// Key blocks per split: the span in keys over block_k, at least one.
__host__ __device__ inline int split_blocks(int block_k) {
  return block_k >= kSplitKeys ? 1 : kSplitKeys / block_k;
}

// The launch geometry, from the head counts, the head dim and the tiles.
struct DecodeArgs {
  int nsplit;  // splits launched per (slot, kv head, head chunk)
  int group;   // q heads per kv head, H / Hkv
  int kg;      // q heads per chunk as instantiated: 2 or kMaxGroup
  int hc;      // head chunks per kv head
  int lpk;     // lanes that cover one K/V row (a power of two, <= 32)
  int cpl;     // 16-byte chunks of a row per lane (1, or 2 for f32 d > 128)
  int vec;     // rows 16-byte aligned: one 16-byte load per chunk
};

__host__ inline DecodeArgs make_args(const AttnParams& p, int elt_bytes,
                                     bool vec) {
  DecodeArgs a;
  const int per_chunk = 16 / elt_bytes;
  const int chunks = (p.d + per_chunk - 1) / per_chunk;
  a.group = p.h / p.hkv;
  a.kg = a.group <= 2 ? 2 : kMaxGroup;
  a.hc = (a.group + a.kg - 1) / a.kg;
  a.lpk = 1;
  while (a.lpk < chunks && a.lpk < 32) a.lpk *= 2;
  a.cpl = (chunks + a.lpk - 1) / a.lpk;
  const int t = split_blocks(p.block_k);
  a.nsplit = (p.m_k + t - 1) / t;
  a.vec = vec && (p.d * elt_bytes) % 16 == 0;
  return a;
}

// Floats of split parts and ints of counters one launch needs.
__host__ inline long long part_floats(const AttnParams& p,
                                      const DecodeArgs& a) {
  return (long long)p.b * p.hkv * a.hc * a.nsplit * a.kg * (p.d + 2);
}
__host__ inline long long counters(const AttnParams& p, const DecodeArgs& a) {
  return (long long)p.b * p.hkv * a.hc;
}

// Key rounds of a warp's batch: 4, or 2 where a lane holds many values.
constexpr __host__ __device__ int rounds(int kg, int cpl) {
  return kg * cpl >= 8 ? 2 : 4;
}

// Dynamic shared memory of one CTA: per warp and head m, l and the merge
// weight, the CTA's m and l per head, and per warp and head acc over d.
__host__ __device__ inline size_t smem_bytes(int kg, int d) {
  return ((size_t)3 * kWarps * kg + 2 * kg + (size_t)kWarps * kg * d) *
         sizeof(float);
}

// -- rows as raw 16-byte chunks ---------------------------------------------

__device__ __forceinline__ unsigned raw_bits(const float* p) {
  return __float_as_uint(*p);
}
__device__ __forceinline__ unsigned raw_bits(const __nv_bfloat16* p) {
  return (unsigned)__bfloat16_as_ushort(*p);
}

// Values [e0, e0 + 16 / sizeof(T)) of a row as 16 raw bytes, zeros past d:
// one 16-byte load when vec, else one load per value (the same bytes).
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ row,
                                            int e0, int d, bool vec) {
  constexpr int n = 16 / sizeof(T);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (e0 >= d) return r;
  if (vec) return *reinterpret_cast<const uint4*>(row + e0);
  unsigned* w = &r.x;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    if (e0 + i < d) {
      const unsigned bits = raw_bits(row + e0 + i);
      if (sizeof(T) == 4)
        w[i] = bits;
      else
        w[i >> 1] |= bits << (16 * (i & 1));
    }
  }
  return r;
}

// Value i of a chunk as f32 (bf16 widens exactly).
template <typename T>
__device__ __forceinline__ float elem(const uint4& c, int i);
template <>
__device__ __forceinline__ float elem<float>(const uint4& c, int i) {
  return __uint_as_float((&c.x)[i]);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& c, int i) {
  const unsigned w = (&c.x)[i >> 1];
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// The routine.  Tiles: member(kb) (whether key block kb is visited) and
// rows(kb, off, krow, vrow) (row `off` of key block kb in K and V).  q and
// o point at the chunk's first q head of the slot ((heads, d) rows);
// [start, end] is the key-block extent after the seq_pos clamp; pidx
// indexes the (slot, kv head, chunk) counter and parts; j is the split.
template <typename T, int kG, int kCpl, typename Tiles>
__device__ __forceinline__ void decode_split(
    const AttnParams& p, const DecodeArgs& a, const Tiles& tiles,
    const T* __restrict__ q, T* __restrict__ o, int gn, int start, int end,
    int pos, int pidx, int j, float* __restrict__ part,
    int* __restrict__ cnt) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kEpl = kCpl * kVec;  // values of a row per lane
  constexpr int kR = rounds(kG, kCpl);
  extern __shared__ __align__(16) float dsm[];
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d = p.d, bk = p.block_k;

  if (start > end) {  // no key at all: out = 0 / 1
    if (j == 0)
      for (int i = tid; i < gn * d; i += kThreads) o[i] = from_f32<T>(0.0f);
    return;
  }
  const int t = split_blocks(bk);
  const int j_lo = start / t, j_hi = end / t;
  if (j < j_lo || j > j_hi) return;
  const int n_live = j_hi - j_lo + 1;
  const int tlo = max(start, j * t), thi = min(end, j * t + t - 1);
  const int k0 = tlo * bk, nkeys = (thi - tlo + 1) * bk;

  const int lpk = a.lpk, kpw = 32 / lpk;
  const int u = lane / lpk, li = lane & (lpk - 1);
  const bool vec = a.vec != 0;

  // the chunk's q heads, pre-scaled in f32 (as load_q), zero past gn and d
  float qr[kG][kEpl];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int c = 0; c < kCpl; ++c)
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int e = (li + c * lpk) * kVec + i;
        qr[g][c * kVec + i] =
            g < gn && e < d ? __fmul_rn(to_f32(q[(size_t)g * d + e]), p.scale)
                            : 0.0f;
      }

  float m[kG], l[kG], acc[kG][kEpl];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < kEpl; ++e) acc[g][e] = 0.0f;
  }

  // key block of key position kpos without an integer division: the f32
  // quotient is within one of it below 2^24 keys
  const float inv_bk = __frcp_rn((float)bk);
  auto block_of = [&](int kpos) {
    int kb = __float2int_rz(__fmul_rn((float)kpos, inv_bk));
    if (kb * bk > kpos) --kb;
    else if ((kb + 1) * bk <= kpos) ++kb;
    return kb;
  };

  const int kpb = kpw * kR;  // keys of a batch
  for (int base = warp * kpb; base < nkeys; base += kWarps * kpb) {
    // -- the batch's K and V rows, all loads issued before any use ------
    uint4 kc[kR][kCpl], vc[kR][kCpl];
    bool live[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = base + r * kpw + u;
      const int kpos = k0 + i;
      const int kb = block_of(kpos);
      live[r] = i < nkeys && key_live(p, 0, kpos, pos) && tiles.member(kb);
      const T* krow = nullptr;
      const T* vrow = nullptr;
      if (live[r]) tiles.rows(kb, kpos - kb * bk, krow, vrow);
#pragma unroll
      for (int c = 0; c < kCpl; ++c) {
        const int e0 = (li + c * lpk) * kVec;
        kc[r][c] = live[r] ? load_chunk(krow, e0, d, vec)
                           : make_uint4(0u, 0u, 0u, 0u);
        vc[r][c] = live[r] ? load_chunk(vrow, e0, d, vec)
                           : make_uint4(0u, 0u, 0u, 0u);
      }
    }

    // -- scores: lane partials over its values, then over the row's lanes
    float s[kR][kG];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < kCpl; ++c)
#pragma unroll
          for (int i = 0; i < kVec; ++i)
            dot = __fmaf_rn(qr[g][c * kVec + i], elem<T>(kc[r][c], i), dot);
        for (int off = lpk >> 1; off > 0; off >>= 1)
          dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, off));
        s[r][g] = live[r] ? dot : kNegInf;
      }

    // -- one online-softmax step per head over the whole batch ----------
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mb = kNegInf;
#pragma unroll
      for (int r = 0; r < kR; ++r) mb = fmaxf(mb, s[r][g]);
      for (int off = lpk; off < 32; off <<= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      const float m_new = fmaxf(m[g], mb);
      const float alpha = exp_f32(__fsub_rn(m[g], m_new));
      float pr[kR], psum = 0.0f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        pr[r] = live[r] ? exp_f32(__fsub_rn(s[r][g], m_new)) : 0.0f;
        psum = __fadd_rn(psum, pr[r]);
      }
      for (int off = lpk; off < 32; off <<= 1)
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, off));
      l[g] = __fmaf_rn(alpha, l[g], psum);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < kCpl; ++c)
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          float pv = 0.0f;
#pragma unroll
          for (int r = 0; r < kR; ++r)
            pv = __fmaf_rn(pr[r], elem<T>(vc[r][c], i), pv);
          acc[g][c * kVec + i] = __fmaf_rn(acc[g][c * kVec + i], alpha, pv);
        }
    }
  }

  // -- the warp's acc: its key groups (lanes li, li + lpk, ...) summed --
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < kEpl; ++e)
      for (int off = lpk; off < 32; off <<= 1)
        acc[g][e] = __fadd_rn(acc[g][e],
                              __shfl_xor_sync(0xffffffffu, acc[g][e], off));

  // -- the warps merge through shared memory in warp order --------------
  float* wm = dsm;                    // kWarps x kG
  float* wl = wm + kWarps * kG;       // kWarps x kG
  float* coef = wl + kWarps * kG;     // kWarps x kG
  float* cm = coef + kWarps * kG;     // kG: the CTA's m
  float* cl = cm + kG;                // kG: the CTA's l
  float* wacc = cl + kG;              // kWarps x kG x d
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      wm[warp * kG + g] = m[g];
      wl[warp * kG + g] = l[g];
    }
  }
  if (u == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int c = 0; c < kCpl; ++c)
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const int e = (li + c * lpk) * kVec + i;
          if (g < gn && e < d)
            wacc[(size_t)(warp * kG + g) * d + e] = acc[g][c * kVec + i];
        }
  }
  __syncthreads();
  if (tid < gn) {
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kG + tid]);
    float lt = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(__fsub_rn(wm[w * kG + tid], mx));
      coef[w * kG + tid] = c;
      lt = __fmaf_rn(c, wl[w * kG + tid], lt);
    }
    cm[tid] = mx;
    cl[tid] = lt;
  }
  __syncthreads();

  const int stride = kG * (d + 2);  // one split's part: per head m, l, acc
  float* mine = part + ((size_t)pidx * a.nsplit + j) * stride;
  for (int idx = tid; idx < gn * d; idx += kThreads) {
    const int g = idx / d, e = idx - g * d;
    float at = 0.0f;
    for (int w = 0; w < kWarps; ++w)
      at = __fmaf_rn(coef[w * kG + g], wacc[(size_t)(w * kG + g) * d + e], at);
    if (n_live == 1) {
      const float lt = cl[g] == 0.0f ? 1.0f : cl[g];
      o[(size_t)g * d + e] = from_f32<T>(__fdiv_rn(at, lt));
    } else {
      mine[g * (d + 2) + 2 + e] = at;
      if (e == 0) {
        mine[g * (d + 2)] = cm[g];
        mine[g * (d + 2) + 1] = cl[g];
      }
    }
  }
  if (n_live == 1) return;

  // -- the last CTA to arrive merges the splits in split order ----------
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(cnt + pidx, 1) == n_live - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* parts = part + (size_t)pidx * a.nsplit * stride;
  for (int idx = tid; idx < gn * d; idx += kThreads) {
    const int g = idx / d, e = idx - g * d;
    float mx = kNegInf;
#pragma unroll 4
    for (int sj = j_lo; sj <= j_hi; ++sj)
      mx = fmaxf(mx, __ldcg(parts + (size_t)sj * stride + g * (d + 2)));
    float lt = 0.0f, at = 0.0f;
#pragma unroll 4
    for (int sj = j_lo; sj <= j_hi; ++sj) {
      const float* ps = parts + (size_t)sj * stride + g * (d + 2);
      const float c = expf(__fsub_rn(__ldcg(ps), mx));
      lt = __fmaf_rn(c, __ldcg(ps + 1), lt);
      at = __fmaf_rn(c, __ldcg(ps + 2 + e), at);
    }
    if (lt == 0.0f) lt = 1.0f;
    o[(size_t)g * d + e] = from_f32<T>(__fdiv_rn(at, lt));
  }
  if (tid == 0) atomicExch(cnt + pidx, 0);
}

}  // namespace dec
}  // namespace attn
