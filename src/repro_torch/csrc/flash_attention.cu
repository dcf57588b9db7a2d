// Block-space flash attention and paged decode for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (repro_torch/kernels/_cuda.py).
//
// Replaces (JAX package, Pallas):
//   flash_fwd_kernel    <- kernels/flash_attention.py::_attn_kernel and its
//                          gpu structure _gpu_flash_call (row bounds
//                          _row_bounds, tile math _attn_tile_update)
//   paged_decode_kernel <- kernels/flash_attention.py::_paged_attn_kernel
//                          and its gpu structure _gpu_paged_call
//
// flash_fwd_kernel: one CTA per (batch * head, query-block row), as the gpu
// structure's grid; an in-kernel loop over that row's key blocks
// [start, end] carries the online-softmax state.  The extent comes from
// the lowering: closed_form computes _row_bounds inline, prefetch_lut reads
// the host row_extents() table (int32 (m_q, 2) on the device), mma reads
// the same table built on the device by row_extents_chain, bounding
// walks [0, m_k - 1] and skips the tiles outside the block domain (the
// skipped tiles are the ones the JAX structure computes and discards, so
// the result is the same).  seq_pos[b] clamps end to pos // block_k and,
// under kind full with a window, raises start to
// max(pos - window + 1, 0) // block_k.  K/V tile kb is read at
// clip(kb - s0, 0, kv_blocks - 1) (compact KV).  GQA: q head h reads kv
// head h / (H / Hkv).
//
// paged_decode_kernel: one CTA per (slot, head); the loop runs from start
// to pos // page_size, reads page = page_table[slot, kb] and the fused
// (2, page_size, d) tile at pool rows 2 kvh (K) and 2 kvh + 1 (V), and runs
// the same tile_update() with block_q = 1, block_k = page_size, kind full.
//
// What bounds them on an H100 (80 GB HBM3 at 3.35 TB/s; 67 TFLOP/s f32
// outside the tensor cores, 989 TFLOP/s bf16 in them): prefill-sized
// attention is bound by operations (4 d flops per visited (query, key)
// pair), decode by bytes (each visited K/V tile read once per q head).
// This first kernel is simple rather than fast: scores and p v run in f32
// on the CUDA cores (no wgmma, no TMA), 8 warps own 4 query rows each per
// pass, K/V tiles are staged through shared memory 32 keys at a time (so
// d = 256 with 128-key tiles fits: 32 q rows + 32 keys + 32 x 128 scores
// of f32 = 97 KB), and a query block of more than 32 rows re-reads its K/V
// tiles once per pass (from L2).  The online softmax still updates once
// per schedule tile: all block_k scores of a tile are in shared memory
// before its row max is taken.  Decode (block_q = 1) keeps one warp busy
// per CTA; split-K is later work.

#include "attention_common.cuh"

namespace {

using namespace attn;

__device__ __forceinline__ bool in_domain(const AttnParams& p, int kb, int qb) {
  if (p.dom == kDomTriangular) return kb <= qb;
  if (p.dom == kDomBand)
    return kb <= qb + p.dom_off && kb > qb + p.dom_off - p.dom_w;
  return true;
}

// _row_bounds: the key-block extent of query-block row qb.
__device__ __forceinline__ void row_bounds(const AttnParams& p, int qb,
                                           int& start, int& end) {
  if (p.kind == kCausal) {
    start = 0;
    end = qb;
  } else if (p.kind == kLocal) {
    const int wb = p.window / p.block_k + 1;
    const int off_b = p.off / p.block_q;
    start = max(qb + off_b - (wb - 1), 0);
    end = qb + off_b;
  } else {
    start = 0;
    end = p.m_k - 1;
  }
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(AttnParams p, const T* __restrict__ q,
                 const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ ext, const int* __restrict__ pos_vec,
                 T* __restrict__ o) {
  extern __shared__ float smem[];
  const Smem sm = smem_layout(smem, p.d);
  const long long cta = blockIdx.x;
  const int bh = (int)(cta / p.m_q), qb = (int)(cta % p.m_q);
  const int b = bh / p.h, kvh = (bh % p.h) / (p.h / p.hkv);

  int start, end;
  if (p.lowering == kPrefetchLut || p.lowering == kMma) {
    start = ext[2 * qb];
    end = ext[2 * qb + 1];
  } else if (p.lowering == kBounding) {
    start = 0;
    end = p.m_k - 1;
  } else {
    row_bounds(p, qb, start, end);
  }
  int pos = 0;
  if (p.has_pos) {
    pos = pos_vec[b];
    end = min(end, floor_div(pos, p.block_k));
    if (p.kind == kFull && p.window)
      start = max(start, floor_div(max(pos - p.window + 1, 0), p.block_k));
  }

  const size_t q_off = ((size_t)bh * p.sq + (size_t)qb * p.block_q) * p.d;
  const size_t kv_head = ((size_t)b * p.hkv + kvh) * p.sk_arr;
  RowState<DPL> st;
  for (int row0 = 0; row0 < p.block_q; row0 += kRowsPerPass) {
    const int nrows = min(kRowsPerPass, p.block_q - row0);
    load_q(sm, q + q_off, row0, nrows, p.d, p.scale);
    st.reset();
    for (int kb = start; kb <= end; ++kb) {
      if (p.lowering == kBounding && !in_domain(p, kb, qb)) continue;
      const int kv = min(max(kb - p.s0, 0), p.kv_blocks - 1);
      const size_t t_off = (kv_head + (size_t)kv * p.block_k) * p.d;
      tile_update<T, DPL>(p, sm, k + t_off, v + t_off, kb,
                          p.off + qb * p.block_q + row0, nrows, pos, st);
    }
    store_rows<T, DPL>(o + q_off, row0, nrows, p.d, st);
  }
}

// p.m_k is the page table's width (max_pages), p.block_k the page size.
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(AttnParams p, const T* __restrict__ q,
                    const T* __restrict__ pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ pos_vec, T* __restrict__ o) {
  extern __shared__ float smem[];
  const Smem sm = smem_layout(smem, p.d);
  const int bh = blockIdx.x;
  const int slot = bh / p.h, kvh = (bh % p.h) / (p.h / p.hkv);
  const int pos = pos_vec[slot];
  int start = 0;
  if (p.window)
    start = floor_div(max(pos - p.window + 1, 0), p.block_k);
  // pages past the table's width are never read (a position there is a
  // caller's error; the contiguous kernel clamps the same way at m_k - 1)
  const int end = min(floor_div(pos, p.block_k), p.m_k - 1);

  const size_t q_off = (size_t)bh * p.d;
  const size_t tile = (size_t)p.block_k * p.d;
  RowState<DPL> st;
  load_q(sm, q + q_off, 0, 1, p.d, p.scale);
  st.reset();
  for (int kb = start; kb <= end; ++kb) {
    const int page = page_table[(size_t)slot * p.m_k + kb];
    const T* kt = pool + ((size_t)page * 2 * p.hkv + 2 * kvh) * tile;
    tile_update<T, DPL>(p, sm, kt, kt + tile, kb, 0, 1, pos, st);
  }
  store_rows<T, DPL>(o + q_off, 0, 1, p.d, st);
}

// Opt in to more than 48 KB of dynamic shared memory once per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int DPL>
int launch_flash(const AttnParams& p, const T* q, const T* k, const T* v,
                 const int* ext, const int* pos, T* o, cudaStream_t s) {
  const size_t bytes = smem_floats(p.d, p.block_k) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, DPL>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  const long long ctas = (long long)p.b * p.h * p.m_q;
  kernel<<<(unsigned)ctas, kThreads, bytes, s>>>(p, q, k, v, ext, pos, o);
  return (int)cudaGetLastError();
}

template <typename T, int DPL>
int launch_paged(const AttnParams& p, const T* q, const T* pool,
                 const int* table, const int* pos, T* o, cudaStream_t s) {
  const size_t bytes = smem_floats(p.d, p.block_k) * sizeof(float);
  auto kernel = paged_decode_kernel<T, DPL>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)(p.b * p.h), kThreads, bytes, s>>>(p, q, pool, table,
                                                         pos, o);
  return (int)cudaGetLastError();
}

// The acc columns a lane holds: d <= 32 DPL.
template <typename T>
int flash(const long long* params, float scale, const void* q, const void* k,
          const void* v, const int* ext, const int* pos, void* o,
          cudaStream_t s) {
  const AttnParams p = make_params(params, scale);
  const T *qq = static_cast<const T*>(q), *kk = static_cast<const T*>(k),
          *vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  if (p.d <= 32) return launch_flash<T, 1>(p, qq, kk, vv, ext, pos, oo, s);
  if (p.d <= 64) return launch_flash<T, 2>(p, qq, kk, vv, ext, pos, oo, s);
  if (p.d <= 128) return launch_flash<T, 4>(p, qq, kk, vv, ext, pos, oo, s);
  if (p.d <= 256) return launch_flash<T, 8>(p, qq, kk, vv, ext, pos, oo, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int paged(const long long* params, float scale, const void* q,
          const void* pool, const int* table, const int* pos, void* o,
          cudaStream_t s) {
  const AttnParams p = make_params(params, scale);
  const T *qq = static_cast<const T*>(q), *pp = static_cast<const T*>(pool);
  T* oo = static_cast<T*>(o);
  if (p.d <= 32) return launch_paged<T, 1>(p, qq, pp, table, pos, oo, s);
  if (p.d <= 64) return launch_paged<T, 2>(p, qq, pp, table, pos, oo, s);
  if (p.d <= 128) return launch_paged<T, 4>(p, qq, pp, table, pos, oo, s);
  if (p.d <= 256) return launch_paged<T, 8>(p, qq, pp, table, pos, oo, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// o = flash attention of q (B, H, Sq, d) over k, v (B, Hkv, Sk_arr, d),
// all contiguous and of one dtype; params: ATTN_PARAMS order.  ext: the
// (m_q, 2) int32 row extents under prefetch_lut, else null.  pos: the (B,)
// int32 decode positions when params[kHasPos], else null.
int fa_forward_f32(const long long* params, float scale, const void* q,
                   const void* k, const void* v, const int* ext,
                   const int* pos, void* o, void* stream) {
  return flash<float>(params, scale, q, k, v, ext, pos, o,
                      static_cast<cudaStream_t>(stream));
}

int fa_forward_bf16(const long long* params, float scale, const void* q,
                    const void* k, const void* v, const int* ext,
                    const int* pos, void* o, void* stream) {
  return flash<__nv_bfloat16>(params, scale, q, k, v, ext, pos, o,
                              static_cast<cudaStream_t>(stream));
}

// o (B, H, 1, d) = single-token decode of q (B, H, 1, d) through the
// (B, max_pages) int32 page table into the fused pool
// (P, 2 Hkv, page_size, d); pos: (B,) int32.
int fa_paged_decode_f32(const long long* params, float scale, const void* q,
                        const void* pool, const int* table, const int* pos,
                        void* o, void* stream) {
  return paged<float>(params, scale, q, pool, table, pos, o,
                      static_cast<cudaStream_t>(stream));
}

int fa_paged_decode_bf16(const long long* params, float scale, const void* q,
                         const void* pool, const int* table, const int* pos,
                         void* o, void* stream) {
  return paged<__nv_bfloat16>(params, scale, q, pool, table, pos, o,
                              static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one CTA of either kernel at (d, block_k).
long long fa_smem_bytes(int d, int block_k) {
  return (long long)(smem_floats(d, block_k) * sizeof(float));
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
