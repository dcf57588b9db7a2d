// The async-copy ring of the JAX package's _dma kernels
// (core/backend.py::stream_tiles) in its Hopper form: 16-byte
// cp.async.cg copies from global into shared memory, committed one group
// per ring step and waited on with wait_group.
//
// The ring of `stages` slots runs as stream_tiles does: a prologue issues
// the copies of steps 0 .. stages - 2 (one commit group each, empty groups
// included, so the count of pending groups stays uniform); step t waits
// until at most stages - 2 groups are pending (its own has landed),
// synchronises the CTA (every reader of the slot step t + stages - 1 will
// overwrite is done), issues that step's copies and commits, then
// computes on slot t % stages.  The fused CA kernel runs the same ring at
// a depth chosen at run time (wait_pending) and gathers its working tiles
// with zero-filled copies (copy16_zfill / copy4_zfill: src-size 0 for the
// cells of out-of-range or non-member blocks).  The flash tile paths copy
// head rows that are no whole number of 16-byte pieces in narrower ones
// (copy_rows_pieces: 8, 4 or 2 bytes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ring {

// 16 bytes global -> shared, cached in L2 only (.cg: the tiles are read
// once per CTA, by way of shared memory).
__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kPending of this thread's groups are in flight.
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The same for a ring depth known at run time: at most `pending` groups
// in flight, 0 <= pending < kMaxPending (deeper counts wait for all).
constexpr int kMaxPending = 3;
__device__ __forceinline__ void wait_pending(int pending) {
  switch (pending) {
    case 2: wait<2>(); break;
    case 1: wait<1>(); break;
    default: wait<0>(); break;
  }
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src-size 0:
// nothing is read from gmem, which must still be a valid address).
__device__ __forceinline__ void copy16_zfill(void* smem, const void* gmem,
                                             bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared (through L1: .cg takes 16-byte copies only),
// or 4 zero bytes when !valid.
__device__ __forceinline__ void copy4_zfill(void* smem, const void* gmem,
                                            bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// 8 bytes global -> shared (through L1, as copy4_zfill), or 8 zero bytes
// when !valid.
__device__ __forceinline__ void copy8_zfill(void* smem, const void* gmem,
                                            bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 8 : 0));
}

// 2 bytes global -> shared through a register (cp.async copies 4 bytes
// at the least: a bf16 row of an odd length starts on a 2-byte boundary
// only), or 2 zero bytes when !valid.  A plain store: the CTA barrier
// that makes a ring slot's async copies visible makes it visible too.
__device__ __forceinline__ void copy2_zfill(void* smem, const void* gmem,
                                            bool valid) {
  unsigned short x = 0;
  if (valid) x = __ldg(static_cast<const unsigned short*>(gmem));
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(x) : "memory");
}

// The widest piece, in bytes, that a row of `row_bytes` (from a 16-byte
// boundary) is a whole number of: 16, 8, 4, or 2 (bf16 rows of an odd
// length).  Every row of such a tile then starts on a piece boundary.
__host__ __device__ constexpr int piece_bytes(int row_bytes) {
  return row_bytes % 16 == 0 ? 16
         : row_bytes % 8 == 0 ? 8
         : row_bytes % 4 == 0 ? 4
                              : 2;
}

// Copy `rows` rows of `cols` values of T (bf16 or f32; cols a whole number
// of 16-byte pieces, at most blockDim.x of them) from a row-major global
// tile of row stride `src_stride` into shared rows of stride `dst_stride`
// elements, spread over the CTA's threads: thread i copies piece
// i % pieces of every (blockDim.x / pieces)-th row.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dst_stride,
                                          const T* src, int src_stride,
                                          int rows, int cols) {
  constexpr int kShift = sizeof(T) == 2 ? 3 : 2;  // log2 values per piece
  static_assert(sizeof(T) << kShift == 16, "16-byte pieces of bf16 or f32");
  const int chunks = cols >> kShift;  // 16-byte pieces per row
  const int sweep = blockDim.x / chunks;
  const int r0 = threadIdx.x / chunks;
  const int c = (threadIdx.x - r0 * chunks) << kShift;
  if (r0 >= sweep) return;
  for (int r = r0; r < rows; r += sweep)
    copy16(dst + (size_t)r * dst_stride + c,
           src + (size_t)r * src_stride + c);
}

// copy_rows into a padded shared tile: `rows_pad` rows of `cols_pad`
// values land, the rows at or past `rows` and the pieces at or past
// `cols` as zeros (src-size 0, nothing read past the tile).  A stale
// slot row would not do: p = 0 times a stale NaN or Inf is NaN.
template <typename T>
__device__ __forceinline__ void copy_rows_zfill(T* dst, int dst_stride,
                                                const T* src, int src_stride,
                                                int rows, int rows_pad,
                                                int cols, int cols_pad) {
  constexpr int kShift = sizeof(T) == 2 ? 3 : 2;
  static_assert(sizeof(T) << kShift == 16, "16-byte pieces of bf16 or f32");
  const int chunks = cols_pad >> kShift;
  const int sweep = blockDim.x / chunks;
  const int r0 = threadIdx.x / chunks;
  const int piece = threadIdx.x - r0 * chunks;
  const int c = piece << kShift;
  const bool col_live = c < cols;
  if (r0 >= sweep) return;
  for (int r = r0; r < rows_pad; r += sweep) {
    const bool live = col_live && r < rows;
    copy16_zfill(dst + (size_t)r * dst_stride + c,
                 live ? src + (size_t)r * src_stride + c : src, live);
  }
}

// One thread's share of copy_rows_pieces in pieces of kW bytes: piece
// columns p0, p0 + lanes, ... of rows r0, r0 + sweep, ...
template <int kW, typename T>
__device__ __forceinline__ void copy_pieces(T* dst, int dst_stride,
                                            const T* src, int src_stride,
                                            int rows, int rows_pad, int cols,
                                            int pieces, int lanes, int sweep,
                                            int r0, int p0) {
  constexpr int kVals = kW / (int)sizeof(T);  // values a piece
  for (int piece = p0; piece < pieces; piece += lanes) {
    const int c = piece * kVals;
    const bool col_live = c < cols;
    T* to = dst + (size_t)r0 * dst_stride + c;
    const T* from = src + (size_t)r0 * src_stride + c;
    for (int r = r0; r < rows_pad; r += sweep) {
      const bool live = col_live && r < rows;
      if constexpr (kW == 8)
        copy8_zfill(to, live ? from : src, live);
      else if constexpr (kW == 4)
        copy4_zfill(to, live ? from : src, live);
      else
        copy2_zfill(to, live ? from : src, live);
      to += (size_t)sweep * dst_stride;
      from += (size_t)sweep * src_stride;
    }
  }
}

// copy_rows_zfill for rows that are no whole number of 16-byte pieces, in
// pieces of `w` bytes (piece_bytes of a row of `cols` values, the same for
// the whole CTA): 8 or 4 by cp.async.ca, 2 (bf16 rows of an odd length)
// through a register (copy2_zfill).  The same rows and columns land as
// copy_rows_zfill's, the padding zero-filled (cols_pad * sizeof(T) a
// multiple of 16); lanes = min(pieces a row, blockDim.x) threads share a
// row, thread i taking pieces i % lanes, + lanes, ... of every
// (blockDim.x / lanes)-th row.
template <typename T>
__device__ __forceinline__ void copy_rows_pieces(T* dst, int dst_stride,
                                                 const T* src,
                                                 int src_stride, int rows,
                                                 int rows_pad, int cols,
                                                 int cols_pad, int w) {
  const int pieces = (cols_pad * (int)sizeof(T)) >> (__ffs(w) - 1);
  const int lanes = pieces < (int)blockDim.x ? pieces : (int)blockDim.x;
  const int sweep = blockDim.x / lanes;
  const int r0 = threadIdx.x / lanes;
  const int p0 = threadIdx.x - r0 * lanes;
  if (r0 >= sweep) return;
  if (w == 8) {
    copy_pieces<8>(dst, dst_stride, src, src_stride, rows, rows_pad, cols,
                   pieces, lanes, sweep, r0, p0);
  } else if (sizeof(T) == 4 || w == 4) {
    copy_pieces<4>(dst, dst_stride, src, src_stride, rows, rows_pad, cols,
                   pieces, lanes, sweep, r0, p0);
  } else if constexpr (sizeof(T) == 2) {
    copy_pieces<2>(dst, dst_stride, src, src_stride, rows, rows_pad, cols,
                   pieces, lanes, sweep, r0, p0);
  }
}

}  // namespace ring
