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
// cells of out-of-range or non-member blocks).
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

}  // namespace ring
