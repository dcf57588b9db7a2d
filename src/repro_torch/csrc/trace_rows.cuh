// Access-trace rows of the trace builds (-DREPRO_TRACE) of the write, sum
// and CA kernels: one int32 row per grid step, written by the kernel from
// the very values its body addresses memory with, for the access
// sanitizer (repro_torch/analysis/sanitizer.py) to hold against the
// static read and write sets.  The row layout is the sanitizer's
// (repro_torch.kernels._cuda.TRACE_COLUMNS):
//
//   visits    times the kernel took the step (atomicAdd)
//   live      the step's block is a member (1) or was discarded (0)
//   bx, by    its scheduled block
//   store     the (row, col) supertile it stored (write, CA)
//   slot      the partial it wrote (sum)
//   loads     per origin slot (dy + 1) * 3 + dx + 1 the (row, col)
//             supertile it read (centre 4: the sum's tile and the CA's
//             centre; the CA's neighbours), -1 where it read nothing
//
// A column the step does not touch keeps its initial -1 (visits and live
// start at 0).  The untraced instantiations take the row pointer as a
// trailing argument they never read, so their code is what it was.
#pragma once

#include "fractal_common.cuh"

namespace trace {

constexpr int kCols = 25;
enum Col { kVisits = 0, kLive = 1, kBx = 2, kBy = 3, kStoreRow = 4,
           kStoreCol = 5, kSlot = 6, kLoads = 7 };

// The row of step t, its visit counted and its block recorded (the block
// of a live step only: a discarded step's decode is not an address).
__device__ __forceinline__ int* visit(int* rows, long long t, bool live,
                                      unsigned bx, unsigned by) {
  int* r = rows + t * kCols;
  atomicAdd(r + kVisits, 1);
  r[kLive] = live ? 1 : 0;
  if (live) {
    r[kBx] = (int)bx;
    r[kBy] = (int)by;
  }
  return r;
}

// The supertile (row, col) of the storage cell origin (row0, col0) into
// dst[0..1].
__device__ __forceinline__ void tile(int* dst, const fractal::FracParams& p,
                                     long long row0, long long col0) {
  dst[0] = (int)(row0 / p.th);
  dst[1] = (int)(col0 / p.tw);
}

// The same for a linear storage offset row0 * pitch + col0 (-1, -1 for a
// negative offset: an origin the kernel reads nothing from).
__device__ __forceinline__ void tile_at(int* dst,
                                        const fractal::FracParams& p,
                                        long long off) {
  if (off < 0) return;
  const long long row0 = off / p.pitch;
  tile(dst, p, row0, off - row0 * p.pitch);
}

}  // namespace trace
