// Warp-level tensor-core pieces (sm_90a, inline PTX) shared by the mma
// lowering's decode chains (mma_decode.cuh) and the tensor-core flash
// attention kernels (flash_attention.cu): the bf16 m16n8k16 and tf32
// m16n8k8 products, the split of an f32 value into tf32 hi and lo parts,
// and the ldmatrix loads of the fragments from shared memory.
//
// Fragment maps of mma.sync.aligned.m16n8k16.row.col (lane l, g = l / 4,
// t = l % 4; each register holds two 16-bit values, the lower first):
//   A (16 x 16, row-major)  a[0] = (g, 2t..2t+1)      a[1] = (g+8, 2t..2t+1)
//                           a[2] = (g, 2t+8..2t+9)    a[3] = (g+8, 2t+8..2t+9)
//   B (16 x 8, "col")       b.x  = (2t..2t+1, g)      b.y  = (2t+8..2t+9, g)
//   C, D (16 x 8, f32)      d[0..1] = (g, 2t..2t+1)   d[2..3] = (g+8, 2t..2t+1)
// so the C fragments of two adjacent n-tiles (columns 0-7 and 8-15),
// rounded in pairs to bf16, are the A fragment of a 16 x 16 tile: the
// C -> A identity flash attention uses to feed p into p v.
//
// Fragment maps of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (one
// 32-bit tf32 value per register):
//   A (16 x 8, row-major)   a[0] = (g, t)   a[1] = (g+8, t)
//                           a[2] = (g, t+4) a[3] = (g+8, t+4)
//   B (8 x 8, "col")        b.x  = (t, g)   b.y  = (t+4, g)
//   C, D (16 x 8, f32)      as m16n8k16
// ldmatrix moves 16-byte rows, so on f32 data an "8 x 8 b16" matrix is
// 8 rows x 4 f32 and register i of lane (g, t) receives word t of row g:
//   * ldmatrix.x4 of the sub-matrices (rows 0-7 | 8-15) x (cols 0-3 | 4-7)
//     of a row-major A, in that register order, is the A fragment;
//   * of (keys 0-7) x (dims 0-3 | 4-7) of row-major K it is K[g][t] and
//     K[g][t+4]: the B fragment of S = Q K^T (k = dim, n = key).
// The C fragment holds columns 2t and 2t+1, and A wants t and t+4, so
// there is no C -> A identity at k8: P V permutes the keys of each 8-key
// group instead (A column t is key 2t, column t+4 is key 2t+1; C's
// d[0], d[2], d[1], d[3] are a[0..3]) and reads V's B fragment at the
// same rows, b.x = V[2t][g] and b.y = V[2t+1][g] (32-bit shared loads:
// ldmatrix.trans moves 16-bit elements and cannot transpose f32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// d += A * B on one 16x8x16 tile (A row-major, B column-major fragments).
__device__ __forceinline__ void mma_bf16(float d[4], const unsigned a[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// d += A * B on one 16x8x8 tile of tf32 fragments (f32 sums).
__device__ __forceinline__ void mma_tf32(float d[4], const unsigned a[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// x = hi + lo as two tf32 values (3xTF32): hi = x rounded to tf32 (10
// mantissa bits, to nearest, ties away from zero: cvt.rna.tf32.f32), lo =
// the f32 difference x - hi (exact) rounded the same way.  The rounding is
// done on the bit pattern, (bits + 0x1000) & ~0x1fff, which is
// cvt.rna.tf32.f32 for every finite x short of the overflow to inf: two
// integer operations, where sm_90 lowers the cvt to a longer sequence of
// compares and selects.
// hi·hi + hi·lo + lo·hi keeps about 22 significant bits of the f32
// product; the dropped lo·lo is ~2^-22 of it.
__device__ __forceinline__ unsigned round_tf32(unsigned bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = round_tf32(__float_as_uint(x));
  lo = round_tf32(__float_as_uint(__fsub_rn(x, __uint_as_float(hi))));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and register i of lane (g, t) receives its (g, 2t..2t+1).
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// The same, transposed: register i of lane (g, t) receives elements
// (2t, g) and (2t+1, g) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// Two f32 rounded to nearest even into one bf16 pair (lo in the low half).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace tc
