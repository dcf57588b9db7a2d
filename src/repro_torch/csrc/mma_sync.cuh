// Warp-level tensor-core pieces (sm_90a, inline PTX) shared by the mma
// lowering's decode chains (mma_decode.cuh) and the tensor-core flash
// attention kernel (flash_attention.cu): the bf16 m16n8k16 product and
// the ldmatrix loads of its fragments from shared memory.
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
