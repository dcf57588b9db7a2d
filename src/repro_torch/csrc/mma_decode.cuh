// The mma lowering's decode chains on the tensor cores (sm_90a), shared by
// sierpinski_write.cu and sierpinski_ca.cu.
//
// Replaces (JAX package): core/mma.py's digit-basis and row-comparison
// chains -- decode_linear (:194), slots_of_linear (:201), neighbor_slots
// (:279), decode_rows (:348) -- which its gpu-structured Pallas kernels
// evaluate in-kernel per program, and its TPU structure binds as a
// scalar-prefetch table (plan.py:312 mma_table).
//
// Each chain is a product of 0/1 one-hots (bf16, the A operand) with an
// integer basis (the B operand), accumulated in f32 by
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, one warp driving
// one 16x8 tile per k-step of 16 columns.  The tensor cores take no f32
// operand and bf16 holds integers exactly only up to 256, so every basis
// entry (below 2^24, negative for the row chain's diff) arrives split into
// three signed 8-bit pieces (core/mma.py exact_split): output w's piece p
// is B column 3w + p.  Each piece column sums at most K terms of magnitude
// <= 255, exactly, and the lanes recombine p0 + 256 p1 + 65536 p2 in int32,
// so the chains equal the integer closed forms bit for bit below 2^24.
// The B fragments are laid out on the host (core/mma.py
// tensor_core_operand): lane l reads its two registers of k-step s as one
// 8-byte load at frag[32 s + l].
//
// The chains (plan.LaunchParams.mma_ops holds their operands):
//   fractal_chain   (B7a) A row 0 = the base-k digit one-hots of step t
//                   (column mu * k + c), B = the coords basis and, on
//                   request, the slots basis (one more mma on the same A):
//                   (bx, by) and the packed slot (sx, sy);
//   fractal_nbrs    (B7b) A row j < 8 = neighbour j's base-m digit-pair
//                   one-hots (column mu * m^2 + dy * m + dx) of its clamped
//                   coords, B = the neighbour basis (pair match folded into
//                   the slots basis, plus a match-count column): per
//                   neighbour its slot and its matched-level count, a
//                   member when the count is r_b; rows 8-15 idle;
//   rows_chain_cta  (B7c) A row 0 = [t >= starts[rho]], row 1 = the
//                   one-hot row [starts[rho] <= t < starts[rho + 1]],
//                   B = (ones, diff): by = count - 1, bx = t + diff.  K is
//                   the block-row count (2048 for the triangle at n = 2^16,
//                   rho = 32: 128 k-steps), so the CTA's warps share the
//                   k-steps and add their exact partials in shared memory
//                   (the CA kernel's form);
//   rows_chain_warp (B7c batched, the write and sum kernels) A rows 2j and
//                   2j + 1 carry those two one-hots of step t + j * stride,
//                   j < 8: one warp's chain decodes eight of its steps.
//
// What bounds them: latency.  A chain is a few to a few hundred dependent
// mma.sync per grid step next to a tile of memory traffic; their tensor
// operations (2 * 16 * 8 * 16 per k-step) are far below the card's rate.
// mma.sync needs all 32 lanes converged, so the kernels launch whole warps
// under mma and call the chains from warp-uniform control flow.
#pragma once

#include "fractal_common.cuh"
#include "mma_sync.cuh"

namespace fractal {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kBf16One = 0x3F80u;  // bf16 bits of 1.0

__device__ __forceinline__ unsigned pack2(bool lo, bool hi) {
  return (lo ? kBf16One : 0u) | ((hi ? kBf16One : 0u) << 16);
}

// d += A * B on one 16x8x16 tile (mma_sync.cuh).
using tc::mma_bf16;

// Element (kRow, kCol) of the warp's D tile, broadcast to every lane:
// lane 4 * (row % 8) + col / 2 holds it in register 2 * (row / 8) + col % 2.
template <int kRow, int kCol>
__device__ __forceinline__ float dget(const float d[4]) {
  return __shfl_sync(kFullMask, d[((kRow >> 3) << 1) | (kCol & 1)],
                     ((kRow & 7) << 2) | (kCol >> 1));
}

// The integer of three exact piece sums.
__device__ __forceinline__ int recombine(float p0, float p1, float p2) {
  return (int)p0 + (int)p1 * 256 + (int)p2 * 65536;
}

// Output w of D row kRow: columns 3w, 3w + 1, 3w + 2.
template <int kRow, int kW>
__device__ __forceinline__ int dout(const float d[4]) {
  return recombine(dget<kRow, 3 * kW>(d), dget<kRow, 3 * kW + 1>(d),
                   dget<kRow, 3 * kW + 2>(d));
}

// Is column `col` of a digit one-hot row of v set: col = mu * base + c
// with c the mu-th base-`base` digit of v (and col inside the K of
// `ncols` live columns)?
__device__ __forceinline__ bool digit_hot(unsigned v, int base, int col,
                                          int ncols) {
  if (col >= ncols) return false;
  const int mu = col / base, c = col - mu * base;
  for (int i = 0; i < mu; ++i) v /= (unsigned)base;
  return (int)(v % (unsigned)base) == c;
}

// Is column `col` = mu * m^2 + dy * m + dx of the digit-pair one-hot row
// of (x, y) set (dx, dy the mu-th base-m digits)?
__device__ __forceinline__ bool pair_hot(unsigned x, unsigned y, int m,
                                         int col, int ncols) {
  if (col >= ncols) return false;
  const int mm = m * m, mu = col / mm, pr = col - mu * mm;
  for (int i = 0; i < mu; ++i) {
    x /= (unsigned)m;
    y /= (unsigned)m;
  }
  return (int)((y % (unsigned)m) * (unsigned)m + x % (unsigned)m) == pr;
}

// B7a: lambda of step t by the coords basis -> (bx, by), and with `slots`
// the packed slot by the slots basis -> (sx, sy) (transposed under
// p.swap, the odd-level coarsening).  Called by a whole warp; every lane
// gets the results.
__device__ __forceinline__ void fractal_chain(const FracParams& p,
                                              const int* __restrict__ ops,
                                              unsigned t, int lane,
                                              bool slots, unsigned& bx,
                                              unsigned& by, unsigned& sx,
                                              unsigned& sy) {
  const uint2* cfrag = reinterpret_cast<const uint2*>(ops);
  const uint2* sfrag = cfrag + p.mk * 32;
  const int g = lane >> 2, tq = lane & 3, ncols = p.r_b * p.k;
  float dc[4] = {0.f, 0.f, 0.f, 0.f}, ds[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ks = 0; ks < p.mk; ++ks) {
    unsigned a[4] = {0u, 0u, 0u, 0u};
    if (g == 0) {  // row 0: the one decode; rows 1-15 idle
      const int c = ks * 16 + 2 * tq;
      a[0] = pack2(digit_hot(t, p.k, c, ncols), digit_hot(t, p.k, c + 1, ncols));
      a[2] = pack2(digit_hot(t, p.k, c + 8, ncols),
                   digit_hot(t, p.k, c + 9, ncols));
    }
    __syncwarp();
    mma_bf16(dc, a, cfrag[ks * 32 + lane]);
    if (slots) mma_bf16(ds, a, sfrag[ks * 32 + lane]);
  }
  bx = (unsigned)dout<0, 0>(dc);
  by = (unsigned)dout<0, 1>(dc);
  if (slots) {
    const unsigned wx = (unsigned)dout<0, 0>(ds), wy = (unsigned)dout<0, 1>(ds);
    sx = p.swap ? wy : wx;
    sy = p.swap ? wx : wy;
  }
}

// B7b: the storage origins of the 8 neighbour supertiles of scheduled
// block (bx, by), into org[(dy + 1) * 3 + dx + 1] (-1 for an out-of-range
// or non-member neighbour, whose cells are never read).  Called by a whole
// warp: lanes 4j .. 4j + 3 work for neighbour j, lane 4j publishes it.
__device__ __forceinline__ void fractal_nbrs(const FracParams& p,
                                             const int* __restrict__ ops,
                                             unsigned bx, unsigned by,
                                             int lane, long long* org_row,
                                             long long* org_col) {
  const uint2* nfrag = reinterpret_cast<const uint2*>(ops) + 2 * p.mk * 32;
  const int g = lane >> 2, tq = lane & 3;
  const int ncols = p.r_b * p.m * p.m;
  const long long x = (long long)bx + kNbrDx[g], y = (long long)by + kNbrDy[g];
  const long long hi = (long long)p.nbx - 1;
  const unsigned xc = (unsigned)(x < 0 ? 0 : (x > hi ? hi : x));
  const unsigned yc = (unsigned)(y < 0 ? 0 : (y > hi ? hi : y));
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ks = 0; ks < p.mk2; ++ks) {
    const int c = ks * 16 + 2 * tq;
    unsigned a[4];
    a[0] = pack2(pair_hot(xc, yc, p.m, c, ncols),
                 pair_hot(xc, yc, p.m, c + 1, ncols));
    a[1] = 0u;  // rows 8-15 idle
    a[2] = pack2(pair_hot(xc, yc, p.m, c + 8, ncols),
                 pair_hot(xc, yc, p.m, c + 9, ncols));
    a[3] = 0u;
    __syncwarp();
    mma_bf16(d, a, nfrag[ks * 32 + lane]);
  }
  // row g of D (this lane's neighbour): columns 2q, 2q + 1 in lane 4g + q
  const int base = lane & ~3;
  float v[7];
#pragma unroll
  for (int c = 0; c < 7; ++c)
    v[c] = __shfl_sync(kFullMask, d[c & 1], base | (c >> 1));
  unsigned sx = (unsigned)recombine(v[0], v[1], v[2]);
  unsigned sy = (unsigned)recombine(v[3], v[4], v[5]);
  if (p.swap) {
    const unsigned tmp = sx;
    sx = sy;
    sy = tmp;
  }
  const bool ok = x >= 0 && y >= 0 && x <= hi && y <= hi &&
                  (int)v[6] == p.r_b;
  if (tq == 0) {
    const int slot = (kNbrDy[g] + 1) * 3 + kNbrDx[g] + 1;
    org_row[slot] = ok ? (long long)sy * p.th : -1;
    org_col[slot] = ok ? (long long)sx * p.tw : -1;
  }
}

// B7c: step t of a row-major domain -> (bx, by).  Called by every thread
// of the CTA (whole warps, from uniform control flow): warp w takes
// k-steps w, w + nwarps, ...; the warps' recombined partials are exact
// integers, added in shared memory.
__device__ __forceinline__ void rows_chain_cta(const FracParams& p,
                                               const int* __restrict__ ops,
                                               long long t, unsigned& bx,
                                               unsigned& by) {
  __shared__ int part[2 * 32];
  const int* starts = ops;
  const uint2* frag = reinterpret_cast<const uint2*>(ops + p.mk * 16 + 2);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nwarps = (blockDim.x * blockDim.y) >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ks = warp; ks < p.mk; ks += nwarps) {
    unsigned a[4] = {0u, 0u, 0u, 0u};
    if (g < 2) {  // row 0: t >= starts[rho]; row 1: t's own row
      const int c = ks * 16 + 2 * tq;
      bool h[4];
      const int cols[4] = {c, c + 1, c + 8, c + 9};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ge = t >= (long long)starts[cols[e]];
        h[e] = g == 0 ? ge : ge && t < (long long)starts[cols[e] + 1];
      }
      a[0] = pack2(h[0], h[1]);
      a[2] = pack2(h[2], h[3]);
    }
    __syncwarp();
    mma_bf16(d, a, frag[ks * 32 + lane]);
  }
  const int count = dout<0, 0>(d), diff = dout<1, 1>(d);
  if (lane == 0) {
    part[2 * warp] = count;
    part[2 * warp + 1] = diff;
  }
  __syncthreads();
  int c = 0, df = 0;
  for (int w = 0; w < nwarps; ++w) {
    c += part[2 * w];
    df += part[2 * w + 1];
  }
  __syncthreads();  // part is reused by the next step
  by = (unsigned)(c - 1);
  bx = (unsigned)(t + df);
}

// Steps per batched row chain: A's 16 rows, two per step.
constexpr int kRowsBatch = 8;

// Element (row, col) of the warp's D tile, each lane naming its own row
// and col: lane 4 * (row % 8) + col / 2 holds it in register
// 2 * (row / 8) + col % 2, so the lane reads all four of that lane's
// registers and keeps one.
__device__ __forceinline__ float dget_at(const float d[4], int row, int col) {
  const int src = ((row & 7) << 2) | (col >> 1);
  const float r0 = __shfl_sync(kFullMask, d[0], src);
  const float r1 = __shfl_sync(kFullMask, d[1], src);
  const float r2 = __shfl_sync(kFullMask, d[2], src);
  const float r3 = __shfl_sync(kFullMask, d[3], src);
  const bool hi = row >= 8, odd = col & 1;
  return hi ? (odd ? r3 : r2) : (odd ? r1 : r0);
}

// B7c batched: the steps t_j = t + j * stride, j < nlive <= kRowsBatch, of
// a row-major domain -> (bx, by) of step lane % 8, in every lane.  A row
// 2j is [t_j >= starts[rho]], row 2j + 1 the one-hot row [starts[rho] <=
// t_j < starts[rho + 1]]; rows of j >= nlive stay 0.  D row 2j, output 0,
// is step j's count of started rows (by = count - 1), row 2j + 1, output
// 1, its diff (bx = t_j + diff): one pass over the K = mk * 16 block rows
// for eight steps.  Called by a whole warp from uniform control flow.
__device__ __forceinline__ void rows_chain_warp(const FracParams& p,
                                                const int* __restrict__ ops,
                                                long long t, int stride,
                                                int nlive, int lane,
                                                unsigned& bx, unsigned& by) {
  const int* starts = ops;
  const uint2* frag = reinterpret_cast<const uint2*>(ops + p.mk * 16 + 2);
  const int g = lane >> 2, tq = lane & 3;
  const bool own = g & 1;  // rows g and g + 8: the own-row one-hot
  const int ja = g >> 1, jb = ja + 4;  // the steps of rows g and g + 8
  // step ids below 2^24 (the mma bound); -1 for a row past the batch,
  // below every start
  const int ta = ja < nlive ? (int)(t + (long long)ja * stride) : -1;
  const int tb = jb < nlive ? (int)(t + (long long)jb * stride) : -1;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int ks = 0; ks < p.mk; ++ks) {
    const int c = ks * 16 + 2 * tq;
    // starts[c .. c + 2] and starts[c + 8 .. c + 10]; an own row also
    // needs t below the next row's start, a >= row does not
    const int s[6] = {starts[c], starts[c + 1], starts[c + 2],
                      starts[c + 8], starts[c + 9], starts[c + 10]};
    const int lo[4] = {s[0], s[1], s[3], s[4]};
    const int hi[4] = {s[1], s[2], s[4], s[5]};
    bool ha[4], hb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int top = own ? hi[e] : 0x7fffffff;
      ha[e] = ta >= lo[e] && ta < top;
      hb[e] = tb >= lo[e] && tb < top;
    }
    unsigned a[4];
    a[0] = pack2(ha[0], ha[1]);
    a[1] = pack2(hb[0], hb[1]);
    a[2] = pack2(ha[2], ha[3]);
    a[3] = pack2(hb[2], hb[3]);
    __syncwarp();
    mma_bf16(d, a, frag[ks * 32 + lane]);
  }
  const int j = lane & 7;
  const int count = recombine(dget_at(d, 2 * j, 0), dget_at(d, 2 * j, 1),
                              dget_at(d, 2 * j, 2));
  const int diff = recombine(dget_at(d, 2 * j + 1, 3),
                             dget_at(d, 2 * j + 1, 4),
                             dget_at(d, 2 * j + 1, 5));
  by = (unsigned)(count - 1);
  bx = (unsigned)(t + (long long)j * stride + diff);
}

}  // namespace fractal
