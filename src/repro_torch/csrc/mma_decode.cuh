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
//   fractal_chain_batch (B7a batched, the CA) A row j = the one-hots of
//                   step t0 + j * stride, j < 16: one pass decodes sixteen
//                   steps; digit mu of each step is found once, by lane mu
//                   (multiply-high by ceil(2^64 / k^mu), no division), and
//                   read by the lanes of its columns with a shuffle;
//   fractal_nbrs_pair (B7b, the CA) A row j < 8 = neighbour j's base-m
//                   digit-pair one-hots (column mu * m^2 + dy * m + dx) of
//                   its clamped coords, rows 8-15 a second block's, B = the
//                   neighbour basis (pair match folded into the slots basis,
//                   plus a match-count column): per neighbour its slot and
//                   its matched-level count, a member when the count is r_b;
//   rows_chain_warp (B7c batched, every fractal kernel) A rows 2j and
//                   2j + 1 carry [t_j >= starts[rho]] and the one-hot row
//                   [starts[rho] <= t_j < starts[rho + 1]] of step t_j =
//                   t + j * stride, j < 8, B = (ones, diff): by = count - 1,
//                   bx = t_j + diff; one warp's chain decodes eight of its
//                   steps over the block-row count K.
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

// ---------------------------------------------------------------------------
// The CA's batched chains: digits without division, sixteen steps a pass
// ---------------------------------------------------------------------------

// Steps per batched fractal chain: B7a's 16 A rows, one a step.
constexpr int kStepsBatch = 16;

// ceil(2^32 / b) for 2 <= b <= 64: v / b == __umulhi(v, magic) for every
// v < 2^26 (the error v (magic - 2^32 / b) / 2^32 stays below 1 / b).
__host__ __device__ constexpr unsigned div_magic(unsigned b) {
  return 0xffffffffu / b + 1u;
}

// ceil(2^64 / b^mu) for the digit mu a lane holds (0 at mu = 0: the value
// itself is its quotient): v / b^mu == __umul64hi(v, magic) for v < 2^24
// and b^mu <= 2^28 (the error stays below 1 / b^mu).  Powers past 2^24
// stop growing: no step or block index reaches them, so their digit is 0
// either way.  Built once per CTA (pow_magics).
__device__ __forceinline__ unsigned long long pow_magic(unsigned b, int mu) {
  unsigned long long pw = 1;
  for (int i = 0; i < mu && pw < (1ull << 24); ++i) pw *= b;
  return mu == 0 ? 0ull : ~0ull / pw + 1ull;
}

// Digit mu of v < 2^24 in base b (2 <= b <= 16), from lane mu's power
// magic and b's division magic: no division.
__device__ __forceinline__ unsigned lane_digit(unsigned v,
                                               unsigned long long pmagic,
                                               unsigned b, unsigned bmagic) {
  const unsigned q = pmagic ? (unsigned)__umul64hi(v, pmagic) : v;
  return q - __umulhi(q, bmagic) * b;
}

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

// Output w of D row `row`, each lane naming its own row: columns 3w ..
// 3w + 2.
__device__ __forceinline__ int row_out(const float d[4], int row, int w) {
  return recombine(dget_at(d, row, 3 * w), dget_at(d, row, 3 * w + 1),
                   dget_at(d, row, 3 * w + 2));
}

// B7a batched: lambda of the steps t0 + j * stride, j < nlive <= 16 (A row
// j; rows past nlive decode t0 and are not read), by the coords basis
// (dc) and, with `slots`, the slots basis (ds): one pass of mk k-steps for
// sixteen steps.  Lane mu finds digit mu (base k) of every step once,
// steps 0-7 in the nibbles of lo and 8-15 in those of hi (k <= 16); the
// lanes that build column mu * k + c read it with one shuffle a half.
// pmagic: this lane's pow_magic(k, lane).  Step j's outputs: row_out of
// row j.  Called by a whole warp.
__device__ __forceinline__ void fractal_chain_batch(
    const FracParams& p, const int* __restrict__ ops, unsigned t0,
    unsigned stride, int nlive, int lane, unsigned long long pmagic,
    bool slots, float (&dc)[4], float (&ds)[4]) {
  const uint2* cfrag = reinterpret_cast<const uint2*>(ops);
  const uint2* sfrag = cfrag + p.mk * 32;
  const unsigned k = (unsigned)p.k, kmagic = div_magic(k);
  const int g = lane >> 2, tq = lane & 3, ncols = p.r_b * p.k;
  unsigned lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < kStepsBatch; ++j) {
    const unsigned t = j < nlive ? t0 + (unsigned)j * stride : t0;
    const unsigned dg = lane_digit(t, pmagic, k, kmagic);
    if (j < 8)
      lo |= dg << (4 * j);
    else
      hi |= dg << (4 * (j - 8));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) dc[e] = ds[e] = 0.f;
  for (int ks = 0; ks < p.mk; ++ks) {
    // columns c, c + 1 (A registers 0 and 1) and c + 8, c + 9 (2 and 3)
    // of rows g (lo) and g + 8 (hi)
    const int c = ks * 16 + 2 * tq;
    bool hg[4], h8[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned col = (unsigned)(c + (e & 1) + (e >> 1) * 8);
      const unsigned mu = __umulhi(col, kmagic), cd = col - mu * k;
      const unsigned wl = __shfl_sync(kFullMask, lo, mu & 31);
      const unsigned wh = __shfl_sync(kFullMask, hi, mu & 31);
      const bool live = (int)col < ncols;
      hg[e] = live && (wl >> (4 * g) & 15u) == cd;
      h8[e] = live && (wh >> (4 * g) & 15u) == cd;
    }
    const unsigned a[4] = {pack2(hg[0], hg[1]), pack2(h8[0], h8[1]),
                           pack2(hg[2], hg[3]), pack2(h8[2], h8[3])};
    __syncwarp();
    mma_bf16(dc, a, cfrag[ks * 32 + lane]);
    if (slots) mma_bf16(ds, a, sfrag[ks * 32 + lane]);
  }
}

// B7b for two steps at once: the packed slots of the 8 neighbour
// supertiles of block (bxa, bya) (A rows 0-7) and of (bxb, byb) (rows
// 8-15), by the neighbour basis (the pair match folded into the slots
// basis, plus a match-count column).  Lane mu holds the base-m digits mu
// of a block's clamped columns bx - 1, bx, bx + 1 (3 bits each, m <= 8)
// and rows by - 1 .. by + 1 (bits 9 on): 18 bits a block, one shuffle a
// block per column mu * m^2 + dy * m + dx.  Lane (g, tq) returns
// neighbour g (kNbrDx/Dy[g]) of both blocks: its slot (sx, sy), swapped
// under p.swap, and whether it is in range and a member (match count
// r_b).  pmagic: this lane's pow_magic(m, lane).  Called by a whole warp.
__device__ __forceinline__ void fractal_nbrs_pair(
    const FracParams& p, const int* __restrict__ ops, unsigned bxa,
    unsigned bya, unsigned bxb, unsigned byb, int lane,
    unsigned long long pmagic, unsigned& sxa, unsigned& sya, bool& oka,
    unsigned& sxb, unsigned& syb, bool& okb) {
  const uint2* nfrag = reinterpret_cast<const uint2*>(ops) + 2 * p.mk * 32;
  const unsigned m = (unsigned)p.m, mm = m * m;
  const unsigned mmagic = div_magic(m), mmmagic = div_magic(mm);
  const int g = lane >> 2, tq = lane & 3, ncols = p.r_b * p.m * p.m;
  const long long hi = (long long)p.nbx - 1;
  auto word = [&](unsigned bx, unsigned by) {
    unsigned w = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const long long x = (long long)bx + i - 1, y = (long long)by + i - 1;
      const unsigned xc = (unsigned)(x < 0 ? 0 : (x > hi ? hi : x));
      const unsigned yc = (unsigned)(y < 0 ? 0 : (y > hi ? hi : y));
      w |= lane_digit(xc, pmagic, m, mmagic) << (3 * i);
      w |= lane_digit(yc, pmagic, m, mmagic) << (9 + 3 * i);
    }
    return w;
  };
  const unsigned wa = word(bxa, bya), wb = word(bxb, byb);
  // this lane's neighbour: the fields of its column and row offsets
  const int sxs = 3 * (kNbrDx[g] + 1), sys = 9 + 3 * (kNbrDy[g] + 1);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ks = 0; ks < p.mk2; ++ks) {
    const int c = ks * 16 + 2 * tq;
    bool ha[4], hb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned col = (unsigned)(c + (e & 1) + (e >> 1) * 8);
      const unsigned mu = __umulhi(col, mmmagic), pr = col - mu * mm;
      const unsigned dy = __umulhi(pr, mmagic), dx = pr - dy * m;
      const unsigned ua = __shfl_sync(kFullMask, wa, mu & 31);
      const unsigned ub = __shfl_sync(kFullMask, wb, mu & 31);
      const bool live = (int)col < ncols;
      ha[e] = live && (ua >> sxs & 7u) == dx && (ua >> sys & 7u) == dy;
      hb[e] = live && (ub >> sxs & 7u) == dx && (ub >> sys & 7u) == dy;
    }
    const unsigned a[4] = {pack2(ha[0], ha[1]), pack2(hb[0], hb[1]),
                           pack2(ha[2], ha[3]), pack2(hb[2], hb[3])};
    __syncwarp();
    mma_bf16(d, a, nfrag[ks * 32 + lane]);
  }
  // rows g and g + 8 of D: columns 2q, 2q + 1 in lane 4g + q
  const int base = lane & ~3;
  float va[7], vb[7];
#pragma unroll
  for (int c = 0; c < 7; ++c) {
    va[c] = __shfl_sync(kFullMask, d[c & 1], base | (c >> 1));
    vb[c] = __shfl_sync(kFullMask, d[2 | (c & 1)], base | (c >> 1));
  }
  auto out = [&](const float (&v)[7], unsigned bx, unsigned by,
                 unsigned& sx, unsigned& sy, bool& ok) {
    const unsigned wx = (unsigned)recombine(v[0], v[1], v[2]);
    const unsigned wy = (unsigned)recombine(v[3], v[4], v[5]);
    sx = p.swap ? wy : wx;
    sy = p.swap ? wx : wy;
    const long long x = (long long)bx + kNbrDx[g], y = (long long)by + kNbrDy[g];
    ok = x >= 0 && y >= 0 && x <= hi && y <= hi && (int)v[6] == p.r_b;
  };
  out(va, bxa, bya, sxa, sya, oka);
  out(vb, bxb, byb, sxb, syb, okb);
}

// Steps per batched row chain: A's 16 rows, two per step.
constexpr int kRowsBatch = 8;

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
