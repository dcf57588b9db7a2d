// The sharded lowering of the fractal kernels (sierpinski_write.cu,
// sierpinski_ca.cu): one rank's share of a block domain split over a mesh
// axis by repro_torch.core.shard.ShardedPlan.
//
// Replaces (JAX package): core/shard.py's traced ShardedPlan methods --
// _decode (:746), _storage_coords (:713), _owned (:805), storage_index
// (:828) and neighbor_index (:850) -- which its Pallas kernels (B1-B3, B7)
// evaluate per grid step from a per-device shard-table row.  Here a
// launch is one rank's: its parameters arrive as one int64 array in
// SHARD_PARAMS order (the ShardParam enum) beside the kernel's own, plus
// two tables.
//
// Partitions (ShardPart):
//   kLinear       embedded storage: the rank's range [lo, lo + count) of
//                 the canonical (lambda-order) enumeration; local step t
//                 is canonical step lo + t, decoded as the unsharded
//                 kernels decode it (the digit loop, the chains, the LUT
//                 chunk's row t);
//   kStorageRows  compact storage: the rank's rpd slot rows from lo_row;
//                 local step t is slot g = lo + t (lo = lo_row * ncols) at
//                 (col, row) = (g % ncols, g / ncols), whose block is lambda
//                 of the orthotope coordinate: the canonical step of the
//                 interleaved digits (orth_linear), then the same decode; a
//                 row-major domain's slot index is its canonical step.  The
//                 rank's slab starts at its first row: local slot
//                 (t / ncols, t % ncols).  The CA's neighbours resolve to
//                 their global slot rows, then through the ghost map to
//                 rows of the extended array [slab ++ ghosts ++ dump].
// Under bounding the grid is the whole box, and a step is live when its
// block is a member the rank owns: its canonical step in [lo, lo + count)
// (kLinear) or its slot row in [lo_row, lo_row + rpd) (kStorageRows).  A
// phase launch (the CA's interior or boundary steps) reads its scheduled
// step ids from the phase list.
//
// What bounds them: nothing new -- a few integer operations and one table
// read a step beside the unsharded decode; the kernels' bytes are the
// rank's share of the unsharded kernel's.
#pragma once

#include "fractal_common.cuh"
#include "mma_decode.cuh"

namespace fractal {

enum ShardPart { kLinear = 0, kStorageRows = 1 };
// Index of each shard parameter in the int64 array (core/shard.py
// SHARD_PARAMS order).
enum ShardParam {
  kPart, kShardLo, kShardCount, kNcols, kNrows, kLoRow, kRpd, kNrowsPad,
  kNumShardParams
};

struct ShardParams {
  int part;
  long long lo;          // first canonical step (kLinear) or slot
  long long count;       // owned steps
  long long ncols, nrows, lo_row, rpd, nrows_pad;  // kStorageRows
  const int* gmap;       // global slot row -> row of the extended array
  const int* phase;      // a phase launch's scheduled steps, else null
};

inline ShardParams make_shard(const long long* a, const int* gmap,
                              const int* phase) {
  ShardParams s;
  s.part = (int)a[kPart];
  s.lo = a[kShardLo];
  s.count = a[kShardCount];
  s.ncols = a[kNcols];
  s.nrows = a[kNrows];
  s.lo_row = a[kLoRow];
  s.rpd = a[kRpd];
  s.nrows_pad = a[kNrowsPad];
  s.gmap = gmap;
  s.phase = phase;
  return s;
}

// lambda over orthotope coords as a canonical step: odd scale levels take
// the base-k digits of wy, even ones those of wx (FractalSpec.lambda_map,
// the Lemma 2 unrolling), so digit mu - 1 of the step is the level's copy.
__device__ __forceinline__ unsigned orth_linear(const FracParams& p,
                                                unsigned wx, unsigned wy) {
  unsigned i = 0, pw = 1;
  const unsigned k = (unsigned)p.k;
  for (int mu = 1; mu <= p.r_b; ++mu) {
    unsigned c;
    if (mu & 1) {
      c = wy % k;
      wy /= k;
    } else {
      c = wx % k;
      wx /= k;
    }
    i += c * pw;
    pw *= k;
  }
  return i;
}

// The scheduled step of local step t: the phase list's, or t.
__device__ __forceinline__ long long sched_step(const ShardParams& sh,
                                                long long t) {
  return sh.phase != nullptr ? (long long)sh.phase[t] : t;
}

// The canonical (lambda-order) step of the rank's scheduled step s.
template <int kDom>
__device__ __forceinline__ long long canonical_step(const FracParams& p,
                                                    const ShardParams& sh,
                                                    long long s) {
  if (sh.part == kLinear) return sh.lo + s;
  const long long g = sh.lo + s;
  if constexpr (kDom == kGenericDom) {
    return g;  // a row-major layout's slot index is its canonical step
  } else {
    const unsigned col = (unsigned)(g % sh.ncols), row = (unsigned)(g / sh.ncols);
    return orth_linear(p, p.swap ? row : col, p.swap ? col : row);
  }
}

// The global packed slot (tx, ty) of a member scheduled block.
template <int kDom>
__device__ __forceinline__ void global_slot(const FracParams& p, unsigned bx,
                                            unsigned by, unsigned& tx,
                                            unsigned& ty) {
  if constexpr (kDom == kGenericDom) {
    generic_slot(p, bx, by, tx, ty);
  } else {
    unsigned wx, wy;
    lambda_inverse(p, bx, by, wx, wy);
    tx = p.swap ? wy : wx;
    ty = p.swap ? wx : wy;
  }
}

// Does the rank own member block (bx, by)?  (the bounding grid's test)
template <int kDom>
__device__ __forceinline__ bool shard_owns(const FracParams& p,
                                           const ShardParams& sh,
                                           unsigned bx, unsigned by) {
  if (sh.part == kLinear) {
    long long i;
    if constexpr (kDom == kGenericDom) {
      i = generic_linear(p, bx, by);
    } else {
      unsigned wx, wy;
      lambda_inverse(p, bx, by, wx, wy);
      i = orth_linear(p, wx, wy);
    }
    return i >= sh.lo && i < sh.lo + sh.count;
  }
  unsigned tx, ty;
  global_slot<kDom>(p, bx, by, tx, ty);
  return ty >= sh.lo_row && ty < sh.lo_row + sh.rpd;
}

// Local step t -> the rank's scheduled block (bx, by); false for a step of
// the bounding grid that is not an owned member.  Under mma the chain is
// warp-collective: t must be warp-uniform (every step but a bounding one).
template <int kDom, bool kMma>
__device__ __forceinline__ bool shard_decode(const FracParams& p,
                                             const ShardParams& sh,
                                             const int* __restrict__ lut,
                                             const int* __restrict__ ops,
                                             long long t, int lane,
                                             unsigned& bx, unsigned& by) {
  if (p.lowering == kBounding) {
    bx = (unsigned)(t % p.nbx);
    by = (unsigned)(t / p.nbx);
    bool member;
    if constexpr (kDom == kGenericDom)
      member = generic_contains(p, bx, by);
    else
      member = block_member(p, bx, by, p.nbx, p.r_b);
    return member && shard_owns<kDom>(p, sh, bx, by);
  }
  const long long s = sched_step(sh, t);
  if (p.lowering == kPrefetchLut) {  // the rank's LUT chunk
    bx = (unsigned)lut[s * p.lut_cols + kLutBx];
    by = (unsigned)lut[s * p.lut_cols + kLutBy];
    return true;
  }
  const long long i = canonical_step<kDom>(p, sh, s);
  if constexpr (kMma && kDom == kFractalDom) {
    unsigned sx, sy;  // B7a at the canonical step
    fractal_chain(p, ops, (unsigned)i, lane, false, bx, by, sx, sy);
  } else if constexpr (kMma) {
    unsigned x, y;  // B7c, one step
    rows_chain_warp(p, ops, i, 1, 1, lane, x, y);
    bx = __shfl_sync(kFullMask, x, 0);
    by = __shfl_sync(kFullMask, y, 0);
  } else if constexpr (kDom == kFractalDom) {
    decode(p, nullptr, i, bx, by);
  } else {
    unsigned x, y;
    generic_coords(p, i, x, y);
    bx = x;
    by = y;
  }
  return true;
}

// The storage origin (row, col) in cells of the rank's local array of its
// owned member block (bx, by) at local step t: embedded, the superblock;
// compact, the slot in the rank's slab (the scheduled step's, or under
// bounding the block's slot row less the slab's first).
template <int kDom>
__device__ __forceinline__ void shard_origin(const FracParams& p,
                                             const ShardParams& sh,
                                             long long t, unsigned bx,
                                             unsigned by, long long& row,
                                             long long& col) {
  if (p.storage == kEmbedded) {
    row = (long long)by * p.span;
    col = (long long)bx * p.span;
    return;
  }
  if (p.lowering == kBounding) {
    unsigned tx, ty;
    global_slot<kDom>(p, bx, by, tx, ty);
    row = ((long long)ty - sh.lo_row) * p.th;
    col = (long long)tx * p.tw;
    return;
  }
  const long long s = sched_step(sh, t);
  row = s / sh.ncols * p.th;
  col = s % sh.ncols * p.tw;
}

// A global slot row, in cells (row >= 0) -> the same row of the rank's
// extended array through the ghost map; -1 stays -1.
__device__ __forceinline__ long long ghost_row(const FracParams& p,
                                               const ShardParams& sh,
                                               long long row) {
  if (row < 0) return row;
  long long ty = row / p.th;
  if (ty > sh.nrows_pad - 1) ty = sh.nrows_pad - 1;
  return (long long)sh.gmap[ty] * p.th;
}

}  // namespace fractal
