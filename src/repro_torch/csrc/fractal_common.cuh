// Shared device code of the fractal kernels (sierpinski_write.cu,
// sierpinski_ca.cu): the launch parameters, the lowerings' decode of a
// grid step, lambda^-1 to packed slots, the membership tests, and the
// integer decode, membership and slots of the row-major (generic) domains.
//
// The parameters arrive from Python as one int64 array in the order of
// repro_torch.core.plan.C_PARAMS (the Param enum below).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fractal {

constexpr int kMaxCopies = 16;
constexpr long long kMaxGrid = 2147483647LL;  // gridDim.x limit

enum Family { kGasket = 0, kSpec = 1, kTriangular = 2, kBand = 3, kBox = 4 };
enum Lowering { kClosedForm = 0, kPrefetchLut = 1, kBounding = 2, kMma = 3 };
// The kernels' domain template parameter: the fractal families (runtime
// gasket / FractalSpec, with intra-block cell structure) or the row-major
// generic families (every cell of a member block is live).
enum DomKind { kFractalDom = 0, kGenericDom = 1 };
enum Storage { kEmbedded = 0, kCompact = 1 };
// LUT columns (repro_torch.core.plan._LUT_*): bx, by, sx, sy, then per
// NEIGHBOR_OFFSETS8 neighbour (sx, sy, valid).
enum LutCol { kLutBx = 0, kLutBy = 1, kLutSx = 2, kLutSy = 3, kLutNbr = 4 };

// Index of each parameter in the int64 array (plan.C_PARAMS order).
enum Param {
  kFamily, kLowering, kRb, kK, kM, kRcell, kN, kBlock, kSteps, kNbx,
  kAllow, kOxs, kOys, kStorage, kPitch, kTh, kTw, kBw, kNfine, kCoarsen,
  kSwap, kRfine, kLutCols, kNby, kDomW, kDomOff, kDomTw, kNblocks, kScols,
  kMk, kMk2, kNumParams
};

// NEIGHBOR_OFFSETS8 order (N S W E NW NE SW SE) as (dx, dy).
__constant__ int kNbrDx[8] = {0, 0, -1, 1, -1, 1, -1, 1};
__constant__ int kNbrDy[8] = {-1, 1, 0, 0, -1, -1, 1, 1};

struct FracParams {
  int family;
  int lowering;
  int r_b;      // scale level of the scheduled (coarse) block grid
  int k;        // copies per level
  int m;        // subdivision factor
  int r_cell;   // log_m(coarsen * block): digit levels inside a superblock
  int block;    // fine tile side in cells
  int storage;
  int th, tw;   // storage supertile, cells
  int bw;       // fine blocks per supertile row (storage arrangement)
  int nfine;    // fine blocks per supertile
  int coarsen;  // fine blocks per superblock side
  int swap;     // coarse orthotope coordinate transposed
  int r_fine;   // scale level of the fine block grid
  int lut_cols;
  unsigned int n;      // embedded side in cells
  unsigned int nbx;    // scheduled blocks per side
  unsigned int span;   // coarsen * block
  long long pitch;     // row length of the state array
  long long steps;     // grid steps
  unsigned long long allow;  // bit (dy * m + dx) set for each copy offset
  int ox[kMaxCopies];
  int oy[kMaxCopies];
  // generic families and the mma chains (plan.LaunchParams)
  unsigned nby;        // scheduled blocks per column
  int dom_w, dom_off;  // band window and key-row offset
  long long dom_tw;    // band's triangular head T(w)
  long long nblocks;   // member blocks
  long long scols;     // slot columns of a generic compact layout
  int mk, mk2;         // k-steps of the primary and the neighbour chain
};

inline FracParams make_params(const long long* a) {
  FracParams p;
  p.family = (int)a[kFamily];
  p.lowering = (int)a[kLowering];
  p.r_b = (int)a[kRb];
  p.k = (int)a[kK];
  p.m = (int)a[kM];
  p.r_cell = (int)a[kRcell];
  p.block = (int)a[kBlock];
  p.storage = (int)a[kStorage];
  p.th = (int)a[kTh];
  p.tw = (int)a[kTw];
  p.bw = (int)a[kBw];
  p.nfine = (int)a[kNfine];
  p.coarsen = (int)a[kCoarsen];
  p.swap = (int)a[kSwap];
  p.r_fine = (int)a[kRfine];
  p.lut_cols = (int)a[kLutCols];
  p.n = (unsigned)a[kN];
  p.nbx = (unsigned)a[kNbx];
  p.span = (unsigned)(p.coarsen * p.block);
  p.pitch = a[kPitch];
  p.steps = a[kSteps];
  p.allow = (unsigned long long)a[kAllow];
  const unsigned long long oxs = (unsigned long long)a[kOxs];
  const unsigned long long oys = (unsigned long long)a[kOys];
  for (int c = 0; c < kMaxCopies; ++c) {
    p.ox[c] = (int)((oxs >> (4 * c)) & 15ULL);
    p.oy[c] = (int)((oys >> (4 * c)) & 15ULL);
  }
  p.nby = (unsigned)a[kNby];
  p.dom_w = (int)a[kDomW];
  p.dom_off = (int)a[kDomOff];
  p.dom_tw = a[kDomTw];
  p.nblocks = a[kNblocks];
  p.scols = a[kScols];
  p.mk = (int)a[kMk];
  p.mk2 = (int)a[kMk2];
  return p;
}

inline dim3 grid_of(long long steps) {
  return dim3((unsigned)(steps < kMaxGrid ? steps : kMaxGrid));
}

// Does the digit pair (dx, dy) name a copy offset?
__device__ __forceinline__ bool allowed(const FracParams& p, unsigned dx,
                                        unsigned dy) {
  return (p.allow >> (dy * p.m + dx)) & 1ULL;
}

// Every base-m digit pair of (x, y) over `levels` levels is a copy offset.
__device__ __forceinline__ bool digits_member(const FracParams& p, unsigned x,
                                              unsigned y, int levels) {
  bool ok = true;
  for (int mu = 0; mu < levels; ++mu) {
    ok &= allowed(p, x % p.m, y % p.m);
    x /= p.m;
    y /= p.m;
  }
  return ok;
}

// Is block (bx, by) of a grid of `side` blocks (scale level `levels`) a
// member of the fractal?
__device__ __forceinline__ bool block_member(const FracParams& p, unsigned bx,
                                             unsigned by, unsigned side,
                                             int levels) {
  if (p.family == kGasket) return (bx & (side - 1 - by)) == 0;
  return digits_member(p, bx, by, levels);
}

// Grid step -> scheduled block (bx, by); false for a discarded bounding
// step.
__device__ __forceinline__ bool decode(const FracParams& p,
                                      const int* __restrict__ lut,
                                      long long t, unsigned& bx,
                                      unsigned& by) {
  if (p.lowering == kBounding) {
    bx = (unsigned)(t % p.nbx);
    by = (unsigned)(t / p.nbx);
    return block_member(p, bx, by, p.nbx, p.r_b);
  }
  if (p.lowering == kPrefetchLut) {
    bx = (unsigned)lut[t * p.lut_cols + kLutBx];
    by = (unsigned)lut[t * p.lut_cols + kLutBy];
    return true;
  }
  unsigned i = (unsigned)t;  // num_blocks < 2^32 (checked by the wrapper)
  unsigned x = 0, y = 0;
  if (p.family == kGasket) {
    // lambda_map_linear: base-3 digit b -> Delta = (b / 2, b != 0)
    for (int mu = 0; mu < p.r_b; ++mu) {
      unsigned b = i % 3u;
      i /= 3u;
      x |= (b >> 1) << mu;
      y |= (unsigned)(b != 0) << mu;
    }
  } else {
    // FractalSpec.lambda_map_linear: base-k digit c picks offsets[c]
    unsigned pw = 1;
    for (int mu = 0; mu < p.r_b; ++mu) {
      unsigned c = i % (unsigned)p.k;
      i /= (unsigned)p.k;
      x += (unsigned)p.ox[c] * pw;
      y += (unsigned)p.oy[c] * pw;
      pw *= (unsigned)p.m;
    }
  }
  bx = x;
  by = y;
  return true;
}

// lambda^-1 of the scheduled block (x, y): its packed (orthotope) coords.
// Odd scale levels fill the digits of wy, even ones those of wx.
__device__ __forceinline__ void lambda_inverse(const FracParams& p,
                                               unsigned x, unsigned y,
                                               unsigned& wx, unsigned& wy) {
  wx = 0;
  wy = 0;
  unsigned px = 1, py = 1;
  for (int mu = 1; mu <= p.r_b; ++mu) {
    unsigned c;
    if (p.family == kGasket) {
      c = (x & 1u) + (y & 1u);  // (0,0)->0 (0,1)->1 (1,1)->2
      x >>= 1;
      y >>= 1;
    } else {
      const int dx = (int)(x % (unsigned)p.m), dy = (int)(y % (unsigned)p.m);
      x /= (unsigned)p.m;
      y /= (unsigned)p.m;
      c = 0;  // an unmatched digit pair (a non-member) falls to copy 0
      for (int j = p.k - 1; j >= 0; --j)
        if (p.ox[j] == dx && p.oy[j] == dy) c = (unsigned)j;
    }
    if (mu & 1) {
      wy += c * py;
      py *= (unsigned)p.k;
    } else {
      wx += c * px;
      px *= (unsigned)p.k;
    }
  }
}

// Storage origin (row, col) in cells of the supertile of the member
// scheduled block (bx, by) of step t.
__device__ __forceinline__ void tile_origin(const FracParams& p,
                                           const int* __restrict__ lut,
                                           long long t, unsigned bx,
                                           unsigned by, long long& row,
                                           long long& col) {
  if (p.storage == kEmbedded) {
    row = (long long)by * p.span;
    col = (long long)bx * p.span;
    return;
  }
  unsigned tx, ty;
  if (p.lowering == kPrefetchLut) {
    tx = (unsigned)lut[t * p.lut_cols + kLutSx];
    ty = (unsigned)lut[t * p.lut_cols + kLutSy];
  } else {
    unsigned wx, wy;
    lambda_inverse(p, bx, by, wx, wy);
    tx = p.swap ? wy : wx;
    ty = p.swap ? wx : wy;
  }
  row = (long long)ty * p.th;
  col = (long long)tx * p.tw;
}

// Embedded fine-block offset (ey, ex) inside its superblock of the packed
// fine block q of a supertile (identity arrangement without a table).
__device__ __forceinline__ void fine_offset(const FracParams& p,
                                            const int* __restrict__ perm,
                                            int q, int& ey, int& ex) {
  if (perm != nullptr) {
    ey = perm[2 * q];
    ex = perm[2 * q + 1];
  } else {
    ey = q / p.bw;
    ex = q % p.bw;
  }
}

// Membership of the cell at offset (ox, oy) from the origin of a member
// superblock, at embedded (gx, gy).
__device__ __forceinline__ bool cell_member(const FracParams& p, unsigned gx,
                                            unsigned gy, unsigned ox,
                                            unsigned oy) {
  if (p.family == kGasket) return (gx & (p.n - 1 - gy)) == 0;
  // the superblock's digits were checked by the decode; the low r_cell
  // digits of the cell are those of its offset inside the superblock
  return digits_member(p, ox, oy, p.r_cell);
}

// ---------------------------------------------------------------------------
// The row-major (generic) domains: TriangularDomain, BandDomain and
// BoundingBoxDomain of repro_torch/core/domain.py, in integer math.
// ---------------------------------------------------------------------------

// floor(sqrt(x)) for x < 2^31: a float sqrt, then two integer correction
// rounds (domain._isqrt's device form; a bare sqrtf is not exact).
__device__ __forceinline__ long long isqrt_exact(long long x) {
  long long s = (long long)floorf(sqrtf((float)x));
  for (int i = 0; i < 2; ++i) {
    if ((s + 1) * (s + 1) <= x) s += 1;
    if (s * s > x) s -= 1;
  }
  return s;
}

// The triangle's row q and column k of linear index i (k <= q).
__device__ __forceinline__ void tri_decode(long long i, long long& k,
                                           long long& q) {
  q = (isqrt_exact(8 * i + 1) - 1) / 2;
  k = i - q * (q + 1) / 2;
}

// block_coords: linear index i of a member block -> (bx, by).
__device__ __forceinline__ void generic_coords(const FracParams& p,
                                               long long i, unsigned& bx,
                                               unsigned& by) {
  long long k, q;
  if (p.family == kTriangular) {
    tri_decode(i, k, q);
  } else if (p.family == kBand) {
    const long long w = p.dom_w;
    if (p.dom_off) {  // rectangular: every row a full window
      q = i / w;
      k = p.dom_off + q - w + 1 + i % w;
    } else if (i < p.dom_tw) {  // the triangular head, rows 0..w-1
      tri_decode(i, k, q);
    } else {  // then dense rows of width w
      const long long j = i - p.dom_tw;
      q = w + j / w;
      k = q - w + 1 + j % w;
    }
  } else {  // kBox
    k = i % p.nbx;
    q = i / p.nbx;
  }
  bx = (unsigned)k;
  by = (unsigned)q;
}

// The member columns [lo, lo + len) of block row q in block_coords order
// (generic_coords' rows): a row walk that steps past lo + len - 1 goes on
// at the next row's lo.
__device__ __forceinline__ void generic_row(const FracParams& p, long long q,
                                            long long& lo, long long& len) {
  const long long w = p.dom_w;
  if (p.family == kTriangular) {
    lo = 0;
    len = q + 1;
  } else if (p.family == kBand) {
    if (p.dom_off) {  // rectangular: every row a full window
      lo = p.dom_off + q - w + 1;
      len = w;
    } else if (q < w) {  // the triangular head
      lo = 0;
      len = q + 1;
    } else {
      lo = q - w + 1;
      len = w;
    }
  } else {  // kBox
    lo = 0;
    len = p.nbx;
  }
}

// contains: is block (x, y) a member (any x, y, as the domains take them)?
__device__ __forceinline__ bool generic_contains(const FracParams& p,
                                                 long long x, long long y) {
  if (p.family == kTriangular) return x <= y;
  if (p.family == kBand)
    return x <= y + p.dom_off && x > y + p.dom_off - p.dom_w;
  return true;  // kBox: every block
}

// linear_index of member block (x, y), clipped into [0, nblocks) as
// CompactLayout.slot clips it.
__device__ __forceinline__ long long generic_linear(const FracParams& p,
                                                    long long x, long long y) {
  long long i;
  const long long w = p.dom_w;
  if (p.family == kTriangular) {
    i = y * (y + 1) / 2 + x;
  } else if (p.family == kBand) {
    if (p.dom_off)
      i = y * w + (x - (p.dom_off + y - w + 1));
    else if (y < w)
      i = y * (y + 1) / 2 + x;
    else
      i = p.dom_tw + (y - w) * w + (x - (y - w + 1));
  } else {
    i = y * p.nbx + x;
  }
  return i < 0 ? 0 : (i >= p.nblocks ? p.nblocks - 1 : i);
}

// Grid step -> scheduled block under closed_form / prefetch_lut /
// bounding; false for a discarded bounding step.
__device__ __forceinline__ bool generic_decode(const FracParams& p,
                                              const int* __restrict__ lut,
                                              long long t, unsigned& bx,
                                              unsigned& by) {
  if (p.lowering == kBounding) {
    bx = (unsigned)(t % p.nbx);
    by = (unsigned)(t / p.nbx);
    return generic_contains(p, bx, by);
  }
  if (p.lowering == kPrefetchLut) {
    bx = (unsigned)lut[t * p.lut_cols + kLutBx];
    by = (unsigned)lut[t * p.lut_cols + kLutBy];
    return true;
  }
  generic_coords(p, t, bx, by);
  return true;
}

// The packed slot of member block (x, y): the row-major near-square grid
// position of its linear index.
__device__ __forceinline__ void generic_slot(const FracParams& p, long long x,
                                             long long y, unsigned& sx,
                                             unsigned& sy) {
  const long long i = generic_linear(p, x, y);
  sx = (unsigned)(i % p.scols);
  sy = (unsigned)(i / p.scols);
}

// Storage origin (row, col) in cells of the member block (bx, by) of step t.
__device__ __forceinline__ void generic_origin(const FracParams& p,
                                              const int* __restrict__ lut,
                                              long long t, unsigned bx,
                                              unsigned by, long long& row,
                                              long long& col) {
  if (p.storage == kEmbedded) {
    row = (long long)by * p.span;
    col = (long long)bx * p.span;
    return;
  }
  unsigned sx, sy;
  if (p.lowering == kPrefetchLut) {
    sx = (unsigned)lut[t * p.lut_cols + kLutSx];
    sy = (unsigned)lut[t * p.lut_cols + kLutSy];
  } else {
    generic_slot(p, bx, by, sx, sy);
  }
  row = (long long)sy * p.th;
  col = (long long)sx * p.tw;
}

}  // namespace fractal
