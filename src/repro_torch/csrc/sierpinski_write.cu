// Fractal write and sum kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (repro_torch/kernels/_cuda.py).
//
// Replaces (JAX package, Pallas):
//   sw_write         <- kernels/sierpinski_write.py::_write_kernel
//                       (and its _dma / _gpu variants, masks _cell_mask and
//                       _tile_mask)
//   sw_sum_partials  <- kernels/sierpinski_write.py::_sum_kernel
//                       (and its _dma / _gpu variants)
//   sw_sum_combine   <- kernels/sierpinski_write.py::_emit_sum.finish, the
//                       in-step-order combine of the per-step partials
//
// What bounds them on an H100 (80 GB HBM3 at 3.35 TB/s): bytes.  The write
// must store every member cell once: 4 * 3^16 B ~ 172 MB for the f32 gasket
// at n = 2^16, ~51 us, under either storage (compact storage also holds
// the non-member cells of member blocks, but the write stores only
// members); the causal triangle of 2^11 block rows at rho = 32 stores
// 8 GiB, ~2.6 ms.  The sum must read the same cells once.  The decode of a
// step is a few to a few hundred integer ops, the membership test a few
// per cell.  The combine is a serial chain of f32 adds, one per grid step:
// it is bound by the latency of that chain (one thread; the rest of its
// CTA stages the partials through shared memory), not by bytes.
//
// What the design does about it (write_kernel, sum_partials_kernel):
//   * a warp owns a grid step, a CTA of kWarps warps owns runs of
//     consecutive steps: the grid is persistent (the SMs times the CTAs
//     the instantiation keeps resident), CTAs take runs by grid stride
//     over runs with 64-bit step ids (the 2^32 steps of the bounding box
//     at rho = 1 launch too), and warp w takes steps w, w + kWarps, ... of
//     a run.  The launch pays no CTA per block, and a step is decoded
//     once, not in every thread of a CTA;
//   * consecutive steps advance along the row: a warp decodes its first
//     step of a run, then walks the block coords forward by kWarps (a
//     row-major domain under closed_form: along the member row of
//     block_coords, and its packed slot along the slot row; the bounding
//     box: along the box row), so the triangle pays its integer sqrt
//     once a run.  A random-access decode (the LUT row, lambda's digit
//     loop and lambda^-1) runs for 32 of the warp's steps at once, one a
//     lane, and each step's tile is broadcast by __shfl_sync.  The
//     fractal chain (B7a) runs once per step in the step's warp;
//   * storage: the supertile origin is the embedded superblock (embedded
//     storage), or its packed slot (compact storage): lambda^-1 in
//     registers, the LUT columns 2-3, the slots chain, or the generic
//     slot.  A coarsened supertile is visited fine block by fine block in
//     embedded order (the packed fine block through the inverse half of
//     the permutation table);
//   * the cells of a fine block are chunks of kV = 16 / elem_bytes cells
//     when kV divides the block (else single cells); chunk j of the block
//     (row-major) belongs to lane j % 32.  When the block, the pitch and
//     the state's base are 16-byte aligned (one uniform test per launch)
//     a chunk is one 128-bit access, else kV scalar ones in the same
//     order.  A generic domain's cells are all live: a plain
//     st.global.v4.  On the fractal families every cell keeps its own
//     cell_member predicate: a chunk of members is one vector store, a
//     partial chunk scalar stores of its members, a chunk of non-members
//     nothing (a non-member cell is never written);
//   * the sum adds a lane's cells in f32 in chunk order, then a fixed
//     __shfl_xor_sync butterfly, and lane 0 stores partials[step]; a
//     discarded bounding step stores 0.  The order depends only on the
//     cell's offset in its superblock (fine blocks in embedded order), so
//     the lowerings agree bit for bit, compact storage agrees with
//     embedded, and integer-valued states sum bit-identically to the
//     plain version.  The combine then adds the partials in step order,
//     the JAX package's order (lambda order, or row-major by * nbx + bx
//     for the bounding box);
//   * under mma the block comes from the tensor-core chains of
//     mma_decode.cuh: a fractal's chain (B7a, with the own slot under
//     compact storage) once per step in the step's warp; a row-major
//     domain's row chain batched (B7c, rows_chain_warp): one m16n8k16
//     chain decodes eight of the warp's steps (a warp's share of a run is
//     a multiple of eight steps, so only the launch's last batch runs
//     short);
//   * cell offsets are 64-bit: an n = 2^16 state has 2^32 cells.
//
// Sharded (sw_write_sharded, sw_sum_partials_sharded; this source built
// with -DREPRO_SHARDED, a library of its own): write_shard_kernel and
// sum_shard_kernel, the same bodies over one rank's steps of a domain
// split by repro_torch.core.shard.ShardedPlan (shard_common.cuh) -- its
// range of the lambda enumeration on the replicated embedded state, or
// its slab of packed rows.  A warp takes its steps one at a time
// (shard_decode: the digit loop, a chain, or the rank's LUT chunk at the
// step's canonical index; the bounding grid's ownership test), then visits
// the tile with the unsharded kernels' cell loops, so a rank's partials
// are the unsharded kernel's partials of its blocks, bit for bit.
//
// Traced (sw_write_trace, sw_sum_partials_trace; this source built with
// -DREPRO_TRACE, a library of its own): write_kernel and
// sum_partials_kernel instantiated with kTrace, which also write each
// grid step's access-trace row (trace_rows.cuh) from lane 0 of its warp:
// the step's block and the supertile origin its stores (write) or loads
// (sum) address, and the sum's partial slot.  The body runs unchanged,
// so a traced launch's output is the untraced one's, bit for bit.  The
// kTrace = false instantiations take the rows as a trailing argument
// they never read.

#include "fractal_common.cuh"
#include "mma_decode.cuh"
#include "shard_common.cuh"
#include "trace_rows.cuh"

namespace {

using namespace fractal;

enum DType { kF32 = 0, kBF16 = 1, kI32 = 2 };

// A CTA is kWarps warps, one grid step each; four CTAs stay resident on an
// SM (at most 64 registers a thread), 32 warps of steps in flight.  Each
// CTA takes about kRunsPerCta runs, so uneven runs (bounding rows of
// discarded blocks) even out; under the batched row chain a warp's share
// of a run is a multiple of kRowsBatch steps, so its batches are full.
// A warp decodes kLaneSteps of its steps at once, one a lane, where the
// decode is a random access (the LUT row, lambda's digit loop).
constexpr int kWarps = 8, kThreads = 32 * kWarps, kMinCtasPerSm = 4;
constexpr int kRunsPerCta = 16, kLaneSteps = 32;

// The cell loop's geometry, uniform over a launch (cells_of).
struct Cells {
  int wide;       // chunks of kV cells (kV divides the block), else 1 cell
  int cpr;        // chunks per block row
  int dr, dc;     // a lane's stride of 32 chunks: dr rows and dc chunks
  int iters;      // chunk rounds of a warp per fine block
  int vec;        // chunks are 16-byte aligned: one 128-bit access each
};

// Where step t's supertile lies: its storage origin (row0, col0) and its
// superblock's embedded origin (x0, y0).
struct Tile {
  long long row0, col0;
  unsigned x0, y0;
};

// A warp's walk along the rows: the block (bx, by) of its current step,
// the member columns [lo, lo + len) of row by, and the packed slot.
struct Walk {
  long long bx, by, lo, len, sx, sy;
};

// Walk from step t - kWarps to step t (first: decode t from scratch).
// Bounding box: t = by * nbx + bx.
__device__ __forceinline__ void walk_box(const FracParams& p, long long t,
                                         bool first, Walk& w) {
  if (first) {
    w.bx = t % p.nbx;
    w.by = t / p.nbx;
    return;
  }
  w.bx += kWarps;
  while (w.bx >= p.nbx) {
    w.bx -= p.nbx;
    ++w.by;
  }
}

// A row-major domain's member rows (block_coords order) and, under
// compact storage, the slot of member t: (t % scols, t / scols).
__device__ __forceinline__ void walk_rows(const FracParams& p, long long t,
                                          bool first, Walk& w) {
  if (first) {
    unsigned bx, by;
    generic_coords(p, t, bx, by);
    w.bx = bx;
    w.by = by;
    generic_row(p, w.by, w.lo, w.len);
    if (p.storage == kCompact) {
      w.sx = t % p.scols;
      w.sy = t / p.scols;
    }
    return;
  }
  long long j = w.bx - w.lo + kWarps;
  while (j >= w.len) {
    j -= w.len;
    ++w.by;
    generic_row(p, w.by, w.lo, w.len);
  }
  w.bx = w.lo + j;
  if (p.storage == kCompact) {
    w.sx += kWarps;
    while (w.sx >= p.scols) {
      w.sx -= p.scols;
      ++w.sy;
    }
  }
}

// Decode grid step t: of the calling warp (lane-uniform), or of the
// calling lane (the LUT, lambda's digit loop); false for a discarded
// bounding step.  `first`: t is the warp's first step of a run.
template <int kDom, bool kMma>
__device__ __forceinline__ bool step_tile(const FracParams& p,
                                          const int* __restrict__ lut,
                                          const int* __restrict__ ops,
                                          long long t, bool first, Walk& w,
                                          Tile& tile) {
  unsigned bx, by;
  if constexpr (kMma) {  // the fractal chain (B7a); rows: rows_chain_warp
    const bool compact = p.storage == kCompact;
    unsigned sx = 0, sy = 0;
    fractal_chain(p, ops, (unsigned)t, threadIdx.x & 31, compact, bx, by,
                  sx, sy);
    tile.row0 = compact ? (long long)sy * p.th : (long long)by * p.span;
    tile.col0 = compact ? (long long)sx * p.tw : (long long)bx * p.span;
  } else if (p.lowering == kBounding) {
    walk_box(p, t, first, w);
    bx = (unsigned)w.bx;
    by = (unsigned)w.by;
    if (kDom == kFractalDom) {
      if (!block_member(p, bx, by, p.nbx, p.r_b)) return false;
      tile_origin(p, lut, t, bx, by, tile.row0, tile.col0);
    } else {
      if (!generic_contains(p, bx, by)) return false;
      generic_origin(p, lut, t, bx, by, tile.row0, tile.col0);
    }
  } else if (kDom == kGenericDom && p.lowering == kClosedForm) {
    walk_rows(p, t, first, w);
    bx = (unsigned)w.bx;
    by = (unsigned)w.by;
    const bool compact = p.storage == kCompact;
    tile.row0 = compact ? w.sy * p.th : (long long)by * p.span;
    tile.col0 = compact ? w.sx * p.tw : (long long)bx * p.span;
  } else if (kDom == kFractalDom) {
    decode(p, lut, t, bx, by);
    tile_origin(p, lut, t, bx, by, tile.row0, tile.col0);
  } else {
    generic_decode(p, lut, t, bx, by);
    generic_origin(p, lut, t, bx, by, tile.row0, tile.col0);
  }
  tile.x0 = bx * p.span;
  tile.y0 = by * p.span;
  return true;
}

// Call visit(t, live, tile) for every grid step, from the step's warp
// (warp-uniform control flow, as mma.sync and the shuffles need).
template <int kDom, bool kMma, typename Visit>
__device__ __forceinline__ void for_each_step(const FracParams& p,
                                              const int* __restrict__ lut,
                                              const int* __restrict__ ops,
                                              long long run, Visit&& visit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nruns = (p.steps + run - 1) / run;
  for (long long r = blockIdx.x; r < nruns; r += gridDim.x) {
    const long long t0 = r * run + warp;
    const long long end = min(r * run + run, p.steps);
    if constexpr (kMma && kDom == kGenericDom) {
      // B7c batched: steps t + j * kWarps, j < kRowsBatch, in one chain
      for (long long t = t0; t < end; t += (long long)kWarps * kRowsBatch) {
        const long long left = (end - t + kWarps - 1) / kWarps;
        const int nlive = left < kRowsBatch ? (int)left : kRowsBatch;
        unsigned bxj, byj;
        rows_chain_warp(p, ops, t, kWarps, nlive, lane, bxj, byj);
        for (int j = 0; j < nlive; ++j) {
          const long long tj = t + (long long)j * kWarps;
          const unsigned bx = __shfl_sync(kFullMask, bxj, j);
          const unsigned by = __shfl_sync(kFullMask, byj, j);
          Tile tl;
          generic_origin(p, nullptr, tj, bx, by, tl.row0, tl.col0);
          tl.x0 = bx * p.span;
          tl.y0 = by * p.span;
          visit(tj, true, tl);
        }
      }
    } else if (!kMma && (p.lowering == kPrefetchLut ||
                         (kDom == kFractalDom && p.lowering == kClosedForm))) {
      // lane j decodes step t + j * kWarps; each step's tile is then
      // broadcast from its lane
      for (long long t = t0; t < end; t += (long long)kWarps * kLaneSteps) {
        const long long mine = t + (long long)lane * kWarps;
        Tile tm{};
        bool lm = false;
        if (mine < end) {
          Walk w;  // unused: these decodes do not walk
          lm = step_tile<kDom, false>(p, lut, ops, mine, true, w, tm);
        }
        const long long left = (end - t + kWarps - 1) / kWarps;
        const int nlive = left < kLaneSteps ? (int)left : kLaneSteps;
        for (int j = 0; j < nlive; ++j) {
          Tile tl;
          tl.row0 = __shfl_sync(kFullMask, tm.row0, j);
          tl.col0 = __shfl_sync(kFullMask, tm.col0, j);
          tl.x0 = __shfl_sync(kFullMask, tm.x0, j);
          tl.y0 = __shfl_sync(kFullMask, tm.y0, j);
          const bool live = __shfl_sync(kFullMask, (int)lm, j) != 0;
          visit(t + (long long)j * kWarps, live, tl);
        }
      }
    } else {
      Walk w{};
      for (long long t = t0; t < end; t += kWarps) {
        Tile tl;
        const bool live = step_tile<kDom, kMma>(p, lut, ops, t, t == t0, w,
                                                tl);
        visit(t, live, tl);
      }
    }
  }
}

// for_each_step for one rank of a sharded launch: a warp takes its steps
// of a run one at a time (shard_decode; a chain's step is warp-uniform),
// and the tile lies in the rank's local array (shard_origin).
template <int kDom, bool kMma, typename Visit>
__device__ __forceinline__ void for_each_shard_step(
    const FracParams& p, const ShardParams& sh, const int* __restrict__ lut,
    const int* __restrict__ ops, long long run, Visit&& visit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nruns = (p.steps + run - 1) / run;
  for (long long r = blockIdx.x; r < nruns; r += gridDim.x) {
    const long long end = min(r * run + run, p.steps);
    for (long long t = r * run + warp; t < end; t += kWarps) {
      unsigned bx = 0, by = 0;
      const bool live = shard_decode<kDom, kMma>(p, sh, lut, ops, t, lane,
                                                 bx, by);
      Tile tl{};
      if (live) shard_origin<kDom>(p, sh, t, bx, by, tl.row0, tl.col0);
      tl.x0 = bx * p.span;
      tl.y0 = by * p.span;
      visit(t, live, tl);
    }
  }
}

// Call f(srow, scol, ox0, oy0) for each fine block of a supertile, in
// embedded order: its storage row/col offset in the supertile and its
// cell offset inside the superblock.  kTiled is false when the supertile
// is one fine block (coarsen 1).  perm: the packed fine blocks' embedded
// offsets, then each embedded fine block's packed index or -1.
template <bool kTiled, typename F>
__device__ __forceinline__ void for_each_fine(const FracParams& p,
                                              const int* __restrict__ perm,
                                              F&& f) {
  if (!kTiled) {
    f(0LL, 0LL, 0u, 0u);
    return;
  }
  const int s = p.coarsen;
  const int ne = perm != nullptr ? s * s : p.nfine;
  for (int e = 0; e < ne; ++e) {
    int q = e, ey = e / p.bw, ex = e % p.bw;
    if (perm != nullptr) {
      q = perm[2 * p.nfine + e];
      if (q < 0) continue;  // a non-member fine block: not stored
      ey = e / s;
      ex = e % s;
    }
    f((long long)(q / p.bw) * p.block, (long long)(q % p.bw) * p.block,
      (unsigned)ex * p.block, (unsigned)ey * p.block);
  }
}

// Call f(off, live) for each chunk of the lane in one fine block: off its
// first cell's offset from the block's storage origin, live the member
// bits of its cells (all set on a generic domain).  kV cells per wide
// chunk.
template <int kV, bool kFrac, typename F>
__device__ __forceinline__ void for_each_chunk(const FracParams& p,
                                               const Cells& L, int lane,
                                               unsigned gx0, unsigned gy0,
                                               unsigned ox0, unsigned oy0,
                                               F&& f) {
  const int va = L.wide ? kV : 1;
  int r = lane / L.cpr, c = lane - r * L.cpr;
#pragma unroll 4
  for (int i = 0; i < L.iters; ++i) {
    if (r < p.block) {
      const unsigned ix = (unsigned)(c * va), iy = (unsigned)r;
      unsigned live = (1u << va) - 1;
      if (kFrac) {
        live = 0;
#pragma unroll
        for (int e = 0; e < kV; ++e)
          if (e < va && cell_member(p, gx0 + ix + e, gy0 + iy, ox0 + ix + e,
                                    oy0 + iy))
            live |= 1u << e;
      }
      f((long long)r * p.pitch + ix, live);
    }
    r += L.dr;
    c += L.dc;
    if (c >= L.cpr) {
      c -= L.cpr;
      ++r;
    }
  }
}

// The 128-bit word of kV copies of a cell value.
template <typename W>
__device__ __forceinline__ uint4 splat(W v) {
  const unsigned w = sizeof(W) == 4 ? (unsigned)v
                                    : ((unsigned)v | ((unsigned)v << 16));
  return make_uint4(w, w, w, w);
}

// write_shard_kernel below repeats this body over one rank's steps: keep
// the two in step.
template <int kDom, bool kMma, bool kTiled, typename W, bool kTrace = false>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
write_kernel(W* __restrict__ m, W value, FracParams p, Cells L, long long run,
             const int* __restrict__ lut, const int* __restrict__ perm,
             const int* __restrict__ ops, int* __restrict__ rows) {
  constexpr int kV = 16 / sizeof(W);
  constexpr bool kFrac = kDom == kFractalDom;
  const int lane = threadIdx.x & 31;
  const unsigned full = L.wide ? (1u << kV) - 1 : 1u;
  const uint4 vv = splat(value);
  for_each_step<kDom, kMma>(p, lut, ops, run,
                            [&](long long t, bool live, const Tile& tl) {
    if constexpr (kTrace) {
      if (lane == 0) {
        int* r = trace::visit(rows, t, live, live ? tl.x0 / p.span : 0,
                              live ? tl.y0 / p.span : 0);
        if (live) trace::tile(r + trace::kStoreRow, p, tl.row0, tl.col0);
      }
    }
    if (!live) return;
    for_each_fine<kTiled>(p, perm, [&](long long srow, long long scol,
                                       unsigned ox0, unsigned oy0) {
      W* base = m + (tl.row0 + srow) * p.pitch + tl.col0 + scol;
      for_each_chunk<kV, kFrac>(p, L, lane, tl.x0 + ox0, tl.y0 + oy0, ox0,
                                oy0, [&](long long off, unsigned bits) {
        W* cell = base + off;
        if (L.vec && bits == full) {
          *reinterpret_cast<uint4*>(cell) = vv;
          return;
        }
#pragma unroll
        for (int e = 0; e < kV; ++e)
          if ((bits >> e) & 1u) cell[e] = value;
      });
    });
  });
}

// acc += the member cells (bits) of a chunk as f32, in cell order: one
// 128-bit load (vec) or a scalar load per member; a 1-cell chunk is cell 0.
template <int DT, int kV>
__device__ __forceinline__ float add_chunk(float acc,
                                           const void* __restrict__ m,
                                           long long off, bool vec, int va,
                                           unsigned bits) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        static_cast<const char*>(m) + off * (16 / kV));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (DT == kBF16) {
        if ((bits >> (2 * i)) & 1u) acc += __uint_as_float(w[i] << 16);
        if ((bits >> (2 * i + 1)) & 1u)
          acc += __uint_as_float(w[i] & 0xffff0000u);
      } else if ((bits >> i) & 1u) {
        acc += DT == kF32 ? __uint_as_float(w[i]) : (float)(int)w[i];
      }
    }
    return acc;
  }
#pragma unroll
  for (int e = 0; e < kV; ++e) {
    if (e >= va) break;
    if (!((bits >> e) & 1u)) continue;
    if (DT == kF32) {
      acc += static_cast<const float*>(m)[off + e];
    } else if (DT == kBF16) {
      const unsigned h = static_cast<const unsigned short*>(m)[off + e];
      acc += __uint_as_float(h << 16);
    } else {
      acc += (float)static_cast<const int*>(m)[off + e];
    }
  }
  return acc;
}

// sum_shard_kernel below repeats this body over one rank's steps: keep
// the two in step.
template <int kDom, bool kMma, bool kTiled, int DT, bool kTrace = false>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
sum_partials_kernel(const void* __restrict__ m, float* __restrict__ partials,
                    FracParams p, Cells L, long long run,
                    const int* __restrict__ lut,
                    const int* __restrict__ perm,
                    const int* __restrict__ ops, int* __restrict__ rows) {
  constexpr int kV = DT == kBF16 ? 8 : 4;
  constexpr bool kFrac = kDom == kFractalDom;
  const int lane = threadIdx.x & 31;
  const int va = L.wide ? kV : 1;
  for_each_step<kDom, kMma>(p, lut, ops, run,
                            [&](long long t, bool live, const Tile& tl) {
    if constexpr (kTrace) {
      if (lane == 0) {
        int* r = trace::visit(rows, t, live, live ? tl.x0 / p.span : 0,
                              live ? tl.y0 / p.span : 0);
        if (live) trace::tile(r + trace::kLoads + 2 * 4, p, tl.row0, tl.col0);
        r[trace::kSlot] = (int)t;
      }
    }
    float acc = 0.0f;
    if (live) {
      for_each_fine<kTiled>(p, perm, [&](long long srow, long long scol,
                                         unsigned ox0, unsigned oy0) {
        const long long base = (tl.row0 + srow) * p.pitch + tl.col0 + scol;
        for_each_chunk<kV, kFrac>(p, L, lane, tl.x0 + ox0, tl.y0 + oy0,
                                  ox0, oy0, [&](long long off,
                                                unsigned bits) {
          if (bits != 0) acc = add_chunk<DT, kV>(acc, m, base + off, L.vec,
                                                 va, bits);
        });
      });
      // fixed butterfly: every lane ends with the same bits (a + b == b + a)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(kFullMask, acc, o);
    }
    if (lane == 0) partials[t] = acc;  // 0 for a discarded bounding step
  });
}

// The sharded kernels: write_kernel's and sum_partials_kernel's bodies over
// one rank's steps (for_each_shard_step).  They stand beside the unsharded
// kernels instead of a kShard branch inside them, which moved the register
// allocation of ten unsharded instantiations.
template <int kDom, bool kMma, bool kTiled, typename W>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
write_shard_kernel(W* __restrict__ m, W value, FracParams p, Cells L,
                   long long run, const int* __restrict__ lut,
                   const int* __restrict__ perm,
                   const int* __restrict__ ops, ShardParams sh) {
  constexpr int kV = 16 / sizeof(W);
  constexpr bool kFrac = kDom == kFractalDom;
  const int lane = threadIdx.x & 31;
  const unsigned full = L.wide ? (1u << kV) - 1 : 1u;
  const uint4 vv = splat(value);
  for_each_shard_step<kDom, kMma>(p, sh, lut, ops, run,
                                  [&](long long, bool live,
                                      const Tile& tl) {
    if (!live) return;
    for_each_fine<kTiled>(p, perm, [&](long long srow, long long scol,
                                       unsigned ox0, unsigned oy0) {
      W* base = m + (tl.row0 + srow) * p.pitch + tl.col0 + scol;
      for_each_chunk<kV, kFrac>(p, L, lane, tl.x0 + ox0, tl.y0 + oy0, ox0,
                                oy0, [&](long long off, unsigned bits) {
        W* cell = base + off;
        if (L.vec && bits == full) {
          *reinterpret_cast<uint4*>(cell) = vv;
          return;
        }
#pragma unroll
        for (int e = 0; e < kV; ++e)
          if ((bits >> e) & 1u) cell[e] = value;
      });
    });
  });
}

template <int kDom, bool kMma, bool kTiled, int DT>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
sum_shard_kernel(const void* __restrict__ m, float* __restrict__ partials,
                 FracParams p, Cells L, long long run,
                 const int* __restrict__ lut, const int* __restrict__ perm,
                 const int* __restrict__ ops, ShardParams sh) {
  constexpr int kV = DT == kBF16 ? 8 : 4;
  constexpr bool kFrac = kDom == kFractalDom;
  const int lane = threadIdx.x & 31;
  const int va = L.wide ? kV : 1;
  for_each_shard_step<kDom, kMma>(p, sh, lut, ops, run,
                                  [&](long long t, bool live,
                                      const Tile& tl) {
    float acc = 0.0f;
    if (live) {
      for_each_fine<kTiled>(p, perm, [&](long long srow, long long scol,
                                         unsigned ox0, unsigned oy0) {
        const long long base = (tl.row0 + srow) * p.pitch + tl.col0 + scol;
        for_each_chunk<kV, kFrac>(p, L, lane, tl.x0 + ox0, tl.y0 + oy0,
                                  ox0, oy0, [&](long long off,
                                                unsigned bits) {
          if (bits != 0) acc = add_chunk<DT, kV>(acc, m, base + off, L.vec,
                                                 va, bits);
        });
      });
      // fixed butterfly: every lane ends with the same bits (a + b == b + a)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(kFullMask, acc, o);
    }
    if (lane == 0) partials[t] = acc;  // 0 for a discarded bounding step
  });
}

// One thread adds the partials in step order (the JAX package's order).
// The other threads of the CTA stage the next chunk of partials into
// shared memory while it adds the current one, so the chain waits on
// shared-memory reads instead of device-memory latency.
constexpr int kCombineThreads = 256;
constexpr int kCombineChunk = 4096;

__global__ void sum_combine_kernel(const float* __restrict__ partials,
                                   long long steps, float* __restrict__ out) {
  __shared__ float buf[2][kCombineChunk];
  const long long nchunks = (steps + kCombineChunk - 1) / kCombineChunk;
  for (int j = threadIdx.x; j < kCombineChunk; j += blockDim.x)
    buf[0][j] = j < steps ? partials[j] : 0.0f;
  __syncthreads();
  float acc = 0.0f;
  for (long long c = 0; c < nchunks; ++c) {
    const int cur = (int)(c & 1);
    if (threadIdx.x == 0) {
      const long long left = steps - c * kCombineChunk;
      const int len = left < kCombineChunk ? (int)left : kCombineChunk;
#pragma unroll 16
      for (int j = 0; j < len; ++j) acc += buf[cur][j];
    } else if (c + 1 < nchunks) {
      const long long base = (c + 1) * kCombineChunk;
      for (int j = threadIdx.x - 1; j < kCombineChunk; j += blockDim.x - 1)
        buf[cur ^ 1][j] = base + j < steps ? partials[base + j] : 0.0f;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = acc;
}

bool generic_family(const FracParams& p) {
  return p.family == kTriangular || p.family == kBand || p.family == kBox;
}

// The cell loop of a state with elem_bytes-byte cells at m.
Cells cells_of(const FracParams& p, int elem_bytes, const void* m) {
  const int v = 16 / elem_bytes;
  Cells L;
  L.wide = p.block % v == 0;
  L.cpr = L.wide ? p.block / v : p.block;
  L.dr = 32 / L.cpr;
  L.dc = 32 % L.cpr;
  L.iters = (int)(((long long)p.block * L.cpr + 31) / 32);
  L.vec = L.wide && p.pitch % v == 0 &&
          reinterpret_cast<uintptr_t>(m) % 16 == 0;
  return L;
}

// The persistent grid of an instantiation: the SMs times the CTAs it
// keeps resident (per_sm, found once by the caller), each CTA taking
// about kRunsPerCta runs of `run` steps, a multiple of kWarps * batch.
cudaError_t persistent(const void* kernel, int& per_sm, long long steps,
                       int batch, long long& run, unsigned& grid) {
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long ctas = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long unit = (long long)kWarps * batch;
  const long long share = ctas * unit * kRunsPerCta;
  const long long units = (steps + share - 1) / share;
  run = unit * (units > 0 ? units : 1);
  const long long runs = (steps + run - 1) / run;
  grid = (unsigned)(runs < ctas ? runs : ctas);
  return cudaSuccess;
}

// The operands of one launch beside the state: the tables, for a sharded
// launch the rank's shard parameters (kShard), and for a traced one its
// trace rows (kTrace).
struct Tables {
  const int* lut;
  const int* perm;
  const int* ops;
  ShardParams sh;
  int* rows;
};

// Find the persistent grid of `kernel`, then go(grid, run).
template <typename F>
cudaError_t launch_persistent(const void* kernel, int& per_sm, long long steps,
                              int batch, F&& go) {
  long long run = 0;
  unsigned grid = 0;
  const cudaError_t e = persistent(kernel, per_sm, steps, batch, run, grid);
  if (e != cudaSuccess) return e;
  go(grid, run);
  return cudaGetLastError();
}

// One launch of write_kernel (or write_shard_kernel): the instantiation of
// the domain kind, the lowering, the tiling (a supertile of more than one
// fine block), the sharding and the trace.
template <int kDom, bool kMma, bool kTiled, bool kShard, bool kTrace,
          typename W>
cudaError_t launch_write_as(W* m, W value, const FracParams& p,
                            const Tables& tb, cudaStream_t s) {
  static int per_sm = 0;  // one per instantiation
  const Cells L = cells_of(p, sizeof(W), m);
  if constexpr (kShard) {
    auto* kernel = write_shard_kernel<kDom, kMma, kTiled, W>;
    return launch_persistent(
        (const void*)kernel, per_sm, p.steps, 1,
        [&](unsigned grid, long long run) {
          kernel<<<grid, kThreads, 0, s>>>(m, value, p, L, run, tb.lut,
                                           tb.perm, tb.ops, tb.sh);
        });
  } else {
    auto* kernel = write_kernel<kDom, kMma, kTiled, W, kTrace>;
    const int batch = kMma && kDom == kGenericDom ? kRowsBatch : 1;
    return launch_persistent(
        (const void*)kernel, per_sm, p.steps, batch,
        [&](unsigned grid, long long run) {
          kernel<<<grid, kThreads, 0, s>>>(m, value, p, L, run, tb.lut,
                                           tb.perm, tb.ops, tb.rows);
        });
  }
}

template <int kDom, bool kMma, bool kShard, bool kTrace, typename W>
cudaError_t launch_write_tiled(W* m, W value, const FracParams& p,
                               const Tables& tb, cudaStream_t s) {
  if (kDom == kFractalDom && p.nfine > 1)
    return launch_write_as<kDom, kMma, true, kShard, kTrace>(m, value, p, tb,
                                                             s);
  return launch_write_as<kDom, kMma, false, kShard, kTrace>(m, value, p, tb,
                                                            s);
}

template <bool kShard, bool kTrace, typename W>
cudaError_t launch_write(W* m, W value, const FracParams& p,
                         const Tables& tb, cudaStream_t s) {
  const bool mma = p.lowering == kMma;
  if (generic_family(p))
    return mma ? launch_write_as<kGenericDom, true, false, kShard, kTrace>(
                     m, value, p, tb, s)
               : launch_write_as<kGenericDom, false, false, kShard, kTrace>(
                     m, value, p, tb, s);
  return mma ? launch_write_tiled<kFractalDom, true, kShard, kTrace>(
                   m, value, p, tb, s)
             : launch_write_tiled<kFractalDom, false, kShard, kTrace>(
                   m, value, p, tb, s);
}

template <int kDom, bool kMma, bool kTiled, bool kShard, bool kTrace, int DT>
cudaError_t launch_sum_as(const void* m, float* partials, const FracParams& p,
                          const Tables& tb, cudaStream_t s) {
  static int per_sm = 0;  // one per instantiation
  const Cells L = cells_of(p, DT == kBF16 ? 2 : 4, m);
  if constexpr (kShard) {
    auto* kernel = sum_shard_kernel<kDom, kMma, kTiled, DT>;
    return launch_persistent(
        (const void*)kernel, per_sm, p.steps, 1,
        [&](unsigned grid, long long run) {
          kernel<<<grid, kThreads, 0, s>>>(m, partials, p, L, run, tb.lut,
                                           tb.perm, tb.ops, tb.sh);
        });
  } else {
    auto* kernel = sum_partials_kernel<kDom, kMma, kTiled, DT, kTrace>;
    const int batch = kMma && kDom == kGenericDom ? kRowsBatch : 1;
    return launch_persistent(
        (const void*)kernel, per_sm, p.steps, batch,
        [&](unsigned grid, long long run) {
          kernel<<<grid, kThreads, 0, s>>>(m, partials, p, L, run, tb.lut,
                                           tb.perm, tb.ops, tb.rows);
        });
  }
}

template <int kDom, bool kMma, bool kShard, bool kTrace, int DT>
cudaError_t launch_sum_tiled(const void* m, float* partials,
                             const FracParams& p, const Tables& tb,
                             cudaStream_t s) {
  if (kDom == kFractalDom && p.nfine > 1)
    return launch_sum_as<kDom, kMma, true, kShard, kTrace, DT>(m, partials,
                                                               p, tb, s);
  return launch_sum_as<kDom, kMma, false, kShard, kTrace, DT>(m, partials,
                                                              p, tb, s);
}

template <bool kShard, bool kTrace, int DT>
cudaError_t launch_sum(const void* m, float* partials, const FracParams& p,
                       const Tables& tb, cudaStream_t s) {
  const bool mma = p.lowering == kMma;
  if (generic_family(p))
    return mma ? launch_sum_as<kGenericDom, true, false, kShard, kTrace, DT>(
                     m, partials, p, tb, s)
               : launch_sum_as<kGenericDom, false, false, kShard, kTrace,
                               DT>(m, partials, p, tb, s);
  return mma ? launch_sum_tiled<kFractalDom, true, kShard, kTrace, DT>(
                   m, partials, p, tb, s)
             : launch_sum_tiled<kFractalDom, false, kShard, kTrace, DT>(
                   m, partials, p, tb, s);
}

template <bool kShard, bool kTrace = false>
int write_entry(void* m, int elem_bytes, unsigned int value_bits,
                const FracParams& p, const Tables& tb, cudaStream_t s) {
  if (p.steps <= 0) return (int)cudaSuccess;
  if (elem_bytes == 4)
    return (int)launch_write<kShard, kTrace>(static_cast<uint32_t*>(m),
                                             (uint32_t)value_bits, p, tb, s);
  if (elem_bytes == 2)
    return (int)launch_write<kShard, kTrace>(static_cast<uint16_t*>(m),
                                             (uint16_t)value_bits, p, tb, s);
  return (int)cudaErrorInvalidValue;
}

template <bool kShard, bool kTrace = false>
int sum_entry(const void* m, int dtype, float* partials, const FracParams& p,
              const Tables& tb, cudaStream_t s) {
  if (p.steps <= 0) return (int)cudaSuccess;
  if (dtype == kF32)
    return (int)launch_sum<kShard, kTrace, kF32>(m, partials, p, tb, s);
  if (dtype == kBF16)
    return (int)launch_sum<kShard, kTrace, kBF16>(m, partials, p, tb, s);
  if (dtype == kI32)
    return (int)launch_sum<kShard, kTrace, kI32>(m, partials, p, tb, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

#if defined(REPRO_TRACE)
// sw_write, also writing each grid step's trace row into rows (steps x
// trace::kCols int32, filled with the initial row by the caller).
int sw_write_trace(void* m, int elem_bytes, unsigned int value_bits,
                   const long long* params, const int* lut, const int* perm,
                   const int* ops, int* rows, void* stream) {
  return write_entry<false, true>(m, elem_bytes, value_bits,
                                  make_params(params),
                                  Tables{lut, perm, ops, ShardParams{}, rows},
                                  static_cast<cudaStream_t>(stream));
}

// sw_sum_partials, also writing each grid step's trace row into rows.
int sw_sum_partials_trace(const void* m, int dtype, float* partials,
                          const long long* params, const int* lut,
                          const int* perm, const int* ops, int* rows,
                          void* stream) {
  return sum_entry<false, true>(m, dtype, partials, make_params(params),
                                Tables{lut, perm, ops, ShardParams{}, rows},
                                static_cast<cudaStream_t>(stream));
}
#elif !defined(REPRO_SHARDED)
// Write the value bits into every member cell of the state m, in place.
// elem_bytes is 4 (f32, int32) or 2 (bf16).  params: plan.C_PARAMS order;
// lut, perm and ops may be null (see LaunchParams; ops is mma_ops).
int sw_write(void* m, int elem_bytes, unsigned int value_bits,
             const long long* params, const int* lut, const int* perm,
             const int* ops, void* stream) {
  return write_entry<false>(m, elem_bytes, value_bits, make_params(params),
                            Tables{lut, perm, ops, ShardParams{}, nullptr},
                            static_cast<cudaStream_t>(stream));
}

// partials[t] = f32 sum of the member cells of grid step t's supertile (0
// for a discarded bounding step).  dtype: 0 f32, 1 bf16, 2 int32.
int sw_sum_partials(const void* m, int dtype, float* partials,
                    const long long* params, const int* lut, const int* perm,
                    const int* ops, void* stream) {
  return sum_entry<false>(m, dtype, partials, make_params(params),
                          Tables{lut, perm, ops, ShardParams{}, nullptr},
                          static_cast<cudaStream_t>(stream));
}

// out[0] = partials[0] + partials[1] + ... in step order, in f32.
int sw_sum_combine(const float* partials, long long steps, float* out,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sum_combine_kernel<<<1, kCombineThreads, 0, s>>>(partials, steps, out);
  return (int)cudaGetLastError();
}
#else
// sw_write over one rank's steps of a sharded domain, on its local state
// m (its slab, or the replicated array): shard holds the SHARD_PARAMS
// (core/shard.py), gmap the rank's ghost map (storage-rows; unread here)
// and phase its scheduled steps (null: every step); params' steps are the
// rank's, lut its LUT chunk.
int sw_write_sharded(void* m, int elem_bytes, unsigned int value_bits,
                     const long long* params, const int* lut,
                     const int* perm, const int* ops, const long long* shard,
                     const int* gmap, const int* phase, void* stream) {
  return write_entry<true>(m, elem_bytes, value_bits, make_params(params),
                           Tables{lut, perm, ops,
                                  make_shard(shard, gmap, phase), nullptr},
                           static_cast<cudaStream_t>(stream));
}

// sw_sum_partials over one rank's steps: partials[t] of its local step t;
// the rest as sw_write_sharded.
int sw_sum_partials_sharded(const void* m, int dtype, float* partials,
                            const long long* params, const int* lut,
                            const int* perm, const int* ops,
                            const long long* shard, const int* gmap,
                            const int* phase, void* stream) {
  return sum_entry<true>(m, dtype, partials, make_params(params),
                         Tables{lut, perm, ops,
                                make_shard(shard, gmap, phase), nullptr},
                         static_cast<cudaStream_t>(stream));
}
#endif  // REPRO_SHARDED

const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
