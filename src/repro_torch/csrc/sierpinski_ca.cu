// Fused cellular-automaton / diffusion step kernel for Hopper (sm_90a),
// with a plain C interface loaded through ctypes
// (repro_torch/kernels/_cuda.py).
//
// Replaces (JAX package, Pallas):
//   sc_ca_launch  <- kernels/sierpinski_ca.py::_ca_fused_kernel (:212), with
//                    its _dma (:232) and _gpu (:268) variants, the shared
//                    math _trapezoid_update (:117), the _dma variant's tile
//                    ring core/backend.py::stream_tiles (:290) and one
//                    launch of the scan in _ca_run_impl (:370)
//
// What it computes, per scheduled (super)block: gather the center and the
// 8 neighbour supertiles into a (span + 2h)^2 working tile (embedded
// neighbours, or their lambda^-1-resolved packed slots under compact
// storage), zero the cells whose fine block is out of range or a
// non-member, advance `steps <= h` iterations of parity
// mod(s + N + S + W + E, 2) or diffusion s + alpha * (sum nbr - deg * s)
// under the cell-membership mask, and store the span^2 interior into the
// stale buffer.
//
// What bounds it on an H100 (80 GB HBM3 at 3.35 TB/s): bytes.  A launch
// must read every member block once and write it once: at n = 2^16,
// rho = 32, compact f32 the packed orthotope (23328 x 7776 cells) is
// 725.6 MB, so 2 x 725.6 MB = 1.45 GB, 0.433 ms.  The halo re-reads
// ((span + 2h)^2 against span^2 cells, mostly from L2) raise the floor to
// ~0.46 ms at fuse 1 and ~0.70 ms at fuse 8; the trapezoid's arithmetic
// (a few f32 operations per cell and step, over a shrinking region) is
// what grows with the fuse depth.
//
// What the design does about it:
//   * persistent CTAs, as many as the occupancy calculator lets reside on
//     the card: CTA c walks grid steps c, c + G, c + 2G, ... (G CTAs), so
//     the steps in flight at any time are neighbours in lambda order and
//     their shared halos meet in L2; under bounding a warp tests 32 of the
//     CTA's steps at a time, the ring only ever holds member blocks, and
//     G is coprime with the box's width (walk_ctas);
//   * the working tiles stream through a ring of `stages` shared-memory
//     slots (async_ring.cuh): while step i's trapezoid runs, the copies of
//     step i + stages - 1 are in flight (the stream_tiles schedule; one
//     commit group per step, empty groups past the CTA's last step);
//     stages = 1 gathers, waits and computes;
//   * a step's block, its nine supertile origins and its place in the
//     ring are resolved one ring step ahead by warp 0, one origin a lane
//     (lambda^-1 in registers, the LUT row's columns under prefetch_lut);
//   * under mma the chains are latency, a few dependent mma.sync each, so
//     the CTA resolves sixteen of its steps at a time, once every sixteen
//     ring steps (a ring of S + 16 entries): one B7a pass decodes all
//     sixteen (A row j: step j's digit one-hots, each digit found once by
//     the lane of its position and shuffled to the lanes of its columns,
//     by multiply-high, no division), then B7b two steps a pass (A rows
//     8-15: the second step's neighbours), the eight passes spread over
//     the warps; a row-major domain's B7c runs batched, eight steps a
//     warp's chain (rows_chain_warp, no CTA barrier), and its origins a
//     thread each;
//   * the gather moves 16-byte pieces along fine-block rows: the working
//     tile's column 0 sits at shared column pad = -h mod 4, so every fine
//     block of a row starts on a piece boundary in both memories (block
//     and pitch multiples of 4, 16-byte aligned buffers; else 4-byte
//     copies).  A piece of an out-of-range or non-member fine block is a
//     zero-filled copy (src-size 0): nothing is read for it.  Division by
//     the block side happens once per row and once per piece (a shift
//     for power-of-two blocks), never per cell.  Rows shorter than a warp
//     share it: 32 / pieces rows at a time, a lane a piece (RowSplit);
//   * the cell mask is one bit per cell, four to a byte: the byte of each
//     16-byte group of a shared row, from the membership bit test, written
//     with the group's copy when the step is gathered;
//   * the trapezoid: a lane per 16-byte group of 4 cells (three 16-byte
//     shared loads and two single ones for its 4 cells and their
//     neighbours, one mask byte, one 16-byte store), rows packed into a
//     warp as in the gather, each row's offset computed once; two tiles
//     ping-pong, the step's ring slot and one more buffer; only the
//     interior is stored, and after k steps it depends only on cells
//     within k of it;
//   * the store moves 16-byte pieces per fine-block row through a table
//     of the fine blocks' shared and storage offsets built once per CTA
//     (the static fine-block permutation under compact coarsening);
//   * working tiles past the 227 KB opt-in limit (e.g. rho = 128 at
//     fuse 128) keep their slot, buffer and masks in a per-CTA slice of one
//     global scratch buffer, with the same loop at depth 1 and plain
//     copies -- the same kernel;
//   * diffusion is written with __fmul_rn / __fadd_rn / __fsub_rn in the
//     JAX expression's order (no FMA contraction), and parity uses the
//     floor-mod of jnp.mod (mod2 below), so the kernel is bit-equal to its
//     plain version at every depth;
//   * cell offsets are 64-bit: an embedded n = 2^16 state has 2^32 cells;
//   * the row-major domains (triangular, band, bounding box) and the mma
//     lowering run in template instantiations of their own (kDom, kMma).
//     A generic domain's halo follows the JAX package's tile semantics
//     exactly: an embedded neighbour tile index is clamped into the box,
//     an invalid compact neighbour reads slot (0, 0), and only the
//     in-range test and the domain's contains() (at block granularity)
//     mask values.
//
// Sharded (sc_ca_launch_sharded; this source built with -DREPRO_SHARDED,
// a library of its own): the same kernel instantiated with kShard, over
// one rank's steps of a domain split by repro_torch.core.shard.
// ShardedPlan (shard_common.cuh), resolved one ring step ahead as above
// by shard_decode (resolve_shard; under mma: B7a for the block
// and the own slot, B7b for the neighbours, one step a pass -- a phase
// launch's steps are not an arithmetic run, so the sixteen-step batch
// does not apply).  Under compact storage src and dst are the rank's
// extended arrays [slab ++ ghost rows ++ dump row]: every slot's global
// slot row goes through the ghost map (the own block's to its slab row,
// a neighbour's to its slab or ghost row), and the store writes the slab.
// Embedded storage reads and writes the replicated arrays as the
// unsharded kernel does.  The kShard = false instantiations compile to
// the SASS they had before: the shard parameters are one trailing kernel
// argument that they never read, and resolve_shard is a lambda of its own
// beside resolve.
//
// Traced (sc_ca_launch_trace; this source built with -DREPRO_TRACE, a
// library of its own): the unsharded kernel instantiated with kTrace,
// whose thread 0 writes each step's access-trace row (trace_rows.cuh)
// when the ring reaches it, from the step's ring entry -- the block, and
// the nine supertile origins the gather and the store address (compact
// storage: the entry's origins; embedded: the neighbours of the entry's
// block) -- before the step is computed.  A neighbour records -1 when
// it is out of range or not a member (the gather reads nothing of it).
// The body runs unchanged; the kTrace = false instantiations take the
// rows as one more trailing argument that they never read.

#include "async_ring.cuh"
#include "fractal_common.cuh"
#include "mma_decode.cuh"
#include "shard_common.cuh"
#include "trace_rows.cuh"

namespace {

using namespace fractal;

enum Rule { kParity = 0, kDiffusion = 1 };

constexpr int kMaxStages = ring::kMaxPending + 1;  // the deepest ring
constexpr int kOriginSlots = 9;  // (dy + 1) * 3 + dx + 1, center 4
// A CTA: 4 warps for working tiles up to 63 cells wide (8 CTAs, each with
// a step in flight, fit an SM), 8 for wider ones, at most 64 registers a
// thread (tighter bounds spill)
constexpr int kThreads = 256;
__host__ __device__ inline int threads_for(int wid) {
  return wid < 64 ? 128 : kThreads;
}

struct CaArgs {
  int halo;      // h: halo ring width (the fuse depth of the run)
  int nsteps;    // steps of this launch, 1 <= nsteps <= h
  int rule;
  float alpha;
  int wid;       // span + 2h
  int stages;    // ring slots (1: gather, wait, compute)
  int pc;        // cells per copied piece: 4 (16 bytes) or 1
  int pad;       // shared column of working column 0 (pc 4: -h mod 4)
  int stride;    // shared row of a tile, floats (a multiple of 4)
  int ngr;       // mask bytes per working row: one per 4 shared columns
  long long tile_floats;  // one tile: wid rows of `stride`
  int meta_bytes;  // the ring's entries and the CTA's tables
};

// One ring entry: a step the CTA will compute (t < 0: past its last),
// its scheduled block and the storage origins of its nine supertiles as
// linear offsets row * pitch + col (compact storage; a fractal neighbour
// that is out of range or not a member has row = col = -1 and its cells
// are never read; embedded: the own block's in every slot).
struct Entry {
  long long t;
  unsigned bx, by;
  long long org_off[kOriginSlots];
};

// Ring entries beyond the `stages` slots: the mma lowering resolves its
// steps kStepsBatch at a time (one chain pass for sixteen steps), so its
// ring holds S + kStepsBatch entries; the others resolve one step a ring
// step, S + 1 entries.
__host__ __device__ inline int ring_entries(bool mma, int stages) {
  return stages + (mma ? kStepsBatch : 1);
}

// log2 of x when x is a power of two, else -1.
__host__ __device__ inline int pow2_shift(int x) {
  if (x <= 0 || (x & (x - 1))) return -1;
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

// x / d for x >= 0: a shift when d is a power of two (shift >= 0).
__device__ __forceinline__ int div_by(int x, int d, int shift) {
  return shift >= 0 ? x >> shift : x / d;
}

// A warp's lanes over the items of rows with `per` items each: up to 32
// items a row give each lane one item of one of 32 / per rows at a time
// (lanes past rows * per idle); longer rows take a lane every 32 items.
struct RowSplit {
  int rows, lr, li, step;
  __device__ RowSplit(int per, int lane) {
    if (per >= 32 || per < 1) {
      rows = 1;
      lr = 0;
      li = lane;
      step = 32;
    } else {
      rows = 32 / per;
      lr = lane / per;
      li = lane - lr * per;
      step = per;
    }
  }
};

// jnp.mod(x, 2) on f32, bit-equal to fmodf then + 2 where the sign
// differs: x - 2 trunc(x / 2) is exact (x / 2 is exact, and the
// subtraction is exact by Sterbenz), and fmod's result takes the sign of
// x, zeros included.
__device__ __forceinline__ float mod2(float x) {
  float r = copysignf(__fmaf_rn(-2.0f, truncf(__fmul_rn(x, 0.5f)), x), x);
  if (r < 0.0f) r = __fadd_rn(r, 2.0f);
  return r;
}

// Origin `slot` (0..8) of the supertiles around the member block (bx, by)
// of step t of a fractal domain: lambda^-1 in registers, or the LUT row.
__device__ __forceinline__ void fractal_origin(const FracParams& p,
                                               const int* __restrict__ lut,
                                               long long t, unsigned bx,
                                               unsigned by, int slot,
                                               long long& row, long long& col) {
  if (slot == 4) {
    tile_origin(p, lut, t, bx, by, row, col);
    return;
  }
  const int dx = slot % 3 - 1, dy = slot / 3 - 1;
  unsigned tx, ty;
  bool ok;
  if (p.lowering == kPrefetchLut) {
    int j = 0;  // its NEIGHBOR_OFFSETS8 index
    while (kNbrDx[j] != dx || kNbrDy[j] != dy) ++j;
    const int* r = lut + t * p.lut_cols + kLutNbr + 3 * j;
    tx = (unsigned)r[0];
    ty = (unsigned)r[1];
    ok = r[2] != 0;
  } else {
    const long long x = (long long)bx + dx, y = (long long)by + dy;
    ok = x >= 0 && y >= 0 && x < p.nbx && y < p.nbx &&
         block_member(p, (unsigned)x, (unsigned)y, p.nbx, p.r_b);
    unsigned wx = 0, wy = 0;
    if (ok) lambda_inverse(p, (unsigned)x, (unsigned)y, wx, wy);
    tx = p.swap ? wy : wx;
    ty = p.swap ? wx : wy;
  }
  row = ok ? (long long)ty * p.th : -1;
  col = ok ? (long long)tx * p.tw : -1;
}

// The same for a generic domain: the own slot, then each neighbour's slot
// when it is in the box and a member, else slot (0, 0)
// (CompactLayout.neighbor_slot; the LUT holds the same).
__device__ __forceinline__ void generic_origin_at(const FracParams& p,
                                                  const int* __restrict__ lut,
                                                  long long t, unsigned bx,
                                                  unsigned by, int slot,
                                                  long long& row,
                                                  long long& col) {
  if (slot == 4) {
    generic_origin(p, lut, t, bx, by, row, col);
    return;
  }
  const int dx = slot % 3 - 1, dy = slot / 3 - 1;
  unsigned sx = 0, sy = 0;
  if (p.lowering == kPrefetchLut) {
    int j = 0;
    while (kNbrDx[j] != dx || kNbrDy[j] != dy) ++j;
    const int* r = lut + t * p.lut_cols + kLutNbr + 3 * j;
    sx = (unsigned)r[0];
    sy = (unsigned)r[1];
  } else {
    const long long x = (long long)bx + dx, y = (long long)by + dy;
    const long long xc = x < 0 ? 0 : (x >= p.nbx ? p.nbx - 1 : x);
    const long long yc = y < 0 ? 0 : (y >= p.nby ? p.nby - 1 : y);
    if (x == xc && y == yc && generic_contains(p, xc, yc))
      generic_slot(p, xc, yc, sx, sy);
  }
  row = (long long)sy * p.th;
  col = (long long)sx * p.tw;
}

template <int kDom>
__device__ __forceinline__ bool decode_step(const FracParams& p,
                                            const int* __restrict__ lut,
                                            long long t, unsigned& bx,
                                            unsigned& by) {
  if constexpr (kDom == kFractalDom)
    return decode(p, lut, t, bx, by);
  else
    return generic_decode(p, lut, t, bx, by);
}

// The trace row of the step of ring entry e (thread 0 of a traced
// launch): its block, the supertile it stores, and the supertile each of
// its nine origin slots reads.
template <int kDom>
__device__ __forceinline__ void trace_entry(int* rows, const FracParams& p,
                                            const Entry& e, bool compact) {
  int* r = trace::visit(rows, e.t, true, e.bx, e.by);
  trace::tile_at(r + trace::kStoreRow, p, e.org_off[4]);
  const long long side = kDom == kFractalDom ? p.nbx : p.nby;
  for (int o = 0; o < kOriginSlots; ++o) {
    int* d = r + trace::kLoads + 2 * o;
    const long long x = (long long)e.bx + o % 3 - 1;
    const long long y = (long long)e.by + o / 3 - 1;
    bool ok = x >= 0 && y >= 0 && x < p.nbx && y < side;
    if constexpr (kDom == kFractalDom)
      ok = ok && block_member(p, (unsigned)x, (unsigned)y, p.nbx, p.r_b);
    else
      ok = ok && generic_contains(p, x, y);
    if (!ok) continue;  // out of range or not a member: nothing read
    if (!compact) {
      trace::tile(d, p, y * p.span, x * p.span);
    } else if (e.org_off[o] < 0) {
      d[0] = d[1] = -2;  // a read through a missing origin
    } else {
      trace::tile_at(d, p, e.org_off[o]);
    }
  }
}

template <bool kShared, int kDom, bool kMma, bool kShard = false,
          bool kTrace = false>
__global__ void __launch_bounds__(kThreads, 4)
ca_fused_kernel(const float* __restrict__ src, float* __restrict__ dst,
                FracParams p, CaArgs ca, const int* __restrict__ lut,
                const int* __restrict__ perm, const int* __restrict__ ops,
                unsigned char* __restrict__ scratch,
                long long scratch_per_cta, ShardParams sh,
                int* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = ca.stages, E = ring_entries(kMma && !kShard, S);
  const int s = p.coarsen, nfine = p.nfine, block = p.block;
  // the ring's entries and the CTA's tables (shared memory); under mma on
  // a fractal, each lane's digit magics (pow_magic of k, then of m)
  Entry* const ent = reinterpret_cast<Entry*>(smem);
  unsigned long long* const dmag =
      reinterpret_cast<unsigned long long*>(ent + E);       // 64 under mma
  long long* const gtab =
      reinterpret_cast<long long*>(dmag + (kMma ? 64 : 0));  // s * s
  long long* const sdst = gtab + s * s;                       // nfine
  int* const ssrc = reinterpret_cast<int*>(sdst + nfine);     // nfine
  // the tiles (S slots, then the ping-pong buffer) and the masks
  unsigned char* const base =
      kShared ? smem + ca.meta_bytes
              : scratch + (long long)blockIdx.x * scratch_per_cta;
  float* const tiles = reinterpret_cast<float*>(base);
  unsigned char* const masks =
      reinterpret_cast<unsigned char*>(tiles + (long long)(S + 1) * ca.tile_floats);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int wid = ca.wid, h = ca.halo, stride = ca.stride, ngr = ca.ngr;
  const int pad = ca.pad, pc = ca.pc;
  const long long pitch = p.pitch;
  const int bshift = pow2_shift(block), sshift = pow2_shift(s);
  const unsigned nbf = p.n / (unsigned)block;  // fine blocks per side
  const bool compact = p.storage == kCompact;

  // -- the CTA's tables: per embedded fine block (fy, fx) of a supertile
  //    its storage offset from the supertile's origin (the gather), per
  //    packed fine block q its tile offset and storage offset (the store)
  for (int i = tid; i < s * s; i += nthreads) {
    const int q = perm != nullptr ? perm[2 * nfine + i] : i;
    gtab[i] = q < 0 ? 0
                    : (long long)(q / p.bw) * block * pitch +
                          (long long)(q % p.bw) * block;
  }
  for (int q = tid; q < nfine; q += nthreads) {
    int ey, ex;
    fine_offset(p, perm, q, ey, ex);
    ssrc[q] = (h + ey * block) * stride + pad + h + ex * block;
    sdst[q] = (long long)(q / p.bw) * block * pitch +
              (long long)(q % p.bw) * block;
  }
  if constexpr (kMma && kDom == kFractalDom) {
    if (tid < 64)
      dmag[tid] = pow_magic((unsigned)(tid < 32 ? p.k : p.m), tid & 31);
  }

  // -- resolve: the CTA's next step into ring entry k % E (warp 0), or
  //    under mma the entries k .. k + 15 in one batch (the whole CTA,
  //    converged) ----------------------------------------------------------
  long long cursor = blockIdx.x;
  // warp 0, converged: lanes < 9 hold the origins of their slot (compact),
  // stored as linear offsets (embedded: the own block's, for the store)
  auto finish = [&](Entry& e, unsigned bx, unsigned by, long long row,
                    long long col) {
    if (lane < kOriginSlots) {
      if (!compact) {
        row = (long long)by * p.span;
        col = (long long)bx * p.span;
      }
      e.org_off[lane] = row * pitch + col;
    }
  };
  auto resolve = [&](int k) {
    if (warp != 0) return;
    Entry& e = ent[k % E];
    long long t = -1;
    unsigned bx = 0, by = 0;
    // bounding: 32 of the CTA's steps a test, the first member kept
    const long long batch = p.lowering == kBounding ? 32 : 1;
    while (cursor < p.steps) {
      const long long c =
          cursor + (batch > 1 ? (long long)lane * gridDim.x : 0);
      unsigned cx = 0, cy = 0;
      const bool ok = c < p.steps && decode_step<kDom>(p, lut, c, cx, cy);
      const unsigned bal = __ballot_sync(kFullMask, ok);
      if (bal) {
        const int src_lane = __ffs(bal) - 1;
        t = __shfl_sync(kFullMask, c, src_lane);
        bx = __shfl_sync(kFullMask, cx, src_lane);
        by = __shfl_sync(kFullMask, cy, src_lane);
        cursor = t + gridDim.x;
        break;
      }
      cursor += batch * gridDim.x;
    }
    long long row = 0, col = 0;
    if (t >= 0 && compact && lane < kOriginSlots) {
      if constexpr (kDom == kFractalDom)
        fractal_origin(p, lut, t, bx, by, lane, row, col);
      else
        generic_origin_at(p, lut, t, bx, by, lane, row, col);
    }
    if (lane == 0) {
      e.t = t;
      e.bx = bx;
      e.by = by;
    }
    finish(e, bx, by, row, col);
  };
  // a sharded launch: the rank's next step into entry k % E (warp 0,
  // converged), decoded by shard_decode; under compact storage each
  // slot's global slot row goes through the ghost map to its row of the
  // extended arrays, and under mma the own slot comes from B7a and the
  // neighbours from B7b (lane l < 9 takes slot l, neighbour g's result
  // from lane 4 g)
  auto resolve_shard = [&](int k) {
    if (warp != 0) return;
    Entry& e = ent[k % E];
    long long t = -1;
    unsigned bx = 0, by = 0;
    // bounding: 32 of the CTA's steps a test, the first owned member kept
    const long long batch = p.lowering == kBounding ? 32 : 1;
    while (cursor < p.steps) {
      const long long c =
          cursor + (batch > 1 ? (long long)lane * gridDim.x : 0);
      unsigned cx = 0, cy = 0;
      const bool ok = c < p.steps &&
                      shard_decode<kDom, kMma>(p, sh, lut, ops, c, lane, cx,
                                               cy);
      const unsigned bal = __ballot_sync(kFullMask, ok);
      if (bal) {
        const int src_lane = __ffs(bal) - 1;
        t = __shfl_sync(kFullMask, c, src_lane);
        bx = __shfl_sync(kFullMask, cx, src_lane);
        by = __shfl_sync(kFullMask, cy, src_lane);
        cursor = t + gridDim.x;
        break;
      }
      cursor += batch * gridDim.x;
    }
    long long row = 0, col = 0;
    if (t >= 0 && compact) {
      const long long st = sched_step(sh, t);
      if constexpr (kMma && kDom == kFractalDom) {
        unsigned cbx, cby, sx, sy, sxa, sya, sxb, syb;
        bool oka, okb;
        fractal_chain(p, ops, (unsigned)canonical_step<kDom>(p, sh, st),
                      lane, true, cbx, cby, sx, sy);
        fractal_nbrs_pair(p, ops, bx, by, bx, by, lane, dmag[32 + lane],
                          sxa, sya, oka, sxb, syb, okb);
        const int dx = lane % 3 - 1, dy = lane / 3 % 3 - 1;
        int g = 0;
        for (int j = 0; j < 8; ++j)
          if (kNbrDx[j] == dx && kNbrDy[j] == dy) g = j;
        const unsigned nsx = __shfl_sync(kFullMask, sxa, 4 * g);
        const unsigned nsy = __shfl_sync(kFullMask, sya, 4 * g);
        const bool nok = __shfl_sync(kFullMask, (int)oka, 4 * g) != 0;
        const bool own = lane == 4;
        row = own ? (long long)sy * p.th : nok ? (long long)nsy * p.th : -1;
        col = own ? (long long)sx * p.tw : nok ? (long long)nsx * p.tw : -1;
      } else if (lane < kOriginSlots) {
        if constexpr (kDom == kFractalDom)
          fractal_origin(p, lut, st, bx, by, lane, row, col);
        else
          generic_origin_at(p, lut, st, bx, by, lane, row, col);
      }
      if (lane < kOriginSlots) row = ghost_row(p, sh, row);
    }
    if (lane == 0) {
      e.t = t;
      e.bx = bx;
      e.by = by;
    }
    finish(e, bx, by, row, col);
  };
  // mma: the CTA's steps blockIdx.x + j G of entries j = k0 .. k0 + 15
  // (k0 a multiple of 16), decoded by one pass of a chain -- B7a for the
  // fractals (warp 0, sixteen steps a pass), B7c for the row-major domains
  // (warps 0 and 1, eight steps each) -- then, under compact storage and
  // after a CTA barrier, their neighbour origins: B7b two steps a pass,
  // the pairs spread over the warps, or a row-major domain's origins a
  // thread each.
  auto resolve_batch = [&](int k0) {
    const long long t0 = blockIdx.x + (long long)k0 * gridDim.x;
    const int nlive =
        t0 >= p.steps
            ? 0
            : (int)min((long long)kStepsBatch,
                       (p.steps - t0 + gridDim.x - 1) / gridDim.x);
    auto put = [&](int j, unsigned bx, unsigned by) {
      Entry& e = ent[(k0 + j) % E];
      e.t = j < nlive ? t0 + (long long)j * gridDim.x : -1;
      e.bx = bx;
      e.by = by;
      if (!compact) {
        const long long off =
            (long long)by * p.span * pitch + (long long)bx * p.span;
        for (int o = 0; o < kOriginSlots; ++o) e.org_off[o] = off;
      }
      return &e;
    };
    if constexpr (kDom == kFractalDom) {
      if (warp == 0) {
        float dc[4], ds[4];
        if (nlive > 0)
          fractal_chain_batch(p, ops, (unsigned)t0, gridDim.x, nlive, lane,
                              dmag[lane], compact, dc, ds);
        const int j = lane & (kStepsBatch - 1);
        unsigned bx = 0, by = 0, sx = 0, sy = 0;
        if (nlive > 0) {
          bx = (unsigned)row_out(dc, j, 0);
          by = (unsigned)row_out(dc, j, 1);
          if (compact) {
            const unsigned wx = (unsigned)row_out(ds, j, 0);
            const unsigned wy = (unsigned)row_out(ds, j, 1);
            sx = p.swap ? wy : wx;
            sy = p.swap ? wx : wy;
          }
        }
        if (lane < kStepsBatch) {
          Entry* e = put(lane, bx, by);
          if (compact)
            e->org_off[4] = (long long)sy * p.th * pitch + (long long)sx * p.tw;
        }
      }
      if (compact) {
        __syncthreads();  // the batch's blocks are in the entries
        for (int pr = warp; 2 * pr < nlive; pr += nwarps) {
          Entry& ea = ent[(k0 + 2 * pr) % E];
          Entry& eb = ent[(k0 + min(2 * pr + 1, nlive - 1)) % E];
          unsigned sxa, sya, sxb, syb;
          bool oka, okb;
          fractal_nbrs_pair(p, ops, ea.bx, ea.by, eb.bx, eb.by, lane,
                            dmag[32 + lane], sxa, sya, oka, sxb, syb, okb);
          const int g = lane >> 2, tq = lane & 3;
          const int slot = (kNbrDy[g] + 1) * 3 + kNbrDx[g] + 1;
          if (tq == 0)
            ea.org_off[slot] = oka ? (long long)sya * p.th * pitch +
                                         (long long)sxa * p.tw
                                   : -pitch - 1;
          if (tq == 1 && 2 * pr + 1 < nlive)
            eb.org_off[slot] = okb ? (long long)syb * p.th * pitch +
                                         (long long)sxb * p.tw
                                   : -pitch - 1;
        }
      }
    } else {
      if (warp < 2) {
        const int j0 = warp * kRowsBatch;
        const int nl = min(max(nlive - j0, 0), kRowsBatch);
        unsigned bx = 0, by = 0;
        if (nl > 0)
          rows_chain_warp(p, ops, t0 + (long long)j0 * gridDim.x, gridDim.x,
                          nl, lane, bx, by);
        if (lane < kRowsBatch) put(j0 + lane, bx, by);
      }
      if (compact) {
        __syncthreads();  // the batch's blocks are in the entries
        for (int i = tid; i < nlive * kOriginSlots; i += nthreads) {
          const int j = i / kOriginSlots, slot = i - j * kOriginSlots;
          Entry& e = ent[(k0 + j) % E];
          long long row, col;
          generic_origin_at(p, lut, e.t, e.bx, e.by, slot, row, col);
          e.org_off[slot] = row * pitch + col;
        }
      }
    }
  };

  // -- gather: entry e's working tile into ring slot sl, pieces of rows
  //    (zero-filled for out-of-range and non-member fine blocks), and the
  //    mask bytes of the row's 4-column groups.  A lane keeps its piece
  //    column for every row it takes (RowSplit), so the column's fine
  //    block is found once a step and the row's once a row --------------
  const int npieces = (pad + wid + pc - 1) / pc;
  const int ngroups = (pad + wid + 3) >> 2;  // mask bytes a row fills
  const RowSplit gsplit(npieces, lane), msplit(ngroups, lane);
  auto mask_byte = [&](int gy, bool row_in, int gxg, int x0) {
    // the 4 cells of working columns x0 .. x0 + 3 (global gxg .. + 3)
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gx = gxg + j;
      bool live = x0 + j >= 0 && x0 + j < wid && row_in && gx >= 0 &&
                  gx < (int)p.n;
      if constexpr (kDom == kFractalDom)
        live = live && block_member(p, (unsigned)gx, (unsigned)gy, p.n,
                                    p.r_b + p.r_cell);
      m |= (unsigned)live << j;
    }
    return m;
  };
  auto gather = [&](const Entry& e, int sl) {
    float* const tile = tiles + (long long)sl * ca.tile_floats;
    unsigned char* const mk = masks + (long long)sl * wid * ngr;
    const int gx0 = (int)e.bx * (int)p.span - h;
    const int gy0 = (int)e.by * (int)p.span - h;
    for (int k = gsplit.li; gsplit.lr < gsplit.rows && k < npieces;
         k += gsplit.step) {
      // the column, once: its fine block, offset in it, supertile column
      const int gx = gx0 - pad + k * pc;
      const bool col_in = gx >= 0 && gx < (int)p.n;
      const int fbx = col_in ? div_by(gx, block, bshift) : 0;
      const int ox = gx - fbx * block;
      const int cbx = div_by(fbx, s, sshift);
      const int fx = fbx - cbx * s;
      const int rdx = cbx - (int)e.bx;  // -1, 0 or 1
      for (int iy = warp * gsplit.rows + gsplit.lr; iy < wid;
           iy += nwarps * gsplit.rows) {
        // the row: its fine-block row, offset in it and supertile row
        const int gy = gy0 + iy;
        const bool row_in = gy >= 0 && gy < (int)p.n;
        bool ok = row_in && col_in;
        long long off = 0;
        if (ok) {
          const int fby = div_by(gy, block, bshift);
          const int oy = gy - fby * block;
          if constexpr (kDom == kGenericDom) {
            ok = generic_contains(p, fbx, fby);
            if (!compact) {
              const int tx = fbx < (int)p.nbx ? fbx : (int)p.nbx - 1;
              const int ty = fby < (int)p.nby ? fby : (int)p.nby - 1;
              off = (long long)(ty * block + oy) * pitch + tx * block + ox;
            } else {
              const int slot = (fby - (int)e.by + 1) * 3 + rdx + 1;
              off = e.org_off[slot] + (long long)oy * pitch + ox;
            }
          } else {
            ok = block_member(p, (unsigned)fbx, (unsigned)fby, nbf, p.r_fine);
            if (!compact) {
              off = (long long)gy * pitch + gx;
            } else if (ok) {
              const int cby = div_by(fby, s, sshift);
              const int slot = (cby - (int)e.by + 1) * 3 + rdx + 1;
              off = e.org_off[slot] + (long long)oy * pitch +
                    gtab[(fby - cby * s) * s + fx] + ox;
            }
          }
        }
        float* const to = tile + iy * stride + k * pc;
        const float* const from = ok ? src + off : src;
        if (pc == 4) {
          if constexpr (kShared)
            ring::copy16_zfill(to, from, ok);
          else
            *reinterpret_cast<float4*>(to) =
                ok ? *reinterpret_cast<const float4*>(from)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
          // a piece is a mask group: its byte, with the copy
          mk[iy * ngr + k] =
              (unsigned char)mask_byte(gy, row_in, gx, 4 * k - pad);
        } else if constexpr (kShared) {
          ring::copy4_zfill(to, from, ok);
        } else {
          *to = ok ? *from : 0.0f;
        }
      }
    }
    if (pc == 1) {  // 4-byte copies: the mask bytes in a pass of their own
      for (int iy = warp * msplit.rows + msplit.lr;
           msplit.lr < msplit.rows && iy < wid; iy += nwarps * msplit.rows) {
        const int gy = gy0 + iy;
        const bool row_in = gy >= 0 && gy < (int)p.n;
        for (int k = msplit.li; k < ngroups; k += msplit.step)
          mk[iy * ngr + k] = (unsigned char)mask_byte(gy, row_in, gx0 + 4 * k,
                                                      4 * k);
      }
    }
  };

  // -- compute: the shrinking trapezoid on slot sl, 4 cells a lane (one
  //    16-byte group of a shared row and its mask byte), then the store --
  auto compute = [&](const Entry& e, int sl) {
    float* cur = tiles + (long long)sl * ca.tile_floats;
    float* nxt = tiles + (long long)S * ca.tile_floats;
    const unsigned char* const mk = masks + (long long)sl * wid * ngr;
    const float alpha = ca.alpha;
    const bool parity = ca.rule == kParity;
    for (int i = 0; i < ca.nsteps; ++i) {
      // step i computes rows and columns lo .. hi - 1 (rings i+1 ..
      // wid-2-i), in whole groups: a group's cells past the region are
      // written too, and no later step reads them
      const int lo = i + 1, hi = wid - lo;
      const int g0 = (lo + pad) >> 2, per = ((hi - 1 + pad) >> 2) - g0 + 1;
      const RowSplit sp(per, lane);
      for (int r = lo + warp * sp.rows + sp.lr; sp.lr < sp.rows && r < hi;
           r += nwarps * sp.rows) {
        const float* const crow = cur + r * stride;  // the row, once
        float* const nrow = nxt + r * stride;
        const unsigned char* const mrow = mk + r * ngr;
        for (int k = sp.li; k < per; k += sp.step) {
          const int g = g0 + k, c = 4 * g;
          const unsigned mb = mrow[g];
          const float4 C = *reinterpret_cast<const float4*>(crow + c);
          const float4 U = *reinterpret_cast<const float4*>(crow + c - stride);
          const float4 Dn = *reinterpret_cast<const float4*>(crow + c + stride);
          const float L = crow[c - 1], R = crow[c + 4];
          const float v[6] = {L, C.x, C.y, C.z, C.w, R};
          const float up[4] = {U.x, U.y, U.z, U.w};
          const float dn[4] = {Dn.x, Dn.y, Dn.z, Dn.w};
          unsigned nb = 0;  // diffusion: the 6 cells' bits left to right
          if (!parity)
            nb = ((unsigned)mrow[g - 1] >> 3 & 1u) | (mb << 1) |
                 (((unsigned)mrow[g + 1] & 1u) << 5);
          const unsigned mu = parity ? 0u : mrow[g - ngr],
                         md = parity ? 0u : mrow[g + ngr];
          float out[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float pv = v[j + 1];
            const float nsum = __fadd_rn(
                __fadd_rn(__fadd_rn(up[j], dn[j]), v[j]), v[j + 2]);
            float o;
            if (parity) {
              o = mod2(__fadd_rn(pv, nsum));
            } else {
              const float deg =
                  (float)((mu >> j & 1u) + (md >> j & 1u) + (nb >> j & 1u) +
                          (nb >> (j + 2) & 1u));
              o = __fadd_rn(
                  pv, __fmul_rn(alpha, __fsub_rn(nsum, __fmul_rn(deg, pv))));
            }
            out[j] = (mb >> j & 1u) ? o : 0.0f;
          }
          *reinterpret_cast<float4*>(nrow + c) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    // the span^2 interior in storage arrangement, pieces per fine-block row
    float* const out = dst + e.org_off[4];
    const int ppr = block / pc, pshift = pow2_shift(ppr);
    const int items = nfine * block * ppr;
    for (int c = tid; c < items; c += nthreads) {
      const int fr = div_by(c, ppr, pshift);
      const int q = div_by(fr, block, bshift);
      const int cy = fr - q * block, x = (c - fr * ppr) * pc;
      const float* from = cur + ssrc[q] + cy * stride + x;
      float* to = out + sdst[q] + (long long)cy * pitch + x;
      if (pc == 4)
        *reinterpret_cast<float4*>(to) = *reinterpret_cast<const float4*>(from);
      else
        *to = *from;
    }
  };

  // -- the ring: prologue, then one step per iteration -------------------
  if constexpr (kShard) {
    if constexpr (kMma) __syncthreads();  // the digit magics are written
    for (int k = 0; k < S; ++k) resolve_shard(k);
  } else if constexpr (kMma) {
    __syncthreads();  // the digit magics are written
    resolve_batch(0);  // S <= kStepsBatch entries are needed first
  } else {
    for (int k = 0; k < S; ++k) resolve(k);
  }
  __syncthreads();  // the entries and tables are written
  for (int k = 0; k + 1 < S; ++k) {
    if (ent[k].t >= 0) gather(ent[k], k);
    ring::commit();
  }
  for (int i = 0;; ++i) {
    const Entry& e = ent[i % E];
    if (S == 1) {
      if (e.t >= 0) gather(e, 0);
      ring::commit();
    }
    ring::wait_pending(S == 1 ? 0 : S - 2);
    __syncthreads();  // slot i % S landed; every reader of step i - 1 is done
    if (e.t < 0) break;
    if constexpr (kTrace) {
      if (tid == 0) trace_entry<kDom>(rows, p, e, compact);
    }
    if (S > 1) {
      const Entry& f = ent[(i + S - 1) % E];
      if (f.t >= 0) gather(f, (i + S - 1) % S);
      ring::commit();
    }
    // entry (i + S) % E held step i - 1, which is done; a batch's entries
    // (i + S .. i + S + 15) % E held steps i - 16 .. i - 1
    if constexpr (kShard) {
      resolve_shard(i + S);
    } else if constexpr (kMma) {
      if ((i + S) % kStepsBatch == 0) resolve_batch(i + S);
    } else {
      resolve(i + S);
    }
    compute(e, i % S);
    if (S == 1) __syncthreads();  // the store read the slot before the
                                  // next gather refills it
  }
}

// A launch's geometry: the tiles' row stride and mask bytes, and the
// bytes of the ring's entries and tables (shared memory) and of its tiles
// and masks (shared or global) at depth `stages`.
struct CaGeom {
  int stride, ngr;
  long long tile_floats;
  long long meta_bytes(const FracParams& p, int stages) const {
    const bool mma = p.lowering == kMma;
    const long long b = (long long)ring_entries(mma, stages) * sizeof(Entry) +
                        (mma ? 64 * 8 : 0) +
                        (long long)p.coarsen * p.coarsen * 8 +
                        (long long)p.nfine * 12;
    return (b + 15) / 16 * 16;
  }
  long long base_bytes(int wid, int stages) const {
    const long long b = (long long)(stages + 1) * tile_floats * 4 +
                        (long long)stages * wid * ngr;
    return (b + 255) / 256 * 256;
  }
};

CaGeom ca_geom(int wid) {
  CaGeom g;
  g.stride = (wid + 3 + 3) / 4 * 4;  // room for the pad, whole pieces
  g.ngr = g.stride / 4;
  g.tile_floats = (long long)wid * g.stride;
  return g;
}


int optin_bytes() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return optin;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The deepest ring of at most `stages` slots whose tiles fit one CTA's
// opt-in shared memory (less 1 KB for the kernel's static shared arrays),
// or 0 when not even one does: then the tiles take the global-scratch
// path at depth 1.
int shared_depth(const FracParams& p, const CaGeom& g, int wid, int stages) {
  const long long limit = optin_bytes() - 1024;
  for (int st = stages; st >= 1; --st)
    if (g.meta_bytes(p, st) + g.base_bytes(wid, st) <= limit) return st;
  return 0;
}

// Resident CTAs of the global-scratch path: two per SM.
long long scratch_ctas(long long steps) {
  const long long want = 2LL * sm_count();
  return steps < want ? steps : want;
}

// The CTAs that walk the grid steps, from `ctas` resident ones: under
// bounding the row-major box's steps go to CTAs by stride, so a stride
// that shares a factor with the box's width would hand each CTA a fixed
// set of columns -- the gasket's columns differ by powers of two in
// their member count, which left some CTAs 32 times the work of others.
// One CTA fewer at a time until the stride is coprime with the width.
long long walk_ctas(const FracParams& p, long long ctas) {
  if (p.lowering != kBounding) return ctas;
  auto gcd = [](long long a, long long b) {
    while (b) {
      const long long r = a % b;
      a = b;
      b = r;
    }
    return a;
  };
  while (ctas > 1 && gcd(ctas, (long long)p.nbx) != 1) --ctas;
  return ctas;
}

// The persistent grid of the shared-memory path at `bytes` a CTA: as
// many CTAs as reside on the card at once (the occupancy calculator, per
// SM, times the SMs), at most one a step (walk_ctas); 0 when none fits.
template <int kDom, bool kMma, bool kShard = false, bool kTrace = false>
long long resident_ctas(const FracParams& p, int threads, int bytes) {
  auto kernel = ca_fused_kernel<true, kDom, kMma, kShard, kTrace>;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    threads, bytes) !=
      cudaSuccess)
    return 0;
  const long long ctas = (long long)per_sm * sm_count();
  return walk_ctas(p, ctas < p.steps ? ctas : p.steps);
}

// The launch's arguments completed from its geometry: the ring's depth
// (the deepest that fits shared memory, else 1 on the global-scratch
// path), strides and table bytes.  Returns the depth that fits (0: the
// global-scratch path).
int complete_args(const FracParams& p, CaArgs& ca) {
  const CaGeom g = ca_geom(ca.wid);
  const int depth = shared_depth(p, g, ca.wid, ca.stages);
  ca.stages = depth > 0 ? depth : 1;
  ca.stride = g.stride;
  ca.ngr = g.ngr;
  ca.tile_floats = g.tile_floats;
  ca.meta_bytes = (int)g.meta_bytes(p, ca.stages);
  return depth;
}

// One fused launch of the instantiation of the domain kind, lowering,
// sharding and trace.
template <int kDom, bool kMma, bool kShard, bool kTrace>
cudaError_t launch_ca(const float* src, float* dst, const FracParams& p,
                      CaArgs ca, const int* lut, const int* perm,
                      const int* ops, unsigned char* scratch,
                      const ShardParams& sh, int* rows, cudaStream_t s) {
  const int depth = complete_args(p, ca);
  const long long tile_bytes = ca_geom(ca.wid).base_bytes(ca.wid, ca.stages);
  if (depth > 0) {
    const int bytes = ca.meta_bytes + (int)tile_bytes;
    const int threads = threads_for(ca.wid);
    const long long ctas =
        resident_ctas<kDom, kMma, kShard, kTrace>(p, threads, bytes);
    if (ctas < 1) return cudaErrorInvalidConfiguration;
    ca_fused_kernel<true, kDom, kMma, kShard, kTrace>
        <<<(unsigned)ctas, threads, bytes, s>>>(src, dst, p, ca, lut, perm,
                                                ops, nullptr, 0, sh, rows);
  } else {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    auto kernel = ca_fused_kernel<false, kDom, kMma, kShard, kTrace>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ca.meta_bytes);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)walk_ctas(p, scratch_ctas(p.steps)),
             threads_for(ca.wid), ca.meta_bytes, s>>>(
        src, dst, p, ca, lut, perm, ops, scratch, tile_bytes, sh, rows);
  }
  return cudaGetLastError();
}

bool aligned16(const void* x);

// One fused launch (sc_ca_launch, sc_ca_launch_sharded and
// sc_ca_launch_trace): the arguments checked, the instantiation picked.
template <bool kShard, bool kTrace = false>
int ca_entry(const float* src, float* dst, const long long* params,
             const int* lut, const int* perm, const int* ops, int halo,
             int nsteps, int rule, float alpha, int stages,
             unsigned char* scratch, const ShardParams& sh, void* stream,
             int* rows = nullptr) {
  const FracParams p = make_params(params);
  CaArgs ca;
  ca.halo = halo;
  ca.nsteps = nsteps;
  ca.rule = rule;
  ca.alpha = alpha;
  ca.wid = (int)p.span + 2 * halo;
  ca.stages = stages;
  if (nsteps < 1 || nsteps > halo || halo > (int)p.span || stages < 1 ||
      stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  if (p.steps == 0) return (int)cudaSuccess;
  // 16-byte pieces: fine blocks start on piece boundaries in both memories
  const bool vec = p.block % 4 == 0 && p.pitch % 4 == 0 && aligned16(src) &&
                   aligned16(dst);
  ca.pc = vec ? 4 : 1;
  ca.pad = vec ? (4 - halo % 4) % 4 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mma = p.lowering == kMma;
  const bool generic =
      p.family == kTriangular || p.family == kBand || p.family == kBox;
  cudaError_t err;
  if (generic)
    err = mma ? launch_ca<kGenericDom, true, kShard, kTrace>(
                    src, dst, p, ca, lut, perm, ops, scratch, sh, rows, s)
              : launch_ca<kGenericDom, false, kShard, kTrace>(
                    src, dst, p, ca, lut, perm, ops, scratch, sh, rows, s);
  else
    err = mma ? launch_ca<kFractalDom, true, kShard, kTrace>(
                    src, dst, p, ca, lut, perm, ops, scratch, sh, rows, s)
              : launch_ca<kFractalDom, false, kShard, kTrace>(
                    src, dst, p, ca, lut, perm, ops, scratch, sh, rows, s);
  return (int)err;
}


bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace

extern "C" {

// Bytes of global scratch a launch at params with halo h and a ring of
// `stages` slots needs: 0 when its working tiles fit shared memory.
long long sc_scratch_bytes(const long long* params, int halo, int stages) {
  const FracParams p = make_params(params);
  const int wid = (int)p.span + 2 * halo;
  const CaGeom g = ca_geom(wid);
  if (shared_depth(p, g, wid, stages) > 0) return 0;
  return g.base_bytes(wid, 1) * scratch_ctas(p.steps);
}

#if defined(REPRO_TRACE)
// sc_ca_launch, also writing each computed step's trace row into rows
// (steps x trace::kCols int32, filled with the initial row by the
// caller).
int sc_ca_launch_trace(const float* src, float* dst, const long long* params,
                       const int* lut, const int* perm, const int* ops,
                       int halo, int nsteps, int rule, float alpha,
                       int stages, unsigned char* scratch, int* rows,
                       void* stream) {
  return ca_entry<false, true>(src, dst, params, lut, perm, ops, halo,
                               nsteps, rule, alpha, stages, scratch,
                               ShardParams{}, stream, rows);
}
#elif !defined(REPRO_SHARDED)
// The ring's slots a launch at params with halo h and `stages` requested
// runs: the deepest that fits shared memory, 0 on the global-scratch path.
int sc_ring_depth(const long long* params, int halo, int stages) {
  const FracParams p = make_params(params);
  const int wid = (int)p.span + 2 * halo;
  return shared_depth(p, ca_geom(wid), wid, stages);
}

// The CTAs a launch at params with halo h and `stages` requested runs.
long long sc_grid_ctas(const long long* params, int halo, int stages) {
  const FracParams p = make_params(params);
  CaArgs ca;
  ca.wid = (int)p.span + 2 * halo;
  ca.stages = stages;
  if (complete_args(p, ca) == 0) return walk_ctas(p, scratch_ctas(p.steps));
  const int bytes = ca.meta_bytes +
                    (int)ca_geom(ca.wid).base_bytes(ca.wid, ca.stages);
  const int threads = threads_for(ca.wid);
  const bool mma = p.lowering == kMma;
  if (p.family == kTriangular || p.family == kBand || p.family == kBox)
    return mma ? resident_ctas<kGenericDom, true>(p, threads, bytes)
               : resident_ctas<kGenericDom, false>(p, threads, bytes);
  return mma ? resident_ctas<kFractalDom, true>(p, threads, bytes)
             : resident_ctas<kFractalDom, false>(p, threads, bytes);
}

// One fused launch: read the state `src`, write the advanced member
// supertiles into `dst` (the stale buffer; unvisited blocks keep its
// contents).  params: plan.C_PARAMS order; lut, perm and ops may be null
// (see LaunchParams; ops is mma_ops); stages: the ring's slots, 1 to
// kMaxStages (a ring deeper than shared memory holds runs at the deepest
// that fits: the same result); scratch holds sc_scratch_bytes(params,
// halo, stages) bytes, or is null when that is 0.
int sc_ca_launch(const float* src, float* dst, const long long* params,
                 const int* lut, const int* perm, const int* ops, int halo,
                 int nsteps, int rule, float alpha, int stages,
                 unsigned char* scratch, void* stream) {
  return ca_entry<false>(src, dst, params, lut, perm, ops, halo, nsteps,
                         rule, alpha, stages, scratch, ShardParams{},
                         stream);
}

#else
// sc_ca_launch over one rank's steps of a sharded domain: src and dst its
// local buffers (the replicated arrays, or the extended arrays [slab ++
// ghost rows ++ dump row] under storage-rows, whose slab rows dst
// receives); shard holds the SHARD_PARAMS (core/shard.py), gmap the rank's
// ghost map (storage-rows, else null), phase a phase launch's scheduled
// steps (else null); params' steps are the rank's, lut its LUT chunk.
int sc_ca_launch_sharded(const float* src, float* dst,
                         const long long* params, const int* lut,
                         const int* perm, const int* ops, int halo,
                         int nsteps, int rule, float alpha, int stages,
                         unsigned char* scratch, const long long* shard,
                         const int* gmap, const int* phase, void* stream) {
  return ca_entry<true>(src, dst, params, lut, perm, ops, halo, nsteps, rule,
                        alpha, stages, scratch,
                        make_shard(shard, gmap, phase), stream);
}
#endif  // REPRO_SHARDED

const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
