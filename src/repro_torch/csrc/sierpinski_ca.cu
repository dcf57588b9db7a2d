// Fused cellular-automaton / diffusion step kernel for Hopper (sm_90a),
// with a plain C interface loaded through ctypes
// (repro_torch/kernels/_cuda.py).
//
// Replaces (JAX package, Pallas):
//   sc_ca_launch  <- kernels/sierpinski_ca.py::_ca_fused_kernel (:212), with
//                    its _dma (:232) and _gpu (:268) variants, the shared
//                    math _trapezoid_update (:117) and one launch of the
//                    scan in _ca_run_impl (:370)
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
// 725.6 MB, so 2 x 725.6 MB = 1.45 GB, 0.433 ms.  The arithmetic is a few
// f32 operations per cell and step, far below the f32 rate; the halo
// re-reads ((span + 2h)^2 against span^2 cells) and the stencil's
// shared-memory traffic are what a simple kernel pays above the bound.
//
// What the design does about it:
//   * one CTA per scheduled (super)block, grid-stride over steps; the
//     nine supertile origins are resolved once per CTA, the lowering's own
//     way: lambda in registers then lambda^-1 for the neighbour slots
//     (closed_form), one read of columns 2-27 of the 28-column LUT row
//     (prefetch_lut), or a row-major split with an early exit on
//     non-member blocks (bounding);
//   * each working cell is gathered once from device memory (neighbouring
//     threads read neighbouring cells of one fine-block row), through the
//     static fine-block permutation under compact coarsening; cells of
//     out-of-range or non-member fine blocks are never read (block_ok);
//   * the step loop runs in the CTA on two buffers (ping-pong), shrinking
//     the computed region by one ring per step: only the interior is
//     stored, and after k steps it depends only on cells within k of it;
//   * the buffers and the cell mask live in shared memory up to the
//     227 KB opt-in limit; larger working tiles (e.g. rho = 128 at
//     fuse 128) keep them in a per-CTA slice of one global scratch buffer
//     under a persistent grid-stride launch -- the same kernel;
//   * diffusion is written with __fmul_rn / __fadd_rn / __fsub_rn in the
//     JAX expression's order (no FMA contraction), and parity uses the
//     floor-mod of jnp.mod, so the kernel is bit-equal to its plain
//     version;
//   * cell offsets are 64-bit: an embedded n = 2^16 state has 2^32 cells;
//   * the row-major domains (triangular, band, bounding box) and the mma
//     lowering run in template instantiations of their own (kDom, kMma):
//     the fractal kernels without mma are the same code as before.  Under
//     mma every warp runs the lambda chain of its step (B7a) and warp 0,
//     converged, resolves the own slot (B7a) and the 8 neighbour slots
//     (B7b) on the tensor cores into org_row / org_col; a row-major
//     domain's row chain (B7c) is shared by the CTA's warps.  A generic
//     domain's halo follows the JAX package's tile semantics exactly: an
//     embedded neighbour tile index is clamped into the box, an invalid
//     compact neighbour reads slot (0, 0), and only the in-range test and
//     the domain's contains() (at block granularity) mask values.

#include "fractal_common.cuh"
#include "mma_decode.cuh"

namespace {

using namespace fractal;

enum Rule { kParity = 0, kDiffusion = 1 };

struct CaArgs {
  int halo;     // h: halo ring width (the fuse depth of the run)
  int nsteps;   // steps of this launch, 1 <= nsteps <= h
  int rule;
  float alpha;
  int wid;      // span + 2h
};

// Resolve the storage origins of the nine supertiles around scheduled
// block (bx, by) of step t into org[(dy + 1) * 3 + dx + 1] (compact
// storage; embedded storage addresses cells directly).  Invalid
// neighbours get no origin: their cells fail block_ok and are not read.
__device__ void resolve_origins(const FracParams& p,
                                const int* __restrict__ lut, long long t,
                                unsigned bx, unsigned by, long long* org_row,
                                long long* org_col) {
  tile_origin(p, lut, t, bx, by, org_row[4], org_col[4]);
  for (int j = 0; j < 8; ++j) {
    const int dx = kNbrDx[j], dy = kNbrDy[j];
    const int slot = (dy + 1) * 3 + dx + 1;
    unsigned tx, ty;
    bool ok;
    if (p.lowering == kPrefetchLut) {
      const int* row = lut + t * p.lut_cols + kLutNbr + 3 * j;
      tx = (unsigned)row[0];
      ty = (unsigned)row[1];
      ok = row[2] != 0;
    } else {
      const long long x = (long long)bx + dx, y = (long long)by + dy;
      ok = x >= 0 && y >= 0 && x < p.nbx && y < p.nbx &&
           block_member(p, (unsigned)x, (unsigned)y, p.nbx, p.r_b);
      unsigned wx = 0, wy = 0;
      if (ok) lambda_inverse(p, (unsigned)x, (unsigned)y, wx, wy);
      tx = p.swap ? wy : wx;
      ty = p.swap ? wx : wy;
    }
    org_row[slot] = ok ? (long long)ty * p.th : -1;
    org_col[slot] = ok ? (long long)tx * p.tw : -1;
  }
}

// The same for a generic domain (thread 0): the own slot, then each
// neighbour's slot when it is in the box and a member, else slot (0, 0)
// (CompactLayout.neighbor_slot; the LUT holds the same).
__device__ void generic_origins(const FracParams& p,
                                const int* __restrict__ lut, long long t,
                                unsigned bx, unsigned by, long long* org_row,
                                long long* org_col) {
  generic_origin(p, lut, t, bx, by, org_row[4], org_col[4]);
  for (int j = 0; j < 8; ++j) {
    const int dx = kNbrDx[j], dy = kNbrDy[j];
    const int slot = (dy + 1) * 3 + dx + 1;
    unsigned sx = 0, sy = 0;
    if (p.lowering == kPrefetchLut) {
      const int* row = lut + t * p.lut_cols + kLutNbr + 3 * j;
      sx = (unsigned)row[0];
      sy = (unsigned)row[1];
    } else {
      const long long x = (long long)bx + dx, y = (long long)by + dy;
      const long long xc = x < 0 ? 0 : (x >= p.nbx ? p.nbx - 1 : x);
      const long long yc = y < 0 ? 0 : (y >= p.nby ? p.nby - 1 : y);
      if (x == xc && y == yc && generic_contains(p, xc, yc))
        generic_slot(p, xc, yc, sx, sy);
    }
    org_row[slot] = (long long)sy * p.th;
    org_col[slot] = (long long)sx * p.tw;
  }
}

// Step t -> scheduled block (bx, by), by every thread of the CTA; false
// for a discarded bounding step (uniform over the CTA).
template <int kDom, bool kMma>
__device__ __forceinline__ bool ca_decode(const FracParams& p,
                                          const int* __restrict__ lut,
                                          const int* __restrict__ ops,
                                          long long t, unsigned& bx,
                                          unsigned& by) {
  if constexpr (kMma && kDom == kFractalDom) {
    unsigned sx, sy;
    fractal_chain(p, ops, (unsigned)t, threadIdx.x & 31, false, bx, by, sx,
                  sy);
    return true;
  } else if constexpr (kMma) {
    rows_chain_cta(p, ops, t, bx, by);
    return true;
  } else if constexpr (kDom == kFractalDom) {
    return decode(p, lut, t, bx, by);
  } else {
    return generic_decode(p, lut, t, bx, by);
  }
}

template <bool kShared, int kDom, bool kMma>
__global__ void __launch_bounds__(512)
ca_fused_kernel(const float* __restrict__ src, float* __restrict__ dst,
                FracParams p, CaArgs ca, const int* __restrict__ lut,
                const int* __restrict__ perm, const int* __restrict__ ops,
                unsigned char* __restrict__ scratch,
                long long scratch_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long org_row[9], org_col[9];
  unsigned char* base =
      kShared ? smem : scratch + (long long)blockIdx.x * scratch_per_cta;
  const int wid = ca.wid, h = ca.halo;
  const int cells = wid * wid;
  float* buf0 = reinterpret_cast<float*>(base);
  float* buf1 = buf0 + cells;
  unsigned char* ok = reinterpret_cast<unsigned char*>(buf1 + cells);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const unsigned nbf = p.n / (unsigned)p.block;  // fine blocks per side
  const int s = p.coarsen;
  const float alpha = ca.alpha;

  for (long long t = blockIdx.x; t < p.steps; t += gridDim.x) {
    unsigned bx, by;
    if (!ca_decode<kDom, kMma>(p, lut, ops, t, bx, by)) continue;
    if constexpr (kMma && kDom == kFractalDom) {
      if (p.storage == kCompact && tid < 32) {  // warp 0, converged
        unsigned x, y, sx, sy;
        fractal_chain(p, ops, (unsigned)t, tid, true, x, y, sx, sy);
        if (tid == 0) {
          org_row[4] = (long long)sy * p.th;
          org_col[4] = (long long)sx * p.tw;
        }
        fractal_nbrs(p, ops, bx, by, tid, org_row, org_col);
      }
    } else if constexpr (kDom == kFractalDom) {
      if (p.storage == kCompact && tid == 0)
        resolve_origins(p, lut, t, bx, by, org_row, org_col);
    } else {
      if (p.storage == kCompact && tid == 0)
        generic_origins(p, lut, t, bx, by, org_row, org_col);
    }
    __syncthreads();

    // -- gather the working tile: block_ok at fine-block granularity,
    //    cell_ok at cell granularity
    const long long gx0 = (long long)bx * p.span - h;
    const long long gy0 = (long long)by * p.span - h;
    for (int c = tid; c < cells; c += nthreads) {
      const int iy = c / wid, ix = c - iy * wid;
      const long long gx = gx0 + ix, gy = gy0 + iy;
      float v = 0.0f;
      bool cell_ok = false;
      if constexpr (kDom == kGenericDom) {
        // every cell of the in-range square is live; values pass where
        // the fine block is a member, read from its (clamped) tile
        if (gx >= 0 && gy >= 0 && gx < p.n && gy < p.n) {
          cell_ok = true;
          const long long fbx = gx / p.block, fby = gy / p.block;
          if (generic_contains(p, fbx, fby)) {
            const long long ox = gx - fbx * p.block, oy = gy - fby * p.block;
            if (p.storage == kEmbedded) {
              const long long tx = fbx < p.nbx ? fbx : p.nbx - 1;
              const long long ty = fby < p.nby ? fby : p.nby - 1;
              v = src[(ty * p.block + oy) * p.pitch + tx * p.block + ox];
            } else {
              const int slot = (int)(fby - by + 1) * 3 + (int)(fbx - bx + 1);
              v = src[(org_row[slot] + oy) * p.pitch + org_col[slot] + ox];
            }
          }
        }
      } else if (gx >= 0 && gy >= 0 && gx < p.n && gy < p.n) {
        const unsigned ux = (unsigned)gx, uy = (unsigned)gy;
        cell_ok = block_member(p, ux, uy, p.n, p.r_b + p.r_cell);
        const unsigned fbx = ux / p.block, fby = uy / p.block;
        if (block_member(p, fbx, fby, nbf, p.r_fine)) {
          if (p.storage == kEmbedded) {
            v = src[(long long)uy * p.n + ux];
          } else {
            // which of the nine supertiles, and where inside it
            const int rdx = (int)(fbx / s) - (int)bx;  // -1, 0 or 1
            const int rdy = (int)(fby / s) - (int)by;
            const int slot = (rdy + 1) * 3 + rdx + 1;
            const int fx = (int)(fbx % s), fy = (int)(fby % s);
            const int q = perm != nullptr ? perm[2 * p.nfine + fy * s + fx]
                                          : 0;
            const long long r = org_row[slot] +
                                (long long)(q / p.bw) * p.block +
                                uy % p.block;
            const long long col = org_col[slot] +
                                  (long long)(q % p.bw) * p.block +
                                  ux % p.block;
            v = src[r * p.pitch + col];
          }
        }
      }
      buf0[c] = v;
      ok[c] = cell_ok;
    }
    __syncthreads();

    // -- the shrinking trapezoid: step i computes rings i+1 .. wid-2-i
    float* cur = buf0;
    float* nxt = buf1;
    for (int i = 0; i < ca.nsteps; ++i) {
      const int lo = i + 1, side = wid - 2 * lo;
      const int region = side * side;
      for (int c = tid; c < region; c += nthreads) {
        const int ry = c / side;
        const int idx = (lo + ry) * wid + lo + (c - ry * side);
        float out = 0.0f;
        if (ok[idx]) {
          const float pv = cur[idx];
          const float nsum =
              __fadd_rn(__fadd_rn(__fadd_rn(cur[idx - wid], cur[idx + wid]),
                                  cur[idx - 1]),
                        cur[idx + 1]);
          if (ca.rule == kParity) {
            // jnp.mod: floor-mod, fmod then + 2 where the sign differs
            float r = fmodf(__fadd_rn(pv, nsum), 2.0f);
            if (r != 0.0f && r < 0.0f) r = __fadd_rn(r, 2.0f);
            out = r;
          } else {
            const float deg = (float)(ok[idx - wid] + ok[idx + wid] +
                                      ok[idx - 1] + ok[idx + 1]);
            out = __fadd_rn(
                pv, __fmul_rn(alpha, __fsub_rn(nsum, __fmul_rn(deg, pv))));
          }
        }
        nxt[idx] = out;
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }

    // -- store the span^2 interior in storage arrangement
    long long row0, col0;
    if (p.storage == kCompact) {
      row0 = org_row[4];
      col0 = org_col[4];
    } else {
      row0 = (long long)by * p.span;
      col0 = (long long)bx * p.span;
    }
    const int fine_cells = p.block * p.block;
    for (int c = tid; c < p.nfine * fine_cells; c += nthreads) {
      const int q = c / fine_cells, e = c - q * fine_cells;
      const int cy = e / p.block, cx = e - cy * p.block;
      int ey, ex;
      fine_offset(p, perm, q, ey, ex);
      const float v =
          cur[(h + ey * p.block + cy) * wid + h + ex * p.block + cx];
      dst[(row0 + (long long)(q / p.bw) * p.block + cy) * p.pitch + col0 +
          (long long)(q % p.bw) * p.block + cx] = v;
    }
    __syncthreads();  // the buffers and origins are reused by the next step
  }
}

long long tile_bytes(int wid) {
  const long long cells = (long long)wid * wid;
  return (2 * cells * 4 + cells + 255) / 256 * 256;
}

int threads_for(int wid) { return wid < 64 ? 256 : 512; }

// Does a working tile of `bytes` fit the opt-in shared memory of one CTA
// (less 1 KB for the kernel's static shared arrays)?
bool fits_shared(long long bytes) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes <= optin - 1024;
}

// Resident CTAs of the global-scratch path: two per SM.
long long persistent_ctas(long long steps) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = 2LL * sms;
  return steps < want ? steps : want;
}

// One fused launch of the instantiation of the domain kind and lowering.
template <int kDom, bool kMma>
cudaError_t launch_ca(const float* src, float* dst, const FracParams& p,
                      const CaArgs& ca, const int* lut, const int* perm,
                      const int* ops, unsigned char* scratch,
                      cudaStream_t s) {
  const long long bytes = tile_bytes(ca.wid);
  const int threads = threads_for(ca.wid);
  if (fits_shared(bytes)) {
    cudaError_t err = cudaFuncSetAttribute(
        ca_fused_kernel<true, kDom, kMma>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    ca_fused_kernel<true, kDom, kMma><<<grid_of(p.steps), threads, bytes,
                                        s>>>(src, dst, p, ca, lut, perm, ops,
                                             nullptr, 0);
  } else {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    ca_fused_kernel<false, kDom, kMma>
        <<<dim3((unsigned)persistent_ctas(p.steps)), threads, 0, s>>>(
            src, dst, p, ca, lut, perm, ops, scratch, bytes);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of global scratch a launch with a (wid x wid) working tile over
// `steps` grid steps needs: 0 when the working tile fits shared memory.
long long sc_scratch_bytes(int wid, long long steps) {
  const long long bytes = tile_bytes(wid);
  if (fits_shared(bytes)) return 0;
  return bytes * persistent_ctas(steps);
}

// One fused launch: read the state `src`, write the advanced member
// supertiles into `dst` (the stale buffer; unvisited blocks keep its
// contents).  params: plan.C_PARAMS order; lut, perm and ops may be null
// (see LaunchParams; ops is mma_ops); scratch holds
// sc_scratch_bytes(wid, steps) bytes, or is null when that is 0.
int sc_ca_launch(const float* src, float* dst, const long long* params,
                 const int* lut, const int* perm, const int* ops, int halo,
                 int nsteps, int rule, float alpha, unsigned char* scratch,
                 void* stream) {
  const FracParams p = make_params(params);
  CaArgs ca;
  ca.halo = halo;
  ca.nsteps = nsteps;
  ca.rule = rule;
  ca.alpha = alpha;
  ca.wid = (int)p.span + 2 * halo;
  if (nsteps < 1 || nsteps > halo || halo > (int)p.span)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mma = p.lowering == kMma;
  const bool generic =
      p.family == kTriangular || p.family == kBand || p.family == kBox;
  cudaError_t err;
  if (generic)
    err = mma ? launch_ca<kGenericDom, true>(src, dst, p, ca, lut, perm, ops,
                                             scratch, s)
              : launch_ca<kGenericDom, false>(src, dst, p, ca, lut, perm,
                                              ops, scratch, s);
  else
    err = mma ? launch_ca<kFractalDom, true>(src, dst, p, ca, lut, perm, ops,
                                             scratch, s)
              : launch_ca<kFractalDom, false>(src, dst, p, ca, lut, perm,
                                              ops, scratch, s);
  return (int)err;
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
