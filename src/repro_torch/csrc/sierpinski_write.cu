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
// members).  The sum must read the same cells once.  Neither does
// arithmetic worth counting (the decode is a few integer ops per block, the
// membership test a few per cell).  The combine is a serial chain of f32
// adds, one per grid step: it is bound by the latency of that chain (one
// thread; the rest of its CTA stages the partials through shared memory),
// not by bytes.
//
// What the design does about it:
//   * one CTA per scheduled (super)block (grid-stride over steps, so the
//     2^32 steps of the bounding box at rho = 1 launch too), min(rho, 32)^2
//     threads looping over the fine rho x rho tiles of the supertile;
//   * storage: the supertile origin is the embedded superblock (embedded
//     storage), or its packed slot in the Lemma 2 orthotope (compact
//     storage): lambda^-1 in registers, or LUT columns 2-3 under
//     prefetch_lut.  Under compact coarsening the packed fine blocks map to
//     their embedded offsets through the static permutation table;
//   * the block is decoded in registers: the base-3 lambda digit loop for
//     the gasket, the base-k digit loop over the by-value copy offsets for a
//     FractalSpec; or one row read of the int32 LUT; or, for the bounding
//     box, a row-major split of the step and an early exit for non-member
//     blocks;
//   * the write is a predicated store of `value` into member cells, with no
//     load of the tile: non-member cells keep their contents because they
//     are never touched, so a write moves only member bytes (the Pallas
//     kernels loaded and re-stored the whole tile);
//   * the sum reduces each tile in f32 (a fixed shared-memory tree, no float
//     atomics) into partials[step]; non-member bounding steps store 0; the
//     combine then adds the partials in step order, which is the JAX
//     package's order (lambda order, or row-major by * nbx + bx for the
//     bounding box), so integer-valued states sum bit-identically;
//   * cell offsets are 64-bit: an n = 2^16 state has 2^32 cells;
//   * the row-major domains (triangular, band, bounding box) and the mma
//     lowering run in template instantiations of their own (kDom, kMma),
//     so the fractal closed_form / prefetch_lut / bounding kernels are the
//     same code as before and keep their registers.  A generic domain's
//     cells are all live, so its cell loop has no membership test; its
//     block comes from the integer decode (the triangle's integer sqrt,
//     the band's two parts, the box's split), the LUT, or the bounding
//     split with its contains test.  Under mma the block comes from the
//     tensor-core chains of mma_decode.cuh: every warp runs the fractal
//     chain of its step (B7a; the own compact slot too) and keeps it in
//     registers, while a row-major domain's row chain (B7c) is shared by
//     the CTA's warps.  Under mma the CTA has at least one whole warp.

#include "fractal_common.cuh"
#include "mma_decode.cuh"

namespace {

using namespace fractal;

enum DType { kF32 = 0, kBF16 = 1, kI32 = 2 };

// Both kernels run up to 1024 threads a CTA (rho >= 32); two such CTAs
// must stay resident on an SM, since the launch is bound by CTA
// scheduling, not bytes: hence at most 32 registers a thread.
constexpr int kMaxThreads = 1024, kMinCtasPerSm = 2;

// Where step t's supertile lies: its storage origin (row0, col0) and its
// superblock's embedded origin (x0, y0).  False for a discarded bounding
// step (uniform over the CTA).
struct Tile {
  long long row0, col0;
  unsigned x0, y0;
};

template <int kDom, bool kMma>
__device__ __forceinline__ bool step_tile(const FracParams& p,
                                          const int* __restrict__ lut,
                                          const int* __restrict__ ops,
                                          long long t, Tile& tile) {
  unsigned bx, by;
  if constexpr (kMma && kDom == kFractalDom) {
    const int lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31;
    const bool compact = p.storage == kCompact;
    unsigned sx = 0, sy = 0;
    fractal_chain(p, ops, (unsigned)t, lane, compact, bx, by, sx, sy);
    tile.row0 = compact ? (long long)sy * p.th : (long long)by * p.span;
    tile.col0 = compact ? (long long)sx * p.tw : (long long)bx * p.span;
  } else if constexpr (kDom == kFractalDom) {
    if (!decode(p, lut, t, bx, by)) return false;
    tile_origin(p, lut, t, bx, by, tile.row0, tile.col0);
  } else {
    if constexpr (kMma)
      rows_chain_cta(p, ops, t, bx, by);
    else if (!generic_decode(p, lut, t, bx, by))
      return false;
    generic_origin(p, lut, t, bx, by, tile.row0, tile.col0);
  }
  tile.x0 = bx * p.span;
  tile.y0 = by * p.span;
  return true;
}

// Fine block q of a supertile: its storage row/col offset and its cell
// offset (ox0, oy0) inside the superblock.  kTiled is false when the
// supertile is one fine block (coarsen 1): then everything is 0 at
// compile time, and the uncoarsened kernels keep their 32 registers.
template <bool kTiled>
__device__ __forceinline__ void fine_block(const FracParams& p,
                                           const int* __restrict__ perm,
                                           int q, long long& srow,
                                           long long& scol, unsigned& ox0,
                                           unsigned& oy0) {
  srow = scol = 0;
  ox0 = oy0 = 0;
  if (!kTiled) return;
  int ey, ex;
  fine_offset(p, perm, q, ey, ex);
  srow = (long long)(q / p.bw) * p.block;
  scol = (long long)(q % p.bw) * p.block;
  oy0 = (unsigned)ey * p.block;
  ox0 = (unsigned)ex * p.block;
}

template <int kDom, bool kMma, bool kTiled, typename W>
__global__ void __launch_bounds__(kMaxThreads, kMinCtasPerSm)
write_kernel(W* __restrict__ m, W value, FracParams p,
             const int* __restrict__ lut, const int* __restrict__ perm,
             const int* __restrict__ ops) {
  const int nfine = kTiled ? p.nfine : 1;
  for (long long t = blockIdx.x; t < p.steps; t += gridDim.x) {
    Tile tl;
    if (!step_tile<kDom, kMma>(p, lut, ops, t, tl)) continue;
    for (int q = 0; q < nfine; ++q) {
      long long srow, scol;
      unsigned ox0, oy0;
      fine_block<kTiled>(p, perm, q, srow, scol, ox0, oy0);
      for (unsigned iy = threadIdx.y; iy < (unsigned)p.block;
           iy += blockDim.y) {
        W* row = m + (tl.row0 + srow + iy) * p.pitch + tl.col0 + scol;
        const unsigned gy = tl.y0 + oy0 + iy;
        for (unsigned ix = threadIdx.x; ix < (unsigned)p.block;
             ix += blockDim.x) {
          if (kDom == kGenericDom ||
              cell_member(p, tl.x0 + ox0 + ix, gy, ox0 + ix, oy0 + iy))
            row[ix] = value;
        }
      }
    }
  }
}

template <int DT>
__device__ __forceinline__ float load_f32(const void* base, long long off) {
  if (DT == kF32) return static_cast<const float*>(base)[off];
  if (DT == kBF16) {
    unsigned bits = static_cast<const unsigned short*>(base)[off];
    return __uint_as_float(bits << 16);
  }
  return (float)static_cast<const int*>(base)[off];
}

template <int kDom, bool kMma, bool kTiled, int DT>
__global__ void __launch_bounds__(kMaxThreads, kMinCtasPerSm)
sum_partials_kernel(const void* __restrict__ m, float* __restrict__ partials,
                    FracParams p, const int* __restrict__ lut,
                    const int* __restrict__ perm,
                    const int* __restrict__ ops) {
  __shared__ float red[1024];
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nfine = kTiled ? p.nfine : 1;
  int top = 1;
  while (top < nthreads) top <<= 1;
  for (long long t = blockIdx.x; t < p.steps; t += gridDim.x) {
    Tile tl;
    if (!step_tile<kDom, kMma>(p, lut, ops, t, tl)) {
      if (tid == 0) partials[t] = 0.0f;  // a discarded bounding step
      continue;
    }
    float acc = 0.0f;
    for (int q = 0; q < nfine; ++q) {
      long long srow, scol;
      unsigned ox0, oy0;
      fine_block<kTiled>(p, perm, q, srow, scol, ox0, oy0);
      for (unsigned iy = threadIdx.y; iy < (unsigned)p.block;
           iy += blockDim.y) {
        const long long row = (tl.row0 + srow + iy) * p.pitch + tl.col0 +
                              scol;
        const unsigned gy = tl.y0 + oy0 + iy;
        for (unsigned ix = threadIdx.x; ix < (unsigned)p.block;
             ix += blockDim.x) {
          if (kDom == kGenericDom ||
              cell_member(p, tl.x0 + ox0 + ix, gy, ox0 + ix, oy0 + iy))
            acc += load_f32<DT>(m, row + ix);
        }
      }
    }
    // fixed-order tree over the CTA's threads: deterministic, no atomics
    red[tid] = acc;
    __syncthreads();
    for (int s = top >> 1; s > 0; s >>= 1) {
      if (tid < s && tid + s < nthreads) red[tid] += red[tid + s];
      __syncthreads();
    }
    if (tid == 0) partials[t] = red[0];
    __syncthreads();  // red is reused by the next step
  }
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

// min(rho, 32)^2 threads; under mma whole warps (mma.sync and the warp
// shuffles need all 32 lanes): the rows of threads rounded up to the
// least count whose product with the row length is a multiple of 32 (the
// extra rows find no cells and idle in the cell loop).
dim3 threads_of(int block, bool whole_warps) {
  const int t = block < 32 ? block : 32;
  if (!whole_warps) return dim3(t, t);
  int g = 32, b = t;  // gcd(32, t)
  while (b) {
    const int r = g % b;
    g = b;
    b = r;
  }
  const int step = 32 / g;  // rows per whole number of warps
  return dim3(t, (t + step - 1) / step * step);
}

bool generic_family(const FracParams& p) {
  return p.family == kTriangular || p.family == kBand || p.family == kBox;
}

// One launch of write_kernel: the instantiation of the domain kind and the
// lowering, tiled only where a supertile holds more than one fine block.
template <int kDom, bool kMma, typename W>
void launch_write_as(W* m, W value, const FracParams& p, const int* lut,
                     const int* perm, const int* ops, cudaStream_t s) {
  const dim3 g = grid_of(p.steps), th = threads_of(p.block, kMma);
  if (kDom == kFractalDom && p.nfine > 1)
    write_kernel<kDom, kMma, true><<<g, th, 0, s>>>(m, value, p, lut, perm,
                                                    ops);
  else
    write_kernel<kDom, kMma, false><<<g, th, 0, s>>>(m, value, p, lut, perm,
                                                     ops);
}

template <typename W>
void launch_write(W* m, W value, const FracParams& p, const int* lut,
                  const int* perm, const int* ops, cudaStream_t s) {
  const bool mma = p.lowering == kMma;
  if (generic_family(p)) {
    if (mma)
      launch_write_as<kGenericDom, true>(m, value, p, lut, perm, ops, s);
    else
      launch_write_as<kGenericDom, false>(m, value, p, lut, perm, ops, s);
  } else if (mma) {
    launch_write_as<kFractalDom, true>(m, value, p, lut, perm, ops, s);
  } else {
    launch_write_as<kFractalDom, false>(m, value, p, lut, perm, ops, s);
  }
}

template <int kDom, bool kMma, int DT>
void launch_sum_as(const void* m, float* partials, const FracParams& p,
                   const int* lut, const int* perm, const int* ops,
                   cudaStream_t s) {
  const dim3 g = grid_of(p.steps), th = threads_of(p.block, kMma);
  if (kDom == kFractalDom && p.nfine > 1)
    sum_partials_kernel<kDom, kMma, true, DT><<<g, th, 0, s>>>(
        m, partials, p, lut, perm, ops);
  else
    sum_partials_kernel<kDom, kMma, false, DT><<<g, th, 0, s>>>(
        m, partials, p, lut, perm, ops);
}

template <int DT>
void launch_sum(const void* m, float* partials, const FracParams& p,
                const int* lut, const int* perm, const int* ops,
                cudaStream_t s) {
  const bool mma = p.lowering == kMma;
  if (generic_family(p)) {
    if (mma)
      launch_sum_as<kGenericDom, true, DT>(m, partials, p, lut, perm, ops, s);
    else
      launch_sum_as<kGenericDom, false, DT>(m, partials, p, lut, perm, ops,
                                            s);
  } else if (mma) {
    launch_sum_as<kFractalDom, true, DT>(m, partials, p, lut, perm, ops, s);
  } else {
    launch_sum_as<kFractalDom, false, DT>(m, partials, p, lut, perm, ops, s);
  }
}

}  // namespace

extern "C" {

// Write the value bits into every member cell of the state m, in place.
// elem_bytes is 4 (f32, int32) or 2 (bf16).  params: plan.C_PARAMS order;
// lut, perm and ops may be null (see LaunchParams; ops is mma_ops).
int sw_write(void* m, int elem_bytes, unsigned int value_bits,
             const long long* params, const int* lut, const int* perm,
             const int* ops, void* stream) {
  const FracParams p = make_params(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    launch_write(static_cast<uint32_t*>(m), (uint32_t)value_bits, p, lut,
                 perm, ops, s);
  } else if (elem_bytes == 2) {
    launch_write(static_cast<uint16_t*>(m), (uint16_t)value_bits, p, lut,
                 perm, ops, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// partials[t] = f32 sum of the member cells of grid step t's supertile (0
// for a discarded bounding step).  dtype: 0 f32, 1 bf16, 2 int32.
int sw_sum_partials(const void* m, int dtype, float* partials,
                    const long long* params, const int* lut, const int* perm,
                    const int* ops, void* stream) {
  const FracParams p = make_params(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    launch_sum<kF32>(m, partials, p, lut, perm, ops, s);
  } else if (dtype == kBF16) {
    launch_sum<kBF16>(m, partials, p, lut, perm, ops, s);
  } else if (dtype == kI32) {
    launch_sum<kI32>(m, partials, p, lut, perm, ops, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out[0] = partials[0] + partials[1] + ... in step order, in f32.
int sw_sum_combine(const float* partials, long long steps, float* out,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sum_combine_kernel<<<1, kCombineThreads, 0, s>>>(partials, steps, out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
