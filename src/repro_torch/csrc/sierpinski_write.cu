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
// at n = 2^16, ~51 us.  The sum must read the same cells once.  Neither does
// arithmetic worth counting (the decode is a few integer ops per block, the
// membership test a few per cell).  The combine is a serial chain of f32
// adds, one per grid step: it is bound by the latency of that chain (one
// thread; the rest of its CTA stages the partials through shared memory),
// not by bytes.
//
// What the design does about it:
//   * one CTA per scheduled block (grid-stride over steps, so the 2^32 steps
//     of the bounding box at rho = 1 launch too), min(rho, 32)^2 threads
//     looping over the rho x rho tile;
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
//   * cell offsets are 64-bit: an n = 2^16 state has 2^32 cells.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCopies = 16;
constexpr long long kMaxGrid = 2147483647LL;  // gridDim.x limit

enum Family { kGasket = 0, kSpec = 1 };
enum Lowering { kClosedForm = 0, kPrefetchLut = 1, kBounding = 2 };
enum DType { kF32 = 0, kBF16 = 1, kI32 = 2 };

struct FracParams {
  int family;
  int lowering;
  int r_b;      // block scale level
  int k;        // copies per level
  int m;        // subdivision factor
  int r_cell;   // log_m(block): digit levels inside one tile
  int block;    // tile side in cells
  unsigned int n;          // embedded side in cells
  unsigned int nbx;        // blocks per side
  long long steps;         // grid steps
  unsigned long long allow;  // bit (dy * m + dx) set for each copy offset
  int ox[kMaxCopies];
  int oy[kMaxCopies];
};

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

// Grid step -> embedded block (bx, by); false for a discarded bounding step.
__device__ __forceinline__ bool decode(const FracParams& p,
                                      const int* __restrict__ lut,
                                      long long t, unsigned& bx,
                                      unsigned& by) {
  if (p.lowering == kBounding) {
    bx = (unsigned)(t % p.nbx);
    by = (unsigned)(t / p.nbx);
    if (p.family == kGasket) return (bx & (p.nbx - 1 - by)) == 0;
    return digits_member(p, bx, by, p.r_b);
  }
  if (p.lowering == kPrefetchLut) {
    bx = (unsigned)lut[2 * t];
    by = (unsigned)lut[2 * t + 1];
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

// Membership of cell (gx, gy) = (x0 + ix, y0 + iy) of a member block.
__device__ __forceinline__ bool cell_member(const FracParams& p, unsigned gx,
                                            unsigned gy, unsigned ix,
                                            unsigned iy) {
  if (p.family == kGasket) return (gx & (p.n - 1 - gy)) == 0;
  // the block digits were checked by the decode; the low r_cell digits
  // of the cell are those of its in-tile offset
  return digits_member(p, ix, iy, p.r_cell);
}

template <typename W>
__global__ void write_kernel(W* __restrict__ m, W value, FracParams p,
                             const int* __restrict__ lut) {
  for (long long t = blockIdx.x; t < p.steps; t += gridDim.x) {
    unsigned bx, by;
    if (!decode(p, lut, t, bx, by)) continue;  // uniform over the CTA
    const unsigned x0 = bx * p.block, y0 = by * p.block;
    for (unsigned iy = threadIdx.y; iy < (unsigned)p.block; iy += blockDim.y) {
      const unsigned gy = y0 + iy;
      W* row = m + (long long)gy * p.n + x0;
      for (unsigned ix = threadIdx.x; ix < (unsigned)p.block;
           ix += blockDim.x) {
        if (cell_member(p, x0 + ix, gy, ix, iy)) row[ix] = value;
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

template <int DT>
__global__ void sum_partials_kernel(const void* __restrict__ m,
                                    float* __restrict__ partials,
                                    FracParams p,
                                    const int* __restrict__ lut) {
  __shared__ float red[1024];
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  int top = 1;
  while (top < nthreads) top <<= 1;
  for (long long t = blockIdx.x; t < p.steps; t += gridDim.x) {
    unsigned bx, by;
    if (!decode(p, lut, t, bx, by)) {  // uniform over the CTA
      if (tid == 0) partials[t] = 0.0f;
      continue;
    }
    const unsigned x0 = bx * p.block, y0 = by * p.block;
    float acc = 0.0f;
    for (unsigned iy = threadIdx.y; iy < (unsigned)p.block; iy += blockDim.y) {
      const unsigned gy = y0 + iy;
      const long long row = (long long)gy * p.n + x0;
      for (unsigned ix = threadIdx.x; ix < (unsigned)p.block;
           ix += blockDim.x) {
        if (cell_member(p, x0 + ix, gy, ix, iy))
          acc += load_f32<DT>(m, row + ix);
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

FracParams make_params(int family, int lowering, int r_b, int k, int m,
                       int r_cell, long long n, int block, long long steps,
                       long long nbx, unsigned long long allow,
                       unsigned long long oxs, unsigned long long oys) {
  FracParams p;
  p.family = family;
  p.lowering = lowering;
  p.r_b = r_b;
  p.k = k;
  p.m = m;
  p.r_cell = r_cell;
  p.block = block;
  p.n = (unsigned)n;
  p.nbx = (unsigned)nbx;
  p.steps = steps;
  p.allow = allow;
  for (int c = 0; c < kMaxCopies; ++c) {
    p.ox[c] = (int)((oxs >> (4 * c)) & 15ULL);
    p.oy[c] = (int)((oys >> (4 * c)) & 15ULL);
  }
  return p;
}

dim3 grid_of(long long steps) {
  return dim3((unsigned)(steps < kMaxGrid ? steps : kMaxGrid));
}

dim3 threads_of(int block) {
  const int t = block < 32 ? block : 32;
  return dim3(t, t);
}

}  // namespace

extern "C" {

// Write the value bits into every member cell of the (n, n) state m,
// in place.  elem_bytes is 4 (f32, int32) or 2 (bf16).
int sw_write(void* m, int elem_bytes, unsigned int value_bits, int family,
             int lowering, int r_b, int k, int mbase, int r_cell,
             long long n, int block, long long steps, long long nbx,
             unsigned long long allow, unsigned long long oxs,
             unsigned long long oys, const int* lut, void* stream) {
  FracParams p = make_params(family, lowering, r_b, k, mbase, r_cell, n,
                             block, steps, nbx, allow, oxs, oys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    write_kernel<uint32_t><<<grid_of(steps), threads_of(block), 0, s>>>(
        static_cast<uint32_t*>(m), (uint32_t)value_bits, p, lut);
  } else if (elem_bytes == 2) {
    write_kernel<uint16_t><<<grid_of(steps), threads_of(block), 0, s>>>(
        static_cast<uint16_t*>(m), (uint16_t)value_bits, p, lut);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// partials[t] = f32 sum of the member cells of grid step t (0 for a
// discarded bounding step).  dtype: 0 f32, 1 bf16, 2 int32.
int sw_sum_partials(const void* m, int dtype, float* partials, int family,
                    int lowering, int r_b, int k, int mbase, int r_cell,
                    long long n, int block, long long steps, long long nbx,
                    unsigned long long allow, unsigned long long oxs,
                    unsigned long long oys, const int* lut, void* stream) {
  FracParams p = make_params(family, lowering, r_b, k, mbase, r_cell, n,
                             block, steps, nbx, allow, oxs, oys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 g = grid_of(steps), th = threads_of(block);
  if (dtype == kF32) {
    sum_partials_kernel<kF32><<<g, th, 0, s>>>(m, partials, p, lut);
  } else if (dtype == kBF16) {
    sum_partials_kernel<kBF16><<<g, th, 0, s>>>(m, partials, p, lut);
  } else if (dtype == kI32) {
    sum_partials_kernel<kI32><<<g, th, 0, s>>>(m, partials, p, lut);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* sw_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// out[0] = partials[0] + partials[1] + ... in step order, in f32.
int sw_sum_combine(const float* partials, long long steps, float* out,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sum_combine_kernel<<<1, kCombineThreads, 0, s>>>(partials, steps, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
