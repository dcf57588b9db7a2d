// Block-space flash attention and decode for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (repro_torch/kernels/_cuda.py).
//
// Replaces (JAX package, Pallas):
//   flash_fwd_tc_kernel   <- kernels/flash_attention.py::_attn_kernel and
//   flash_fwd_tf32_kernel    its gpu structure _gpu_flash_call (row bounds
//   flash_fwd_kernel         _row_bounds, tile math _attn_tile_update);
//   flash_decode_kernel      the tile paths' K/V ring is core/backend.py::
//                            stream_tiles, the ring of the _dma variants;
//                            flash_decode_kernel is _attn_kernel at
//                            block_q = 1 through seq_pos
//   paged_decode_kernel   <- kernels/flash_attention.py::_paged_attn_kernel
//                            and its gpu structure _gpu_paged_call
//
// The wrapper (kernels/flash_attention.py flash_route) sends single-token
// kind "full" calls with seq_pos (decode) to flash_decode_kernel, every
// other bf16 call to flash_fwd_tc_kernel and every other f32 call to
// flash_fwd_tf32_kernel (any block_q, block_k and d up to 256 for both;
// q, k, v copied to 16-byte aligned buffers first where a view starts off
// a boundary).  No route takes flash_fwd_kernel: it stays built as the
// yardstick the tile paths are timed against.
//
// Every flash kernel: one CTA per (batch * head, query-block row), as the
// gpu structure's grid; an in-kernel loop over that row's key blocks
// [start, end] carries the online-softmax state.  The extent comes from
// the lowering: closed_form computes _row_bounds inline, prefetch_lut reads
// the host row_extents() table (int32 (m_q, 2) on the device), mma reads
// the same table built on the device by row_extents_chain, bounding
// walks [0, m_k - 1] and skips the tiles outside the block domain (the
// skipped tiles are the ones the JAX structure computes and discards, so
// the result is the same).  seq_pos[b] clamps end to pos // block_k and,
// under kind full with a window, raises start to
// max(pos - window + 1, 0) // block_k.  K/V tile kb is read at
// clip(kb - s0, 0, kv_blocks - 1) (compact KV).  GQA: q head h reads kv
// head h / (H / Hkv).  Every lowering runs the same tile arithmetic in the
// same order, so the four are bit-equal to each other.
//
// The two decode kernels are front ends of one routine
// (decode_split.cuh): flash_decode_kernel takes the extent from the
// lowering as above (bounding's skip and the compact-KV clamp in its tile
// functor), paged_decode_kernel runs from start to
// min(pos // page_size, max_pages - 1) and reads logical block kb at page
// page_table[slot, kb], K at pool row 2 kvh and V at 2 kvh + 1.  Decode is
// bound by bytes: each K/V row visited is 2 d values against 4 d flops per
// q head (gemma3-12b's decode: ~51 MB of K/V for 4 slots at 1552 keys,
// 0.015 ms at 3.35 TB/s).  So a CTA serves a whole GQA group (each K/V
// byte read once per kv head, in 16-byte loads), one per (slot, kv head,
// split), split j covering key blocks [j T, j T + T - 1] of the extent
// with T = dec::kSplitKeys / block_k: the rule sees only the key block,
// block_k, pos and the window, so paged decode is bit-equal to contiguous
// decode at block_k == page_size whatever the table's width, and the four
// lowerings to each other.  Warps keep their own online state over fixed
// key batches and merge in warp order; the splits merge in split order in
// the same launch (the last CTA to arrive, by an atomic counter).
//
// What bounds the others on an H100 (80 GB HBM3 at 3.35 TB/s; 67 TFLOP/s
// f32 outside the tensor cores, 989 TFLOP/s bf16 and 495 TF32 in them):
// prefill-sized attention is bound by operations (4 d flops per visited
// (query, key) pair, three times that in 3xTF32).
//
// flash_fwd_tc_kernel (bf16 prefill) moves those operations onto the
// tensor cores with mma.sync.m16n8k16 (bf16 operands, f32 sums):
//   * block_q / 16 warps (at most 8; a longer query block runs in passes
//     of 128 rows), each owning 16 query rows, read from shared memory
//     with ldmatrix;
//   * S = Q K^T per 64-key sub-tile, K the B operand by ldmatrix.x4 from
//     row-major K; the bf16 products are exact and sum in f32, and scale
//     multiplies the f32 score after the product (pre-scaling Q in bf16
//     would round it); masks as tile_update (-1e30, not -inf, by
//     attention_common.cuh's key_live), tested per element only in a
//     warp-uniform branch for the sub-tiles where the warp's rows meet a
//     mask edge (keys_all_live), so the other steps only scale;
//   * the online softmax in registers per 64-key sub-tile: 64 keys are 8
//     score n-tiles (32 f32 per lane) beside the 128-f32 O accumulator of
//     d = 256, which keeps the kernel within 255 registers; 32-key
//     sub-tiles would halve the score registers but double the rescales
//     of O and the ring's barriers.
//     Per sub-tile instead of per schedule tile is the same math rounded
//     in another order; a wholly masked prefix still gives m = -1e30,
//     p = 1, and the next live sub-tile's alpha = exp(-1e30 - m) = 0
//     wipes it.  exp runs on the SFU (ex2.approx), and a warp whose row
//     maxima did not move skips the rescale of O (alpha is exactly 1);
//   * P rounded to bf16 (the rounding the MXU applies to an f32 dot at
//     default precision) is the A operand of P V straight from the score
//     fragments (mma_sync.cuh's C -> A identity), V the B operand by
//     ldmatrix.x4.trans; O and l sum in f32; out = O / l (l == 0 -> 1)
//     rounded to bf16;
//   * K/V sub-tiles stream through a ring of shared-memory slots
//     (async_ring.cuh, cp.async.cg 16 B, commit/wait groups): 2 stages at
//     d <= 256 (Q 67.6 KB + 2 x (K + V) 135 KB of the 227 KB opt-in),
//     3 at d <= 128; rows padded by 16 B so the 8 rows of an ldmatrix
//     fall in distinct banks;
//   * CTA order: query-block rows outermost, (batch, head) innermost, so
//     the q heads of one kv head run side by side (their K/V stay in L2);
//     under causal and local the longest rows (largest qb) start first and
//     the short first rows fill the last wave, which shortens the tail on
//     132 SMs (local: 64 rows x 16 heads are 7.8 waves of one CTA per SM).
// The head dim rounds up to an instantiation (64, 128, 256); k-steps and
// output n-tiles past d are skipped, so no padding column is read.  Each
// k-step loads its fragments before its products (one ldmatrix latency
// per k-step, not per product).  d <= 64 runs two CTAs per SM.  What
// still bounds it: every warp reads the whole K/V sub-tile from shared
// memory for its 16 rows (16 flops per byte, half the tensor cores' rate
// at the SM's 128 B/clk); wgmma's 64-row warpgroup tiles are the fix.
//
// flash_fwd_tf32_kernel (f32 prefill) is the same tile loop -- warps of
// 16 rows, 64-key sub-tiles, the ring, the masks, the softmax per
// sub-tile, the CTA order -- on mma.sync.m16n8k8.tf32 (mma_sync.cuh's
// fragment maps).  Hopper has no f32 product on the tensor cores, so each
// f32 operand x is split into tf32 parts hi = rna(x), lo = rna(x - hi)
// (rounded on the bit pattern: two integer operations each) and a
// product sums lo·hi + hi·lo + hi·hi in f32 (3xTF32: the dropped lo·lo
// is ~2^-22 of it, the f32 result good to about 22 bits):
//   * Q is read raw into shared memory and scaled in f32 as its fragment
//     is loaded (the plain version pre-scales Q in f32; scaling after the
//     product would round differently), then split once per k-step for
//     that step's eight n-tiles; K's fragments by ldmatrix from row-major
//     K (16-byte rows of 4 f32), split once for their three products;
//   * P is f32 in the plain version, so it is split too: its A fragment
//     comes from the score fragments with the keys of each 8-key group
//     permuted (no C -> A identity at k8), V's B fragment from 32-bit
//     shared loads at the permuted rows;
//   * rows padded by 4 f32, a row stride of 4 mod 32 words: the 8 rows
//     of an ldmatrix and the 32 lanes of a V load fall in distinct banks;
//   * two ring stages: Q (128 rows) and two slots are 102 KB at d = 64,
//     two CTAs per SM, and 198 KB at d = 128.  Q is not kept split
//     (hi and lo planes would take a second 35 KB at d = 64, one CTA per
//     SM); a lane re-splits 4 Q values per k-step;
//   * d = 256 (any d past 128 up to 256) would need 131 KB for
//     128 Q rows and 131 KB for one 64-key slot, and 128 accumulators a
//     lane: so a pair of warps shares 16 query rows, each warp owning 128
//     of the output dims (64 accumulators), 64 rows a pass in 32-key
//     sub-tiles (Q 65 KB, two slots 130 KB, 16 KB of partial scores).
//     Each warp of the pair multiplies its half of the head dim; the two
//     halves meet in shared memory behind a 64-thread named barrier and
//     are added dims 0-127 first in both warps, so the pair holds one set
//     of scores, runs one softmax and the four lowerings stay bit-equal;
//   * where d is the instantiation's and block_k a multiple of the
//     sub-tile (the models' shapes), an exact instantiation takes both as
//     constants:
//     its tile loops unroll without a branch, which lets the scheduler
//     overlap one n-tile's loads and splits with another's products.
// Its bound is three tf32 products of 4 d flops per unmasked pair at
// 495 TFLOP/s (quickstart causal S 4096: 0.625 ms).  What still bounds
// it: every warp splits the K and V values it reads (the same sub-tile
// in all 8 warps), so integer and f32 work issues beside each product.
//
// Ragged calls (block_q or block_k not a multiple of 16, block_q = 1
// without seq_pos, bf16 d % 16 != 0, f32 d % 8 != 0) run the tile paths'
// kRagged instantiations, padded inside the kernel: a 72-row query block
// is five warps of 16 rows, its last 8 rows zero-filled and never
// stored; a row's key blocks run as one sequence of keys (run_keys: the
// domains' rows are runs of blocks, and their K/V rows are consecutive)
// in sub-tiles that cross block boundaries, so only the run's last
// sub-tile is short: its keys past the run are zero-filled
// (copy_rows_zfill: src-size 0, nothing read past the tile; a stale V
// row would give p = 0 times NaN) and masked to -inf; the columns from d
// to the k-step (16 bf16, 8 f32) are zero-filled.  Sub-tiles that cross
// blocks round in another order than per-block ones: every lowering walks
// the same run, so they stay bit-equal to each other.  The exact and
// 16-multiple instantiations keep their code (run-time bounds in a loop
// cost the f32 path its unrolling).  A head row of d values need not be a
// whole number of 16-byte pieces: the kNarrow instantiations copy every
// row in the widest piece its bytes are a whole number of
// (ring::piece_bytes: f32 D 62 in 8-byte pieces, bf16 D 250 and f32 D 37
// in 4-byte ones by cp.async.ca; bf16 rows of an odd d, 2-byte aligned
// only, through a register), so no padded copy of q, k or v is made and
// the default scale stays 1/sqrt(d); store_o writes single values where a
// pair would straddle a row's end or sit off its alignment.  The f32
// kernel runs its exact loops where a narrow d pads up to the
// instantiation's (D 62 over 64 columns, the last two zero-filled).  The
// narrow code has instantiations of its own: the piece width as a
// run-time value in the ragged 16-byte instantiations cost them 4-15 %.
//
// flash_fwd_kernel is simple rather than fast: scores and p v run in f32
// on the CUDA cores, 8 warps own 4
// query rows each per pass, K/V tiles are staged through shared memory
// 32 keys at a time (so d = 256 with 128-key tiles fits: 32 q rows + 32
// keys + 32 x 128 scores of f32 = 97 KB), and a query block of more than
// 32 rows re-reads its K/V tiles once per pass (from L2).  The online
// softmax updates once per schedule tile: all block_k scores of a tile
// are in shared memory before its row max is taken.
//
// Sharded (fa_forward_tc_bf16_sharded, fa_forward_tc_f32_sharded; this
// source built with -DREPRO_SHARDED, a library of its own): the tile
// paths instantiated with kShard, replacing _attn_kernel under the JAX
// package's ShardedPlan(partition="rows" / "zigzag") (core/shard.py
// _zz_global_row, _place_coords).  A launch is one rank's band of query
// block rows: q and o hold the band, k and v the whole keys, and each
// CTA's band row becomes its global row (RowShard: row_lo + l, or the
// causal snake's) for the extent, the block mask and the key mask -- the
// CTA then computes what the unsharded kernel's CTA of that row computes,
// bit for bit.  The kShard = false instantiations compile to the SASS
// they had before (the row map is one trailing argument they never
// read).  Bound and design are the tile paths': a rank does 1 / D of the
// work, in fewer CTAs.

#include <cstdint>
#include <type_traits>

#include "async_ring.cuh"
#include "attention_common.cuh"
#include "decode_split.cuh"
#include "mma_sync.cuh"

namespace {

using namespace attn;

__device__ __forceinline__ bool in_domain(const AttnParams& p, int kb, int qb) {
  if (p.dom == kDomTriangular) return kb <= qb;
  if (p.dom == kDomBand)
    return kb <= qb + p.dom_off && kb > qb + p.dom_off - p.dom_w;
  return true;
}

// _row_bounds: the key-block extent of query-block row qb.
__device__ __forceinline__ void row_bounds(const AttnParams& p, int qb,
                                           int& start, int& end) {
  if (p.kind == kCausal) {
    start = 0;
    end = qb;
  } else if (p.kind == kLocal) {
    const int wb = p.window / p.block_k + 1;
    const int off_b = p.off / p.block_q;
    start = max(qb + off_b - (wb - 1), 0);
    end = qb + off_b;
  } else {
    start = 0;
    end = p.m_k - 1;
  }
}

// The key-block extent [start, end] of query-block row qb under the
// lowering, clamped by batch row b's seq_pos; pos: that position (or 0).
__device__ __forceinline__ void row_extent(const AttnParams& p, int qb, int b,
                                           const int* __restrict__ ext,
                                           const int* __restrict__ pos_vec,
                                           int& start, int& end, int& pos) {
  if (p.lowering == kPrefetchLut || p.lowering == kMma) {
    start = ext[2 * qb];
    end = ext[2 * qb + 1];
  } else if (p.lowering == kBounding) {
    start = 0;
    end = p.m_k - 1;
  } else {
    row_bounds(p, qb, start, end);
  }
  pos = 0;
  if (p.has_pos) {
    pos = pos_vec[b];
    end = min(end, floor_div(pos, p.block_k));
    if (p.kind == kFull && p.window)
      start = max(start, floor_div(max(pos - p.window + 1, 0), p.block_k));
  }
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(AttnParams p, const T* __restrict__ q,
                 const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ ext, const int* __restrict__ pos_vec,
                 T* __restrict__ o) {
  extern __shared__ float smem[];
  const Smem sm = smem_layout(smem, p.d);
  const long long cta = blockIdx.x;
  const int bh = (int)(cta / p.m_q), qb = (int)(cta % p.m_q);
  const int b = bh / p.h, kvh = (bh % p.h) / (p.h / p.hkv);

  int start, end, pos;
  row_extent(p, qb, b, ext, pos_vec, start, end, pos);

  const size_t q_off = ((size_t)bh * p.sq + (size_t)qb * p.block_q) * p.d;
  const size_t kv_head = ((size_t)b * p.hkv + kvh) * p.sk_arr;
  RowState<DPL> st;
  for (int row0 = 0; row0 < p.block_q; row0 += kRowsPerPass) {
    const int nrows = min(kRowsPerPass, p.block_q - row0);
    load_q(sm, q + q_off, row0, nrows, p.d, p.scale);
    st.reset();
    for (int kb = start; kb <= end; ++kb) {
      if (p.lowering == kBounding && !in_domain(p, kb, qb)) continue;
      const int kv = min(max(kb - p.s0, 0), p.kv_blocks - 1);
      const size_t t_off = (kv_head + (size_t)kv * p.block_k) * p.d;
      tile_update<T, DPL>(p, sm, k + t_off, v + t_off, kb,
                          p.off + qb * p.block_q + row0, nrows, pos, st);
    }
    store_rows<T, DPL>(o + q_off, row0, nrows, p.d, st);
  }
}

// ---------------------------------------------------------------------------
// the tile paths on the tensor cores: shared pieces
// ---------------------------------------------------------------------------

constexpr int kTcRowsPerWarp = 16;  // one m16 tile of query rows per warp
constexpr int kTcMaxWarps = 8;
constexpr int kTcRowsPerPass = kTcRowsPerWarp * kTcMaxWarps;
constexpr int kTcSub = 64;  // keys per sub-tile: one ring slot of K and V

// The first key block at or after kb that the row visits (bounding skips
// the tiles outside the block domain); end + 1 when none is left.
__device__ __forceinline__ int next_live(const AttnParams& p, int kb, int qb,
                                         int end) {
  if (p.lowering == kBounding)
    while (kb <= end && !in_domain(p, kb, qb)) ++kb;
  return kb;
}

// The keys of row qb's live key blocks, first (next_live(start)) to last,
// as one run: the attention domains' rows are runs of blocks (bounding
// skips to the same ones), and the run's K/V rows are consecutive.
__device__ __forceinline__ int run_keys(const AttnParams& p, int start,
                                        int end, int qb) {
  const int first = next_live(p, start, qb, end);
  int last = end;
  if (p.lowering == kBounding)
    while (last >= first && !in_domain(p, last, qb)) --last;
  return last >= first ? (last - first + 1) * p.block_k : 0;
}

// The CTA's query-block row qb and (batch * head) bh: query-block rows
// outermost (longest first under causal and local), then (batch, head),
// so the q heads of one kv head are neighbours.
__device__ __forceinline__ void cta_tile(const AttnParams& p, int& qb,
                                         int& bh) {
  const int bhs = p.b * p.h;
  qb = (int)(blockIdx.x / bhs);
  bh = (int)(blockIdx.x - (unsigned)qb * bhs);
  if (p.kind != kFull) qb = p.m_q - 1 - qb;
}

// The masks of tile_update on a warp's score fragments (s[nt][e]: query
// qrow + 8 (e >> 1) of lane (g, t4), key kmin + 8 nt + 2 t4 + (e & 1)):
// -1e30, not -inf, by key_live, tested per element only in a warp-uniform
// branch for the sub-tiles where the warp's rows meet a mask edge
// (keys_all_live), so the other steps do no more than scale.  kScale: the
// live scores are also multiplied by p.scale.  kRagged: a sub-tile whose
// nkeys live keys are fewer than the `covered` keys the loops read takes
// the edge branch too, and its padded keys (index nkeys and up, whose
// positions would alias the next key block's) become -inf, not -1e30:
// exp(-inf - m) is 0 whatever m is, so a padded key adds nothing to l
// even in a row whose every key is masked (where a -1e30 key has p = 1
// and counts), and the sub-tile sums as if it held nkeys keys.
template <int kNt, bool kScale, bool kRagged = false>
__device__ __forceinline__ void mask_scores(const AttnParams& p,
                                            float (&s)[kNt][4], int qrow,
                                            int g, int t4, int kmin,
                                            int nkeys, int pos,
                                            int covered = 0) {
  const int qmin = qrow - g;
  if ((!kRagged || nkeys == covered) &&
      keys_all_live(p, qmin, qmin + kTcRowsPerWarp - 1, kmin,
                    kmin + nkeys - 1, pos)) {
    if (kScale) {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = __fmul_rn(s[nt][e], p.scale);
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kidx = 2 * t4 + nt * 8 + (e & 1);
        s[nt][e] = kRagged && kidx >= nkeys ? -INFINITY
                   : key_live(p, qrow + (e >> 1) * 8, kmin + kidx, pos)
                       ? (kScale ? __fmul_rn(s[nt][e], p.scale) : s[nt][e])
                       : kNegInf;
      }
  }
}

// The online softmax over one sub-tile (rows g and g + 8 of the lane's
// quad; n-tiles at or past nkeys are not read): s becomes
// p = exp(s - m_new), l = alpha l + rowsum(p) with alpha = exp(m - m_new),
// and O is rescaled by alpha unless no row max of the warp moved (alpha
// is then exactly 1).  l keeps lane partials: the quad's four lanes add
// at the end.
template <int kNt, int kOt>
__device__ __forceinline__ void softmax_step(float (&s)[kNt][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&acc)[kOt][4],
                                             int nkeys) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
      if (nt * 8 < nkeys)
        mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    const float alpha = exp_f32(__fsub_rn(m[i], m_new));
    float sum = 0.0f;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      if (nt * 8 < nkeys) {
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[nt][e] = exp_f32(__fsub_rn(s[nt][e], m_new));
          sum = __fadd_rn(sum, s[nt][e]);
        }
      }
    }
    l[i] = __fmaf_rn(alpha, l[i], sum);
    m[i] = m_new;
    if (!__all_sync(0xffffffffu, alpha == 1.0f)) {
#pragma unroll
      for (int ot = 0; ot < kOt; ++ot) {
        acc[ot][2 * i] = __fmul_rn(acc[ot][2 * i], alpha);
        acc[ot][2 * i + 1] = __fmul_rn(acc[ot][2 * i + 1], alpha);
      }
    }
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a,
                                           float b) {
  *reinterpret_cast<unsigned*>(dst) = tc::pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_one(__nv_bfloat16* dst, float a) {
  *dst = __float2bfloat16_rn(a);
}
__device__ __forceinline__ void store_one(float* dst, float a) { *dst = a; }

// out = O / l (l == 0 -> 1) for rows `row` and row + 8 of the pass, lane
// (g, t4) writing columns 8 ot + 2 t4 and + 1 of each output n-tile
// below ncols (o: the query block's first row at the warp's first output
// column; rows of d values).  kRagged: rows at or past `nrows` (the
// padding of a query block that is not a multiple of 16) are not stored,
// and the test is per column pair (f32 head dims of 4 mod 8).  kNarrow
// (rows of no whole number of 16-byte pieces): each column is tested
// against ncols, and a pair is written as one store only where both
// columns lie in the row and the row's pairs are aligned, else as single
// values (at an odd d the last pair of a row would straddle the next
// row's first column, and every other row starts off a pair boundary).
template <int kOt, bool kRagged = false, bool kNarrow = false, typename T>
__device__ __forceinline__ void store_o(T* __restrict__ o, int row, int d,
                                        int ncols, int t4,
                                        const float (&acc)[kOt][4],
                                        const float (&l)[2], int nrows = 0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 1));
    lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 2));
    if (lt == 0.0f) lt = 1.0f;
    if (kRagged && row + 8 * i >= nrows) continue;
    T* dst = o + (size_t)(row + 8 * i) * d + 2 * t4;
    if constexpr (kNarrow) {
      // n-tiles are 8 values apart: all of a row's pairs or none aligned
      const bool pairs =
          reinterpret_cast<uintptr_t>(dst) % (2 * sizeof(T)) == 0;
#pragma unroll
      for (int ot = 0; ot < kOt; ++ot) {
        const int c = ot * 8 + 2 * t4;
        if (c >= ncols) continue;
        const float a = __fdiv_rn(acc[ot][2 * i], lt);
        if (pairs && c + 1 < ncols) {
          store_pair(dst + ot * 8, a, __fdiv_rn(acc[ot][2 * i + 1], lt));
        } else {
          store_one(dst + ot * 8, a);
          if (c + 1 < ncols)
            store_one(dst + ot * 8 + 1, __fdiv_rn(acc[ot][2 * i + 1], lt));
        }
      }
      continue;
    }
#pragma unroll
    for (int ot = 0; ot < kOt; ++ot) {
      if ((kRagged ? ot * 8 + 2 * t4 : ot * 8) < ncols)
        store_pair(dst + ot * 8, __fdiv_rn(acc[ot][2 * i], lt),
                   __fdiv_rn(acc[ot][2 * i + 1], lt));
    }
  }
}

// 16-row (and 16-key) granularity of the tile paths' ragged instantiations.
constexpr __host__ __device__ int round16(int x) { return (x + 15) & ~15; }

// ---------------------------------------------------------------------------
// flash_fwd_tc_kernel: the bf16 tile path on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcPad = 8;  // bf16 padding per shared row (16 bytes)

// The instantiated head dim of d (any d up to 256), its ring
// depth, and one CTA's dynamic shared memory: the pass's query rows and
// `stages` slots of a K and a V sub-tile, rows of dt + kTcPad bf16.
constexpr __host__ __device__ int tc_dt(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}
constexpr __host__ __device__ int tc_stages(int dt) {
  return dt > 128 ? 2 : 3;
}
__host__ __device__ inline size_t tc_smem_bytes(int d, int block_q) {
  const int dt = tc_dt(d);
  const int rows =
      round16(block_q) < kTcRowsPerPass ? round16(block_q) : kTcRowsPerPass;
  return ((size_t)rows + (size_t)tc_stages(dt) * 2 * kTcSub) *
         (size_t)(dt + kTcPad) * sizeof(__nv_bfloat16);
}

// d <= 64 fits two CTAs per SM (at most 128 registers a thread, 74 KB of
// shared memory each); wider heads run one CTA of up to 255 registers.
// kRagged: block_q, block_k or d is not a multiple of 16.  The
// instantiation pads inside the kernel: Q rows past the block and K/V
// rows past the row's key run arrive zero-filled up to the next 16, and so
// do the columns from d up to the 16-column k-step; padded keys are masked
// (mask_scores) and padded rows never stored (store_o).  kNarrow (with
// kRagged): a row of d values is no whole number of 16-byte pieces (d
// % 8 != 0), so it is copied in pieces of piece_bytes(2 d) -- 8, 4 or 2
// bytes (copy_rows_pieces) -- and stored column by column where a pair
// would not do (store_o).  The other instantiations keep their code.
template <int DT, bool kRagged, bool kNarrow = false, bool kShard = false>
__global__ void __launch_bounds__(kTcMaxWarps * 32, DT > 64 ? 1 : 2)
flash_fwd_tc_kernel(AttnParams p, const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ ext,
                    const int* __restrict__ pos_vec,
                    __nv_bfloat16* __restrict__ o, RowShard rs) {
  constexpr int kStages = tc_stages(DT);
  constexpr int kStride = DT + kTcPad;  // shared row, bf16 elements
  constexpr int kNt = kTcSub / 8;       // score n-tiles of a sub-tile
  constexpr int kOt = DT / 8;           // output n-tiles
  constexpr size_t kSlot = (size_t)2 * kTcSub * kStride;  // K then V
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* const sq = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* const skv =
      sq + (size_t)min(kRagged ? round16(p.block_q) : p.block_q,
                       kTcRowsPerPass) *
               kStride;

  int qb, bh;
  cta_tile(p, qb, bh);
  const int ql = qb;  // the block row of q and o (a sharded band's own)
  if constexpr (kShard) qb = rs.global(qb);  // masks and extents: global
  const int b = bh / p.h, kvh = (bh % p.h) / (p.h / p.hkv);
  int start, end, pos;
  row_extent(p, qb, b, ext, pos_vec, start, end, pos);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int d = p.d, bk = p.block_k;
  const int dpad = kRagged ? round16(d) : d;  // columns a shared row holds
  const int w = kNarrow ? ring::piece_bytes(2 * d) : 16;  // copied pieces
  const size_t q_off = ((size_t)bh * p.sq + (size_t)ql * p.block_q) * d;
  const size_t kv_head = ((size_t)b * p.hkv + kvh) * p.sk_arr;
  // ldmatrix row offsets of this lane: A (Q) tiles take matrices
  // (rows 0-7 | 8-15) x (cols 0-7 | 8-15) in register order, K's B tiles
  // (keys 0-7 | 8-15) x (d 0-7 | 8-15), V's transposed B tiles
  // (keys 0-7 | 8-15) x (d 0-7 | 8-15) with the key half first
  const int lrow = lane & 7, mi = lane >> 3;
  const int a_row = (mi & 1) * 8 + lrow, a_col = (mi >> 1) * 8;
  const int k_row = (mi >> 1) * 8 + lrow, k_col = (mi & 1) * 8;
  const int v_row = (mi & 1) * 8 + lrow, v_col = (mi >> 1) * 8;

  // the ring's step cursor: key block kb, sub-tile offset c within it;
  // kRagged: the row's keys as one run (run_keys) from its first block,
  // in sub-tiles that cross block boundaries, only the run's last one
  // short
  const int nrun = kRagged ? run_keys(p, start, end, qb) : 0;
  const int span = kRagged ? nrun : bk;  // keys from the cursor's block on
  auto advance = [&](int& kb, int& c) {
    c += kTcSub;
    if (!kRagged && c >= bk) {
      c = 0;
      kb = next_live(p, kb + 1, qb, end);
    }
  };
  auto pending = [&](int kb, int c) { return kRagged ? c < nrun : kb <= end; };
  auto issue = [&](int kb, int c, int slot) {
    const int kv = min(max(kb - p.s0, 0), p.kv_blocks - 1);
    const size_t t_off = (kv_head + (size_t)kv * bk + c) * d;
    const int rows = min(kTcSub, span - c);
    __nv_bfloat16* dst = skv + (size_t)slot * kSlot;
    if constexpr (kNarrow) {
      ring::copy_rows_pieces(dst, kStride, k + t_off, d, rows, round16(rows),
                             d, dpad, w);
      ring::copy_rows_pieces(dst + (size_t)kTcSub * kStride, kStride,
                             v + t_off, d, rows, round16(rows), d, dpad, w);
    } else if constexpr (kRagged) {
      ring::copy_rows_zfill(dst, kStride, k + t_off, d, rows, round16(rows),
                            d, dpad);
      ring::copy_rows_zfill(dst + (size_t)kTcSub * kStride, kStride,
                            v + t_off, d, rows, round16(rows), d, dpad);
    } else {
      ring::copy_rows(dst, kStride, k + t_off, d, rows, d);
      ring::copy_rows(dst + (size_t)kTcSub * kStride, kStride, v + t_off, d,
                      rows, d);
    }
  };

  for (int row0 = 0; row0 < p.block_q; row0 += kTcRowsPerPass) {
    const int nrows = min(kTcRowsPerPass, p.block_q - row0);
    const bool busy = warp * kTcRowsPerWarp < nrows;
    const int qrow = p.off + qb * p.block_q + row0 + warp * kTcRowsPerWarp + g;

    // prologue: Q rides in the first group, then stages - 1 ring steps
    if constexpr (kNarrow)
      ring::copy_rows_pieces(sq, kStride, q + q_off + (size_t)row0 * d, d,
                             nrows, round16(nrows), d, dpad, w);
    else if constexpr (kRagged)
      ring::copy_rows_zfill(sq, kStride, q + q_off + (size_t)row0 * d, d,
                            nrows, round16(nrows), d, dpad);
    else
      ring::copy_rows(sq, kStride, q + q_off + (size_t)row0 * d, d, nrows,
                      d);
    int kb_c = next_live(p, start, qb, end), c_c = 0;
    int kb_p = kb_c, c_p = 0;
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (pending(kb_p, c_p)) {
        issue(kb_p, c_p, st);
        advance(kb_p, c_p);
      }
      ring::commit();
    }

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    float acc[kOt][4];
#pragma unroll
    for (int ot = 0; ot < kOt; ++ot)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ot][e] = 0.0f;

    int slot = 0;
    while (pending(kb_c, c_c)) {
      ring::wait<kStages - 2>();
      __syncthreads();  // slot `slot` landed; slot - 1 is free again
      if (pending(kb_p, c_p)) {
        issue(kb_p, c_p, slot == 0 ? kStages - 1 : slot - 1);
        advance(kb_p, c_p);
      }
      ring::commit();

      if (busy) {
        const __nv_bfloat16* sk = skv + (size_t)slot * kSlot;
        const __nv_bfloat16* sv = sk + (size_t)kTcSub * kStride;
        const __nv_bfloat16* sqw = sq + (size_t)warp * kTcRowsPerWarp * kStride;
        // live keys of the sub-tile: a multiple of 16 unless kRagged
        const int nkeys = min(kTcSub, span - c_c);

        // -- S = Q K^T: 16 rows x nkeys, f32 ---------------------------
        // each k-step loads its A and B fragments before its products, so
        // one ldmatrix latency is paid per k-step, not per product
        float s[kNt][4];
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < DT / 16; ++ks) {
          if (ks * 16 < d) {
            unsigned a[4], kf[kNt / 2][4];
            tc::ldmatrix_x4(a, sqw + (size_t)a_row * kStride + ks * 16 + a_col);
#pragma unroll
            for (int np = 0; np < kNt / 2; ++np)
              if (np * 16 < nkeys)
                tc::ldmatrix_x4(kf[np], sk + (size_t)(np * 16 + k_row) *
                                                 kStride + ks * 16 + k_col);
#pragma unroll
            for (int np = 0; np < kNt / 2; ++np) {
              if (np * 16 < nkeys) {
                tc::mma_bf16(s[2 * np], a, make_uint2(kf[np][0], kf[np][1]));
                tc::mma_bf16(s[2 * np + 1], a,
                             make_uint2(kf[np][2], kf[np][3]));
              }
            }
          }
        }

        // -- scale after the product, then the masks ---------------------
        mask_scores<kNt, true, kRagged>(p, s, qrow, g, t4, kb_c * bk + c_c,
                                        nkeys, pos, round16(nkeys));
        // every n-tile of the 16-key steps P V reads gets its p (padded
        // keys 0)
        softmax_step<kNt, kOt>(s, m, l, acc,
                               kRagged ? round16(nkeys) : nkeys);

        // -- O += P V: P in bf16 from the score fragments (C -> A) -------
        // V fragments load four at a time ahead of their products
#pragma unroll
        for (int kk = 0; kk < kNt / 2; ++kk) {
          if (kk * 16 < nkeys) {
            const unsigned a[4] = {
                tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int n0 = 0; n0 < DT / 16; n0 += 4) {
              unsigned vf[4][4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if ((n0 + j) * 16 < d)
                  tc::ldmatrix_x4_trans(
                      vf[j], sv + (size_t)(kk * 16 + v_row) * kStride +
                                 (n0 + j) * 16 + v_col);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if ((n0 + j) * 16 < d) {
                  tc::mma_bf16(acc[2 * (n0 + j)], a,
                               make_uint2(vf[j][0], vf[j][1]));
                  tc::mma_bf16(acc[2 * (n0 + j) + 1], a,
                               make_uint2(vf[j][2], vf[j][3]));
                }
              }
            }
          }
        }
      }
      advance(kb_c, c_c);
      slot = slot + 1 == kStages ? 0 : slot + 1;
    }
    ring::wait<0>();
    __syncthreads();  // every reader of sq and the ring is done

    // -- out = O / l (l == 0 -> 1), rounded to bf16 -----------------------
    if (busy)
      store_o<kOt, kRagged, kNarrow>(o + q_off,
                                     row0 + warp * kTcRowsPerWarp + g, d, d,
                                     t4, acc, l, row0 + nrows);
  }
}

// ---------------------------------------------------------------------------
// flash_fwd_tf32_kernel: the f32 tile path on the tensor cores (3xTF32)
// ---------------------------------------------------------------------------

constexpr int kTfPad = 4;     // f32 padding per shared row (16 bytes)
constexpr int kTfStages = 2;  // ring depth

// The instantiated head dim of d (any d up to 256) and its
// geometry.  Up to d = 128 a warp owns 16 query rows and every output
// dim, 128 rows a pass, 64-key sub-tiles.  d = 256 does not fit that
// form: 128 query rows and one 64-key K/V slot in rows of 260 f32 are
// 266 KB of shared memory, past the 227 KB a CTA may have, and a warp's
// 16 x 256 outputs would be 128 accumulators a lane beside the scores and
// fragments.  So at d = 256 a pair of warps shares 16 query rows, each
// warp owning 128 of the output dims (64 accumulators a lane), 64 rows a
// pass, 32-key sub-tiles: each warp of the pair computes the scores over
// its half of the head dim and the pair adds the two halves in one fixed
// order (dims 0-127 first) through shared memory, so both hold the same
// scores and run the same softmax.
constexpr __host__ __device__ int tf32_dt(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}
constexpr __host__ __device__ int tf32_halves(int dt) {
  return dt > 128 ? 2 : 1;  // warps sharing 16 query rows
}
constexpr __host__ __device__ int tf32_sub(int dt) {
  return dt > 128 ? 32 : kTcSub;  // keys per sub-tile
}
constexpr __host__ __device__ int tf32_rows_per_pass(int dt) {
  return kTcRowsPerPass / tf32_halves(dt);
}
// One CTA's dynamic shared memory: the pass's query rows (f32, unscaled),
// two slots of a K and a V sub-tile, rows of dt + kTfPad f32, and at
// d = 256 each warp's 16 x 32 partial scores.  d = 64: 102 KB, two CTAs
// per SM; d = 128: 198 KB; d = 256: 65 KB + 130 KB + 16 KB = 211 KB.
__host__ __device__ inline size_t tf32_smem_bytes(int d, int block_q) {
  const int dt = tf32_dt(d);
  const int pass = tf32_rows_per_pass(dt);
  const int rows = round16(block_q) < pass ? round16(block_q) : pass;
  const size_t xchg = tf32_halves(dt) > 1
                          ? (size_t)(rows / kTcRowsPerWarp) * 2 * 32 *
                                (tf32_sub(dt) / 2)
                          : 0;
  return (((size_t)rows + (size_t)kTfStages * 2 * tf32_sub(dt)) *
              (size_t)(dt + kTfPad) +
          xchg) *
         sizeof(float);
}

// Splits four f32 values (bit patterns) into tf32 hi and lo parts.
__device__ __forceinline__ void split_frag(const unsigned x[4],
                                           unsigned hi[4], unsigned lo[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    tc::split_tf32(__uint_as_float(x[e]), hi[e], lo[e]);
}

// acc += A B in 3xTF32: the two small products first, then hi x hi.
__device__ __forceinline__ void mma_3xtf32(float acc[4], const unsigned ahi[4],
                                           const unsigned alo[4], uint2 bhi,
                                           uint2 blo) {
  tc::mma_tf32(acc, alo, bhi);
  tc::mma_tf32(acc, ahi, blo);
  tc::mma_tf32(acc, ahi, bhi);
}

// The two warps of a pair (64 threads) wait for each other on named
// barrier `id` (1 + the pair's row group; barrier 0 is __syncthreads).
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// d <= 64 fits two CTAs per SM (128 registers a thread, 102 KB of shared
// memory each); wider heads run one CTA of up to 255 registers.  kExact:
// d is DT and block_k a multiple of the sub-tile, so the head dim and the
// keys of a sub-tile are compile-time and the tile loops run without
// branches.  kRagged: block_q or block_k is not a multiple of 16 or d not
// a multiple of 8, padded as the bf16 kernel's kRagged, columns up to the
// 8-column k-step.  Both (d is DT, the blocks ragged): every sub-tile
// runs the exact loops over kSub keys, the run's last one zero-filled up
// to kSub rows and its keys past the run masked (a few wasted products a
// row, no run-time loop bound).  kNarrow (with kRagged): d % 4 != 0, rows
// copied and stored as the bf16 kernel's kNarrow; with kExact, d pads up
// to DT (f32 D 62: the exact loops over 64 columns, the last two
// zero-filled) and the tensors' rows are p.d values apart.
template <int DT, bool kExact, bool kRagged, bool kNarrow = false,
          bool kShard = false>
__global__ void __launch_bounds__(kTcMaxWarps * 32, DT > 64 ? 1 : 2)
flash_fwd_tf32_kernel(AttnParams p, const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ ext,
                      const int* __restrict__ pos_vec,
                      float* __restrict__ o, RowShard rs) {
  constexpr int kHalves = tf32_halves(DT);
  constexpr int kSub = tf32_sub(DT);
  constexpr int kPass = tf32_rows_per_pass(DT);
  constexpr int kDw = DT / kHalves;     // output dims a warp owns
  constexpr int kStride = DT + kTfPad;  // shared row, f32 elements
  constexpr int kNt = kSub / 8;         // score n-tiles (8 keys) of a sub-tile
  constexpr int kOt = kDw / 8;          // a warp's output n-tiles
  constexpr size_t kSlot = (size_t)2 * kSub * kStride;  // K then V
  extern __shared__ __align__(16) unsigned char tf_smem[];
  float* const sq = reinterpret_cast<float*>(tf_smem);
  const int qrows = min(kRagged ? round16(p.block_q) : p.block_q, kPass);
  float* const skv = sq + (size_t)qrows * kStride;
  // each warp's partial scores (d = 256): lane-major, conflict-free
  float* const sx = skv + (size_t)kTfStages * kSlot;

  int qb, bh;
  cta_tile(p, qb, bh);
  const int ql = qb;  // the block row of q and o (a sharded band's own)
  if constexpr (kShard) qb = rs.global(qb);  // masks and extents: global
  const int b = bh / p.h, kvh = (bh % p.h) / (p.h / p.hkv);
  int start, end, pos;
  row_extent(p, qb, b, ext, pos_vec, start, end, pos);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / kHalves, half = warp - rg * kHalves;
  const int dof = half * kDw;  // this warp's first output dim
  const int g = lane >> 2, t4 = lane & 3;
  // d: the columns the loops cover; dr: the values of a global (and a
  // stored) row, below d where kNarrow's exact loops pad d up to DT
  const int d = kExact ? DT : p.d, bk = p.block_k;
  const int dr = kNarrow ? p.d : d;
  const int dpad = kRagged ? (d + 7) & ~7 : d;  // columns a shared row holds
  const int w = kNarrow ? ring::piece_bytes(4 * dr) : 16;  // copied pieces
  const size_t q_off = ((size_t)bh * p.sq + (size_t)ql * p.block_q) * dr;
  const size_t kv_head = ((size_t)b * p.hkv + kvh) * p.sk_arr;
  // ldmatrix row addresses of this lane (16-byte rows of 4 f32): Q's A
  // tiles (rows 0-7 | 8-15) x (cols 0-3 | 4-7) in register order, K's B
  // tiles (keys 0-7 | 8-15) x (dims 0-3 | 4-7) with the dim half first
  const int lrow = lane & 7, mi = lane >> 3;
  const int a_row = (mi & 1) * 8 + lrow, a_col = (mi >> 1) * 4;
  const int k_row = (mi >> 1) * 8 + lrow, k_col = (mi & 1) * 4;

  // the ring's steps, as the bf16 kernel's
  const int nrun = kRagged ? run_keys(p, start, end, qb) : 0;
  const int span = kRagged ? nrun : bk;  // keys from the cursor's block on
  auto advance = [&](int& kb, int& c) {
    c += kSub;
    if (!kRagged && c >= bk) {
      c = 0;
      kb = next_live(p, kb + 1, qb, end);
    }
  };
  auto pending = [&](int kb, int c) { return kRagged ? c < nrun : kb <= end; };
  auto issue = [&](int kb, int c, int slot) {
    const int kv = min(max(kb - p.s0, 0), p.kv_blocks - 1);
    const size_t t_off = (kv_head + (size_t)kv * bk + c) * dr;
    const int rows = min(kSub, span - c);
    const int rows_pad = kExact ? kSub : round16(rows);  // rows the loops read
    float* dst = skv + (size_t)slot * kSlot;
    if constexpr (kNarrow) {
      ring::copy_rows_pieces(dst, kStride, k + t_off, dr, rows, rows_pad, dr,
                             dpad, w);
      ring::copy_rows_pieces(dst + (size_t)kSub * kStride, kStride,
                             v + t_off, dr, rows, rows_pad, dr, dpad, w);
    } else if constexpr (kRagged) {
      ring::copy_rows_zfill(dst, kStride, k + t_off, d, rows, rows_pad, d,
                            dpad);
      ring::copy_rows_zfill(dst + (size_t)kSub * kStride, kStride, v + t_off,
                            d, rows, rows_pad, d, dpad);
    } else {
      ring::copy_rows(dst, kStride, k + t_off, d, rows, d);
      ring::copy_rows(dst + (size_t)kSub * kStride, kStride, v + t_off, d,
                      rows, d);
    }
  };

  for (int row0 = 0; row0 < p.block_q; row0 += kPass) {
    const int nrows = min(kPass, p.block_q - row0);
    const bool busy = rg * kTcRowsPerWarp < nrows;
    const int qrow = p.off + qb * p.block_q + row0 + rg * kTcRowsPerWarp + g;

    // prologue: Q and the first ring step in one group
    if constexpr (kNarrow)
      ring::copy_rows_pieces(sq, kStride, q + q_off + (size_t)row0 * dr, dr,
                             nrows, round16(nrows), dr, dpad, w);
    else if constexpr (kRagged)
      ring::copy_rows_zfill(sq, kStride, q + q_off + (size_t)row0 * d, d,
                            nrows, round16(nrows), d, dpad);
    else
      ring::copy_rows(sq, kStride, q + q_off + (size_t)row0 * d, d, nrows,
                      d);
    int kb_c = next_live(p, start, qb, end), c_c = 0;
    int kb_p = kb_c, c_p = 0;
    if (pending(kb_p, c_p)) {
      issue(kb_p, c_p, 0);
      advance(kb_p, c_p);
    }
    ring::commit();

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    float acc[kOt][4];
#pragma unroll
    for (int ot = 0; ot < kOt; ++ot)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ot][e] = 0.0f;

    int slot = 0;
    while (pending(kb_c, c_c)) {
      ring::wait<kTfStages - 2>();
      __syncthreads();  // slot `slot` landed; the other is free again
      if (pending(kb_p, c_p)) {
        issue(kb_p, c_p, slot ^ 1);
        advance(kb_p, c_p);
      }
      ring::commit();

      if (busy) {
        const float* sk = skv + (size_t)slot * kSlot;
        const float* sv = sk + (size_t)kSub * kStride;
        const float* sqw = sq + (size_t)rg * kTcRowsPerWarp * kStride;
        // keys of the run in the sub-tile (a multiple of 16 unless
        // kRagged) and keys the loops cover
        const int live = min(kSub, span - c_c);
        const int nkeys = kExact ? kSub : live;

        // -- S = Q K^T: 16 rows x nkeys in 3xTF32, f32 sums --------------
        // over this warp's dims; Q is scaled in f32 before the split (as
        // the plain version pre-scales it); each k-step splits its A
        // fragment once for its n-tiles, and each K fragment once for its
        // three products
        float s[kNt][4];
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kDw / 8; ++ks) {
          const int col = dof + ks * 8;
          if (col < d) {
            unsigned a[4], ahi[4], alo[4];
            tc::ldmatrix_x4(a, sqw + (size_t)a_row * kStride + col + a_col);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              a[e] = __float_as_uint(__fmul_rn(__uint_as_float(a[e]), p.scale));
            split_frag(a, ahi, alo);
#pragma unroll
            for (int np = 0; np < kNt / 2; ++np) {
              if (np * 16 < nkeys) {
                unsigned kf[4], khi[4], klo[4];
                tc::ldmatrix_x4(kf, sk + (size_t)(np * 16 + k_row) * kStride +
                                        col + k_col);
                split_frag(kf, khi, klo);
                mma_3xtf32(s[2 * np], ahi, alo, make_uint2(khi[0], khi[1]),
                           make_uint2(klo[0], klo[1]));
                mma_3xtf32(s[2 * np + 1], ahi, alo,
                           make_uint2(khi[2], khi[3]),
                           make_uint2(klo[2], klo[3]));
              }
            }
          }
        }
        if constexpr (kHalves == 2) {
          // the pair's halves, summed dims 0-127 + dims 128-255 in both
          // warps (one order, so both hold the same scores)
          float* mine = sx + (size_t)warp * 32 * kNt * 4;
          const float* other = sx + (size_t)(warp ^ 1) * 32 * kNt * 4;
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) mine[(nt * 4 + e) * 32 + lane] = s[nt][e];
          pair_sync(1 + rg);
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = other[(nt * 4 + e) * 32 + lane];
              s[nt][e] = half == 0 ? __fadd_rn(s[nt][e], x)
                                   : __fadd_rn(x, s[nt][e]);
            }
        }

        mask_scores<kNt, false, kRagged>(p, s, qrow, g, t4, kb_c * bk + c_c,
                                         kRagged ? live : nkeys, pos,
                                         kExact ? kSub : round16(live));
        softmax_step<kNt, kOt>(s, m, l, acc, nkeys);

        // -- O += P V in 3xTF32, this warp's output dims -------------------
        // per 8-key k-step, keys permuted in the group (A column t is key
        // 2t, column t + 4 key 2t + 1): the score fragment's d[0], d[2],
        // d[1], d[3] are P's A fragment, and V's B fragment is read at rows
        // 2t and 2t + 1 (32-bit loads; row stride 4 mod 32 words puts the
        // 32 lanes in distinct banks)
#pragma unroll
        for (int kk = 0; kk < kNt; ++kk) {
          if (kk * 8 < nkeys) {
            const unsigned pf[4] = {
                __float_as_uint(s[kk][0]), __float_as_uint(s[kk][2]),
                __float_as_uint(s[kk][1]), __float_as_uint(s[kk][3])};
            unsigned phi[4], plo[4];
            split_frag(pf, phi, plo);
            const float* vr =
                sv + (size_t)(kk * 8 + 2 * t4) * kStride + dof + g;
#pragma unroll
            for (int ot = 0; ot < kOt; ++ot) {
              if (dof + ot * 8 < d) {
                unsigned vhi0, vlo0, vhi1, vlo1;
                tc::split_tf32(vr[ot * 8], vhi0, vlo0);
                tc::split_tf32(vr[kStride + ot * 8], vhi1, vlo1);
                mma_3xtf32(acc[ot], phi, plo, make_uint2(vhi0, vhi1),
                           make_uint2(vlo0, vlo1));
              }
            }
          }
        }
      }
      advance(kb_c, c_c);
      slot ^= 1;
    }
    ring::wait<0>();
    __syncthreads();  // every reader of sq and the ring is done

    if (busy)
      store_o<kOt, kRagged, kNarrow>(o + q_off + dof,
                                     row0 + rg * kTcRowsPerWarp + g, dr,
                                     dr - dof, t4, acc, l, row0 + nrows);
  }
}

// ---------------------------------------------------------------------------
// decode: flash_decode_kernel and paged_decode_kernel, two front ends of
// the split-K routine of decode_split.cuh
// ---------------------------------------------------------------------------

// Contiguous caches (B, Hkv, sk_arr, d): key block kb at the compact-KV
// clamp clip(kb - s0, 0, kv_blocks - 1); the bounding lowering visits
// only the blocks of the domain (query-block row 0).
template <typename T>
struct ContigTiles {
  AttnParams p;
  const T* __restrict__ k;
  const T* __restrict__ v;
  size_t kv_head;  // first row of this (batch, kv head)

  __device__ __forceinline__ bool member(int kb) const {
    return p.lowering != kBounding || in_domain(p, kb, 0);
  }
  __device__ __forceinline__ void rows(int kb, int off, const T*& krow,
                                       const T*& vrow) const {
    const int kv = min(max(kb - p.s0, 0), p.kv_blocks - 1);
    const size_t r = (kv_head + (size_t)kv * p.block_k + off) * p.d;
    krow = k + r;
    vrow = v + r;
  }
};

// The fused pool (P, 2 Hkv, page_size, d): logical block kb of the slot at
// page table_row[kb], K at row 2 kvh of the page and V at row 2 kvh + 1.
template <typename T>
struct PagedTiles {
  AttnParams p;
  const T* __restrict__ pool;
  const int* __restrict__ table_row;
  int kvh;

  __device__ __forceinline__ bool member(int) const { return true; }
  __device__ __forceinline__ void rows(int kb, int off, const T*& krow,
                                       const T*& vrow) const {
    const size_t tile = (size_t)p.block_k * p.d;
    const int page = table_row[kb];
    krow = pool + ((size_t)page * 2 * p.hkv + 2 * kvh) * tile +
           (size_t)off * p.d;
    vrow = krow + tile;
  }
};

// The CTA's (slot, kv head, head chunk): grid (nsplit, Hkv hc, B); the
// chunk's first q head and its head count.
__device__ __forceinline__ void decode_cta(const AttnParams& p,
                                           const dec::DecodeArgs& a, int& b,
                                           int& kvh, int& h0, int& gn,
                                           int& pidx) {
  b = blockIdx.z;
  kvh = blockIdx.y / a.hc;
  const int chunk = blockIdx.y - kvh * a.hc;
  h0 = kvh * a.group + chunk * a.kg;
  gn = min(a.kg, a.group - chunk * a.kg);
  pidx = (b * p.hkv + kvh) * a.hc + chunk;
}

// B4's decode: q (B, H, 1, d) over the caches, the extent from the
// lowering (ext under prefetch_lut and mma, the closed form, or the
// bounding walk over [0, m_k - 1]) clamped by seq_pos.
template <typename T, int kG, int kCpl>
__global__ void __launch_bounds__(dec::kThreads)
flash_decode_kernel(AttnParams p, dec::DecodeArgs a, const T* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ ext,
                    const int* __restrict__ pos_vec, T* __restrict__ o,
                    float* __restrict__ part, int* __restrict__ cnt) {
  int b, kvh, h0, gn, pidx;
  decode_cta(p, a, b, kvh, h0, gn, pidx);
  int start, end, pos;
  row_extent(p, 0, b, ext, pos_vec, start, end, pos);
  const ContigTiles<T> tiles{p, k, v, ((size_t)b * p.hkv + kvh) * p.sk_arr};
  const size_t off = ((size_t)b * p.h + h0) * p.d;
  dec::decode_split<T, kG, kCpl>(p, a, tiles, q + off, o + off, gn, start,
                                 end, pos, pidx, blockIdx.x, part, cnt);
}

// B5: p.m_k is the page table's width (max_pages), p.block_k the page size.
template <typename T, int kG, int kCpl>
__global__ void __launch_bounds__(dec::kThreads)
paged_decode_kernel(AttnParams p, dec::DecodeArgs a, const T* __restrict__ q,
                    const T* __restrict__ pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ pos_vec, T* __restrict__ o,
                    float* __restrict__ part, int* __restrict__ cnt) {
  int b, kvh, h0, gn, pidx;
  decode_cta(p, a, b, kvh, h0, gn, pidx);
  const int pos = pos_vec[b];
  int start = 0;
  if (p.window)
    start = floor_div(max(pos - p.window + 1, 0), p.block_k);
  // pages past the table's width are never read (a position there is a
  // caller's error; the contiguous kernel clamps the same way at m_k - 1)
  const int end = min(floor_div(pos, p.block_k), p.m_k - 1);
  const PagedTiles<T> tiles{p, pool, page_table + (size_t)b * p.m_k, kvh};
  const size_t off = ((size_t)b * p.h + h0) * p.d;
  dec::decode_split<T, kG, kCpl>(p, a, tiles, q + off, o + off, gn, start,
                                 end, pos, pidx, blockIdx.x, part, cnt);
}

// Opt in to more than 48 KB of dynamic shared memory once per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int DPL>
int launch_flash(const AttnParams& p, const T* q, const T* k, const T* v,
                 const int* ext, const int* pos, T* o, cudaStream_t s) {
  const size_t bytes = smem_floats(p.d, p.block_k) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, DPL>;
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  const long long ctas = (long long)p.b * p.h * p.m_q;
  kernel<<<(unsigned)ctas, kThreads, bytes, s>>>(p, q, k, v, ext, pos, o);
  return (int)cudaGetLastError();
}

// One tile-path kernel (flash_fwd_tc_kernel or flash_fwd_tf32_kernel) at
// `bytes` of shared memory: `halves` warps per 16 query rows (a ragged
// block's last 16 padded) of a pass of at most `pass` rows (at most 8
// warps).
template <typename T, typename K>
int launch_tile_path(K kernel, size_t bytes, const AttnParams& p, const T* q,
                     const T* k, const T* v, const int* ext, const int* pos,
                     T* o, const RowShard& rs, cudaStream_t s,
                     int pass = kTcRowsPerPass, int halves = 1) {
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  const int rows = round16(p.block_q) < pass ? round16(p.block_q) : pass;
  const int warps = rows / kTcRowsPerWarp * halves;
  const long long ctas = (long long)p.b * p.h * p.m_q;
  kernel<<<(unsigned)ctas, warps * 32, bytes, s>>>(p, q, k, v, ext, pos, o,
                                                   rs);
  return (int)cudaGetLastError();
}

// One decode kernel: grid (nsplit, Hkv hc, B) of dec::kThreads threads.
template <typename K, typename... Args>
int launch_decode(K kernel, const AttnParams& p, const dec::DecodeArgs& a,
                  cudaStream_t s, Args... args) {
  const size_t bytes = dec::smem_bytes(a.kg, p.d);
  // the opt-in also when bytes is near 48 KB: the routine's static
  // shared memory counts against the same limit
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)a.nsplit, (unsigned)(p.hkv * a.hc),
                  (unsigned)p.b);
  kernel<<<grid, dec::kThreads, bytes, s>>>(p, a, args...);
  return (int)cudaGetLastError();
}

// Call go(kG, kCpl) with the instantiation the geometry needs: kG 2 for
// groups of up to two q heads, else dec::kMaxGroup; kCpl 2 only for f32
// rows of more than 128 values.
template <typename T, typename F>
int by_shape(const dec::DecodeArgs& a, F go) {
  using G2 = std::integral_constant<int, 2>;
  using G8 = std::integral_constant<int, dec::kMaxGroup>;
  using C1 = std::integral_constant<int, 1>;
  using C2 = std::integral_constant<int, 2>;
  if (a.cpl > 2 || (sizeof(T) == 2 && a.cpl > 1))
    return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    if (a.cpl == 2) return a.kg == 2 ? go(G2{}, C2{}) : go(G8{}, C2{});
  }
  return a.kg == 2 ? go(G2{}, C1{}) : go(G8{}, C1{});
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <typename T>
int decode(const long long* params, float scale, const void* q,
           const void* k, const void* v, const int* ext, const int* pos,
           void* o, float* part, int* cnt, cudaStream_t s) {
  const AttnParams p = make_params(params, scale);
  if (p.d > 256 || p.block_q != 1 || p.m_q != 1 || !p.has_pos ||
      p.kind != kFull || (long long)p.m_k * p.block_k > (1 << 24))
    return (int)cudaErrorInvalidValue;
  const dec::DecodeArgs a =
      dec::make_args(p, sizeof(T), aligned16(k) && aligned16(v));
  const T *qq = static_cast<const T*>(q), *kk = static_cast<const T*>(k),
          *vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  return by_shape<T>(a, [&](auto g, auto c) {
    return launch_decode(flash_decode_kernel<T, decltype(g)::value,
                                             decltype(c)::value>,
                         p, a, s, qq, kk, vv, ext, pos, oo, part, cnt);
  });
}

template <typename T>
int paged(const long long* params, float scale, const void* q,
          const void* pool, const int* table, const int* pos, void* o,
          float* part, int* cnt, cudaStream_t s) {
  const AttnParams p = make_params(params, scale);
  if (p.d > 256 || (long long)p.m_k * p.block_k > (1 << 24))
    return (int)cudaErrorInvalidValue;
  const dec::DecodeArgs a = dec::make_args(p, sizeof(T), aligned16(pool));
  const T *qq = static_cast<const T*>(q), *pp = static_cast<const T*>(pool);
  T* oo = static_cast<T*>(o);
  return by_shape<T>(a, [&](auto g, auto c) {
    return launch_decode(paged_decode_kernel<T, decltype(g)::value,
                                             decltype(c)::value>,
                         p, a, s, qq, pp, table, pos, oo, part, cnt);
  });
}

// The acc columns a lane holds: d <= 32 DPL.
template <typename T>
int flash(const long long* params, float scale, const void* q, const void* k,
          const void* v, const int* ext, const int* pos, void* o,
          cudaStream_t s) {
  const AttnParams p = make_params(params, scale);
  const T *qq = static_cast<const T*>(q), *kk = static_cast<const T*>(k),
          *vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  if (p.d <= 32) return launch_flash<T, 1>(p, qq, kk, vv, ext, pos, oo, s);
  if (p.d <= 64) return launch_flash<T, 2>(p, qq, kk, vv, ext, pos, oo, s);
  if (p.d <= 128) return launch_flash<T, 4>(p, qq, kk, vv, ext, pos, oo, s);
  if (p.d <= 256) return launch_flash<T, 8>(p, qq, kk, vv, ext, pos, oo, s);
  return (int)cudaErrorInvalidValue;
}

// A tile path's instantiation for its flags (narrow implies ragged).
template <int DT, bool kShard>
auto tc_kernel(bool ragged, bool narrow) {
  return narrow   ? flash_fwd_tc_kernel<DT, true, true, kShard>
         : ragged ? flash_fwd_tc_kernel<DT, true, false, kShard>
                  : flash_fwd_tc_kernel<DT, false, false, kShard>;
}
template <int DT, bool kShard>
auto tf32_kernel(bool exact, bool ragged, bool narrow) {
  if (narrow)
    return exact ? flash_fwd_tf32_kernel<DT, true, true, true, kShard>
                 : flash_fwd_tf32_kernel<DT, false, true, true, kShard>;
  if (exact)
    return ragged ? flash_fwd_tf32_kernel<DT, true, true, false, kShard>
                  : flash_fwd_tf32_kernel<DT, true, false, false, kShard>;
  return ragged ? flash_fwd_tf32_kernel<DT, false, true, false, kShard>
                : flash_fwd_tf32_kernel<DT, false, false, false, kShard>;
}

// The tile paths copy rows in pieces of up to 16 bytes from q, k and v on
// 16-byte boundaries (every row then starts on a boundary of its pieces).
bool tile_aligned(const void* q, const void* k, const void* v,
                  const void* o) {
  return aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
}

// The tc kernel takes any block_q and block_k and any d up to 256 (the
// ragged instantiation where one of the three is not a multiple of 16,
// the narrow one where a row is no whole number of 16-byte pieces).
template <bool kShard>
int flash_tc(const long long* params, float scale, const void* q,
             const void* k, const void* v, const int* ext, const int* pos,
             void* o, const RowShard& rs, cudaStream_t s) {
  const AttnParams p = make_params(params, scale);
  if (p.d > 256 || !tile_aligned(q, k, v, o))
    return (int)cudaErrorInvalidValue;
  const auto *qq = static_cast<const __nv_bfloat16*>(q),
             *kk = static_cast<const __nv_bfloat16*>(k),
             *vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  const size_t bytes = tc_smem_bytes(p.d, p.block_q);
  const bool ragged = p.block_q % 16 || p.block_k % 16 || p.d % 16;
  const bool narrow = ring::piece_bytes(2 * p.d) < 16;
  auto kernel = tc_dt(p.d) == 64    ? tc_kernel<64, kShard>(ragged, narrow)
                : tc_dt(p.d) == 128 ? tc_kernel<128, kShard>(ragged, narrow)
                                    : tc_kernel<256, kShard>(ragged, narrow);
  return launch_tile_path(kernel, bytes, p, qq, kk, vv, ext, pos, oo, rs, s);
}

// The tf32 kernel takes any block_q and block_k and any d up to 256
// (ragged where a block is not a multiple of 16 or d of 8, narrow where d
// is not a multiple of 4).  The exact loops (the instantiation's d, whole
// sub-tiles) run where d is dt and block_k a multiple of the sub-tile or
// the call ragged, and on narrow calls whose d pads up to dt (the columns
// from d to dt zero-filled).
template <bool kShard>
int flash_tf32(const long long* params, float scale, const void* q,
               const void* k, const void* v, const int* ext, const int* pos,
               void* o, const RowShard& rs, cudaStream_t s) {
  const AttnParams p = make_params(params, scale);
  if (p.d > 256 || !tile_aligned(q, k, v, o))
    return (int)cudaErrorInvalidValue;
  const auto *qq = static_cast<const float*>(q),
             *kk = static_cast<const float*>(k),
             *vv = static_cast<const float*>(v);
  auto* oo = static_cast<float*>(o);
  const int dt = tf32_dt(p.d);
  const size_t bytes = tf32_smem_bytes(p.d, p.block_q);
  const bool ragged = p.block_q % 16 || p.block_k % 16 || p.d % 8;
  const bool narrow = ring::piece_bytes(4 * p.d) < 16;
  const bool exact = (narrow ? (p.d + 7) & ~7 : p.d) == dt &&
                     (ragged || p.block_k % tf32_sub(dt) == 0);
  auto kernel = dt == 64    ? tf32_kernel<64, kShard>(exact, ragged, narrow)
                : dt == 128 ? tf32_kernel<128, kShard>(exact, ragged, narrow)
                            : tf32_kernel<256, kShard>(exact, ragged, narrow);
  return launch_tile_path(kernel, bytes, p, qq, kk, vv, ext, pos, oo, rs, s,
                          tf32_rows_per_pass(dt), tf32_halves(dt));
}

}  // namespace

extern "C" {

#ifndef REPRO_SHARDED
// o = flash attention of q (B, H, Sq, d) over k, v (B, Hkv, Sk_arr, d),
// all contiguous and of one dtype; params: ATTN_PARAMS order.  ext: the
// (m_q, 2) int32 row extents under prefetch_lut, else null.  pos: the (B,)
// int32 decode positions when params[kHasPos], else null.
int fa_forward_f32(const long long* params, float scale, const void* q,
                   const void* k, const void* v, const int* ext,
                   const int* pos, void* o, void* stream) {
  return flash<float>(params, scale, q, k, v, ext, pos, o,
                      static_cast<cudaStream_t>(stream));
}

int fa_forward_bf16(const long long* params, float scale, const void* q,
                    const void* k, const void* v, const int* ext,
                    const int* pos, void* o, void* stream) {
  return flash<__nv_bfloat16>(params, scale, q, k, v, ext, pos, o,
                              static_cast<cudaStream_t>(stream));
}

// The same on the tensor cores, bf16 only (flash_fwd_tc_kernel): params
// as fa_forward_bf16, with q, k, v, o on 16-byte boundaries.
int fa_forward_tc_bf16(const long long* params, float scale, const void* q,
                       const void* k, const void* v, const int* ext,
                       const int* pos, void* o, void* stream) {
  return flash_tc<false>(params, scale, q, k, v, ext, pos, o, RowShard{},
                         static_cast<cudaStream_t>(stream));
}

// The same in f32 on the tensor cores (flash_fwd_tf32_kernel, 3xTF32):
// params as fa_forward_f32, with q, k, v, o on 16-byte boundaries.
int fa_forward_tc_f32(const long long* params, float scale, const void* q,
                      const void* k, const void* v, const int* ext,
                      const int* pos, void* o, void* stream) {
  return flash_tf32<false>(params, scale, q, k, v, ext, pos, o, RowShard{},
                           static_cast<cudaStream_t>(stream));
}

// o (B, H, 1, d) = single-token decode of q (B, H, 1, d) over the caches
// k, v (B, Hkv, sk_arr, d) at the (B,) int32 positions pos, split-K
// (flash_decode_kernel); params as fa_forward_*, with block_q = m_q = 1
// and has_pos; ext as fa_forward_*.  part, cnt: scratch of
// fa_decode_scratch(params, sizeof(T), 0 / 1) floats / ints, the counters
// zero before the first call (every call leaves them zero).
int fa_decode_f32(const long long* params, float scale, const void* q,
                  const void* k, const void* v, const int* ext,
                  const int* pos, void* o, void* part, void* cnt,
                  void* stream) {
  return decode<float>(params, scale, q, k, v, ext, pos, o,
                       static_cast<float*>(part), static_cast<int*>(cnt),
                       static_cast<cudaStream_t>(stream));
}

int fa_decode_bf16(const long long* params, float scale, const void* q,
                   const void* k, const void* v, const int* ext,
                   const int* pos, void* o, void* part, void* cnt,
                   void* stream) {
  return decode<__nv_bfloat16>(params, scale, q, k, v, ext, pos, o,
                               static_cast<float*>(part),
                               static_cast<int*>(cnt),
                               static_cast<cudaStream_t>(stream));
}

// o (B, H, 1, d) = single-token decode of q (B, H, 1, d) through the
// (B, max_pages) int32 page table into the fused pool
// (P, 2 Hkv, page_size, d); pos: (B,) int32; part, cnt as fa_decode_*.
// The same routine as fa_decode_*: bit-equal to it at
// block_k == page_size.
int fa_paged_decode_f32(const long long* params, float scale, const void* q,
                        const void* pool, const int* table, const int* pos,
                        void* o, void* part, void* cnt, void* stream) {
  return paged<float>(params, scale, q, pool, table, pos, o,
                      static_cast<float*>(part), static_cast<int*>(cnt),
                      static_cast<cudaStream_t>(stream));
}

int fa_paged_decode_bf16(const long long* params, float scale, const void* q,
                         const void* pool, const int* table, const int* pos,
                         void* o, void* part, void* cnt, void* stream) {
  return paged<__nv_bfloat16>(params, scale, q, pool, table, pos, o,
                              static_cast<float*>(part),
                              static_cast<int*>(cnt),
                              static_cast<cudaStream_t>(stream));
}

// Scratch of one decode launch at params (either front end) with values
// of elt_bytes: which 0 -> floats of split parts, 1 -> int counters.
long long fa_decode_scratch(const long long* params, int elt_bytes,
                            int which) {
  const AttnParams p = make_params(params, 1.0f);
  const dec::DecodeArgs a = dec::make_args(p, elt_bytes, true);
  return which == 0 ? dec::part_floats(p, a) : dec::counters(p, a);
}

// Dynamic shared memory of one CTA of either decode kernel.
long long fa_decode_smem_bytes(const long long* params, int elt_bytes) {
  const AttnParams p = make_params(params, 1.0f);
  return (long long)dec::smem_bytes(
      dec::make_args(p, elt_bytes, true).kg, p.d);
}

// Keys per split of the decode kernels (dec::kSplitKeys).
int fa_decode_split_keys() { return dec::kSplitKeys; }

// Dynamic shared memory of one CTA of flash_fwd_kernel at (d, block_k).
long long fa_smem_bytes(int d, int block_k) {
  return (long long)(smem_floats(d, block_k) * sizeof(float));
}

#else
// One rank's band of a query-axis sharded call on the tile paths (the
// kShard instantiations; this source built with -DREPRO_SHARDED, a
// library of its own): q and o hold the band's m_q block rows (params'
// m_q and sq are the band's), k and v the whole keys; shard is
// [partition (1 rows, 2 zigzag), row_lo, rank, 2 D] (RowShard), which maps
// a band row to the global row its masks and extents (ext: the global
// (m_q, 2) table) follow.
int fa_forward_tc_bf16_sharded(const long long* params, float scale,
                               const void* q, const void* k, const void* v,
                               const int* ext, const int* pos, void* o,
                               const long long* shard, void* stream) {
  return flash_tc<true>(params, scale, q, k, v, ext, pos, o,
                        make_row_shard(shard),
                        static_cast<cudaStream_t>(stream));
}

int fa_forward_tc_f32_sharded(const long long* params, float scale,
                              const void* q, const void* k, const void* v,
                              const int* ext, const int* pos, void* o,
                              const long long* shard, void* stream) {
  return flash_tf32<true>(params, scale, q, k, v, ext, pos, o,
                          make_row_shard(shard),
                          static_cast<cudaStream_t>(stream));
}
#endif  // REPRO_SHARDED

// Dynamic shared memory of one CTA of the tc kernel at (d, block_q).
long long fa_tc_smem_bytes(int d, int block_q) {
  return (long long)tc_smem_bytes(d, block_q);
}

// Dynamic shared memory of one CTA of the tf32 kernel at (d, block_q).
long long fa_tc_f32_smem_bytes(int d, int block_q) {
  return (long long)tf32_smem_bytes(d, block_q);
}

const char* cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
