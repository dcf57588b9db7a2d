"""The tile paths' ragged instantiations (csrc/flash_attention.cu,
``kRagged`` of flash_fwd_tc_kernel and flash_fwd_tf32_kernel) without the
card.

A torch emulation of what one CTA of a ragged call does, index for
index: its key-block extent from the lowering (bounding skips to the
domain's blocks) clamped by seq_pos; the row's blocks as one run of keys
(``run_keys``) walked in sub-tiles of 64 keys (32 for f32 past d = 128)
that cross block boundaries; each sub-tile copied into a shared slot
that held garbage (NaN here), its rows past the run and its columns past
d zero-filled up to the next 16 rows (the f32 path at d 64 / 128 / 256,
whose loops are exact: up to the whole sub-tile) and the k-step (16 bf16,
8 f32 columns: ``copy_rows_zfill``); Q's pass rows likewise up to the
next 16;
scores masked with -1e30 by ``key_live`` and padded keys with -inf; the
online softmax per sub-tile (bf16: the product in f32, scaled after it,
p rounded to bf16 for p v; f32: Q scaled in f32, 3xTF32 products, past
d = 128 the two halves added dims 0-127 first); only rows below the
block stored.

Rows that are no whole number of 16-byte pieces (the kNarrow
instantiations: f32 D 62 / 37, bf16 D 60 / 250 / 37) are copied thread
by thread in pieces of ``ring::piece_bytes`` -- 8, 4, or 2 bytes through
a register (``ring::copy_rows_pieces``) -- and stored value by value
where a pair would cross a row's end or sit off its alignment
(``store_o``).

Asserted at block_q, block_k in {1, 8, 24, 40, 72, 100} and d in {40,
64, 72, 256} (and f32 at d 36 / 132, rows of 4 mod 8 values; the narrow
rows at blocks of 64 and 72): every key of every visited block is read
exactly once a pass; every value of a padded tile lands once, exactly
the live values are read, each once, and nothing past a row or the
tensor, each piece aligned to its width; every padded key and row is
zero and every padded key's p is 0; no padded row is stored and every
output value is stored once; the lowerings are bit-equal; the emulation
agrees with
``flash_attention_plain`` within the kernels' tolerances (f32 2e-5, bf16
2e-2 with ``ROW_RTOL``), and the plain version with the JAX package's
``repro.kernels.ref.attention_ref`` and tpu-interpret
``repro.kernels.ops.flash_attention`` at those blocks and head dims.
Planted faults (a stale padded row, a padded key left live, a padded
row stored, a piece one step too wide, a pair stored across a row's
end) fail it.  The constants mirror the kernel: 16-row warps, the
sub-tiles, the rows a pass.
"""
import functools
import importlib
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.compact import pack_kv
from repro_torch.core.plan import LOWERINGS

FA = importlib.import_module("repro_torch.kernels.flash_attention")

ROWS = 16     # query rows a warp; keys of an mma n-tile pair
HALF = 128    # output dims a warp owns in the f32 pair form (d > 128)
BLOCKS = (1, 8, 24, 40, 72, 100)
DIMS = (40, 64, 72, 256)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the emulation runs many small tensor ops: threads cost more than
    # they give, most of all beside other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def round16(x):
    return (x + 15) & ~15


def dt_of(d):
    """The instantiated head dim (tc_dt, tf32_dt)."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


def geometry(dtype, d):
    """(keys a sub-tile, rows a pass, columns a shared row holds, exact)
    of the tile path of ``dtype`` at head dim d: tf32_sub,
    tf32_rows_per_pass, d up to the k-step (16 bf16, 8 f32), and whether
    the f32 path's exact loops run (d is the instantiation's 64, 128 or
    256, or a narrow d -- rows of no whole number of 16-byte pieces --
    pads up to it: every sub-tile then covers its whole kSub keys, the
    run's last one zero-filled up to them, and the loops all DT
    columns)."""
    f32 = dtype == torch.float32
    wide = f32 and d > HALF
    step = 8 if f32 else 16
    cols = -(-d // step) * step
    return ((32 if wide else 64), (64 if wide else 128), cols,
            f32 and (d if d % 4 == 0 else cols) == dt_of(d))


def piece_bytes(row_bytes):
    """ring::piece_bytes: the widest piece a row is a whole number of."""
    return next(w for w in (16, 8, 4, 2) if row_bytes % w == 0)


def is_ragged(sched, dtype):
    step = 8 if dtype == torch.float32 else 16
    return bool(sched.block_q % 16 or sched.block_k % 16 or sched.d % step)


def _tf32(x):
    """cvt.rna.tf32.f32 on the bit pattern (csrc/mma_sync.cuh)."""
    b = x.to(torch.float32).view(torch.int32)
    return ((b + 0x1000) & ~0x1fff).view(torch.float32)


def _mm3(a, b):
    """a @ b of f32 as 3xTF32 (lo hi + hi lo + hi hi, exact in float64,
    rounded to f32)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al.double() @ bh.double() + ah.double() @ bl.double()
            + ah.double() @ bh.double()).float()


@functools.lru_cache(maxsize=None)
def _pieces(rows, rows_pad, cols, cols_pad, stride, esize, threads,
            wide=False):
    """The pieces ring::copy_rows_zfill's ``threads`` threads copy for a
    tile of ``rows`` live rows (``stride`` values apart) padded to
    ``rows_pad`` x ``cols_pad``, checked as zfill_copy says; returns
    (the tile values the live pieces land on, the values they read
    relative to the tile's first, the last of those, the piece width)."""
    w = piece_bytes(cols * esize) * (2 if wide else 1)
    assert w in (16, 8, 4) or (w == 2 and esize == 2)
    vals, pieces = w // esize, cols_pad * esize // w
    lanes = min(pieces, threads)
    sweep = threads // lanes
    t = torch.arange(sweep * lanes)
    rr = (t // lanes)[:, None] + sweep * torch.arange(-(-rows_pad // sweep))
    pp = (t % lanes)[:, None] + lanes * torch.arange(-(-pieces // lanes))
    r = rr[:, :, None].expand(-1, -1, pp.shape[1])
    pc = pp[:, None, :].expand(-1, rr.shape[1], -1)
    keep = (r < rows_pad) & (pc < pieces)
    r, c = r[keep], pc[keep] * vals
    live = (c < cols) & (r < rows)
    j = torch.arange(vals)
    dst = (r * cols_pad + c)[:, None] + j  # tile values a piece lands on
    src = (r * stride + c)[:, None] + j    # values it reads
    assert torch.equal(torch.bincount(dst.flatten(),
                                      minlength=rows_pad * cols_pad),
                       torch.ones(rows_pad * cols_pad, dtype=torch.int64))
    read = src[live].flatten()
    want = (torch.arange(rows)[:, None] * stride
            + torch.arange(cols)).flatten()
    read_sorted = read.sort().values
    assert torch.equal(read_sorted, want.sort().values)
    # pieces aligned to their width: the tile's rows (a multiple of the
    # width apart) and the shared rows (16-byte multiples)
    assert not (src[:, 0] * esize % w)[live].any()
    assert not (c * esize % w).any()
    top = int(read_sorted[-1]) if read.numel() else -1
    return dst[live].flatten(), read, top, w


def zfill_copy(flat, base, stride, rows, rows_pad, cols, cols_pad,
               slot_rows, threads, faults=()):
    """ring::copy_rows_zfill into a shared slot of ``slot_rows`` rows that
    held garbage (NaN), piece by piece as ``threads`` threads copy them:
    the tile's rows lie in ``flat`` (a tensor's storage, 16-byte aligned)
    from element ``base``, ``stride`` apart; pieces of piece_bytes(cols)
    bytes (the 2-byte ones through a register); rows [0, rows_pad) x
    columns [0, cols_pad) land, those at or past ``rows`` / ``cols`` as
    zeros; the rest keeps its garbage.  Asserts that every value of the
    padded tile lands exactly once, that exactly the ``rows`` x ``cols``
    live values are read, each once (nothing past a row, nor past the
    tensor), and that each piece is a cp.async size (or the register
    path's 2 bytes of bf16) aligned to its width at both ends.
    ``faults``: "stale_rows" leaves the padded rows as they were;
    "wide_piece" copies pieces one step too wide."""
    esize = flat.element_size()
    dst, read, top, w = _pieces(rows, rows_pad, cols, cols_pad, stride,
                                esize, threads, "wide_piece" in faults)
    assert base * esize % w == 0
    assert base + top < flat.numel()  # nothing read past the tensor
    tile = torch.zeros(rows_pad * cols_pad)
    tile[dst] = flat[base + read].float()
    slot = torch.full((slot_rows, cols_pad + 8), float("nan"))
    landed = rows if "stale_rows" in faults else rows_pad
    slot[:landed, :cols_pad] = tile.view(rows_pad, cols_pad)[:landed]
    return slot


def store_rows(out, written, res, first, d, dof, ncols, cover, faults=()):
    """store_o for a pass's stored rows: ``res`` (n, >= d) f32 values of
    rows whose first output value is out[first[i]] (``out``: the output's
    storage, 16-byte aligned, with ``written`` counting stores per value).
    A warp owning output dims [dof, dof + cover) stores, lane by lane,
    column pairs c, c + 1 (c even) below ``ncols`` of them: one pair store
    where both lie in the row and the pair's address is aligned to the
    pair, else single values.  ``faults``: "straddle_pair" stores every
    pair whose first column is below ncols as a pair (the test before odd
    head dims: at odd d the row's last pair writes the next row's first
    value, off the pair's alignment)."""
    esize = out.element_size()
    c = torch.arange(0, cover, 2)
    c = c[c < ncols]
    at = first[:, None] + dof + c  # each pair's first value
    both = (c + 1 < ncols).expand_as(at)
    pair = both & (at * esize % (2 * esize) == 0)
    if "straddle_pair" in faults:
        pair = torch.ones_like(pair)
    assert not (at * esize % (2 * esize))[pair].any()  # aligned pairs
    second = pair | both
    rows = torch.arange(res.shape[0])[:, None].expand_as(at)
    idx = torch.cat([at.flatten(), (at + 1)[second]])
    val = torch.cat([res[rows, dof + c].flatten(),
                     res[rows[second], (dof + c + 1).expand_as(at)[second]]])
    written.index_add_(0, idx, torch.ones_like(idx))
    out[idx] = val.to(out.dtype)


def row_extent(sched, bounds, qb, pos):
    """csrc row_extent: the lowering's [start, end] of row qb, clamped by
    the row's seq_pos."""
    start, end = (int(x) for x in bounds[qb])
    if pos is not None:
        end = min(end, pos // sched.block_k)
        if sched.kind == "full" and sched.window:
            start = max(start, max(pos - sched.window + 1, 0)
                        // sched.block_k)
    return start, end


def run_keys(sched, start, end, qb):
    """csrc next_live / run_keys: the row's first live block and the keys
    of its live blocks as one run (bounding skips to the members)."""
    member = (lambda kb: bool(sched.member(kb, qb))) \
        if sched.lowering == "bounding" else (lambda kb: True)
    first = start
    while first <= end and not member(first):
        first += 1
    last = end
    while last >= first and not member(last):
        last -= 1
    visited = [kb for kb in range(first, last + 1) if member(kb)]
    assert visited == list(range(first, last + 1)), "rows are runs"
    return first, (last - first + 1) * sched.block_k if last >= first else 0


def key_live(sched, qpos, kpos, pos):
    """csrc key_live on broadcast tensors."""
    live = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                      dtype=torch.bool)
    if sched.kind != "full":
        live = kpos <= qpos
        if sched.kind == "local":
            live = live & (kpos > qpos - sched.window)
    if pos is not None:
        pm = kpos <= pos
        if sched.kind == "full" and sched.window:
            pm = pm & (kpos > pos - sched.window)
        live = live & pm
    return live


def ragged_tiles(q, k, v, sched, pos=None, faults=()):
    """The ragged tile path on q (B, H, Sq, D), k, v (B, Hkv, Sk_arr, D)
    of one dtype; returns (out, log).  log["reads"]: per (CTA, pass) the
    Counter of K/V rows read; log["visited"]: the rows of the visited
    blocks; log["stored"]: stores per output row (Sq + 16 rows, so a
    padded row stored past the last block counts too); log["written"]:
    stores per output value (D past the output's end, where a store that
    straddles the last row would land).  ``faults`` plants a fault:
    "stale_rows" (padded slot rows not zero-filled), "live_pad" (padded
    keys masked by key_live alone), "store_pad" (padded query rows
    stored), "wide_piece" (copies one piece width too wide),
    "straddle_pair" (pair stores tested by their first column only)."""
    bf16 = q.dtype == torch.bfloat16
    b, h, sq, d = q.shape
    bq, bk, g = sched.block_q, sched.block_k, sched.group
    sub, npass, cols, exact = geometry(q.dtype, d)
    halves = 2 if not bf16 and d > HALF else 1
    cover = dt_of(d) // halves  # output dims a warp owns
    threads = min(round16(bq), npass) // ROWS * halves * 32
    qf, kf, vf = (t.contiguous().view(-1) for t in (q, k, v))
    bounds = sched.row_bounds()
    out = torch.full((q.numel() + d,), float("nan"), dtype=q.dtype)
    written = torch.zeros(q.numel() + d, dtype=torch.int64)
    stored = torch.zeros((b, h, sq + ROWS), dtype=torch.int64)
    log = {"reads": [], "visited": [], "stored": stored, "written": written}
    for bi in range(b):
        pb = None if pos is None else int(pos[bi])
        for hi in range(h):
            kvh = hi // g
            kv_row0 = (bi * k.shape[1] + kvh) * k.shape[2]
            for qb in range(sched.m_q):
                start, end = row_extent(sched, bounds, qb, pb)
                first, nrun = run_keys(sched, start, end, qb)
                kv0 = min(max(first - sched.s0, 0), sched.kv_blocks - 1)
                for row0 in range(0, bq, npass):
                    nrows = min(npass, bq - row0)
                    qrow0 = qb * bq + row0
                    q_row0 = (bi * h + hi) * sq + qrow0
                    sq_ = zfill_copy(qf, q_row0 * d, d, nrows,
                                     round16(nrows), d, cols, npass,
                                     threads, faults)
                    qs = sq_[:round16(nrows), :cols]
                    qpos = (sched.off + qrow0
                            + torch.arange(qs.shape[0]))[:, None]
                    m = torch.full((qs.shape[0], 1), FA.NEG_INF)
                    l = torch.zeros((qs.shape[0], 1))
                    acc = torch.zeros((qs.shape[0], cols))
                    reads = Counter()
                    for c in range(0, nrun, sub):
                        rows = min(sub, nrun - c)
                        pad = sub if exact else round16(rows)
                        r0 = kv0 * bk + c
                        reads.update(range(r0, r0 + rows))
                        ks, vs = (zfill_copy(
                            t, (kv_row0 + r0) * d, d, rows, pad, d, cols,
                            sub, threads, faults)[:pad, :cols]
                            for t in (kf, vf))
                        if "stale_rows" not in faults:
                            assert not ks[rows:].any() and \
                                not vs[rows:].any()
                            assert not ks[:, d:].any() and \
                                not qs[nrows:].any()
                        if bf16:  # the product in f32, scaled after it
                            s = (qs.double() @ ks.double().T).float() \
                                * sched.scale
                        else:  # Q scaled in f32 as loaded, 3xTF32
                            qsc = qs * sched.scale
                            s = _mm3(qsc[:, :HALF], ks[:, :HALF].T)
                            if cols > HALF:  # the pair's halves
                                s = s + _mm3(qsc[:, HALF:], ks[:, HALF:].T)
                        kidx = torch.arange(s.shape[1])[None, :]
                        live = key_live(sched, qpos, first * bk + c + kidx,
                                        pb)
                        s = torch.where(live, s, FA.NEG_INF)
                        if "live_pad" not in faults:
                            s = torch.where(kidx >= rows, -torch.inf, s)
                        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                        p = torch.exp(s - m_new)
                        if "live_pad" not in faults:
                            assert not p[:, rows:].any()
                        alpha = torch.exp(m - m_new)
                        l = alpha * l + p.sum(-1, keepdim=True)
                        if bf16:
                            pv = (p.to(torch.bfloat16).double()
                                  @ vs.double()).float()
                        else:
                            pv = _mm3(p, vs)
                        acc = acc * alpha + pv
                        m = m_new
                    log["reads"].append(reads)
                    log["visited"].append(sorted(
                        r for kb in range(first, first + nrun // bk)
                        for r in range((kb - sched.s0) * bk,
                                       (kb - sched.s0 + 1) * bk)))
                    res = acc / torch.where(l == 0, 1.0, l)
                    nstore = qs.shape[0] if "store_pad" in faults else nrows
                    stored[bi, hi, qrow0:qrow0 + nstore] += 1
                    n_in = min(nstore, sq - qrow0)  # rows inside the output
                    first_val = (q_row0 + torch.arange(n_in)) * d
                    for dof in range(0, halves * cover, cover):
                        store_rows(out, written, res[:n_in], first_val, d,
                                   dof, d - dof, cover, faults)
    return out[:q.numel()].view(q.shape), log


def _qkv(b, h, hkv, sq, sk, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def check_case(q, k, v, kw, pos=None, faults=()):
    """The emulation under every lowering: the walk's reads and stores,
    bit-equal lowerings, and the plain version's tolerance.  Returns the
    plain version's output."""
    outs = []
    for gm in LOWERINGS:
        sched = FA.flash_schedule(q.shape, k.shape, grid_mode=gm,
                                  has_pos=pos is not None, **kw)
        assert is_ragged(sched, q.dtype)
        assert FA.flash_route(sched, q.dtype) == \
            ("tc" if q.dtype == torch.bfloat16 else "tc_f32")
        out, log = ragged_tiles(q, k, v, sched, pos, faults)
        for reads, visited in zip(log["reads"], log["visited"]):
            assert sorted(reads) == visited  # every key of the run
            assert set(reads.values()) <= {1}  # ... exactly once
        stored, written = log["stored"], log["written"]
        assert (stored[..., :q.shape[2]] == 1).all()
        assert not stored[..., q.shape[2]:].any()
        # every output value stored exactly once, nothing past a row
        assert (written[:q.numel()] == 1).all()
        assert not written[q.numel():].any()
        outs.append(out)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    plain = FA.flash_attention_plain(q, k, v, sched, pos)
    FA._compare(outs[0], plain, f"ragged emulation {kw} {q.dtype}")
    return plain


def _jax_close(plain, want, dtype):
    tol = FA.TOLERANCE[dtype]
    np.testing.assert_allclose(plain.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("block", BLOCKS)
def test_ragged_causal_walk_matches_plain(block, d, dtype):
    s = 2 * block if block > 8 else 24
    q, k, v = _qkv(1, 1, 1, s, s, d, dtype, block * 7 + d)
    check_case(q, k, v, dict(kind="causal", block_q=block, block_k=block))


#: (kind, block_q, block_k, S, D, window): rectangular blocks (kind
#: full) and local bands, in both dtypes; then f32 rows of 4 mod 8
#: values (bf16 rows of d % 8 != 0 take the CUDA-core kernel)
EXTRA_CASES = [("full", 1, 72, 144, 64, 0), ("full", 24, 100, 200, 256, 0),
               ("full", 100, 8, 200, 40, 0), ("full", 72, 40, 120, 72, 0),
               ("full", 8, 1, 16, 64, 0), ("local", 24, 24, 96, 64, 48),
               ("local", 40, 40, 120, 256, 80), ("local", 72, 72, 216, 40, 72)]
NARROW_CASES = [("causal", 40, 40, 80, 36, 0), ("causal", 72, 72, 144, 132, 0),
                ("full", 24, 8, 48, 4, 0)]


def _case_qkv(kind, bq, s, d, dtype):
    # kind full takes query blocks of their own: 2 (or 1 of 1 row)
    sq = (2 * bq if bq >= 8 else bq) if kind == "full" else s
    return _qkv(1, 4, 2, sq, s, d, dtype, s + d + bq)


@pytest.mark.parametrize("kind,bq,bk,s,d,window,dtype", [
    c + (dt,) for c in EXTRA_CASES for dt in (torch.float32, torch.bfloat16)]
    + [c + (torch.float32,) for c in NARROW_CASES])
def test_ragged_blocks_bands_and_narrow_rows(kind, bq, bk, s, d, window,
                                             dtype):
    q, k, v = _case_qkv(kind, bq, s, d, dtype)
    check_case(q, k, v, dict(kind=kind, window=window, block_q=bq,
                             block_k=bk))


_ATTN_REF = jax.jit(jref.attention_ref, static_argnames=("kind", "window"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_matches_the_jax_reference_at_ragged_blocks(dtype):
    # the plain version at every block size of the walk (causal), the
    # rectangular and local cases, against repro.kernels.ref
    cases = [("causal", b, b, 2 * b if b > 8 else 24, 64, 0) for b in BLOCKS]
    for kind, bq, bk, s, d, window in cases + EXTRA_CASES:
        q, k, v = _case_qkv(kind, bq, s, d, dtype)
        plain = FA.flash_attention_plain(q, k, v, FA.flash_schedule(
            q.shape, k.shape, kind=kind, window=window, block_q=bq,
            block_k=bk))
        want = _ATTN_REF(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                         kind=kind, window=window)
        _jax_close(plain, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ragged_seq_pos_and_compact_kv(dtype):
    # seq_pos scalar / per row, with a window, at 72-token blocks; and a
    # rectangular local band whose compact K/V start at block s0 > 0
    q, k, v = _qkv(3, 4, 2, 144, 216, 64, dtype, 11)
    for p, win in ((100, 0), ([37, 215, 72], 0), ([37, 215, 150], 50)):
        pos = torch.as_tensor(np.broadcast_to(p, (3,)).copy(),
                              dtype=torch.int32)
        check_case(q, k, v, dict(kind="full", window=win, block_q=72,
                                 block_k=72), pos)
    q, k, v = _qkv(1, 4, 2, 72, 288, 40, dtype, 12)
    full = FA.flash_schedule(q.shape, k.shape, kind="local", window=48,
                             block_q=24, block_k=24)
    kc, vc = (pack_kv(t, full.domain, 24).contiguous() for t in (k, v))
    kw = dict(kind="local", window=48, block_q=24, block_k=24,
              storage="compact", kv_seq_len=288)
    assert FA.flash_schedule(q.shape, kc.shape, **kw).s0 > 0
    comp = check_case(q, kc, vc, kw)
    assert torch.equal(comp, FA.flash_attention_plain(q, k, v, full))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,block,s,d", [("causal", 72, 144, 64),
                                            ("local", 24, 96, 256)])
def test_plain_matches_tpu_interpret_at_ragged_blocks(kind, block, s, d,
                                                      dtype):
    q, k, v = _qkv(1, 2, 1, s, s, d, dtype, block + d)
    kw = dict(kind=kind, window=2 * block if kind == "local" else 0,
              block_q=block, block_k=block)
    plain = FA.flash_attention_plain(q, k, v, FA.flash_schedule(
        q.shape, k.shape, **kw))
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jops.flash_attention(*(jnp.asarray(t.float().numpy()).astype(jd)
                                  for t in (q, k, v)),
                                grid_mode="closed_form", **kw)
    _jax_close(plain, np.asarray(want.astype(jnp.float32)), dtype)


#: head rows that are no whole number of 16-byte pieces, by the piece
#: the loaders copy them in: f32 D 62 (8 bytes), D 37 (4); bf16 D 60 (8),
#: D 250 (4), D 37 (2: the register path)
NARROW_ROWS = [(torch.float32, 62), (torch.float32, 37),
               (torch.bfloat16, 60), (torch.bfloat16, 250),
               (torch.bfloat16, 37)]


@pytest.mark.parametrize("dtype,d,w,threads", [
    (torch.float32, 64, 16, 256), (torch.float32, 62, 8, 256),
    (torch.float32, 37, 4, 160), (torch.bfloat16, 64, 16, 256),
    (torch.bfloat16, 60, 8, 160), (torch.bfloat16, 250, 4, 160),
    (torch.bfloat16, 37, 2, 256), (torch.bfloat16, 255, 2, 160),
    (torch.float32, 255, 4, 64)])
def test_narrow_pieces_land_every_value_once(dtype, d, w, threads):
    # one sub-tile of 40 rows padded to 48, the tensor ending at its last
    # row, in pieces of w bytes (rows of more pieces than threads take
    # several a thread): each value lands once, the padding is zero, each
    # live value is read once and nothing past a row or the tensor
    assert piece_bytes(d * (2 if dtype == torch.bfloat16 else 4)) == w
    cols = geometry(dtype, d)[2]
    src = torch.from_numpy(np.random.default_rng(d).normal(
        size=(3, d)).astype(np.float32)).to(dtype)
    flat = torch.cat([torch.zeros(37 * d, dtype=dtype), src.flatten(),
                      torch.ones(5, dtype=dtype)])[:40 * d]
    flat = torch.cat([flat[:37 * d], src.flatten()])
    slot = zfill_copy(flat, 0, d, 40, 48, d, cols, 64, threads)
    assert torch.equal(slot[37:40, :d], src.float())
    assert not slot[40:48, :cols].any() and not slot[:48, d:cols].any()
    assert slot[48:].isnan().all()


@pytest.mark.parametrize("dtype,d", NARROW_ROWS,
                         ids=[f"{'f32' if t == torch.float32 else 'bf16'}-{d}"
                              for t, d in NARROW_ROWS])
@pytest.mark.parametrize("block", [64, 72])
def test_narrow_rows_walk_matches_plain(block, dtype, d):
    # the loaders' narrow pieces and the store's single values at odd d,
    # under every lowering, against the plain version; the last rows of
    # q, k and v end their tensors
    q, k, v = _qkv(1, 2, 1, 2 * block, 2 * block, d, dtype, block + d)
    check_case(q, k, v, dict(kind="causal", block_q=block, block_k=block))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_matches_the_jax_reference_at_narrow_rows(dtype):
    for d in (37, 60, 62, 250):
        for kind, block, window in (("causal", 64, 0), ("local", 72, 72)):
            q, k, v = _qkv(1, 4, 2, 2 * block, 2 * block, d, dtype,
                           d + block)
            plain = FA.flash_attention_plain(q, k, v, FA.flash_schedule(
                q.shape, k.shape, kind=kind, window=window, block_q=block,
                block_k=block))
            want = _ATTN_REF(*(jnp.asarray(t.float().numpy())
                               for t in (q, k, v)), kind=kind, window=window)
            _jax_close(plain, want, dtype)
            if dtype in FA.ROW_RTOL:
                assert FA.row_rel_err(plain, torch.from_numpy(np.array(
                    want, np.float32))) <= FA.ROW_RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [37, 60, 62, 250])
def test_every_prefill_head_dim_takes_a_tile_path(d, dtype):
    # whatever pieces its rows take, a prefill call up to head dim 256
    # goes to the tensor cores, at square and ragged blocks
    for blk in (64, 72):
        sched = FA.flash_schedule((1, 2, 2 * blk, d), (1, 2, 2 * blk, d),
                                  block_q=blk, block_k=blk)
        assert FA.flash_route(sched, dtype) == \
            ("tc" if dtype == torch.bfloat16 else "tc_f32")


#: planted faults and the head dim each needs to show: f32 D 62 for a
#: piece one step too wide (16-byte pieces read past a row of 248 bytes),
#: f32 D 37 for the pair store that straddles a row's end
FAULTS = [("stale_rows", 64), ("live_pad", 64), ("store_pad", 64),
          ("wide_piece", 62), ("straddle_pair", 37)]


@pytest.mark.parametrize("fault,d", FAULTS, ids=[f for f, _ in FAULTS])
def test_planted_faults_fail_the_walk(fault, d):
    # a stale padded slot row (NaN garbage through p = 0), a padded key
    # left to key_live (it aliases the next block's keys), a padded query
    # row stored, a copy piece wider than the row's bytes allow, a pair
    # store across a row's end: each is caught
    q, k, v = _qkv(1, 2, 1, 216, 216, d, torch.float32, 3)
    kw = dict(kind="full", block_q=72, block_k=72)
    check_case(q, k, v, kw)
    with pytest.raises(AssertionError):
        check_case(q, k, v, kw, faults=(fault,))
