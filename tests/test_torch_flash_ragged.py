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

Asserted at block_q, block_k in {1, 8, 24, 40, 72, 100} and d in {40,
64, 72, 256} (and f32 at d 36 / 132, rows of 4 mod 8 values): every key
of every visited block is read exactly once a pass; every padded key and
row is zero and every padded key's p is 0; no padded row is stored; the
lowerings are bit-equal; the emulation agrees with
``flash_attention_plain`` within the kernels' tolerances (f32 2e-5, bf16
2e-2 with ``ROW_RTOL``), and the plain version with the JAX package's
``repro.kernels.ref.attention_ref`` and tpu-interpret
``repro.kernels.ops.flash_attention`` at those blocks.  The constants
mirror the kernel: 16-row warps, the sub-tiles, the rows a pass.
"""
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


def geometry(dtype, d):
    """(keys a sub-tile, rows a pass, columns a shared row holds, exact)
    of the tile path of ``dtype`` at head dim d: tf32_sub,
    tf32_rows_per_pass, d up to the k-step (16 bf16, 8 f32), and whether
    the f32 path's exact loops run (d is the instantiation's 64, 128 or
    256: every sub-tile then covers its whole kSub keys, the run's last
    one zero-filled up to them)."""
    f32 = dtype == torch.float32
    wide = f32 and d > HALF
    step = 8 if f32 else 16
    return ((32 if wide else 64), (64 if wide else 128), -(-d // step) * step,
            f32 and d in (64, 128, 256))


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


def zfill_copy(src, rows, rows_pad, cols, cols_pad, slot_rows, faults=()):
    """copy_rows_zfill into a shared slot of ``slot_rows`` rows that held
    garbage: rows [0, rows_pad) x columns [0, cols_pad) land, those at or
    past ``rows`` / ``cols`` as zeros; the rest keeps its garbage.
    ``faults``: "stale_rows" leaves the padded rows as they were."""
    dst = torch.full((slot_rows, cols_pad + 8), float("nan"))
    dst[:rows, :cols] = src[:rows, :cols].float()
    dst[:rows_pad, cols:cols_pad] = 0.0
    if "stale_rows" not in faults:
        dst[rows:rows_pad, :cols_pad] = 0.0
    return dst


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
    padded row stored past the last block counts too).  ``faults``
    plants a fault: "stale_rows" (padded slot rows not zero-filled),
    "live_pad" (padded keys masked by key_live alone)."""
    bf16 = q.dtype == torch.bfloat16
    b, h, sq, d = q.shape
    bq, bk, g = sched.block_q, sched.block_k, sched.group
    sub, npass, cols, exact = geometry(q.dtype, d)
    bounds = sched.row_bounds()
    out = torch.full((b, h, sq, d), float("nan"))
    stored = torch.zeros((b, h, sq + ROWS), dtype=torch.int64)
    log = {"reads": [], "visited": [], "stored": stored}
    for bi in range(b):
        pb = None if pos is None else int(pos[bi])
        for hi in range(h):
            kvh = hi // g
            for qb in range(sched.m_q):
                start, end = row_extent(sched, bounds, qb, pb)
                first, nrun = run_keys(sched, start, end, qb)
                kv0 = min(max(first - sched.s0, 0), sched.kv_blocks - 1)
                for row0 in range(0, bq, npass):
                    nrows = min(npass, bq - row0)
                    qrow0 = qb * bq + row0
                    sq_ = zfill_copy(q[bi, hi, qrow0:qrow0 + nrows], nrows,
                                     round16(nrows), d, cols, npass, faults)
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
                        ks = zfill_copy(k[bi, kvh, r0:r0 + rows], rows, pad,
                                        d, cols, sub, faults)[:pad, :cols]
                        vs = zfill_copy(v[bi, kvh, r0:r0 + rows], rows, pad,
                                        d, cols, sub, faults)[:pad, :cols]
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
                    for r in range(nstore):
                        stored[bi, hi, qrow0 + r] += 1
                        if qrow0 + r < sq:
                            out[bi, hi, qrow0 + r] = res[r, :d]
    return out.to(q.dtype), log


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
        stored = log["stored"]
        assert (stored[..., :q.shape[2]] == 1).all()
        assert not stored[..., q.shape[2]:].any()
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


@pytest.mark.parametrize("fault", ["stale_rows", "live_pad", "store_pad"])
def test_planted_faults_fail_the_walk(fault):
    # a stale padded slot row (NaN garbage through p = 0), a padded key
    # left to key_live (it aliases the next block's keys), a padded query
    # row stored: each is caught
    q, k, v = _qkv(1, 2, 1, 216, 216, 64, torch.float32, 3)
    kw = dict(kind="full", block_q=72, block_k=72)
    check_case(q, k, v, kw)
    with pytest.raises(AssertionError):
        check_case(q, k, v, kw, faults=(fault,))
