"""The tensor-core flash kernel (csrc/flash_attention.cu
flash_fwd_tc_kernel) without the card:

(a) a numpy emulation of its fragment maps -- the m16n8k16 A, B and C
    fragments, ldmatrix for Q and K, ldmatrix.trans for V, and the
    score-accumulator -> P A-fragment identity -- run over one warp's 16
    query rows and a few 64-key sub-tiles, equal to a dense float64
    product of the same bf16 operands rounded to f32;
(b) an emulation of the tile path's numerics (bf16 operands, scale after
    the product, the online softmax per 64-key sub-tile, p rounded to
    bf16 before p v) against tpu-interpret ``repro.kernels.ops.
    flash_attention`` and the port's plain version, within the bf16
    kernel tolerance 2e-2, the lowerings bit-equal to each other; and
    the per-row check of ``_compare`` fails an emulated stale ring slot
    that the elementwise tolerance passes;
(c) ``flash_route``: which calls take the tensor-core kernel (f32 prefill
    takes the 3xTF32 one, tests/test_torch_flash_tf32.py).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.compact import pack_kv
from repro_torch.core.plan import LOWERINGS
from torch_parity import as_f32, qkv_pair

FA = importlib.import_module("repro_torch.kernels.flash_attention")

#: the kernel's geometry (csrc/flash_attention.cu): 16 rows per warp,
#: 64-key sub-tiles, shared rows padded by 8 bf16
ROWS, SUB, PAD = 16, 64, 8
TOL = FA.TOLERANCE[torch.bfloat16]


# ---------------------------------------------------------------------------
# (a) fragment maps
# ---------------------------------------------------------------------------

def _bf16(x):
    """float32 values rounded to bf16 (round to nearest even), as f64."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).double().numpy()


def _ldmatrix(smem, addr, trans=False):
    """ldmatrix.x4 over a 2-D shared array: lane 8i + r gives the (row,
    col) of row r of matrix i; returns per lane 4 registers of 2 values.
    Plain: register i of lane (g, t) holds (g, 2t), (g, 2t+1) of matrix
    i; trans: (2t, g), (2t+1, g)."""
    out = np.zeros((32, 4, 2))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            for e in range(2):
                rr, cc = (2 * t + e, g) if trans else (g, 2 * t + e)
                row, col = addr(8 * i + rr)
                out[lane, i, e] = smem[row, col + cc]
    return out


def _mma(d, a, bx, by):
    """d (32, 4) += A (16 x 16) B (16 x 8) from lane fragments: a (32, 4,
    2), bx / by (32, 2), accumulated in float64."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for e in range(2):
            A[g, 2 * t + e] = a[lane, 0, e]
            A[g + 8, 2 * t + e] = a[lane, 1, e]
            A[g, 2 * t + 8 + e] = a[lane, 2, e]
            A[g + 8, 2 * t + 8 + e] = a[lane, 3, e]
            B[2 * t + e, g] = bx[lane, e]
            B[2 * t + 8 + e, g] = by[lane, e]
    D = A @ B
    for lane in range(32):
        g, t = lane // 4, lane % 4
        d[lane] += [D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
                    D[g + 8, 2 * t + 1]]


def _dense(frags):
    """The (16, 8 n) tile held by C fragments frags (n, 32, 4)."""
    out = np.zeros((16, 8 * len(frags)))
    for nt, d in enumerate(frags):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            out[g, 8 * nt + 2 * t:8 * nt + 2 * t + 2] = d[lane, :2]
            out[g + 8, 8 * nt + 2 * t:8 * nt + 2 * t + 2] = d[lane, 2:]
    return out


def _lane_offsets(lane):
    """The kernel's ldmatrix row/col offsets of one lane: (a_row, a_col),
    (k_row, k_col), (v_row, v_col)."""
    lrow, mi = lane & 7, lane >> 3
    return (((mi & 1) * 8 + lrow, (mi >> 1) * 8),
            ((mi >> 1) * 8 + lrow, (mi & 1) * 8),
            ((mi & 1) * 8 + lrow, (mi >> 1) * 8))


@pytest.mark.parametrize("d,nkeys", [(64, 128), (128, 64), (256, 192),
                                     (32, 48)])
def test_fragment_maps_give_the_dense_products(d, nkeys):
    rng = np.random.default_rng(d + nkeys)
    q = _bf16(rng.normal(size=(ROWS, d)))
    kk = _bf16(rng.normal(size=(nkeys, d)))
    vv = _bf16(rng.normal(size=(nkeys, d)))
    stride = d + PAD
    sq = np.zeros((ROWS, stride))
    sq[:, :d] = q
    # S per 64-key sub-tile, then P = bf16(S) into O, as the kernel loops
    o = np.zeros((d // 8, 32, 4))
    s_all = []
    for c in range(0, nkeys, SUB):
        n = min(SUB, nkeys - c)
        sk, sv = np.zeros((SUB, stride)), np.zeros((SUB, stride))
        sk[:n, :d], sv[:n, :d] = kk[c:c + n], vv[c:c + n]
        s = np.zeros((SUB // 8, 32, 4))
        for ks in range(d // 16):
            a = _ldmatrix(sq, lambda ln: (_lane_offsets(ln)[0][0],
                                          ks * 16 + _lane_offsets(ln)[0][1]))
            for np_ in range(n // 16):
                bb = _ldmatrix(sk, lambda ln: (
                    np_ * 16 + _lane_offsets(ln)[1][0],
                    ks * 16 + _lane_offsets(ln)[1][1]))
                _mma(s[2 * np_], a, bb[:, 0], bb[:, 1])
                _mma(s[2 * np_ + 1], a, bb[:, 2], bb[:, 3])
        s = s[:n // 8].astype(np.float32).astype(np.float64)
        s_all.append(_dense(s))
        for kk_ in range(n // 16):
            # the C -> A identity: two score n-tiles are one A tile
            pa = np.stack([s[2 * kk_][:, :2], s[2 * kk_][:, 2:],
                           s[2 * kk_ + 1][:, :2], s[2 * kk_ + 1][:, 2:]], 1)
            pa = _bf16(pa)
            for np_ in range(d // 16):
                bb = _ldmatrix(sv, lambda ln: (
                    kk_ * 16 + _lane_offsets(ln)[2][0],
                    np_ * 16 + _lane_offsets(ln)[2][1]), trans=True)
                _mma(o[2 * np_], pa, bb[:, 0], bb[:, 1])
                _mma(o[2 * np_ + 1], pa, bb[:, 2], bb[:, 3])
    s_dense = (q @ kk.T).astype(np.float32)
    np.testing.assert_array_equal(np.concatenate(s_all, 1), s_dense)
    o_dense = (_bf16(s_dense) @ vv).astype(np.float32)
    np.testing.assert_array_equal(_dense(o).astype(np.float32), o_dense)


# ---------------------------------------------------------------------------
# (b) the tile path's numerics
# ---------------------------------------------------------------------------

def tc_numerics(q, k, v, sched, pos=None):
    """What flash_fwd_tc_kernel computes, as tensor math on bf16 q, k, v:
    every query-block row walks its key blocks in order, each in 64-key
    sub-tiles; s = (q k^T in f32) * scale, masked with -1e30; the online
    softmax updates per sub-tile; p is rounded to bf16 before p v, l sums
    the f32 p; out = acc / l (l == 0 -> 1) in bf16."""
    b, h, sq, d = q.shape
    hkv, g, bq, bk = sched.hkv, sched.group, sched.block_q, sched.block_k
    qf = q.float().reshape(b, hkv, g, sched.m_q, bq, d)
    kf = k.float().reshape(b, hkv, sched.kv_blocks, bk, d)
    vf = v.float().reshape(b, hkv, sched.kv_blocks, bk, d)
    bounds = torch.from_numpy(sched.row_bounds()).long()
    start = bounds[:, 0].expand(b, sched.m_q)
    end = bounds[:, 1].expand(b, sched.m_q)
    start, end, nsteps = FA._extents(start, end, pos, sched.kind,
                                     sched.window, bk)
    bidx = torch.arange(b)[:, None]
    qb = torch.arange(sched.m_q)[None, :]
    qpos = (sched.off + torch.arange(sched.m_q)[:, None] * bq
            + torch.arange(bq)[None, :])[None, None, None, :, :, None]
    acc = qf.new_zeros(qf.shape)
    m = qf.new_full(qf.shape[:-1] + (1,), FA.NEG_INF)
    l = qf.new_zeros(qf.shape[:-1] + (1,))
    for j in range(nsteps):
        kb = start + j
        live = kb <= end
        if sched.lowering == "bounding":
            live = live & torch.as_tensor(sched.member(kb, qb))
        kv = (kb - sched.s0).clamp(0, sched.kv_blocks - 1)
        kt = kf[bidx, :, kv].permute(0, 2, 1, 3, 4)
        vt = vf[bidx, :, kv].permute(0, 2, 1, 3, 4)
        upd = live[:, None, None, :, None, None]
        for c in range(0, bk, SUB):
            ks, vs = kt[..., c:c + SUB, :], vt[..., c:c + SUB, :]
            s = torch.einsum("bhgrqd,bhrkd->bhgrqk", qf, ks) * sched.scale
            kpos = (kb[:, :, None] * bk + c + torch.arange(ks.shape[-2]))[
                :, None, None, :, None, :]
            mask = torch.ones_like(s, dtype=torch.bool)
            if sched.kind != "full":
                mask = kpos <= qpos
                if sched.kind == "local":
                    mask = mask & (kpos > qpos - sched.window)
            if pos is not None:
                pp = pos.long()[:, None, None, None, None, None]
                pm = kpos <= pp
                if sched.kind == "full" and sched.window:
                    pm = pm & (kpos > pp - sched.window)
                mask = mask & pm
            s = torch.where(mask, s, FA.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            pv = torch.einsum("bhgrqk,bhrkd->bhgrqd",
                              p.to(torch.bfloat16).float(), vs)
            acc = torch.where(upd, acc * alpha + pv, acc)
            l = torch.where(upd, alpha * l + p.sum(-1, keepdim=True), l)
            m = torch.where(upd, m_new, m)
    l = torch.where(l == 0, 1.0, l)
    return (acc / l).reshape(b, h, sq, d).to(torch.bfloat16)


def _close(got, want):
    g, w = as_f32(got), as_f32(want)
    np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    return float(np.abs(g - w).max())


HEADS = {"MHA": (2, 2), "GQA": (4, 2), "MQA": (4, 1)}


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("kind", ["causal", "local", "full"])
def test_tile_numerics_match_jax_and_plain(kind, heads, d, block):
    h, hkv = HEADS[heads]
    s = 4 * block if kind == "local" else 2 * block
    window = 2 * block if kind == "local" else 0
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(1, h, hkv, s, s, d,
                                          seed=d + block, dtype="bfloat16")
    kw = dict(kind=kind, window=window, block_q=block, block_k=block)
    want = jops.flash_attention(jq, jk, jv, grid_mode="closed_form", **kw)
    # the plain version's lowerings are bit-equal (test_torch_flash.py)
    plain = FA.flash_attention_plain(tq, tk, tv, FA.flash_schedule(
        tq.shape, tk.shape, **kw))
    outs = []
    for gm in LOWERINGS:
        sched = FA.flash_schedule(tq.shape, tk.shape, grid_mode=gm, **kw)
        assert FA.flash_route(sched, tq.dtype) == "tc"
        outs.append(tc_numerics(tq, tk, tv, sched))
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    _close(outs[0], want)
    _close(outs[0], plain)


@pytest.mark.parametrize("grid_mode", LOWERINGS)
def test_tile_numerics_compact_kv_and_seq_pos(grid_mode):
    from repro.core.compact import pack_kv as j_pack_kv
    from repro.core.domain import make_attention_domain as j_dom
    # rectangular local, block_q 64: the first visited tile of the first
    # rows is wholly masked; compact K/V hold the band's support
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(1, 4, 2, 128, 512, 64, seed=11,
                                          dtype="bfloat16")
    kw = dict(kind="local", window=128, block_q=64, block_k=64)
    emb = FA.flash_schedule(tq.shape, tk.shape, grid_mode=grid_mode, **kw)
    tkc = pack_kv(tk, emb.domain, 64).contiguous()
    tvc = pack_kv(tv, emb.domain, 64).contiguous()
    comp = FA.flash_schedule(tq.shape, tkc.shape, grid_mode=grid_mode,
                             storage="compact", kv_seq_len=512, **kw)
    got = tc_numerics(tq, tkc, tvc, comp)
    assert torch.equal(got, tc_numerics(tq, tk, tv, emb))
    jd = j_dom("local", 2, 8, 3)
    want = jops.flash_attention(jq, j_pack_kv(jk, jd, 64),
                                j_pack_kv(jv, jd, 64), storage="compact",
                                kv_seq_len=512, grid_mode=grid_mode, **kw)
    _close(got, want)
    _close(got, FA.flash_attention_plain(tq, tkc, tvc, comp))
    # seq_pos at block_q 64: per-row positions, full and full + window
    (jq, jk, jv), (tq, tk, tv) = qkv_pair(3, 4, 2, 64, 256, 64, seed=12,
                                          dtype="bfloat16")
    for pos, window in ((200, 0), ([37, 255, 128], 0), ([37, 255, 128], 80)):
        kw = dict(kind="full", window=window, block_q=64, block_k=64,
                  grid_mode=grid_mode)
        sched = FA.flash_schedule(tq.shape, tk.shape, has_pos=True, **kw)
        assert FA.flash_route(sched, tq.dtype) == "tc"
        pv = FA.seq_pos_vector(pos, 3, "cpu")
        got = tc_numerics(tq, tk, tv, sched, pv)
        _close(got, jops.flash_attention(jq, jk, jv, seq_pos=jnp.asarray(pos),
                                         **kw))
        _close(got, FA.flash_attention_plain(tq, tk, tv, sched, pv))


def test_row_check_fails_a_stale_sub_tile_inside_the_elementwise_tolerance():
    # the last query-block row (128 rows over ~4000 keys) reads 16 keys of
    # one sub-tile from its ring slot's earlier contents (two steps back
    # at two stages): every element stays within rtol = atol = 2e-2 of
    # the plain version, the rows move by ~0.2 of their norm
    _, (q, k, v) = qkv_pair(1, 1, 1, 4096, 4096, 256, seed=1,
                            dtype="bfloat16")
    sched = FA.flash_schedule(q.shape, k.shape, kind="causal")
    plain = FA.flash_attention_plain(q, k, v, sched)
    sound = tc_numerics(q, k, v, sched)
    assert FA._compare(sound, plain, "sound") <= TOL
    assert FA.row_rel_err(sound, plain) < FA.ROW_RTOL[torch.bfloat16] / 2
    ks, vs = k.clone(), v.clone()
    ks[..., 2560:2576, :] = k[..., 2432:2448, :]
    vs[..., 2560:2576, :] = v[..., 2432:2448, :]
    stale = sound.clone()
    stale[..., 3968:, :] = tc_numerics(q, ks, vs, sched)[..., 3968:, :]
    assert torch.allclose(stale.float(), plain.float(), rtol=TOL, atol=TOL)
    assert FA.row_rel_err(stale, plain) > 10 * FA.ROW_RTOL[torch.bfloat16]
    with pytest.raises(AssertionError, match="a row of the kernel's output"):
        FA._compare(stale, plain, "stale slot")


# ---------------------------------------------------------------------------
# (c) routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,shape,kw,route", [
    (torch.bfloat16, (1, 2, 256, 64), dict(), "tc"),
    (torch.bfloat16, (1, 2, 256, 256), dict(block_q=64, block_k=64), "tc"),
    (torch.bfloat16, (1, 2, 256, 16), dict(block_q=32, block_k=32), "tc"),
    (torch.bfloat16, (1, 2, 96, 48), dict(kind="full", block_q=48,
                                          block_k=48), "tc"),
    (torch.bfloat16, (1, 2, 1024, 64), dict(block_q=256, block_k=256), "tc"),
    (torch.float32, (1, 2, 256, 64), dict(), "tc_f32"),         # 3xTF32
    (torch.bfloat16, (1, 2, 256, 40), dict(), "tc"),             # d % 16 = 8
    (torch.bfloat16, (1, 2, 64, 64), dict(kind="full", block_q=8,
                                          block_k=8), "tc"),
    (torch.bfloat16, (1, 2, 96, 64), dict(kind="full", block_q=24,
                                          block_k=24), "tc"),
    (torch.bfloat16, (1, 2, 1, 64), dict(kind="full", block_q=1,
                                         block_k=64), "tc"),
    (torch.bfloat16, (1, 2, 256, 36), dict(), "tc"),             # d % 8
    (torch.bfloat16, (1, 2, 256, 37), dict(), "tc"),             # odd d
    (torch.bfloat16, (1, 2, 256, 250), dict(), "tc"),            # 4-byte
    (torch.bfloat16, (1, 2, 96, 1), dict(kind="full", block_q=24,
                                         block_k=24), "tc"),
    (torch.bfloat16, (1, 2, 256, 264), dict(), "cuda_core"),     # d > 256
    (torch.float16, (1, 2, 256, 64), dict(), "cuda_core"),
])
def test_flash_route_picks_the_tensor_core_kernel_by_rule(dtype, shape, kw,
                                                         route):
    sched = FA.flash_schedule(shape, shape, **kw)
    assert FA.flash_route(sched, dtype) == route


def test_flash_route_keeps_decode_on_the_cuda_cores():
    # decode (block_q = 1 with seq_pos) and the paged kernel's shapes never
    # take a tensor-core kernel, whatever the dtype: they take the split-K
    # decode kernel on the CUDA cores, the routine the paged kernel runs
    for dtype in (torch.bfloat16, torch.float32):
        sched = FA.flash_schedule((4, 16, 1, 256), (4, 8, 1664, 256),
                                  kind="full", window=1024, block_q=1,
                                  block_k=128, has_pos=True)
        assert FA.flash_route(sched, dtype) == "decode"
    assert set(FA.KERNELS) == {"flash_attention", "flash_attention_decode",
                               "flash_attention_tc",
                               "flash_attention_tc_f32",
                               "paged_flash_attention"}


def test_flash_route_sends_misaligned_tensors_to_the_cuda_cores():
    # the tc kernel copies 16-byte pieces: a bf16 view that starts off a
    # 16-byte boundary keeps the tensor-core route, decided from shape and
    # dtype alone before launch (flash_cuda copies such a view to an
    # aligned buffer first, which _aligned detects)
    shape = (1, 2, 256, 64)
    sched = FA.flash_schedule(shape, shape)
    assert FA.flash_route(sched, torch.bfloat16) == "tc"
    base = torch.zeros(1 + 2 * 256 * 64, dtype=torch.bfloat16)
    assert FA._aligned(base[:-1].view(shape))
    assert not FA._aligned(base[:-1].view(shape), base[1:].view(shape))
    assert FA._aligned(base[1:].view(shape).clone())


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    FA.reset_launch_counts()
    _, (tq, tk, tv) = qkv_pair(1, 2, 2, 128, 128, 64, seed=13,
                               dtype="bfloat16")
    out = FA.flash_attention(tq, tk, tv, block_q=64, block_k=64)
    sched = FA.flash_schedule(tq.shape, tk.shape, block_q=64, block_k=64)
    assert torch.equal(out, FA.flash_attention_plain(tq, tk, tv, sched))
    assert FA.launch_counts() == {name: 0 for name in FA.KERNELS}
    with pytest.raises(ValueError, match="CUDA tensors"):
        FA.flash_tc_cuda(tq, tk, tv, sched)
