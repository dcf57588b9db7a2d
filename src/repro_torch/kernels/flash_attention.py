"""Block-space flash attention and paged decode.

The (q_block, k_block) pairs of causal attention form a lower-triangular
block domain -- the 2-simplex case of the block-space program -- and
local attention a band.  ``flash_attention`` visits exactly the member
tiles of the domain, one CTA per (batch * head, query-block row) with an
in-kernel loop over that row's key-block extent (the JAX package's gpu
structure).  ``grid_mode`` selects where the extent comes from:

* ``closed_form`` (alias ``compact``) -- the row bounds in closed form;
* ``prefetch_lut`` -- the host-built ``GridPlan.row_extents()`` table,
  an int32 (m_q, 2) device tensor memoized per domain and device;
* ``bounding`` -- the full key range, skipping the tiles outside the
  domain (the JAX package computes and discards them; the result is the
  same);
* ``mma`` -- the extents built on the device by the membership matmuls
  of :func:`repro_torch.core.mma.row_extents_chain`, memoized per domain
  and device, and walked like ``prefetch_lut``'s.

Compact KV (``storage="compact"``): ``kind="local"`` with ``sq < sk``
(queries are the last sq positions) touches only the last key blocks,
and compact storage reads K/V packed to exactly that support
(:func:`repro_torch.core.compact.pack_kv`); pass the true key length as
``kv_seq_len``.  ``seq_pos`` (decode, ``kind="full"`` only) masks keys
past each batch row's position, truncates the key loop at
``pos // block_k``, and with ``window=`` gives a run-time sliding window.

``paged_flash_attention`` is the single-token decode over a paged,
head-interleaved KV pool (:mod:`repro_torch.core.paged`), each logical
key block resolved to its physical page through the page table.  It and
the contiguous ``seq_pos`` decode are two front ends of one split-K
routine (``csrc/decode_split.cuh``: a CTA per (slot, kv head, split)
serving the whole GQA group, splits of ``DECODE_SPLIT_KEYS`` keys merged
in split order in the same launch), so at ``block_k == page_size`` paged
decode is bit-equal to the contiguous one.

Three kernels compute ``flash_attention`` on the card, picked by
:func:`flash_route` from the call's shape and dtype before any launch:
``flash_decode_kernel`` (``"decode"``: single-token ``kind="full"``
calls with ``seq_pos``); and on the tensor cores, with K/V streamed
through a cp.async ring, any block_q and block_k (padded to the next 16
inside the kernel) and any head dim up to 256 (rows copied in the widest
pieces of 16, 8, 4 or 2 bytes they are a whole number of),
``flash_fwd_tc_kernel`` (``"tc"``: every other bf16 call) and
``flash_fwd_tf32_kernel`` (``"tc_f32"``: every other f32 call, in
3xTF32), misaligned views copied to an aligned buffer first.  No route
takes the CUDA-core kernel ``flash_fwd_kernel`` (f32 arithmetic on the
CUDA cores): :func:`flash_cuda_core` launches it directly, as the
yardstick the tile paths are timed and checked against.

Each kernel sits beside its plain PyTorch version (the same row bounds,
tile order and masks as tensor index math, vectorized over rows and
heads).  The entry points follow the tensors' device: CUDA tensors
launch the kernels of ``csrc/flash_attention.cu`` (or raise), CPU
tensors run the plain versions, and ``meta`` tensors (the dry run,
:mod:`repro_torch.launch.dryrun`) launch nothing: they charge the
routed kernel's work to the dry run's counter and return an empty
output of the right shape.  Each CUDA wrapper counts its launches
in ``launches``.

``flash_attention``'s ``grid_mode``, ``block_q``, ``block_k``,
``num_warps`` and ``num_stages`` accept ``"auto"``: a lookup of the
``"flash"`` entry of the tune cache (:mod:`repro_torch.core.tune`) under
``{kind, batch, heads, kv_heads, sq, sk, d, window}`` and the tensors'
target, never a measurement; an untuned problem gets the JAX package's
defaults (closed_form, 128 x 128 blocks), an explicit value is never
overridden.  ``num_warps`` and ``num_stages`` are taken, whatever their
value, as the JAX package's TPU structure takes them, and give the same
bits: the port's kernels fix their warps and their ring depth per
instantiation (``tc_stages``, ``kTfStages`` in ``csrc/flash_attention.cu``),
so the tuner does not search them.  ``paged_flash_attention`` takes them
the same way and has no lookup of its own, as in the JAX package: its
``grid_mode="auto"`` is an unknown lowering, and the page size
:func:`repro_torch.core.tune.autotune_paged` picks is the caller's to
apply to its pool.

``mesh=`` (a DeviceMesh, :mod:`repro_torch.launch.mesh`) shards the
query-block axis over ``shard_axis``: each rank runs its band of whole
query-block rows (``shard_balance="contiguous"``), or its rows of the
causal snake (``"zigzag"``, Q permuted into snake order first and O
back after, :func:`repro_torch.core.shard.zigzag_row_order`), with K
and V replicated; the bands are then gathered along the sequence, and
every rank gets the global output.  A row's online softmax never
crosses ranks, so the result is bit-equal to the unsharded run.  On the
card each rank launches its tile path's sharded instantiation, whose
masks and extents read the band row's global row
(``fa_forward_tc_*_sharded``); :func:`flash_rank` runs one rank's band
without a process group.  Paged decode takes no mesh here: the serving
mesh shards both decode kernels' slots over its data axis in
:mod:`repro_torch.models.attention` (``decode_attention_flash`` /
``decode_attention_paged`` with ``mesh=``), each rank launching the
kernel on its slot group.

Forward only, as in the JAX package, whose training path takes the
plain-tensor flash VJP (:mod:`repro_torch.models.attention`).

``verify=True`` statically verifies the launch's plan before any launch
(:func:`verify_schedule`, the ``"flash"`` access model: coverage, tables
and the per-row key windows, with the extents table the launch reads):
the domain's plan, or under ``mesh=`` the sharded plan of the query rows;
the paged decode verifies the ``"full"`` key-block plan of its page
table.  A failing plan raises ``PlanVerificationError`` (a
``ValueError``) with nothing launched.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import memo
from repro_torch.core import mma
from repro_torch.core.compact import key_block_support
from repro_torch.core.domain import BlockDomain, make_attention_domain
from repro_torch.core.plan import GridPlan, normalize_lowering, normalize_storage

from . import _cuda
from .sierpinski_write import resolve_auto_schedule

NEG_INF = float(-1e30)  # avoid true -inf so exp() stays nan-free

#: the kernels' head dims (csrc/attention_common.cuh); their shared
#: memory per CTA (``fa_smem_bytes``) must fit the card's opt-in limit.
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)

#: order of the integer launch parameters (``Param`` in
#: csrc/attention_common.cuh)
ATTN_PARAMS = ("b", "h", "hkv", "sq", "d", "block_q", "block_k", "m_q",
               "m_k", "kind", "window", "off", "s0", "kv_blocks", "sk_arr",
               "lowering", "dom", "dom_w", "dom_off", "has_pos")
KIND_CODES = {"causal": 0, "local": 1, "full": 2}
LOWERING_CODES = {"closed_form": 0, "prefetch_lut": 1, "bounding": 2,
                  "mma": 3}
#: the lowerings whose kernel reads an extents table
TABLE_LOWERINGS = ("prefetch_lut", "mma")
DOM_ALL, DOM_TRIANGULAR, DOM_BAND = 0, 1, 2


def verify_schedule(sched: "FlashSchedule", device, num_shards=None,
                    shard_balance: str = "contiguous") -> None:
    """``verify=True``: statically verify the plan a flash launch of
    ``sched`` on ``device`` runs -- over the block domain with the
    (batch * heads) batch axis, sharded over ``num_shards`` query-row
    bands when given -- with the extents table the launch reads; raises
    ``PlanVerificationError`` on any finding."""
    from repro_torch.analysis.verifier import verify_or_raise
    from repro_torch.core.shard import ShardedPlan
    if num_shards is None:
        plan = GridPlan(sched.domain, sched.lowering,
                        batch_dims=(sched.b * sched.h,), backend=device)
    else:
        plan = ShardedPlan(
            sched.domain, sched.lowering, batch_dims=(sched.b * sched.h,),
            backend=device, num_shards=num_shards,
            partition="zigzag" if shard_balance == "zigzag" else "rows")
    ext = sched.row_extents(device) \
        if sched.lowering in TABLE_LOWERINGS else None
    verify_or_raise(plan, kernel="flash", device=device, row_extents=ext)


# ---------------------------------------------------------------------------
# the schedule: validation and row bounds
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlashSchedule:
    """One flash launch after the JAX package's ``_flash_impl``
    validation: shapes, block geometry, the block domain and its
    lowering, and the compact-KV shift ``s0``."""

    b: int
    h: int
    hkv: int
    sq: int
    sk: int
    sk_arr: int
    d: int
    kind: str
    window: int
    scale: float
    block_q: int
    block_k: int
    m_q: int
    m_k: int
    wb: int
    off: int
    s0: int
    lowering: str
    domain: BlockDomain
    has_pos: bool = False

    @property
    def group(self) -> int:
        return self.h // self.hkv

    @property
    def kv_blocks(self) -> int:
        return self.m_k - self.s0

    def row_bounds(self) -> np.ndarray:
        """(m_q, 2) int32 [start, end] of every query-block row before
        the seq_pos clamp, as the lowering computes it."""
        if self.lowering == "prefetch_lut":
            return GridPlan(self.domain, "prefetch_lut",
                            backend="cpu").row_extents()
        if self.lowering == "mma":
            return mma.row_extents_chain(self.domain).numpy()
        qb = np.arange(self.m_q, dtype=np.int64)
        if self.lowering == "bounding" or self.kind == "full":
            lo, hi = np.zeros_like(qb), np.full_like(qb, self.m_k - 1)
        elif self.kind == "causal":
            lo, hi = np.zeros_like(qb), qb
        else:
            off_b = self.off // self.block_q
            lo = np.maximum(qb + off_b - (self.wb - 1), 0)
            hi = qb + off_b
        return np.stack([lo, hi], -1).astype(np.int32)

    def row_extents(self, device) -> torch.Tensor:
        """The extents table of a TABLE_LOWERINGS launch as an int32
        (m_q, 2) tensor on ``device``, memoized per (domain, lowering,
        device): prefetch_lut's host table copied over, or mma's built
        on ``device`` by :func:`mma.row_extents_chain`."""
        device = torch.device(device)

        def build():
            if self.lowering == "mma":
                return mma.row_extents_chain(self.domain, device)
            return torch.from_numpy(self.row_bounds()).to(device)
        return memo.cached("flash-row-extents", self.domain,
                           (self.lowering, str(device)), build)

    def member(self, kb, qb):
        """Block-domain membership of key block kb in query row qb (the
        bounding lowering's skip test)."""
        if getattr(self.domain, "always_member", False):
            return torch.ones_like(kb, dtype=torch.bool) \
                if isinstance(kb, torch.Tensor) else True
        return self.domain.contains(kb, qb)

    def _dom(self) -> Tuple[int, int, int]:
        if self.lowering != "bounding" or getattr(
                self.domain, "always_member", False):
            return DOM_ALL, 0, 0
        if self.kind == "causal":
            return DOM_TRIANGULAR, 0, 0
        return DOM_BAND, self.domain.w, self.domain.off

    def c_params(self, has_pos: bool) -> ctypes.Array:
        dom, dom_w, dom_off = self._dom()
        vals = dict(b=self.b, h=self.h, hkv=self.hkv, sq=self.sq, d=self.d,
                    block_q=self.block_q, block_k=self.block_k,
                    m_q=self.m_q, m_k=self.m_k,
                    kind=KIND_CODES[self.kind], window=self.window,
                    off=self.off, s0=self.s0, kv_blocks=self.kv_blocks,
                    sk_arr=self.sk_arr,
                    lowering=LOWERING_CODES[self.lowering], dom=dom,
                    dom_w=dom_w, dom_off=dom_off, has_pos=int(has_pos))
        return (ctypes.c_longlong * len(ATTN_PARAMS))(
            *[int(vals[name]) for name in ATTN_PARAMS])


def flash_schedule(q_shape, k_shape, *, kind: str = "causal",
                   window: int = 0, scale: Optional[float] = None,
                   block_q: int = 128, block_k: int = 128,
                   grid_mode: str = "compact", storage: str = "embedded",
                   kv_seq_len: Optional[int] = None,
                   has_pos: bool = False) -> FlashSchedule:
    """Validate a flash launch exactly as the JAX package's
    ``_flash_impl`` does (same ``ValueError``\\ s, raised before any
    launch) and return its :class:`FlashSchedule`."""
    b, h, sq, d = (int(x) for x in q_shape)
    _, hkv, sk_arr, _ = (int(x) for x in k_shape)
    if scale is None:
        scale = float(1.0 / np.sqrt(d))
    lowering = normalize_lowering(grid_mode)
    storage = normalize_storage(storage)
    sk = kv_seq_len if kv_seq_len is not None else sk_arr
    if kind == "local":
        # rectangular local (sq < sk) still needs square blocks: clamp
        # both to one value instead of letting min(.., sq) / min(.., sk)
        # diverge
        block_q = block_k = min(block_q, block_k, sq, sk)
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError("sequence must be divisible by block size")
    m_q, m_k = sq // block_q, sk // block_k

    wb = 0
    if kind == "causal" and (sq != sk or block_q != block_k):
        raise ValueError("causal requires a square block grid")
    if kind == "local":
        if block_q != block_k or window % block_k:
            raise ValueError("local: need block_q == block_k | window")
        if (sk - sq) % block_k:
            raise ValueError("local: Sk - Sq must be block-aligned")
        wb = window // block_k + 1
    off = sk - sq if kind == "local" else 0
    if has_pos and kind != "full":
        raise ValueError(
            f"seq_pos requires kind='full' (got kind={kind!r}); pass "
            f"window= for a run-time sliding window anchored at "
            f"seq_pos")

    domain = make_attention_domain(kind, m_q, m_k, wb)
    # compact KV: k/v hold only the key blocks in [s0, m_k)
    s0 = key_block_support(domain)[0] if storage == "compact" else 0
    if sk_arr != sk - s0 * block_k:
        raise ValueError(
            f"{storage} storage expects k/v of {sk - s0 * block_k} key "
            f"positions (support blocks [{s0}, {m_k}) of sk={sk}), got "
            f"{sk_arr}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"q heads ({h}) must be a multiple of the kv "
                         f"heads ({hkv})")
    return FlashSchedule(b=b, h=h, hkv=hkv, sq=sq, sk=sk, sk_arr=sk_arr,
                         d=d, kind=kind, window=int(window),
                         scale=float(scale), block_q=block_q,
                         block_k=block_k, m_q=m_q, m_k=m_k, wb=wb, off=off,
                         s0=s0, lowering=lowering, domain=domain,
                         has_pos=bool(has_pos))


def seq_pos_vector(seq_pos, b: int, device) -> Optional[torch.Tensor]:
    """seq_pos as a (B,) int32 tensor on ``device``: a scalar (or a
    1-vector) broadcasts, a (B,) vector carries one position per row."""
    if seq_pos is None:
        return None
    sp = torch.as_tensor(seq_pos).to(device=device, dtype=torch.int32)
    if sp.ndim == 0 or tuple(sp.shape) == (1,):
        return sp.reshape(()).expand(b).contiguous()
    if tuple(sp.shape) != (b,):
        raise ValueError(
            f"seq_pos must be a scalar or a ({b},) per-row vector, got "
            f"shape {tuple(sp.shape)}")
    return sp.contiguous()


def _check_qkv(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(
            f"expected q (B, H, Sq, D) and k, v (B, Hkv, Sk, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"k/v batch and head dim must match q's: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}")


# ---------------------------------------------------------------------------
# plain versions: the same tiles, masks and order as tensor index math
# ---------------------------------------------------------------------------

def _attend_plain(qf, tiles, start, end, nsteps, *, kind, window,
                  block_k, qpos, pos, member=None):
    """The online-softmax loop shared by both plain versions.

    qf: (B, Hkv, G, R, BQ, D) pre-scaled f32 queries (R query-block
    rows); start/end: (B, R) key-block extents; ``tiles(kb)`` returns
    the f32 (K, V) tiles of key blocks kb (B, R), each (B, Hkv, R, BK,
    D).  Step j updates row r with tile start + j where that lies in
    [start, end] (and ``member(kb)`` holds).  qpos: (R, BQ) query
    positions; pos: (B,) decode positions or None.  Returns (acc, l)."""
    b, hkv, g, rows, bq, d = qf.shape
    acc = qf.new_zeros((b, hkv, g, rows, bq, d))
    m = qf.new_full((b, hkv, g, rows, bq, 1), NEG_INF)
    l = qf.new_zeros((b, hkv, g, rows, bq, 1))
    kidx = torch.arange(block_k, device=qf.device)
    for j in range(nsteps):
        kb = start + j                                    # (B, R)
        live = kb <= end
        if member is not None:
            live = live & member(kb)
        kt, vt = tiles(kb)
        s = torch.einsum("bhgrqd,bhrkd->bhgrqk", qf, kt)
        kpos = (kb[:, :, None] * block_k + kidx)[:, None, None, :, None, :]
        mask = None
        if kind in ("causal", "local"):
            qp = qpos[None, None, None, :, :, None]
            mask = kpos <= qp
            if kind == "local":
                mask = mask & (kpos > qp - window)
        if pos is not None:
            pp = pos.long()[:, None, None, None, None, None]
            pm = kpos <= pp
            if kind == "full" and window:
                pm = pm & (kpos > pp - window)
            mask = pm if mask is None else mask & pm
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_new = alpha * l + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum("bhgrqk,bhrkd->bhgrqd", p, vt)
        upd = live[:, None, None, :, None, None]
        acc = torch.where(upd, acc_new, acc)
        m = torch.where(upd, m_new, m)
        l = torch.where(upd, l_new, l)
    return acc, torch.where(l == 0, 1.0, l)


def _extents(start, end, pos, kind, window, block_k, cap=None):
    """Apply the seq_pos clamp to (B, R) extents; returns (start, end,
    nsteps)."""
    if pos is not None:
        p = pos.long()[:, None]
        end = torch.minimum(end, torch.div(p, block_k, rounding_mode="floor"))
        if kind == "full" and window:
            lo = torch.div((p - window + 1).clamp(min=0), block_k,
                           rounding_mode="floor")
            start = torch.maximum(start, lo)
    if cap is not None:
        end = end.clamp(max=cap)
    nsteps = int((end - start + 1).max().clamp(min=0)) if end.numel() else 0
    return start, end, nsteps


def flash_attention_plain(q, k, v, sched: FlashSchedule,
                          pos: Optional[torch.Tensor] = None,
                          rows: Optional[torch.Tensor] = None):
    """Plain version of the flash kernel: every query-block row walks
    its key-block extent in step order, all rows and heads at once.
    ``rows`` (a sharded band): the global query-block rows that ``q``'s
    block rows are, in order (every row of the schedule by default)."""
    b, h, sq, d = q.shape
    hkv, g, bq, bk = sched.hkv, sched.group, sched.block_q, sched.block_k
    dev = q.device
    if rows is None:
        rows = torch.arange(sched.m_q, device=dev)
    rows = rows.to(dev, torch.int64)
    m_q = rows.numel()
    qf = (q.to(torch.float32) * sched.scale).reshape(b, hkv, g, m_q, bq, d)
    kf = k.to(torch.float32).reshape(b, hkv, sched.kv_blocks, bk, d)
    vf = v.to(torch.float32).reshape(b, hkv, sched.kv_blocks, bk, d)
    if sched.lowering == "mma":
        bounds = sched.row_extents(dev).to(torch.int64)
    else:
        bounds = torch.from_numpy(sched.row_bounds()).to(dev, torch.int64)
    bounds = bounds[rows]
    start = bounds[:, 0].expand(b, m_q)
    end = bounds[:, 1].expand(b, m_q)
    start, end, nsteps = _extents(start, end, pos, sched.kind,
                                  sched.window, bk)
    bidx = torch.arange(b, device=dev)[:, None]

    def tiles(kb):
        kv = (kb - sched.s0).clamp(0, sched.kv_blocks - 1)
        return (kf[bidx, :, kv].permute(0, 2, 1, 3, 4).contiguous(),
                vf[bidx, :, kv].permute(0, 2, 1, 3, 4).contiguous())

    qb = rows[None, :]
    member = None
    if sched.lowering == "bounding" and not getattr(
            sched.domain, "always_member", False):
        member = lambda kb: sched.member(kb, qb)  # noqa: E731
    qpos = sched.off + rows[:, None] * bq \
        + torch.arange(bq, device=dev)[None, :]
    acc, l = _attend_plain(qf, tiles, start, end, nsteps, kind=sched.kind,
                           window=sched.window, block_k=bk, qpos=qpos,
                           pos=pos, member=member)
    return (acc / l).reshape(b, h, sq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# paged decode: schedule and plain version
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PagedSchedule:
    """One paged decode launch after ``_paged_impl``'s validation."""

    b: int
    h: int
    hkv: int
    d: int
    page_size: int
    max_pages: int
    window: int
    scale: float

    @property
    def group(self) -> int:
        return self.h // self.hkv

    def c_params(self) -> ctypes.Array:
        vals = dict(b=self.b, h=self.h, hkv=self.hkv, sq=1, d=self.d,
                    block_q=1, block_k=self.page_size, m_q=1,
                    m_k=self.max_pages, kind=KIND_CODES["full"],
                    window=self.window, off=0, s0=0,
                    kv_blocks=self.max_pages, sk_arr=0, lowering=0,
                    dom=DOM_ALL, dom_w=0, dom_off=0, has_pos=1)
        return (ctypes.c_longlong * len(ATTN_PARAMS))(
            *[int(vals[name]) for name in ATTN_PARAMS])


def paged_schedule(q_shape, pool_shape, table_shape, *, window: int = 0,
                   scale: Optional[float] = None) -> PagedSchedule:
    """Validate a paged decode as the JAX package's ``_paged_impl``."""
    b, h, sq, d = (int(x) for x in q_shape)
    if sq != 1:
        raise ValueError(f"paged decode is single-token: Sq={sq}")
    num_pages, h2, page_size, dp = (int(x) for x in pool_shape)
    if h2 % 2 or dp != d:
        raise ValueError(
            f"kv_pool must be (P, 2*Hkv, page_size, {d}), got "
            f"{tuple(pool_shape)}")
    hkv = h2 // 2
    if len(table_shape) != 2:
        raise ValueError(f"page_table must be (slots, max_pages), got "
                         f"{tuple(table_shape)}")
    if table_shape[0] != b:
        raise ValueError(
            f"page_table rows ({table_shape[0]}) != slots ({b})")
    if hkv < 1 or h % hkv:
        raise ValueError(f"q heads ({h}) must be a multiple of the kv "
                         f"heads ({hkv})")
    if scale is None:
        scale = float(1.0 / np.sqrt(d))
    return PagedSchedule(b=b, h=h, hkv=hkv, d=d, page_size=page_size,
                         max_pages=int(table_shape[1]), window=int(window),
                         scale=float(scale))


def paged_attention_plain(q, kv_pool, page_table, pos,
                          sched: PagedSchedule):
    """Plain version of the paged decode kernel: per step, gather each
    slot's page and run the same online-softmax update as the contiguous
    ``seq_pos`` decode (bit-equal to it at block_k == page_size)."""
    b, h, _, d = q.shape
    hkv, g, ps = sched.hkv, sched.group, sched.page_size
    dev = q.device
    qf = (q.to(torch.float32) * sched.scale).reshape(b, hkv, g, 1, 1, d)
    pool = kv_pool.to(torch.float32).reshape(-1, hkv, 2, ps, d)
    table = page_table.to(dev, torch.int64)
    start = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    end = torch.full((b, 1), sched.max_pages - 1, dtype=torch.int64,
                     device=dev)
    start, end, nsteps = _extents(start, end, pos, "full", sched.window, ps,
                                  cap=sched.max_pages - 1)
    bidx = torch.arange(b, device=dev)[:, None]

    def tiles(kb):
        page = table[bidx, kb.clamp(0, sched.max_pages - 1)]   # (B, 1)
        t = pool[page]                                 # (B, 1, Hkv, 2, ps, d)
        return (t[:, :, :, 0].permute(0, 2, 1, 3, 4).contiguous(),
                t[:, :, :, 1].permute(0, 2, 1, 3, 4).contiguous())

    qpos = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    acc, l = _attend_plain(qf, tiles, start, end, nsteps, kind="full",
                           window=sched.window, block_k=ps, qpos=qpos,
                           pos=pos)
    return (acc / l).reshape(b, h, 1, d).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_SIGNATURES = {
    "fa_forward_f32": [_P, ctypes.c_float, _P, _P, _P, _P, _P, _P, _P],
    "fa_forward_bf16": [_P, ctypes.c_float, _P, _P, _P, _P, _P, _P, _P],
    "fa_forward_tc_bf16": [_P, ctypes.c_float, _P, _P, _P, _P, _P, _P, _P],
    "fa_forward_tc_f32": [_P, ctypes.c_float, _P, _P, _P, _P, _P, _P, _P],
    "fa_decode_f32": [_P, ctypes.c_float] + [_P] * 9,
    "fa_decode_bf16": [_P, ctypes.c_float] + [_P] * 9,
    "fa_paged_decode_f32": [_P, ctypes.c_float] + [_P] * 8,
    "fa_paged_decode_bf16": [_P, ctypes.c_float] + [_P] * 8,
}
#: keys per split of the decode kernels (``kSplitKeys`` in
#: csrc/decode_split.cuh; the library's value is checked against it when
#: it is loaded)
DECODE_SPLIT_KEYS = 256


def _lib() -> ctypes.CDLL:
    lib = _cuda.load("flash_attention")
    if not getattr(lib, "_repro_bound", False):
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name in ("fa_smem_bytes", "fa_tc_smem_bytes",
                     "fa_tc_f32_smem_bytes"):
            getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_longlong
        lib.fa_decode_scratch.argtypes = [_P, ctypes.c_int, ctypes.c_int]
        lib.fa_decode_scratch.restype = ctypes.c_longlong
        lib.fa_decode_smem_bytes.argtypes = [_P, ctypes.c_int]
        lib.fa_decode_smem_bytes.restype = ctypes.c_longlong
        lib.fa_decode_split_keys.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        if lib.fa_decode_split_keys() != DECODE_SPLIT_KEYS:
            raise RuntimeError(
                f"the decode kernels split {lib.fa_decode_split_keys()} "
                f"keys, the wrapper expects {DECODE_SPLIT_KEYS}")
        lib._repro_bound = True
    return lib


def _shard_lib() -> ctypes.CDLL:
    """The sharded half of the flash library (the tile paths' kShard
    instantiations, built from the same source with -DREPRO_SHARDED)."""
    lib = _cuda.load("flash_attention_sharded")
    if not getattr(lib, "_repro_bound", False):
        for name in ("fa_forward_tc_bf16_sharded",
                     "fa_forward_tc_f32_sharded"):
            fn = getattr(lib, name)
            fn.argtypes = [_P, ctypes.c_float] + [_P] * 8
            fn.restype = ctypes.c_int
        for name in ("fa_tc_smem_bytes", "fa_tc_f32_smem_bytes"):
            getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_longlong
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check_cuda(what: str, *tensors) -> None:
    """The kernels take contiguous CUDA tensors of one supported dtype on
    one device, head dims up to 256."""
    t0 = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != t0.device:
            raise ValueError(
                f"the {what} kernel needs CUDA tensors on one device, got "
                f"{[str(x.device) for x in tensors]}")
        if t.dtype != t0.dtype:
            raise TypeError(f"the {what} kernel needs one dtype, got "
                            f"{[x.dtype for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"the {what} kernel needs contiguous tensors")
    if t0.dtype not in DTYPES:
        raise TypeError(f"dtype {t0.dtype} is not supported; expected one "
                        f"of {DTYPES}")
    d = t0.shape[-1]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside the kernels' [1, "
                         f"{MAX_HEAD_DIM}]")


def _check_smem(device, need: int, what: str) -> None:
    """Raise unless ``need`` bytes of shared memory per CTA fit the card's
    opt-in limit; ``what`` names the geometry."""
    have = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(
            f"{what} needs {need} B of shared memory per CTA, more than "
            f"the card's {have}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


#: the f32 tensor-core kernel's widest head dim.  Up to d = 128 a warp
#: owns 16 query rows (128 a pass, 64-key sub-tiles); past 128 a pair of
#: warps shares them, each owning half of the output dims, 64 rows a pass
#: in 32-key sub-tiles: at d = 256 Q (65 KB), two K/V slots (130 KB) and
#: the pairs' partial scores (16 KB) take 211 KB of the 227 KB a CTA may
#: have
TF32_MAX_HEAD_DIM = 256


def flash_route(sched: FlashSchedule, dtype) -> str:
    """The flash kernel a launch takes, from shape and dtype alone:
    ``"decode"`` (flash_decode_kernel) for single-token ``kind="full"``
    calls with seq_pos, whatever the dtype and alignment (it loads 16-byte
    pieces where it can), so paged decode, which runs the same routine,
    stays bit-equal to it; on the tensor cores every other call up to
    head dim 256, for any block_q and block_k (a block that is not a
    multiple of 16 is padded to the next 16 inside the kernel, block_q = 1
    without seq_pos included) and any head dim (a row that is no whole
    number of 16-byte pieces is copied in 8-, 4- or 2-byte ones):
    ``"tc"`` (flash_fwd_tc_kernel) for bf16, ``"tc_f32"``
    (flash_fwd_tf32_kernel, 3xTF32) for f32; ``"cuda_core"`` only for
    what the entry points refuse before any launch (head dims past 256,
    dtypes outside ``DTYPES``).  A view that starts off a 16-byte boundary
    takes its route all the same: :func:`flash_cuda` copies it to an
    aligned buffer first."""
    if sched.has_pos and sched.sq == 1 and sched.kind == "full":
        return "decode"
    if dtype == torch.bfloat16 and sched.d <= MAX_HEAD_DIM:
        return "tc"
    if dtype == torch.float32 and sched.d <= TF32_MAX_HEAD_DIM:
        return "tc_f32"
    return "cuda_core"


def _aligned(*tensors) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch_flash(fn, q, k, v, sched: FlashSchedule, pos, what: str,
                  band=None, lib=None):
    """Run one flash kernel's C entry point ``fn`` (of ``lib``, the
    unsharded library by default); returns the output.  ``band``: a
    sharded launch's :class:`RowBand` (its shard parameters follow the
    output's address)."""
    if pos is not None and (pos.device != q.device
                            or pos.dtype != torch.int32):
        raise ValueError("seq_pos must be an int32 tensor on q's device")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ext = sched.row_extents(q.device) \
        if sched.lowering in TABLE_LOWERINGS else None
    params = sched.c_params(pos is not None) if band is None \
        else band.local(sched).c_params(False)
    extra = () if band is None else (band.c_params(),)
    with torch.cuda.device(q.device):
        status = fn(params, sched.scale, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), _cuda.ptr(ext), _cuda.ptr(pos),
                    out.data_ptr(), *extra, _stream(q.device))
    _cuda.raise_on(lib or _lib(), status, what)
    return out


def flash_cuda(q, k, v, sched: FlashSchedule,
               pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the flash kernel :func:`flash_route` picks: (B, H, Sq, D) in
    q's dtype.  A tile path's q, k or v that starts off a 16-byte boundary
    is copied to an aligned buffer first.  Each kernel's wrapper counts
    its launches (:func:`decode_cuda`, :func:`flash_tc_cuda`,
    :func:`flash_tc_f32_cuda`)."""
    _check_cuda("flash attention", q, k, v)
    route = flash_route(sched, q.dtype)
    if route in ("tc", "tc_f32"):
        q, k, v = (t if _aligned(t) else t.clone() for t in (q, k, v))
    return _ROUTES[route](q, k, v, sched, pos)


def flash_cuda_core(q, k, v, sched: FlashSchedule,
                    pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA-core flash kernel (flash_fwd_kernel: f32 arithmetic
    on the CUDA cores, K/V staged 32 keys at a time) on any call the
    entry points take, whatever :func:`flash_route` says: (B, H, Sq, D) in
    q's dtype.  No route takes it; it is the yardstick the tile paths are
    timed and checked against.  Raises where block_k's tiles at this head
    dim need more shared memory than the card has."""
    _check_cuda("flash attention", q, k, v)
    lib = _lib()
    _check_smem(q.device, lib.fa_smem_bytes(sched.d, sched.block_k),
                f"block_k={sched.block_k} at head dim {sched.d}")
    fn = lib.fa_forward_f32 if q.dtype == torch.float32 \
        else lib.fa_forward_bf16
    out = _launch_flash(fn, q, k, v, sched, pos, "flash attention kernel")
    if out.numel():
        flash_cuda_core.launches += 1
    return out


flash_cuda_core.launches = 0


def _launch_tile_path(route, q, k, v, sched, pos, takes: str):
    """Launch the tensor-core kernel of ``route`` ("tc" or "tc_f32") after
    checking that :func:`flash_route` sends the call there and that q, k
    and v start on 16-byte boundaries (``takes`` says what it takes);
    returns the output."""
    _check_cuda("flash attention", q, k, v)
    if flash_route(sched, q.dtype) != route or not _aligned(q, k, v):
        raise ValueError(
            f"the {takes}, got {q.dtype}, blocks "
            f"{sched.block_q}/{sched.block_k}, head dim {sched.d}, "
            f"16-byte aligned {_aligned(q, k, v)}")
    lib = _lib()
    _check_tile_smem(lib, route, q.device, sched, q.dtype)
    c_fn = "fa_forward_tc_bf16" if route == "tc" else "fa_forward_tc_f32"
    return _launch_flash(getattr(lib, c_fn), q, k, v, sched, pos,
                         f"flash attention kernel (tensor cores, {q.dtype})")


def _check_tile_smem(lib, route, device, sched: FlashSchedule,
                     dtype) -> None:
    """Raise unless a tile path's CTA (``route`` "tc" or "tc_f32") at
    this block_q and head dim fits the card's shared memory."""
    smem_fn = lib.fa_tc_smem_bytes if route == "tc" \
        else lib.fa_tc_f32_smem_bytes
    _check_smem(device, smem_fn(sched.d, sched.block_q),
                f"block_q={sched.block_q} at head dim {sched.d} (tensor "
                f"cores, {dtype})")


def _check_decode_smem(lib, device, params, elt: int, d: int) -> None:
    """Raise unless a decode CTA (either front end) fits the card's
    shared memory."""
    _check_smem(device, lib.fa_decode_smem_bytes(params, elt),
                f"decode at head dim {d}")


def check_launch(sched, dtype, device) -> None:
    """Every refusal a launch of ``sched`` (a :class:`FlashSchedule` or a
    :class:`PagedSchedule`) on ``device`` raises after the entry point's
    validation -- the shared memory of its kernel's CTA against the
    card's -- without launching; nothing on the CPU, whose plain versions
    have no such limit.  The tuner calls it while building a candidate,
    so that a refused geometry counts as inviable."""
    device = torch.device(device)
    if not backend_lib.resolve(device).kernels:
        return
    lib = _lib()
    elt = dtype.itemsize
    if isinstance(sched, PagedSchedule):
        _check_decode_smem(lib, device, sched.c_params(), elt, sched.d)
        return
    route = flash_route(sched, dtype)
    if route in ("tc", "tc_f32"):
        _check_tile_smem(lib, route, device, sched, dtype)
    elif route == "decode":
        _check_decode_smem(lib, device, sched.c_params(True), elt, sched.d)


def flash_tc_cuda(q, k, v, sched: FlashSchedule,
                  pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the bf16 tensor-core flash kernel (any block_q, block_k and
    head dim up to 256, q, k and v 16-byte aligned, as :func:`flash_route`
    sends them): (B, H, Sq, D) bf16."""
    out = _launch_tile_path(
        "tc", q, k, v, sched, pos,
        f"tensor-core flash kernel takes 16-byte aligned bf16 prefill with "
        f"a head dim up to {MAX_HEAD_DIM}")
    if out.numel():
        flash_tc_cuda.launches += 1
    return out


flash_tc_cuda.launches = 0


def flash_tc_f32_cuda(q, k, v, sched: FlashSchedule,
                      pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the f32 tensor-core flash kernel (3xTF32; any block_q,
    block_k and head dim up to TF32_MAX_HEAD_DIM, q, k and v 16-byte
    aligned, as :func:`flash_route` sends them): (B, H, Sq, D) f32."""
    out = _launch_tile_path(
        "tc_f32", q, k, v, sched, pos,
        f"f32 tensor-core flash kernel takes 16-byte aligned f32 prefill "
        f"with a head dim up to {TF32_MAX_HEAD_DIM}")
    if out.numel():
        flash_tc_f32_cuda.launches += 1
    return out


flash_tc_f32_cuda.launches = 0


@dataclasses.dataclass(frozen=True)
class RowBand:
    """One rank's query-block rows of a sharded flash launch:
    ``partition`` "rows" (``rbd`` rows from ``row_lo``) or "zigzag" (band
    row l is global row ``(l // 2) * 2D + (dev if l even else 2D-1-dev)``,
    ``dev`` the rank, D = ``num_shards``)."""

    partition: str
    rank: int
    num_shards: int
    rbd: int
    row_lo: int = 0

    def rows(self) -> np.ndarray:
        """The band's global query-block rows, in band order."""
        l = np.arange(self.rbd)  # noqa: E741
        if self.partition == "rows":
            return self.row_lo + l
        two_d = 2 * self.num_shards
        return (l // 2) * two_d + np.where(l % 2 == 0, self.rank,
                                           two_d - 1 - self.rank)

    def local(self, sched: FlashSchedule) -> FlashSchedule:
        """``sched`` cut to the band: its rows and queries."""
        return dataclasses.replace(sched, m_q=self.rbd,
                                   sq=self.rbd * sched.block_q)

    def c_params(self) -> ctypes.Array:
        """[partition (1 rows, 2 zigzag), row_lo, rank, 2D]: the sharded
        kernels' ``RowShard``."""
        return (ctypes.c_longlong * 4)(
            1 if self.partition == "rows" else 2, self.row_lo, self.rank,
            2 * self.num_shards)


def flash_shard_cuda(q, k, v, sched: FlashSchedule,
                     band: RowBand) -> torch.Tensor:
    """Launch the sharded tile path of ``q``'s dtype for one rank's band:
    ``q`` is the band's queries (B, H, rbd * block_q, D), ``k`` and ``v``
    the whole (replicated) keys; masks and extents follow each band
    row's global row.  Returns the band's output."""
    _check_cuda("flash attention", q, k, v)
    route = flash_route(sched, q.dtype)
    if route not in ("tc", "tc_f32"):
        raise ValueError(f"a sharded flash launch takes a tile path, got "
                         f"route {route!r}")
    q, k, v = (t if _aligned(t) else t.clone() for t in (q, k, v))
    lib = _shard_lib()
    _check_tile_smem(lib, route, q.device, sched, q.dtype)
    name = "fa_forward_tc_bf16_sharded" if route == "tc" \
        else "fa_forward_tc_f32_sharded"
    out = _launch_flash(getattr(lib, name), q, k, v, sched, None,
                        f"sharded flash attention kernel ({q.dtype})",
                        band, lib)
    if out.numel():
        flash_shard_cuda.launches += 1
    return out


flash_shard_cuda.launches = 0

#: the decode kernels' counters, one int32 tensor per (device, stream):
#: allocated zeroed, grown when a launch needs more, left zero by every
#: launch (the last CTA of each (slot, kv head, chunk) resets its own)
_DECODE_COUNTERS: dict = {}


def _decode_launch(fn, params, scale, q, ptrs, what: str) -> None:
    """Run a decode kernel's C entry point ``fn`` (either front end):
    ``ptrs`` are its pointers after q's, up to the output's; the split
    parts (``torch.empty``) and the counters follow.  Raises when the
    launch is refused."""
    lib = _lib()
    elt = q.element_size()
    _check_decode_smem(lib, q.device, params, elt, q.shape[-1])
    key = (q.device, _stream(q.device))
    need = lib.fa_decode_scratch(params, elt, 1)
    cnt = _DECODE_COUNTERS.get(key)
    if cnt is None or cnt.numel() < need:
        cnt = torch.zeros(max(need, 1), dtype=torch.int32, device=q.device)
        _DECODE_COUNTERS[key] = cnt
    part = torch.empty(max(lib.fa_decode_scratch(params, elt, 0), 1),
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = fn(params, scale, q.data_ptr(), *ptrs, part.data_ptr(),
                    cnt.data_ptr(), _stream(q.device))
    _cuda.raise_on(lib, status, what)


def _check_int32(device, **tensors) -> None:
    for name, t in tensors.items():
        if (t is None or t.device != device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"q's device")


def decode_cuda(q, k, v, sched: FlashSchedule,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the split-K decode kernel (flash_decode_kernel) on a
    single-token ``kind="full"`` call with seq_pos, as :func:`flash_route`
    sends it: (B, H, 1, D) in q's dtype."""
    _check_cuda("flash attention", q, k, v)
    if flash_route(sched, q.dtype) != "decode":
        raise ValueError(
            f"the decode kernel takes single-token kind='full' calls with "
            f"seq_pos, got Sq {sched.sq}, kind {sched.kind!r}, seq_pos "
            f"{sched.has_pos}")
    _check_int32(q.device, seq_pos=pos)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    ext = sched.row_extents(q.device) \
        if sched.lowering in TABLE_LOWERINGS else None
    fn = lib.fa_decode_f32 if q.dtype == torch.float32 \
        else lib.fa_decode_bf16
    _decode_launch(fn, sched.c_params(True), sched.scale, q,
                   (k.data_ptr(), v.data_ptr(), _cuda.ptr(ext),
                    pos.data_ptr(), out.data_ptr()), "decode kernel")
    decode_cuda.launches += 1
    return out


decode_cuda.launches = 0
_ROUTES = {"decode": decode_cuda, "tc": flash_tc_cuda,
           "tc_f32": flash_tc_f32_cuda}


def paged_cuda(q, kv_pool, page_table, pos,
               sched: PagedSchedule) -> torch.Tensor:
    """Launch the paged decode kernel (paged_decode_kernel, the routine
    of :func:`decode_cuda` reading through the page table): (B, H, 1, D)
    in q's dtype."""
    _check_cuda("paged decode", q, kv_pool)
    _check_int32(q.device, page_table=page_table, seq_pos=pos)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    fn = lib.fa_paged_decode_f32 if q.dtype == torch.float32 \
        else lib.fa_paged_decode_bf16
    _decode_launch(fn, sched.c_params(), sched.scale, q,
                   (kv_pool.data_ptr(), page_table.data_ptr(),
                    pos.data_ptr(), out.data_ptr()), "paged decode kernel")
    paged_cuda.launches += 1
    return out


paged_cuda.launches = 0

#: kernel name -> its CUDA wrapper (each carries ``launches``)
KERNELS = {"flash_attention": flash_cuda_core,
           "flash_attention_decode": decode_cuda,
           "flash_attention_tc": flash_tc_cuda,
           "flash_attention_tc_f32": flash_tc_f32_cuda,
           "paged_flash_attention": paged_cuda}
#: the sharded tile paths' wrapper (the mesh path), counted apart
SHARDED_KERNELS = {"flash_attention_sharded": flash_shard_cuda}
#: flash_route's answer -> the name of the kernel it launches
ROUTE_KERNELS = {"decode": "flash_attention_decode",
                 "tc": "flash_attention_tc",
                 "tc_f32": "flash_attention_tc_f32",
                 "cuda_core": "flash_attention"}


def reset_launch_counts() -> None:
    for fn in (*KERNELS.values(), *SHARDED_KERNELS.values()):
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def shard_launch_counts() -> dict:
    return {name: fn.launches for name, fn in SHARDED_KERNELS.items()}


# ---------------------------------------------------------------------------
# kernels against their plain versions (chip_smoke.py, the cuda tests)
# ---------------------------------------------------------------------------

#: kernel-vs-plain tolerance per input dtype: the JAX tests' own
#: (tests/test_kernels.py, f32 and bf16).  The CUDA-core kernel sums each
#: dot product sequentially over d and the plain version through a
#: matmul.  The decode kernels sum each dot product over a lane's values,
#: then across the row's lanes, update the softmax once per batch of a
#: warp's keys (exp on the SFU, ex2.approx, ~2^-22 relative), and merge
#: the warps and then the splits each as sum_i exp(m_i - M) (l_i, acc_i),
#: where the plain version walks the tiles in order: the same sums in
#: another order, a few f32 ulps apart (tests/test_torch_decode_split.py
#: emulates the order within 2e-5 of the plain version and tpu-interpret
#: ``repro``).  Both tensor-core kernels update the softmax per 64-key
#: sub-tile and take exp on the SFU (ex2.approx, ~2^-22 relative); the
#: bf16 one rounds p to bf16 before p v, where the plain version keeps
#: f32 p; the f32 one (3xTF32) drops the lo x lo term of every product,
#: ~2^-22 of it (tests/test_torch_flash_tf32.py emulates it against the
#: plain version within 2e-5 and fails 1xTF32).
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: bf16 also holds each output row (one (batch, head, query) over d) to
#: ||kernel - plain|| / ||plain|| <= ROW_RTOL.  The outputs of randn
#: inputs over thousands of keys are a few 1e-2, so 2e-2 alone passes a
#: row that lost one 64-key sub-tile of S keys, which moves the row by
#: about sqrt(64 / S) of its norm (0.125 at 4096 keys); the sound kernel's
#: rounding (p and the output to bf16, 2^-9 relative each) leaves ~0.0035
#: (tests/test_torch_flash_tc.py's emulation against the plain version at
#: the head dim and lengths of gemma3-12b).
ROW_RTOL = {torch.bfloat16: 1e-2}


def row_rel_err(got, want) -> float:
    """The largest ||got - want|| / ||want|| over the output rows (the
    last dim), in f32; 0 for an empty output."""
    if not got.numel():
        return 0.0
    g, w = got.to(torch.float32), want.to(torch.float32)
    den = torch.linalg.vector_norm(w, dim=-1).clamp_min(1e-30)
    return float((torch.linalg.vector_norm(g - w, dim=-1) / den).max())


def _compare(got, want, what) -> float:
    """Raise AssertionError unless the kernel's output ``got`` agrees with
    the plain version's ``want`` within TOLERANCE (and, in bf16, every row
    within ROW_RTOL); returns max |err|."""
    tol = TOLERANCE[want.dtype]
    g, w = got.to(torch.float32), want.to(torch.float32)
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.allclose(g, w, rtol=tol, atol=tol):
        raise AssertionError(f"{what}: kernel != plain version (max |err| "
                             f"{err}, rtol = atol = {tol})")
    if want.dtype in ROW_RTOL:
        rel = row_rel_err(got, want)
        if rel > ROW_RTOL[want.dtype]:
            raise AssertionError(
                f"{what}: a row of the kernel's output is {rel} of its norm "
                f"off the plain version's (bound {ROW_RTOL[want.dtype]})")
    return err


def check_flash_against_plain(q, k, v, sched: FlashSchedule, pos=None):
    """Run the flash kernel and its plain version on the same inputs;
    raise AssertionError unless they agree (:func:`_compare`).  Returns
    (max |err|, kernel output)."""
    got = flash_cuda(q, k, v, sched, pos)
    want = flash_attention_plain(q, k, v, sched, pos)
    route = flash_route(sched, q.dtype)
    what = (f"flash ({route}) {sched.kind} "
            f"{sched.lowering} q {tuple(q.shape)} "
            f"k {tuple(k.shape)} blocks {sched.block_q}/{sched.block_k} "
            f"{q.dtype}")
    return _compare(got, want, what), got


def check_paged_against_plain(q, kv_pool, page_table, pos,
                              sched: PagedSchedule):
    """Run the paged kernel and its plain version; raise unless they
    agree (:func:`_compare`).  Returns (max |err|, kernel output)."""
    got = paged_cuda(q, kv_pool, page_table, pos, sched)
    want = paged_attention_plain(q, kv_pool, page_table, pos, sched)
    what = (f"paged decode q {tuple(q.shape)} pool "
            f"{tuple(kv_pool.shape)} {q.dtype}")
    return _compare(got, want, what), got


def check_flash_shard_against_plain(q, k, v, sched: FlashSchedule,
                                    band: RowBand):
    """Run one rank's sharded launch and the plain version of its band;
    raise AssertionError unless they agree (:func:`_compare`).  ``q`` is
    the band's queries.  Returns (max |err|, kernel output)."""
    got = flash_shard_cuda(q, k, v, sched, band)
    want = flash_attention_plain(q, k, v, sched,
                                 rows=torch.from_numpy(band.rows()))
    what = (f"sharded flash ({band.partition} rank {band.rank} of "
            f"{band.num_shards}) {sched.kind} {sched.lowering} q "
            f"{tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    return _compare(got, want, what), got


# ---------------------------------------------------------------------------
# the sharded query axis
# ---------------------------------------------------------------------------

def shard_band(sched: FlashSchedule, num_shards: int, rank: int,
               shard_balance: str = "contiguous") -> RowBand:
    """Validate a sharded flash launch as the JAX package does (the same
    ``ValueError``\\ s) and return rank ``rank``'s band."""
    from repro_torch.core.shard import ShardedPlan
    D = num_shards
    if sched.m_q % D:
        raise ValueError(
            f"sharded flash needs the query-block grid divisible by "
            f"the mesh axis: m_q={sched.m_q} blocks over {D} devices")
    partition = "rows"
    if shard_balance == "zigzag":
        if sched.kind != "causal":
            raise ValueError(
                "shard_balance='zigzag' balances the causal "
                "triangle; contiguous bands already balance "
                f"kind={sched.kind!r}")
        if sched.m_q % (2 * D):
            raise ValueError(
                f"zigzag needs the query-block grid ({sched.m_q}) "
                f"divisible by 2 * mesh axis ({2 * D}) for an "
                f"exactly balanced snake")
        partition = "zigzag"
    elif shard_balance != "contiguous":
        raise ValueError(
            f"unknown shard_balance {shard_balance!r}; expected "
            f"'contiguous' or 'zigzag'")
    plan = ShardedPlan(sched.domain, sched.lowering,
                       batch_dims=(sched.b * sched.h,), backend="cpu",
                       num_shards=D, partition=partition)
    row_lo = int(plan._row_lo[rank]) if partition == "rows" else 0
    return RowBand(partition, rank, D, plan.rbd, row_lo)


def band_queries(q: torch.Tensor, sched: FlashSchedule,
                 band: RowBand) -> torch.Tensor:
    """The band's block rows of the global queries ``q``."""
    b, h, _, d = q.shape
    rows = torch.from_numpy(band.rows()).to(q.device)
    return q.reshape(b, h, sched.m_q, sched.block_q, d)[:, :, rows] \
        .reshape(b, h, band.rbd * sched.block_q, d)


def flash_rank(q, k, v, sched: FlashSchedule, band: RowBand):
    """One rank's share of a sharded flash call: the band's output from
    its queries ``q`` (:func:`band_queries`) and the whole K and V --
    the sharded kernel on the card, the plain version on the CPU."""
    if not backend_lib.resolve(q).kernels:
        return flash_attention_plain(q, k, v, sched,
                                     rows=torch.from_numpy(band.rows()))
    return flash_shard_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                            sched, band)


def _flash_sharded(q, k, v, sched: FlashSchedule, mesh, shard_axis,
                   shard_balance, verify=False):
    """The mesh call of :func:`flash_attention`."""
    from repro_torch.distributed import collectives
    from repro_torch.launch import mesh as mesh_lib
    D = mesh_lib.axis_size(mesh, shard_axis)
    shard_band(sched, D, 0, shard_balance)  # refusals before any collective
    if verify:
        verify_schedule(sched, q.device, D, shard_balance)
    mesh_lib.check_mesh_device(mesh, q, k, v)
    band = shard_band(sched, D, mesh_lib.axis_rank(mesh, shard_axis),
                      shard_balance)
    out = flash_rank(band_queries(q, sched, band), k, v, sched, band)
    b, h, _, d = q.shape
    # the bands, rank-major along the sequence: (D * rbd) block rows
    rows = collectives.all_gather(
        out.reshape(b, h, band.rbd, sched.block_q, d).permute(2, 0, 1, 3, 4)
        .contiguous(), 0, mesh_lib.axis_group(mesh, shard_axis))
    if band.partition == "zigzag":
        from repro_torch.core.shard import zigzag_row_order
        inv = np.argsort(zigzag_row_order(sched.m_q, band.num_shards))
        rows = rows[torch.from_numpy(inv).to(rows.device)]
    return rows.permute(1, 2, 0, 3, 4).reshape(b, h, sched.sq, d)


# ---------------------------------------------------------------------------
# meta tensors: the dry run's charge of a launch
# ---------------------------------------------------------------------------

def _decode_keys(seq_pos, b: int, sk: int, window: int) -> np.ndarray:
    """(B,) keys each row's decode attends: those up to its position
    (within ``window`` of it when set).  A position held on ``meta`` has
    no value, so every row then counts the whole cache."""
    if isinstance(seq_pos, torch.Tensor) and seq_pos.device.type == "meta":
        pos = np.full(b, sk - 1)
    else:
        pos = np.broadcast_to(np.asarray(torch.as_tensor(seq_pos).cpu(),
                                         np.int64).reshape(-1), (b,))
    keys = np.minimum(pos, sk - 1) + 1
    return np.minimum(keys, window) if window else keys


def flash_meta(q, k, v, sched: FlashSchedule, seq_pos) -> torch.Tensor:
    """A launch on ``meta`` tensors (the dry run): the work the routed
    kernel's schedule does, charged under its name
    (:func:`repro_torch.launch.op_analysis.charge_kernel`), and an empty
    output.  A tile path computes every member (q block, k block) pair of
    the domain whole, 2 * block_q * block_k * (d + dv) FLOPs a pair and
    head (the causal diagonal blocks in full); the decode kernel 2 * (d +
    dv) a key and head over the keys up to each row's position.  Bytes:
    q, the K/V rows read and the output, each once."""
    from repro_torch.launch.op_analysis import charge_kernel, nbytes
    dv = v.shape[-1]
    out = q.new_empty((sched.b, sched.h, sched.sq, dv))
    name = ROUTE_KERNELS[flash_route(sched, q.dtype)]
    if sched.has_pos:
        keys = int(_decode_keys(seq_pos, sched.b, sched.sk,
                                sched.window).sum())
        flops = 2.0 * keys * sched.h * sched.sq * (sched.d + dv)
        kv = keys * sched.hkv * (sched.d + dv) * k.element_size()
    else:
        pairs = sched.domain.num_blocks
        flops = (2.0 * pairs * sched.b * sched.h * sched.block_q
                 * sched.block_k * (sched.d + dv))
        kv = nbytes(k) + nbytes(v)
    charge_kernel(name, flops, nbytes(q) + kv + nbytes(out))
    return out


def paged_meta(q, kv_pool, sched: PagedSchedule, seq_pos) -> torch.Tensor:
    """:func:`flash_meta` of a paged decode: the keys up to each slot's
    position (every page of its table row when the positions are on
    ``meta``), charged under ``paged_flash_attention``."""
    from repro_torch.launch.op_analysis import charge_kernel, nbytes
    out = torch.empty_like(q)
    keys = int(_decode_keys(seq_pos, sched.b,
                            sched.max_pages * sched.page_size,
                            sched.window).sum())
    flops = 4.0 * keys * sched.h * sched.d
    kv = 2 * keys * sched.hkv * sched.d * kv_pool.element_size()
    charge_kernel("paged_flash_attention", flops,
                  nbytes(q) + kv + nbytes(out))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                    scale: float | None = None, block_q: int = 128,
                    block_k: int = 128, grid_mode: str = "compact",
                    storage: str = "embedded",
                    kv_seq_len: int | None = None, seq_pos=None,
                    num_warps=None, num_stages=None, mesh=None,
                    shard_axis: str = "data",
                    shard_balance: str = "contiguous",
                    verify: bool = False) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) with Hkv | H.

    kind:      "causal" | "local" (window tokens) | "full"
    grid_mode: "closed_form" (alias "compact") | "prefetch_lut" |
               "bounding" | "mma" | "auto" (the tuned lowering, and the
               tuned blocks where block_q / block_k are "auto"; see the
               module docstring, with num_warps / num_stages)
    storage:   "embedded" (k/v hold the full key sequence) | "compact"
               (k/v hold only the domain's key-block support; pass the
               true key length as ``kv_seq_len``)
    seq_pos:   decode position, a scalar or a (B,) vector (requires
               ``kind="full"``; ``window=`` then gives a run-time sliding
               window anchored at seq_pos): keys past it are masked and
               key blocks past ``seq_pos // block_k`` are not read.

    mesh:      shard the query-block axis over ``shard_axis`` with
               ``shard_balance`` "contiguous" or "zigzag" (causal only;
               module docstring)

    causal requires Sq == Sk; local accepts Sq < Sk with the decode
    convention (queries are the last Sq positions).  CUDA tensors launch
    the kernel, CPU tensors run the plain version, ``meta`` tensors (the
    dry run) charge the kernel's work and return an empty output
    (:func:`flash_meta`).  ``verify=True``
    statically verifies the plan first (module docstring)."""
    _check_qkv(q, k, v)
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    sk = kv_seq_len if kv_seq_len is not None else k.shape[2]
    # num_warps / num_stages change nothing here, so only the geometry
    # and the lowering are looked up
    grid_mode, block_q, block_k = resolve_auto_schedule(
        "flash", {"kind": kind, "batch": b, "heads": h, "kv_heads": hkv,
                  "sq": sq, "sk": sk, "d": d, "window": window},
        device=q.device,
        grid_mode=(grid_mode, "lowering", "closed_form"),
        block_q=(block_q, "block_q", 128),
        block_k=(block_k, "block_k", 128))
    sched = flash_schedule(q.shape, k.shape, kind=kind, window=window,
                           scale=scale, block_q=block_q, block_k=block_k,
                           grid_mode=grid_mode, storage=storage,
                           kv_seq_len=kv_seq_len,
                           has_pos=seq_pos is not None)
    if mesh is not None:
        if seq_pos is not None:
            raise ValueError(
                "seq_pos (decode) does not combine with the query-row mesh "
                "partition; shard the batch axis instead (see "
                "repro.models.attention.decode_attention_flash)")
        if q.device.type == "meta":
            raise ValueError("a meta dry run charges unsharded launches "
                             "only; mesh= takes real tensors")
        return _flash_sharded(q, k, v, sched, mesh, shard_axis,
                              shard_balance, verify)
    if q.device.type == "meta":
        return flash_meta(q, k, v, sched, seq_pos)
    if verify:
        verify_schedule(sched, q.device)
    pos = seq_pos_vector(seq_pos, sched.b, q.device)
    if not backend_lib.resolve(q).kernels:
        return flash_attention_plain(q, k, v, sched, pos)
    return flash_cuda(q.contiguous(), k.contiguous(), v.contiguous(), sched,
                      pos)


def verify_paged(q, kv_pool, page_table, *, window: int = 0,
                 grid_mode: str = "compact") -> None:
    """``verify=True`` of :func:`paged_flash_attention`: statically
    verify the ``"full"`` key-block plan of the page table (one row of
    ``page_table.shape[1]`` pages, the (batch * heads) batch axis) on
    ``q``'s device; raises ``PlanVerificationError`` on any finding."""
    from repro_torch.analysis.verifier import verify_or_raise
    sched = paged_schedule(q.shape, kv_pool.shape, page_table.shape,
                           window=window)
    verify_or_raise(GridPlan(make_attention_domain(
        "full", 1, page_table.shape[1], 0), grid_mode,
        batch_dims=(sched.b * sched.h,), backend=q), kernel="flash",
        device=q.device)


def paged_flash_attention(q, kv_pool, page_table, seq_pos, *,
                          window: int = 0, scale: float | None = None,
                          grid_mode: str = "compact", num_warps=None,
                          num_stages=None, verify: bool = False):
    """Paged single-token decode over a fused-KV page pool.

    q:          (B, H, 1, D) -- one query per serving slot.
    kv_pool:    (P, 2*Hkv, page_size, D) physical pages, K/V heads
                interleaved ``[K0, V0, K1, V1, ...]``; page 0 is the
                null page.
    page_table: (B, max_pages) int logical-block -> physical-page map.
    seq_pos:    (B,) per-slot decode positions (a scalar broadcasts).
                Keys past a slot's position are masked; pages past
                ``pos // page_size`` are never read.
    window:     optional run-time sliding window anchored at seq_pos.

    ``grid_mode`` is validated and, as on the JAX package's gpu
    structure, does not change the launch; ``num_warps`` and
    ``num_stages`` are taken and change nothing (module docstring).
    Bit-equal to ``flash_attention(..., kind="full", seq_pos=...)`` at
    ``block_k == page_size`` when the mapped pages hold the same
    values.  ``verify=True`` statically verifies the ``"full"`` key-block
    plan of the page table first (module docstring).  ``meta`` tensors
    (the dry run) charge the kernel's work (:func:`paged_meta`)."""
    normalize_lowering(grid_mode)
    sched = paged_schedule(q.shape, kv_pool.shape, page_table.shape,
                           window=window, scale=scale)
    if q.device.type == "meta":
        return paged_meta(q, kv_pool, sched, seq_pos)
    if verify:
        verify_paged(q, kv_pool, page_table, window=window,
                     grid_mode=grid_mode)
    table = torch.as_tensor(page_table).to(q.device, torch.int32)
    pos = torch.as_tensor(seq_pos).to(q.device, torch.int32).reshape(-1)
    if pos.numel() not in (1, sched.b):
        raise ValueError(f"seq_pos must be a scalar or a ({sched.b},) "
                         f"per-slot vector, got {pos.numel()} values")
    pos = pos.expand(sched.b).contiguous()
    if not backend_lib.resolve(q).kernels:
        return paged_attention_plain(q, kv_pool, table, pos, sched)
    return paged_cuda(q.contiguous(), kv_pool.contiguous(),
                      table.contiguous(), pos, sched)
