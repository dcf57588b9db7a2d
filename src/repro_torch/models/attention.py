"""Attention for the model stack, plain PyTorch around the block-space
kernels.

Strategies, selected by sequence length and config (as in the JAX
package's ``repro.models.attention``):

* ``simple``  -- full masked attention (prefill up to ``flash_threshold``)
* ``flash``   -- chunked online softmax (above it), with a custom
                 backward (:class:`_Flash`) that recomputes per-chunk
                 scores, so training holds O(S * chunk) and never the
                 S x S score matrix
* ``decode``  -- one-token query against a KV cache: the plain masked
                 :func:`decode_attention`, or the block-space flash
                 kernel (:func:`decode_attention_flash`), or the paged
                 kernel (:func:`decode_attention_paged`)

The flash path has two *schedules*, the plain-tensor mirror of the
GridPlan lowerings: ``dense`` computes and masks every (q, k-chunk)
pair (the bounding box); ``triangular`` loops over q chunks with
per-row k-extents from the block domain's ``GridPlan.row_extents()``
(the compact block space).  ``schedule`` also accepts lowering names
("closed_form", "prefetch_lut", "bounding", "compact"), mapped through
``plan.xla_schedule``.

GQA groups q heads as (Hkv, G) so K/V are never repeated per q head.

The serving mesh: :func:`set_decode_mesh` registers a mesh (the model
stack stays mesh-agnostic), and the two decode kernels' entry points
shard the *slot* axis over its ``data`` axis (``mesh=`` /
``shard_axis=`` override it per call), as the JAX package's
``shard_map``: each rank launches the kernel on its contiguous group of
``B / D`` slots -- the flash decode on its cache rows, the paged decode
on its page-table rows against the pool, which every rank holds whole
-- and the groups are gathered along the slots.  A batch that does not
tile the axis runs the kernel unsharded.  The rest of a decode step
runs on every rank over every slot.  A slot group is a leading slice of
the caches, so it keeps their alignment.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.domain import make_attention_domain
from repro_torch.core.plan import GridPlan, xla_schedule
from repro_torch.distributed import collectives

NEG_INF = float(-1e30)
F32 = torch.float32


def _schedule_name(schedule: str) -> str:
    """Normalize: accept schedules and GridPlan lowering names."""
    if schedule in ("dense", "triangular"):
        return schedule
    return xla_schedule(schedule)


def _mask(qpos, kpos, kind: str, window: int):
    if kind == "full":
        return None
    m = kpos <= qpos
    if kind == "local":
        m = m & (kpos > qpos - window)
    return m


def _apply_mask(s, mask):
    return s if mask is None else torch.where(mask, s, NEG_INF)


# ---------------------------------------------------------------------------
# simple (full materialization)
# ---------------------------------------------------------------------------

def simple_attention(q, k, v, *, kind="causal", window=0,
                     scale: Optional[float] = None):
    """q: (B,H,Sq,D); k,v: (B,Hkv,Sk,D).  f32 scores and softmax,
    returns q.dtype."""
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    dv = v.shape[-1]
    g = h // hkv
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    qg = q.reshape(b, hkv, g, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(F32), k.to(F32)) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    s = _apply_mask(s, _mask(qpos, kpos, kind, window))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype), v)
    return o.reshape(b, h, sq, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# flash: chunked online softmax (forward)
# ---------------------------------------------------------------------------

def _chunk_fwd_scan(qg, k, v, kind, window, scale, chunk, q_offset):
    """Online softmax over k chunks.  qg: (B,Hkv,G,Sq,D); k,v:
    (B,Hkv,Sk,D).  Returns o (f32) and lse, both (B,Hkv,G,Sq,*)."""
    b, hkv, g, sq, d = qg.shape
    sk = k.shape[2]
    dv = v.shape[-1]
    nc = sk // chunk
    qpos = torch.arange(sq, device=qg.device)[:, None] + q_offset
    q32 = qg.to(F32)
    acc = q32.new_zeros((b, hkv, g, sq, dv))
    m = q32.new_full((b, hkv, g, sq, 1), NEG_INF)
    l = q32.new_zeros((b, hkv, g, sq, 1))
    for ci in range(nc):
        kci = k[:, :, ci * chunk:(ci + 1) * chunk].to(F32)
        vci = v[:, :, ci * chunk:(ci + 1) * chunk].to(F32)
        s = torch.einsum("bhgqd,bhkd->bhgqk", q32, kci) * scale
        kpos = ci * chunk + torch.arange(chunk, device=qg.device)[None, :]
        s = _apply_mask(s, _mask(qpos, kpos, kind, window))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vci)
        m = m_new
    l = torch.where(l == 0, 1.0, l)
    return acc / l, m + torch.log(l)


def _chunk_bwd_scan(qg, k, v, o, lse, dog, kind, window, scale, chunk,
                    q_offset):
    """Backward of :func:`_chunk_fwd_scan` over the same k chunks,
    recomputing each chunk's scores from ``lse``.  Shapes as there;
    o / do / lse in the grouped layout, f32.  Returns dqg (f32), dk and
    dv (f32, (B,Hkv,Sk,*))."""
    b, hkv, g, sq, d = qg.shape
    sk = k.shape[2]
    nc = sk // chunk
    qpos = torch.arange(sq, device=qg.device)[:, None] + q_offset
    q32 = qg.to(F32)
    delta = torch.sum(dog * o, dim=-1, keepdim=True)  # (B,Hkv,G,Sq,1)
    dq = q32.new_zeros((b, hkv, g, sq, d))
    dks, dvs = [], []
    for ci in range(nc):
        kci = k[:, :, ci * chunk:(ci + 1) * chunk].to(F32)
        vci = v[:, :, ci * chunk:(ci + 1) * chunk].to(F32)
        s = torch.einsum("bhgqd,bhkd->bhgqk", q32, kci) * scale
        kpos = ci * chunk + torch.arange(chunk, device=qg.device)[None, :]
        s = _apply_mask(s, _mask(qpos, kpos, kind, window))
        p = torch.exp(s - lse)
        dvs.append(torch.einsum("bhgqk,bhgqd->bhkd", p, dog))
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vci)
        ds = p * (dp - delta) * scale
        dq = dq + torch.einsum("bhgqk,bhkd->bhgqd", ds, kci)
        dks.append(torch.einsum("bhgqk,bhgqd->bhkd", ds, q32))
    return dq, torch.cat(dks, dim=2), torch.cat(dvs, dim=2)


def _tri_klen(i: int, chunk: int, sk: int, sq: int, kind: str,
              window: int) -> tuple[int, int]:
    """Static (k_start, k_len) for q chunk i under the compact schedule
    with a q/k offset (cross-attention-style sk > sq)."""
    hi = min(sk, (i + 1) * chunk + (sk - sq))
    if kind == "local":
        lo = max(0, (i * chunk + (sk - sq) - window) // chunk * chunk)
    else:
        lo = 0
    return lo, hi - lo


@functools.lru_cache(maxsize=256)
def _compact_extents(kind: str, window: int, chunk: int, sq: int,
                     sk: int) -> tuple:
    """Static per-q-chunk (k_start, k_len) for the compact schedule.

    For square self-attention the extents come from the block domain
    itself (``GridPlan.row_extents``); the offset case (sk > sq) keeps
    the token-level closed form."""
    m_q = sq // chunk
    if sq != sk:
        return tuple(_tri_klen(i, chunk, sk, sq, kind, window)
                     for i in range(m_q))
    wb = (-(-window // chunk) + 1) if kind == "local" else 0
    domain = make_attention_domain(kind, m_q, m_q, wb)
    ext = GridPlan(domain, backend="cpu").row_extents()
    return tuple((int(lo) * chunk, (int(hi) + 1 - int(lo)) * chunk)
                 for lo, hi in ext)


def _flash_fwd_impl(q, k, v, kind, window, scale, chunk, schedule):
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = h // hkv
    qg = q.reshape(b, hkv, g, sq, d)
    q_offset = sk - sq
    if schedule == "dense" or kind == "full":
        o, lse = _chunk_fwd_scan(qg, k, v, kind, window, scale, chunk,
                                 q_offset)
    else:  # triangular / band compact schedule: loop over q chunks
        nq = sq // chunk
        extents = _compact_extents(kind, window, chunk, sq, sk)
        os_, lses = [], []
        for i in range(nq):
            lo, ln = extents[i]
            qi = qg[:, :, :, i * chunk:(i + 1) * chunk]
            oi, lsei = _chunk_fwd_scan(
                qi, k[:, :, lo:lo + ln], v[:, :, lo:lo + ln], kind, window,
                scale, min(chunk, ln), q_offset + i * chunk - lo)
            os_.append(oi)
            lses.append(lsei)
        o = torch.cat(os_, dim=3)
        lse = torch.cat(lses, dim=3)
    return o.reshape(b, h, sq, v.shape[-1]).to(q.dtype), lse


def _flash_vjp_bwd(kind, window, scale, chunk, schedule, res, do):
    q, k, v, o, lse = res
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    dvd = v.shape[-1]
    g = h // hkv
    qg = q.reshape(b, hkv, g, sq, d)
    og = o.reshape(b, hkv, g, sq, dvd).to(F32)
    dog = do.reshape(b, hkv, g, sq, dvd).to(F32)
    q_offset = sk - sq
    if schedule == "dense" or kind == "full":
        dq, dk, dv = _chunk_bwd_scan(qg, k, v, og, lse, dog, kind, window,
                                     scale, chunk, q_offset)
    else:  # dk / dv add up over the q chunks whose extents overlap
        nq = sq // chunk
        extents = _compact_extents(kind, window, chunk, sq, sk)
        dq = og.new_zeros((b, hkv, g, sq, d))
        dk = og.new_zeros((b, hkv, sk, d))
        dv = og.new_zeros((b, hkv, sk, dvd))
        for i in range(nq):
            lo, ln = extents[i]
            sl = slice(i * chunk, (i + 1) * chunk)
            dqi, dki, dvi = _chunk_bwd_scan(
                qg[:, :, :, sl], k[:, :, lo:lo + ln], v[:, :, lo:lo + ln],
                og[:, :, :, sl], lse[:, :, :, sl], dog[:, :, :, sl],
                kind, window, scale, min(chunk, ln),
                q_offset + i * chunk - lo)
            dq[:, :, :, sl] = dqi
            dk[:, :, lo:lo + ln] += dki
            dv[:, :, lo:lo + ln] += dvi
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """The JAX package's ``jax.custom_vjp`` ``_flash``: the forward saves
    ``q, k, v, o, lse``; the backward recomputes the scores per chunk."""

    @staticmethod
    def forward(ctx, q, k, v, kind, window, scale, chunk, schedule):
        o, lse = _flash_fwd_impl(q, k, v, kind, window, scale, chunk,
                                 schedule)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (kind, window, scale, chunk, schedule)
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _flash_vjp_bwd(*ctx.args, ctx.saved_tensors, do)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_xla(q, k, v, *, kind="causal", window=0,
                        scale: Optional[float] = None, chunk=1024,
                        schedule="dense"):
    """Chunked online-softmax attention with the recomputing backward,
    the JAX package's ``flash_attention_xla``."""
    schedule = _schedule_name(schedule)
    if scale is None:
        scale = float(1.0 / np.sqrt(q.shape[-1]))
    chunk = min(chunk, k.shape[2])
    if k.shape[2] % chunk:
        raise ValueError("Sk must be divisible by chunk")
    if schedule == "triangular" and q.shape[2] % chunk:
        raise ValueError("Sq must be divisible by chunk for triangular")
    return _Flash.apply(q, k, v, kind, window, float(scale), chunk,
                        schedule)


# ---------------------------------------------------------------------------
# decode: one new token against a KV cache
# ---------------------------------------------------------------------------

#: the mesh the block-space decode path shards its continuous-batching
#: slot groups over; set by the serving layer (``set_decode_mesh``) so
#: the model stack stays mesh-agnostic.
_DECODE_MESH = None
_DECODE_AXIS = "data"

#: calls of each decode kernel's entry point on a rank's slot group (on
#: the card one kernel launch each, also counted by the kernel's wrapper)
SLOT_CALLS = {"flash_attention_decode": 0, "paged_flash_attention": 0}


def set_decode_mesh(mesh, axis: str = "data") -> None:
    """Register the serving mesh for :func:`decode_attention_flash` and
    :func:`decode_attention_paged` (``None`` disables sharding); the
    next decode step picks it up."""
    global _DECODE_MESH, _DECODE_AXIS
    _DECODE_MESH = mesh
    _DECODE_AXIS = axis


@contextlib.contextmanager
def decode_mesh(mesh, axis: str = "data"):
    """:func:`set_decode_mesh` for the duration of the block, the earlier
    registration restored after (a ``Server(mesh=)``'s calls)."""
    old = (_DECODE_MESH, _DECODE_AXIS)
    set_decode_mesh(mesh, axis)
    try:
        yield
    finally:
        set_decode_mesh(*old)


def reset_slot_calls() -> None:
    for k in SLOT_CALLS:
        SLOT_CALLS[k] = 0


def slot_group(b: int, mesh, shard_axis, *tensors):
    """(slice of this rank's slots, the axis's process group) when
    ``mesh`` (default: the registered one) shards ``b`` slots over its
    axis, else None (no mesh, an axis of 1, or a batch that does not
    tile the axis).  Raises when a tensor lies off this rank's device of
    the mesh."""
    from repro_torch.launch import mesh as mesh_lib
    if mesh is None:
        mesh = _DECODE_MESH
    axis = shard_axis or _DECODE_AXIS
    if mesh is None:
        return None
    size = mesh_lib.axis_size(mesh, axis)
    if size == 1 or b % size:
        return None
    mesh_lib.check_mesh_device(mesh, *tensors)
    n = b // size
    r = mesh_lib.axis_rank(mesh, axis)
    return slice(r * n, (r + 1) * n), mesh_lib.axis_group(mesh, axis)


def decode_attention_flash(q, k, v, pos, *, kind="causal", window=0,
                           scale: Optional[float] = None,
                           block_k: int = 128, grid_mode: str = "compact",
                           mesh=None, shard_axis: Optional[str] = None):
    """Single-token decode through the block-space flash kernel.

    q: (B,H,1,D); k,v: (B,Hkv,Smax,D) caches; pos: () current position
    or a (B,) vector of per-row positions.  The kernel masks keys past
    ``pos`` and does not read key blocks past ``pos // block_k``;
    ``kind='local'`` anchors the sliding window at ``pos``.
    ``grid_mode`` is the kernel's lowering (any GridPlan lowering; the
    result is the same under each).  A cache length that does not tile
    ``block_k`` runs the plain :func:`decode_attention` instead (the JAX
    package's rule).

    ``mesh`` (default: the registered serving mesh) shards the slot axis
    over ``shard_axis`` (default: the registered axis, ``"data"``): each
    rank decodes its contiguous slot group with its cache rows, and the
    groups are gathered (module docstring)."""
    b = q.shape[0]
    sk = k.shape[2]
    block_k = min(block_k, sk)
    if sk % block_k:
        return decode_attention(q, k, v, pos, kind=kind, window=window,
                                scale=scale)
    from repro_torch.kernels.flash_attention import flash_attention
    w = window if kind == "local" else 0
    kw = dict(kind="full", window=w, scale=scale, block_q=1,
              block_k=block_k, grid_mode=grid_mode)
    group = slot_group(b, mesh, shard_axis, q, k, v)
    if group is None:
        return flash_attention(q, k, v, seq_pos=pos, **kw)
    sl, grp = group
    posv = torch.as_tensor(pos, device=q.device).to(torch.int32) \
        .reshape(-1).expand(b)
    o = flash_attention(q[sl], k[sl], v[sl], seq_pos=posv[sl].contiguous(),
                        **kw)
    SLOT_CALLS["flash_attention_decode"] += 1
    return collectives.all_gather(o, 0, grp)


def decode_attention(q, k, v, pos, *, kind="causal", window=0,
                     scale: Optional[float] = None):
    """q: (B,H,1,D); k,v: (B,Hkv,S,D) cache; pos: () current position
    or (B,) per-row positions.  Keys at kpos > pos (unfilled cache tail)
    are masked out."""
    b, h, _, d = q.shape
    _, hkv, sk, _ = k.shape
    g = h // hkv
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    qg = q.reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg.to(F32), k.to(F32)) * scale
    kpos = torch.arange(sk, device=q.device)[None, None, None, :]
    pos = torch.as_tensor(pos, device=q.device)
    if pos.ndim:  # (B,) per-row decode positions
        pos = pos.reshape(b, 1, 1, 1)
    valid = kpos <= pos
    if kind == "local":
        valid = valid & (kpos > pos - window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p.to(v.dtype), v)
    return o.reshape(b, h, 1, v.shape[-1]).to(q.dtype)


def decode_attention_paged(q, kv_pool, page_table, pos, *,
                           window: int = 0,
                           scale: Optional[float] = None,
                           grid_mode: str = "compact", mesh=None,
                           shard_axis: Optional[str] = None,
                           verify: bool = False):
    """Paged single-token decode through the block-space paged kernel.

    q: (B,H,1,D) slot queries; kv_pool: (P, 2*Hkv, page_size, D) fused
    page pool; page_table: (B, max_pages) int; pos: (B,) per-slot
    positions (a scalar broadcasts).  See
    :func:`repro_torch.kernels.flash_attention.paged_flash_attention`.

    ``mesh`` (default: the registered serving mesh) shards the slot
    axis: each rank decodes its contiguous slot group against its
    page-table rows, the pool whole on every rank, and the groups are
    gathered.  A batch that does not tile the axis runs unsharded.
    ``verify=True`` verifies each launch's plan first."""
    from repro_torch.kernels.flash_attention import paged_flash_attention
    b = q.shape[0]
    kw = dict(window=window, scale=scale, grid_mode=grid_mode, verify=verify)
    group = slot_group(b, mesh, shard_axis, q, kv_pool)
    if group is None:
        return paged_flash_attention(q, kv_pool, page_table, pos, **kw)
    sl, grp = group
    posv = torch.as_tensor(pos, device=q.device).to(torch.int32) \
        .reshape(-1).expand(b)
    table = torch.as_tensor(page_table, device=q.device)
    o = paged_flash_attention(q[sl], kv_pool, table[sl].contiguous(),
                              posv[sl].contiguous(), **kw)
    SLOT_CALLS["paged_flash_attention"] += 1
    return collectives.all_gather(o, 0, grp)


def decode_attention_paged_xla(q, kv_pool, page_table, pos, *,
                               window: int = 0,
                               scale: Optional[float] = None):
    """Plain paged decode: gather the mapped pages back into contiguous
    caches, then run :func:`decode_attention` (no kernel in the loop)."""
    from repro_torch.core.paged import gather_kv
    k, v = gather_kv(kv_pool, page_table)
    kind = "local" if window else "causal"
    return decode_attention(q, k, v, pos, kind=kind, window=window,
                            scale=scale)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

def attention(q, k, v, *, kind="causal", window=0, scale=None,
              chunk=1024, schedule="dense", flash_threshold=8192):
    """schedule: "dense" | "triangular", or any GridPlan lowering name
    ("closed_form" | "prefetch_lut" | "bounding" | "mma" | "compact")."""
    sq, sk = q.shape[2], k.shape[2]
    if sq == 1:
        raise ValueError("use decode_attention for single-token queries")
    if max(sq, sk) <= flash_threshold:
        return simple_attention(q, k, v, kind=kind, window=window,
                                scale=scale)
    return flash_attention_xla(q, k, v, kind=kind, window=window,
                               scale=scale, chunk=chunk, schedule=schedule)
