"""Paged block-space KV cache: the lambda-map trick applied to serving.

The paper's central move -- addressing a compact store through a cheap
index translation instead of materializing the bounding box -- is the
indirection a paged KV cache needs: a per-slot table from *logical* key
blocks to *physical* pages, read per key block.  This module supplies:

``PagedKVPool``
    The host-side allocator: a free list over physical pages with page 0
    reserved as the *null page* -- inactive slots route their writes
    there and no reader ever dereferences it, so fully-batched scatters
    need no host-side compaction.  ``stats()`` reports occupancy and
    fragmentation.

Device-side layout helpers
    The pool tensor is ``(num_pages, 2*Hkv, page_size, d)`` with the K
    and V heads *interleaved* on the head axis (``[K0,V0,K1,V1,...]``):
    one page-tile read of head ``h`` (rows ``2h`` and ``2h + 1``) feeds
    both attention operands.  :func:`fuse_kv` / :func:`split_kv`
    convert between this layout and separate ``(B, Hkv, S, d)`` caches;
    :func:`gather_kv` rebuilds contiguous caches from the pool (the
    oracle of the paged tests and of the plain paged decode);
    :func:`append_token` / :func:`write_prefill_pages` are the scatter
    writes of the serving decode and prefill steps.  Unlike the JAX
    package's functional updates, the two writers update the pool **in
    place** (and return it), so a step holds one pool, not two.

The JAX package's ``PagedPlan`` routes the page table through the TPU's
scalar prefetch; the CUDA kernel reads the table itself (one int32 per
key block), so it has no counterpart here.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.backend import default_device

#: physical page 0 is never allocated: it is the write target of
#: inactive slots (masked scatters) and the pad entry of page tables.
NULL_PAGE = 0


# ---------------------------------------------------------------------------
# host-side allocator
# ---------------------------------------------------------------------------

class PagedKVPool:
    """Free-list page allocator for one serving process.

    Pure host bookkeeping: the device pool tensors are held by the
    caller.  Page 0 is reserved (:data:`NULL_PAGE`).  Allocation hands
    out the lowest-numbered free pages first, which keeps reuse tight
    after churn."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free = sorted(range(1, self.num_pages), reverse=True)
        self._used: set[int] = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._used)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> Optional[list[int]]:
        """``n`` physical pages, or ``None`` when the pool cannot serve
        the request (the scheduler's admission signal -- never a raise:
        running out of pages is a load condition, not a bug)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._used.update(pages)
        return pages

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p == NULL_PAGE:
                continue
            if p not in self._used:
                raise ValueError(f"double free of page {p}")
            self._used.discard(p)
            self._free.append(p)
        self._free.sort(reverse=True)

    def stats(self, seq_lens: Sequence[int] = ()) -> dict:
        """Occupancy + fragmentation.  ``seq_lens`` are the live
        sequence lengths; *internal fragmentation* is the fraction of
        allocated token slots no live token occupies (the tail waste of
        partially-filled last pages)."""
        cap = self.num_pages - 1
        used = len(self._used)
        tokens = int(sum(seq_lens))
        alloc_tokens = used * self.page_size
        return {
            "num_pages": cap,
            "used_pages": used,
            "free_pages": len(self._free),
            "utilization": used / cap if cap else 0.0,
            "live_tokens": tokens,
            "alloc_tokens": alloc_tokens,
            "fragmentation": (1.0 - tokens / alloc_tokens)
            if alloc_tokens else 0.0,
        }


def pages_for(seq_len: int, page_size: int) -> int:
    """Physical pages needed to hold ``seq_len`` tokens."""
    return -(-int(seq_len) // int(page_size)) if seq_len > 0 else 0


# ---------------------------------------------------------------------------
# device-side layout helpers (head-interleaved fused KV)
# ---------------------------------------------------------------------------

def fuse_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., Hkv, S, d) x2 -> (..., 2*Hkv, S, d) with heads interleaved
    ``[K0, V0, K1, V1, ...]``."""
    stacked = torch.stack([k, v], dim=-3)        # (..., Hkv, 2, S, d)
    shape = stacked.shape
    return stacked.reshape(shape[:-4] + (shape[-4] * 2,) + shape[-2:])


def split_kv(kv: torch.Tensor):
    """Inverse of :func:`fuse_kv`."""
    shape = kv.shape
    hkv = shape[-3] // 2
    pairs = kv.reshape(shape[:-3] + (hkv, 2) + shape[-2:])
    return pairs[..., 0, :, :], pairs[..., 1, :, :]


def init_pool(num_pages: int, kv_heads: int, page_size: int, d: int,
              dtype=torch.float32, device=None) -> torch.Tensor:
    """Zeroed pool ``(num_pages, 2*Hkv, page_size, d)`` on ``device``
    (the card unless the caller names another)."""
    return torch.zeros((num_pages, 2 * kv_heads, page_size, d),
                       dtype=dtype, device=default_device(device))


def gather_kv(pool: torch.Tensor, page_table: torch.Tensor):
    """Rebuild contiguous caches from the pool (a plain gather).

    pool: (P, 2*Hkv, ps, d); page_table: (B, m) -> k, v each
    (B, Hkv, m*ps, d).  Rows mapped to the null page come back as
    whatever page 0 holds -- positions beyond each slot's ``seq_pos``
    are masked by every consumer."""
    b, m = page_table.shape
    _, h2, ps, d = pool.shape
    tiles = pool[page_table.long()]              # (B, m, 2Hkv, ps, d)
    kv = tiles.permute(0, 2, 1, 3, 4).reshape(b, h2, m * ps, d)
    return split_kv(kv)


def append_token(pool: torch.Tensor, page_table: torch.Tensor,
                 pos: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, active=None) -> torch.Tensor:
    """Scatter one new K/V token per slot into its current page, **in
    place**; returns ``pool``.

    pool: (P, 2*Hkv, ps, d); page_table: (B, m); pos: (B,) the token's
    position; k_new/v_new: (B, Hkv, 1, d).  ``active`` (B,) bool routes
    the writes of finished / empty slots to the null page (page 0 is
    never read, so duplicate scatter targets there are harmless).  A
    position past the table's last page lands in the last mapped page,
    as the JAX package's clamped gather places it."""
    b = pos.shape[0]
    ps = pool.shape[2]
    pos = pos.long()
    blk = (pos // ps).clamp(max=page_table.shape[1] - 1)
    pages = page_table.long()[torch.arange(b, device=pos.device), blk]
    if active is not None:
        pages = torch.where(active.bool(), pages, NULL_PAGE)
    kv = fuse_kv(k_new, v_new)[:, :, 0, :].to(pool.dtype)   # (B, 2Hkv, d)
    pool[pages, :, pos % ps, :] = kv
    return pool


def write_prefill_pages(pool: torch.Tensor, pages: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Write one request's contiguous prefill KV into its pages, **in
    place**; returns ``pool``.

    pages: (n,) int physical page ids (pad entries = null page);
    k/v: (Hkv, S, d) with S <= n*ps -- the tail of the last page is
    zero padding (masked by ``seq_pos`` at read time)."""
    n = pages.shape[0]
    hkv, s, d = k.shape
    ps = pool.shape[2]
    kv = fuse_kv(k, v)                           # (2Hkv, S, d)
    pad = n * ps - s
    if pad:
        kv = torch.nn.functional.pad(kv, (0, 0, 0, pad))
    tiles = kv.reshape(2 * hkv, n, ps, d).permute(1, 0, 2, 3)
    pool[pages.long()] = tiles.to(pool.dtype)
    return pool


# ---------------------------------------------------------------------------
# host-side page-table assembly (what the scheduler maintains)
# ---------------------------------------------------------------------------

def build_page_table(num_slots: int, max_pages: int,
                     slot_pages: dict[int, Sequence[int]]) -> np.ndarray:
    """(num_slots, max_pages) i32 table from the scheduler's per-slot
    page lists; unmapped entries are the null page."""
    table = np.full((num_slots, max_pages), NULL_PAGE, np.int32)
    for slot, pages in slot_pages.items():
        pages = list(pages)
        if len(pages) > max_pages:
            raise ValueError(
                f"slot {slot} holds {len(pages)} pages, table has room "
                f"for {max_pages}")
        table[slot, :len(pages)] = pages
    return table
