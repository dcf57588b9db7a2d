"""Process-wide memo for host-built execution tables.

Decode LUTs (and their device copies) are pure functions of
``(domain, plan axes, device)``, so every launch of a plan-driven
kernel reads them from here instead of rebuilding them.

Domains opt in by exposing ``cache_key`` (a hashable tuple fully
describing the instance); domains without one -- e.g. a
``BoundingBoxDomain`` closed over an arbitrary membership callable --
are uncacheable and every lookup falls through to the builder.

Entries are host numpy arrays (marked read-only by their builders),
device tensors or small frozen helper objects; sizes are bounded by the
geometry already resident per plan, so no eviction is needed --
``clear()`` exists for tests.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

_CACHE: dict = {}
#: lookup statistics, readable by tests: hits avoid a host-table rebuild.
STATS = {"hits": 0, "misses": 0}


def domain_key(domain) -> Optional[Tuple]:
    """The domain's identity for memoization, or None when the domain
    cannot guarantee one."""
    key = getattr(domain, "cache_key", None)
    return key() if callable(key) else key


def cached(kind: str, domain, extra: Tuple, build: Callable):
    """Return ``build()`` memoized under ``(kind, domain, *extra)``.

    ``extra`` must be hashable and must capture every input of
    ``build`` besides the domain (lowering, storage, coarsen, device...).
    A domain without a cache key disables memoization for that call.
    """
    dk = domain_key(domain)
    if dk is None:
        STATS["misses"] += 1
        return build()
    key = (kind, dk) + tuple(extra)
    hit = _CACHE.get(key)
    if hit is not None:
        STATS["hits"] += 1
        return hit
    STATS["misses"] += 1
    out = build()
    _CACHE[key] = out
    return out


def clear() -> None:
    _CACHE.clear()
    STATS["hits"] = STATS["misses"] = 0


def size() -> int:
    return len(_CACHE)
