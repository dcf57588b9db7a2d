"""Plain-torch oracles for the port's kernels, the counterparts of the
JAX package's ``kernels/ref.py``.

Deliberately naive: full materialization of the dense membership grid
(or of the whole attention score matrix), no tiling, no block decode.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fractal as F


def _gasket_mask(m: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(F.membership_grid(m.shape[0])).to(m.device)


def sierpinski_write_ref(m: torch.Tensor, value) -> torch.Tensor:
    """Write ``value`` at every gasket cell of the embedded n x n matrix."""
    v = torch.tensor(value, dtype=m.dtype, device=m.device)
    return torch.where(_gasket_mask(m), v, m)


def sierpinski_sum_ref(m: torch.Tensor) -> torch.Tensor:
    """f32 sum over the gasket cells of the embedded matrix."""
    return torch.where(_gasket_mask(m), m, 0).to(torch.float32).sum()


# ---------------------------------------------------------------------------
# Cellular automaton / diffusion on the embedded gasket
# ---------------------------------------------------------------------------

def _neighbor_shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Value of the (dy, dx)-neighbor at each cell, 0 outside the matrix."""
    n = a.shape[0]
    out = torch.roll(a, shifts=(dy, dx), dims=(0, 1))
    if dy == 1:
        out[0, :] = 0
    if dy == -1:
        out[n - 1, :] = 0
    if dx == 1:
        out[:, 0] = 0
    if dx == -1:
        out[:, n - 1] = 0
    return out


def ca_step_ref(state: torch.Tensor, rule: str = "parity",
                alpha: float = 0.25) -> torch.Tensor:
    """One CA / diffusion step restricted to gasket cells.

    parity:    s' = (s + N + S + W + E) mod 2           (Wolfram-style)
    diffusion: s' = s + alpha * sum_{nbr in gasket}(nbr - s)   (graph heat eq)
    Non-member cells stay 0 in both rules.
    """
    member = _gasket_mask(state)
    nb = [_neighbor_shift(state, dy, dx)
          for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1))]
    nsum = nb[0] + nb[1] + nb[2] + nb[3]
    if rule == "parity":
        x = state + nsum
        r = torch.fmod(x, 2)
        new = torch.where((r != 0) & (r < 0), r + 2, r)  # floor mod
    elif rule == "diffusion":
        nbm = [_neighbor_shift(member.to(state.dtype), dy, dx)
               for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1))]
        deg = nbm[0] + nbm[1] + nbm[2] + nbm[3]
        new = state + alpha * (nsum - deg * state)
    else:
        raise ValueError(rule)
    return torch.where(member, new, 0).to(state.dtype)


# ---------------------------------------------------------------------------
# Attention (causal / local / full), GQA-aware
# ---------------------------------------------------------------------------

def attention_mask(kind: str, sq: int, sk: int, window: int = 0,
                   device=None) -> torch.Tensor:
    """(sq, sk) boolean mask. ``window`` is in tokens for kind="local".

    For causal/local with sq != sk the queries are assumed to be the
    *last* sq positions of the sk-long key sequence (decode convention).
    """
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    if kind == "full":
        return torch.ones((sq, sk), dtype=torch.bool, device=device)
    if kind == "causal":
        return kpos <= qpos
    if kind == "local":
        return (kpos <= qpos) & (kpos > qpos - window)
    raise ValueError(kind)


def attention_ref(q, k, v, kind: str = "causal", window: int = 0,
                  scale: float | None = None) -> torch.Tensor:
    """Naive softmax attention. q: (B,H,Sq,D); k,v: (B,Hkv,Sk,D), Hkv | H.
    Rows with no live key (fully masked) come out 0."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    group = h // hkv
    kk = k.repeat_interleave(group, dim=1).to(torch.float32)
    vv = v.repeat_interleave(group, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk) * scale
    mask = attention_mask(kind, sq, sk, window, device=q.device)
    s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # fully-masked rows -> 0
    o = torch.einsum("bhqk,bhkd->bhqd", p, vv)
    return o.to(q.dtype)
