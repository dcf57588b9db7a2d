"""Plain-torch oracles for the port's kernels, the counterparts of the
JAX package's ``kernels/ref.py``.

Deliberately naive: full materialization of the dense membership grid,
no tiling, no block decode.  The attention oracles come with the
attention kernels.
"""
from __future__ import annotations

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
