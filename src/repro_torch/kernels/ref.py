"""Plain-torch oracles for the port's kernels, the counterparts of the
JAX package's ``kernels/ref.py``.

Deliberately naive: full materialization of the dense membership grid,
no tiling, no block decode.  Only the write/sum half is ported so far.
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
