"""Gradient compression for the data-parallel all-reduce: int8 blockwise
quantization with error feedback -- the JAX package's
``repro.optim.compression`` on tensors over ``torch.distributed``.

Each gradient (plus its error-feedback residual) is quantized per block
of :data:`BLOCK` values to int8 with one f32 scale a block, and the
quantization error is kept as the new residual, so the bias stays out
of the optimizer's trajectory (Seide et al. 2014; Karimireddy et al.
2019).  As in the JAX package, the ranks add the *dequantized* f32
values (the all-reduce moves f32; the int8 form is what a wire format
would carry) and divide by the group's size.

The JAX package's function runs inside a ``shard_map`` over the DP axes;
the port's takes the process group the mean is over (or a mesh and its
axis names).  ``torch.round`` and ``jnp.round`` both round half to even,
so the quantization is bit-equal to the JAX package's.  Neither
package's ``Trainer`` calls :func:`compressed_psum_grads`.
"""
from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32
BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization along the flattened tensor:
    (q int8 (blocks, BLOCK), scale f32 (blocks, 1)); a zero block gets
    scale 1."""
    flat = x.to(F32).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones((), dtype=F32,
                                               device=x.device), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape) -> torch.Tensor:
    """The f32 tensor of ``shape`` that ``(q, scale)`` encode."""
    n = 1
    for s in shape:
        n *= int(s)
    return (q.to(F32) * scale).reshape(-1)[:n].reshape(tuple(shape))


def compress_roundtrip(x: torch.Tensor) -> torch.Tensor:
    q, s = quantize_int8(x)
    return dequantize_int8(q, s, x.shape)


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts / lists / tuples of
    tensors (the first tree's structure)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def init_residual(params):
    """Zero f32 residuals beside every leaf of ``params``."""
    return _map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
                params)


def compressed_psum_grads(grads, residual, group=None, *, mesh=None,
                          axes=None):
    """Error-feedback compressed gradient mean over a process group.

    ``grads`` are this rank's local gradients (nested dicts / lists of
    tensors), ``residual`` the f32 residuals of the same structure.  The
    mean is over ``group`` (default: every rank), or over ``mesh``'s
    ``axes`` (default: its DP axes) when a mesh is given.  Returns
    ``(synced_grads, new_residual)``: each leaf the mean of the ranks'
    dequantized ``grad + residual``, in the gradient's dtype, and this
    rank's quantization error."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    if mesh is not None:
        from repro_torch.distributed.sharding import dp_axes
        from repro_torch.launch.mesh import axes_group
        group = axes_group(mesh, tuple(axes) if axes else dp_axes(mesh))
    n = dist.get_world_size(group)

    def one(g, r):
        gf = g.to(F32) + r
        q, s = quantize_int8(gf)
        deq = dequantize_int8(q, s, gf.shape)
        total = collectives.all_reduce_sum(deq.clone(), group)
        return (total / n).to(g.dtype), gf - deq

    pairs = _map(one, grads, residual)
    return (_map(lambda _, p: p[0], grads, pairs),
            _map(lambda _, p: p[1], grads, pairs))


__all__ = ["BLOCK", "compress_roundtrip", "compressed_psum_grads",
           "dequantize_int8", "init_residual", "quantize_int8"]
