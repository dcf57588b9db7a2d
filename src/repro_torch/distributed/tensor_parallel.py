"""The mesh's ``model`` axis: the tensor-parallel attention projections,
SwiGLU MLP, embedding and LM head, the gather at use of every other
sharded parameter, and the collectives of the trainer on a mesh, each
an autograd function with the gradient its place in the step needs.

:func:`repro_torch.distributed.sharding.shard_model` cuts each
parameter by the sharding rules (``param_spec_tree``) and keeps each
rank's piece.  Where the rules split the dense stack into whole heads or
whole hidden columns, the rank computes on its pieces (:func:`mark`
tags those modules), Megatron's f/g pair around them:

* attention (``wq``/``wk``/``wv`` and their biases by columns, ``wo``
  by rows), when the query and KV heads both tile the axis: the rank
  projects its ``H / tp`` query and ``Hkv / tp`` KV heads, keeps only
  those in its KV cache or page pool, attends over them, and its rows
  of ``wo`` give a partial sum, added over the axis (:func:`reduce`:
  an all-reduce, the gradient passed through); the input enters through
  :func:`enter` (the identity, the gradient all-reduced: each rank's
  columns give part of it);
* the MLP (``wi``/``wg`` by columns, ``wo`` by rows): the same pair;
* the embedding (vocabulary rows): the rank looks up the tokens its
  rows hold, zeros the others, and the pieces are added (the gradient
  passed through: each row has one owner);
* the LM head (vocabulary columns): :func:`enter`, then local logits
  gathered along the vocabulary (the gradient cut back to the rank's
  columns).  Both need ``padded_vocab % tp == 0`` (:func:`check_vocab`).

Every other sharded parameter -- attention whose heads do not tile the
axis, the MoE experts, router and shared expert, MLA's projections, the
Mamba mixers, zamba2's shared block, and under ``fsdp`` the leaves cut
over the DP axes -- is all-gathered at use, one layer at a time, and
dropped after (:func:`at_use`).  Every rank of the model axis then
computes the module alike on the same input, so the gathered leaf's
gradient is the same on each and is cut back to the rank's piece; over
a DP axis each rank's gradient is its own batch's part, so the pieces
are summed over the axis (a reduce-scatter) and the trainer divides by
the DP size as for every other leaf.  The JAX package reaches the same
results through GSPMD, which partitions each of these computations
from the parameters' shardings; the port gathers instead.

A reduce-scatter here is an all-reduce over :mod:`.collectives`, in
pieces of at most :data:`REDUCE_CHUNK` values, of which the rank keeps
its part.

bf16 partial sums are added in f32 and rounded once
(:func:`repro_torch.distributed.collectives.all_reduce`), so a
tensor-parallel result differs from one device's by the rounding of
the split reductions, not by more.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from . import collectives


@dataclasses.dataclass(frozen=True, eq=False)
class TPGroup:
    """The ``model`` axis a tensor-parallel module runs over."""
    mesh: Any
    group: Any
    size: int
    rank: int


def check_vocab(cfg, tp: int) -> None:
    """Raise unless the padded vocabulary tiles the model axis (the
    embedding's rows and the LM head's columns are split along it)."""
    if tp > 1 and cfg.padded_vocab % tp:
        raise ValueError(
            f"{cfg.name}: padded_vocab {cfg.padded_vocab} does not tile "
            f"the model axis of {tp}")


def _spec_is(p, *want) -> bool:
    lay = getattr(p, "_layout", None)
    return lay is not None and tuple(lay.spec) == tuple(want)


def _tp_attention(a, cfg, tp: int) -> bool:
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        return False
    names = ["wq", "wk", "wv"] + (["bq", "bk", "bv"] if cfg.qkv_bias else [])
    return (all(_spec_is(getattr(a, n), *((None, "model") if n[0] == "w"
                                          else ("model",)))
                for n in names)
            and _spec_is(a.wo, "model", None))


def _tp_mlp(m, tp: int) -> bool:
    return (_spec_is(m.wi, None, "model") and _spec_is(m.wg, None, "model")
            and _spec_is(m.wo, "model", None)
            and m.wi._layout.shape[1] % tp == 0)


def mark(model, mesh) -> None:
    """Tag the modules of a laid-out ``model`` that run tensor-parallel
    on their pieces (``_tp``); every other sharded module is gathered at
    use.  A mesh whose model axis is 1 tags nothing."""
    from repro_torch.launch.mesh import axis_group, axis_rank, axis_size
    from repro_torch.models import layers as L
    tp = axis_size(mesh, "model")
    if tp == 1:
        return
    cfg = model.cfg
    grp = TPGroup(mesh, axis_group(mesh, "model"), tp,
                  axis_rank(mesh, "model"))
    if hasattr(model, "embed"):
        if not _spec_is(model.embed.table, "model", None):
            raise ValueError("the embedding is not split by vocabulary rows")
        model.embed._tp = grp
    if not _spec_is(model.lm_head.w, None, "model"):
        raise ValueError("the LM head is not split by vocabulary columns")
    model.lm_head._tp = grp
    for layer in model.layers:
        if isinstance(layer.mixer, L.Attention) and _tp_attention(
                layer.mixer, cfg, tp):
            layer.mixer._tp = grp
        ffn = getattr(layer, "ffn", None)
        if isinstance(ffn, L.MLP) and _tp_mlp(ffn, tp):
            ffn._tp = grp


def kv_heads(attn, cfg) -> int:
    """The KV heads an attention module's caches hold on this rank: its
    share under tensor parallelism, else all of them."""
    g = group_of(attn)
    return cfg.n_kv_heads if g is None else cfg.n_kv_heads // g.size


def group_of(module):
    """The TPGroup a module runs over, or None."""
    return getattr(module, "_tp", None)


# ---------------------------------------------------------------------------
# collectives with their gradients
# ---------------------------------------------------------------------------

#: values of one all-reduce of a reduce-scatter: bounds its f32 and
#: pinned host temporaries when an fsdp leaf's whole gradient is large
REDUCE_CHUNK = 1 << 25


def _sum_over(g: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``g`` over the group's ranks, a new tensor of ``g``'s
    dtype, all-reduced :data:`REDUCE_CHUNK` values at a time."""
    flat = g.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    for lo in range(0, flat.numel(), REDUCE_CHUNK):
        hi = min(lo + REDUCE_CHUNK, flat.numel())
        out[lo:hi] = collectives.all_reduce(flat[lo:hi], group)
    return out.reshape(g.shape)


def _pad_dim(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    if x.shape[dim] >= n:
        return x
    pad = [0, 0] * (x.ndim - 1 - dim) + [0, n - x.shape[dim]]
    return torch.nn.functional.pad(x, pad)


class _Enter(torch.autograd.Function):
    """Megatron's f: the identity; the gradient all-reduced."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce(g.contiguous(), ctx.group), None


class _Reduce(torch.autograd.Function):
    """Megatron's g: an all-reduce; the gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        return collectives.all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` of pieces of ``ceil(n / size)`` (the
    last ones shorter), trimmed to ``n``.  The gradient is cut back to
    the rank's piece: as it is (``"slice"``: every rank computed alike
    on the whole) or summed over the ranks first (``"sum"``: each rank's
    gradient is a part)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, mode):
        size = dist.get_world_size(group)
        chunk = -(-n // size)
        ctx.dim, ctx.group, ctx.mode, ctx.chunk = dim, group, mode, chunk
        ctx.length = x.shape[dim]
        full = collectives.all_gather(_pad_dim(x, dim, chunk).contiguous(),
                                      dim, group)
        return full.narrow(dim, 0, n)

    @staticmethod
    def backward(ctx, g):
        if ctx.mode == "none":
            raise ValueError("a gather over DP and other axes together has "
                             "no gradient rule")
        size = dist.get_world_size(ctx.group)
        index = dist.get_rank(ctx.group)
        g = _pad_dim(g, ctx.dim, size * ctx.chunk)
        if ctx.mode == "sum":
            g = _sum_over(g, ctx.group)
        piece = g.narrow(ctx.dim, index * ctx.chunk, ctx.length)
        return piece.contiguous(), None, None, None, None


class _Split(torch.autograd.Function):
    """The rank's piece along ``dim`` (which its size tiles); the
    gradient all-gathered."""

    @staticmethod
    def forward(ctx, x, dim, group):
        size = dist.get_world_size(group)
        index = dist.get_rank(group)
        chunk = x.shape[dim] // size
        ctx.dim, ctx.group = dim, group
        return x.narrow(dim, index * chunk, chunk).clone()

    @staticmethod
    def backward(ctx, g):
        return (collectives.all_gather(g.contiguous(), ctx.dim, ctx.group),
                None, None)


def gather_along(x: torch.Tensor, dim: int, group, n: int,
                 backward: str = "slice") -> torch.Tensor:
    """The global tensor (``n`` long along ``dim``) from every rank's
    piece ``x`` (pieces of ``ceil(n / size)``, the last ones shorter or
    empty); the gradient cut back to the piece as it is (``backward=
    "slice"``) or after summing it over the group (``"sum"``); with
    ``"none"`` a backward through it raises."""
    if backward not in ("slice", "sum", "none"):
        raise ValueError(f"backward must be 'slice', 'sum' or 'none', got "
                         f"{backward!r}")
    return _Gather.apply(x, dim % x.ndim, group, int(n), backward)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The rank's piece of ``x`` along ``dim`` (the group's size must
    tile it); the gradient all-gathered."""
    return _Split.apply(x, dim % x.ndim, group)


def enter(module, x: torch.Tensor) -> torch.Tensor:
    """The input of a tensor-parallel module's column-parallel
    projections: ``x`` itself, its gradient all-reduced over the model
    axis (``x`` itself for any other module)."""
    g = group_of(module)
    return x if g is None else _Enter.apply(x, g.group)


def reduce(module, x: torch.Tensor) -> torch.Tensor:
    """``x``, a tensor-parallel module's partial sum, added over its
    model axis (``x`` itself for any other module)."""
    g = group_of(module)
    return x if g is None else _Reduce.apply(x, g.group)


def gather(module, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x``, a tensor-parallel module's piece along ``dim``, gathered
    over its model axis (``x`` itself for any other module)."""
    g = group_of(module)
    if g is None:
        return x
    return gather_along(x, dim, g.group, x.shape[dim] * g.size)


def embed_rows(module, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` (before the cast): looked up in
    this rank's vocabulary rows, zero elsewhere, added over the axis.
    Exact: each row has one owner."""
    g = group_of(module)
    table = module.table
    if g is None:
        return table[tokens]
    lo = g.rank * table.shape[0]
    local = tokens - lo
    own = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    rows = torch.where(own[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))
    return _Reduce.apply(rows, g.group)


class _SumOver(torch.autograd.Function):
    """An all-reduce whose gradient is all-reduced too: the ranks'
    partial results, each rank's loss using the sum (the experts' hidden
    dimension cut over the DP axes: every DP rank adds its own batch's
    part of the gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collectives.all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce(g.contiguous(), ctx.group), None


def expert_sum(module, y: torch.Tensor) -> torch.Tensor:
    """The experts' output ``y``: summed over the DP ranks when the
    module computes on its pieces of the experts' hidden dimension
    (:func:`at_use` under ``fsdp``), else ``y``."""
    group = getattr(module, "_expert_group", None)
    return y if group is None else _SumOver.apply(y, group)


#: an MoE module's expert leaves and the dimension of each that holds
#: the experts' hidden size F
_EXPERT_F = {"wi": 2, "wg": 2, "wo": 1}


def _expert_axes(module):
    """The DP axes over which an MoE module's experts are cut along F
    alone (``fsdp``'s expert rule), or None."""
    from .sharding import DP_AXES, _dims
    params = module._parameters
    if "router" not in params or not all(n in params for n in _EXPERT_F):
        return None
    axes = set()
    for n, f in _EXPERT_F.items():
        lay = getattr(params[n], "_layout", None)
        if lay is None:
            return None
        for dim, axis, _, _ in _dims(lay.spec, lay.mesh):
            names = axis if isinstance(axis, tuple) else (axis,)
            if all(a in DP_AXES for a in names):
                if dim != f:
                    return None
                axes.add(axis)
    return axes.pop() if len(axes) == 1 else None


def _gathered(module: nn.Module) -> nn.Module:
    """A shallow copy of ``module`` whose sharded parameters are the
    global tensors (gathered now), its tensor-parallel submodules kept
    as they are.  An MoE module whose experts ``fsdp`` cuts along their
    hidden dimension F over DP axes keeps those pieces (gathered over
    ``model`` only): each DP rank computes its part of every expert's
    SwiGLU and the parts are added (:func:`expert_sum`), so no rank holds
    the whole experts."""
    from repro_torch.launch.mesh import axis_group
    from .sharding import gather_tensor
    out = copy.copy(module)
    fsdp = _expert_axes(module)
    out._parameters = {
        n: (gather_tensor(p, p._layout,
                          keep=fsdp if n in _EXPERT_F else None)
            if hasattr(p, "_layout") else p)
        for n, p in module._parameters.items()}
    if fsdp is not None:
        out._expert_group = axis_group(
            module._parameters["wi"]._layout.mesh, fsdp)
    out._modules = {n: at_use(m) for n, m in module._modules.items()}
    return out


def at_use(module):
    """The module a forward step computes with: ``module`` itself when it
    holds no sharded parameter or runs tensor-parallel on its pieces,
    else a copy holding the gathered global tensors (dropped when the
    caller lets it go).  The one gather-at-use helper of the mesh."""
    if (module is None or not getattr(module, "_sharded", False)
            or group_of(module) is not None):
        return module
    return _gathered(module)
