"""The serving mesh's ``model`` axis: the tensor-parallel forward of the
attention projections, the SwiGLU MLP, the embedding and the LM head,
and the gather at use of every other sharded parameter.  Forward only:
training on a mesh comes with ROADMAP A12's last part.

:func:`repro_torch.distributed.sharding.shard_model` cuts each
parameter by the sharding rules (``param_spec_tree``, ``fsdp=False``)
and keeps each rank's piece.  Where the rules split the dense stack
into whole heads or whole hidden columns, the rank computes on its
pieces (:func:`mark` tags those modules):

* attention (``wq``/``wk``/``wv`` and their biases by columns, ``wo``
  by rows), when the query and KV heads both tile the axis: the rank
  projects its ``H / tp`` query and ``Hkv / tp`` KV heads, keeps only
  those in its KV cache or page pool, attends over them, and its rows
  of ``wo`` give a partial sum, added over the axis (:func:`reduce`);
* the MLP (``wi``/``wg`` by columns, ``wo`` by rows): the same pair;
* the embedding (vocabulary rows): the rank looks up the tokens its
  rows hold, zeros the others, and the pieces are added;
* the LM head (vocabulary columns): local logits, gathered along the
  vocabulary before sampling.  Both need ``padded_vocab % tp == 0``
  (:func:`check_vocab`).

Every other sharded parameter -- attention whose heads do not tile the
axis, the MoE experts, router and shared expert, MLA's projections, the
Mamba mixers, zamba2's shared block -- is all-gathered over its axis at
use, one layer at a time, and dropped after (:func:`at_use`).  So every
family the port serves also serves on a mesh, correct but not fast.
The JAX package reaches the same results through GSPMD, which
partitions each of these computations from the parameters' shardings;
the port gathers instead.

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


def reduce(module, x: torch.Tensor) -> torch.Tensor:
    """``x``, a tensor-parallel module's partial sum, added over its
    model axis (``x`` itself for any other module)."""
    g = group_of(module)
    return x if g is None else collectives.all_reduce(x, g.group)


def gather(module, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x``, a tensor-parallel module's piece along ``dim``, gathered
    over its model axis (``x`` itself for any other module)."""
    g = group_of(module)
    if g is None:
        return x
    return collectives.all_gather(x.contiguous(), dim % x.ndim, g.group)


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
    return collectives.all_reduce(rows, g.group)


def _gathered(module: nn.Module) -> nn.Module:
    """A shallow copy of ``module`` whose sharded parameters are the
    global tensors (gathered now), its tensor-parallel submodules kept
    as they are."""
    from .sharding import gather_tensor
    out = copy.copy(module)
    out._parameters = {
        n: (gather_tensor(p, p._layout) if hasattr(p, "_layout") else p)
        for n, p in module._parameters.items()}
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
