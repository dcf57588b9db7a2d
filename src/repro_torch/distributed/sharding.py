"""Sharding rules: name-pattern parameter PartitionSpecs, the batch,
activation and cache specs, and the DP/TP mapping onto the (data, model)
mesh -- the JAX package's ``repro.distributed.sharding``, as pure
functions of shapes, configs and mesh axis sizes, plus the port's own
placement of tensors on a :class:`~torch.distributed.device_mesh.
DeviceMesh` (:func:`shard_tensor`, :func:`gather_tensor`,
:func:`shard_model`).

Axis semantics (as in the JAX package):
  * ``pod``   -- outermost data parallelism across pods (multi-pod mesh)
  * ``data``  -- intra-pod data parallelism (batch); doubles as the FSDP
                 axis for expert weights on the big MoE archs and as the
                 sequence axis for long-context decode caches
  * ``model`` -- tensor parallelism (heads / ffn hidden / experts / vocab)

:class:`PartitionSpec` and :class:`NamedSharding` stand in for
``jax.sharding``'s: a spec is a tuple of axis names (or ``None``, or a
tuple of names) per dimension, normalised as JAX normalises it (a
one-name tuple is the name, an empty tuple is ``None``); a sharding
pairs it with a mesh.  The mesh may be a ``DeviceMesh`` or any object
whose ``shape`` maps an axis name to its size (and whose
``axis_names``, if present, orders them).

The port's layer stack is a list of per-layer modules where the JAX
package stacks each group's layers along a leading axis
(``blocks/slot_s/...``).  :func:`param_spec_tree` walks the port's
model by the JAX paths (:func:`repro_torch.models.convert.jax_paths`),
so the same rules match the same leaves, and gives each per-layer
tensor the JAX package's stacked spec without its leading ``None`` (the
scan axis): the two packages place every layer's tensor alike.

A rank keeps only its shard of a sharded parameter at rest
(:func:`shard_model`; a dimension of ``n`` over an axis of size ``k`` is
cut into pieces of ``ceil(n / k)``, the last ones shorter or empty, as a
padded JAX shard).  What each rank then computes on them is
:mod:`repro_torch.distributed.tensor_parallel`'s.

Activation layouts (the trainer on a mesh): ``activation_specs``
installs :func:`act_specs`' shardings in a ``contextvars.ContextVar``
and the model code stays mesh-agnostic, as in the JAX package.  Where
the JAX package's ``constrain(x, name)`` pins a layout for GSPMD, the
port's moves the tensor: the only layout it changes is the
``"residual"``'s under ``seq_shard`` (the rank keeps its piece of the
sequence, :func:`constrain`), and :func:`whole_sequence` is its inverse
before each block.  Every other name is a layout the rank's modules
already compute in (a tensor-parallel module's hidden columns and heads
are its own pieces; the MoE runs over the global batch's tokens,
:func:`global_tokens`).  With no specs installed all of these are
no-ops, so serving and one device run as before.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence

import torch

DP_AXES = ("pod", "data")   # batch axes (pod may be absent on 1-pod mesh)


class PartitionSpec(tuple):
    """A tuple of per-dimension axis entries: ``None`` (replicated), an
    axis name, or a tuple of axis names.  A one-name tuple normalises to
    the name and an empty tuple to ``None``, as ``jax.sharding.
    PartitionSpec`` does."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                if not p:
                    return None
                return p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh: ``jax.sharding.NamedSharding``'s two fields."""
    mesh: Any
    spec: PartitionSpec


# ---------------------------------------------------------------------------
# reading a mesh
# ---------------------------------------------------------------------------

def axis_names(mesh) -> tuple:
    """The mesh's axis names in order: a DeviceMesh's dimension names, a
    stand-in's ``axis_names``, or the keys of its ``shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names)
    names = getattr(mesh, "axis_names", None)
    if names is not None:
        return tuple(names)
    return tuple(mesh.shape)


def axis_size(mesh, axis: str) -> int:
    from repro_torch.launch.mesh import axis_size as size
    return size(mesh, axis)


def dp_axes(mesh):
    return tuple(a for a in DP_AXES if a in axis_names(mesh))


def live_dp_axes(mesh) -> tuple:
    """(the DP axes of ``mesh`` larger than 1, their product): the axes
    a rank's share of the batch is cut over."""
    axes = tuple(a for a in dp_axes(mesh) if axis_size(mesh, a) > 1)
    size = 1
    for a in axes:
        size *= axis_size(mesh, a)
    return axes, size


# ---------------------------------------------------------------------------
# parameter specs by name pattern
# ---------------------------------------------------------------------------

# (regex over the '/'-joined param path, its spec).  `fsdp_axes`
# enables sharding the big expert / ffn / lora weights over the data
# (and pod) axes too (ZeRO-3 style).
def _rules(fsdp_axes, ep_data: bool = False):
    dat = fsdp_axes if fsdp_axes else None
    if ep_data:
        # gather-free expert parallelism: experts stationary, sharded
        # E over 'data' and F over 'model'; tokens move (all-to-all)
        expert_rules = [
            (r"ffn/router$",  P(None, None)),
            (r"ffn/w[ig]$",   P("data", None, "model")),
            (r"ffn/wo$",      P("data", "model", None)),
        ]
    else:
        expert_rules = [
            (r"ffn/router$",  P(dat, None)),
            (r"ffn/w[ig]$",   P("model", None, dat)),
            (r"ffn/wo$",      P("model", dat, None)),
        ]
    return expert_rules + [
        (r"embed/table$",            P("model", None)),
        (r"lm_head/w$",              P(None, "model")),
        # attention
        (r"(mixer|attn)/w[qkv]$",    P(None, "model")),
        (r"(mixer|attn)/wo$",        P("model", None)),
        (r"(mixer|attn)/b[qkv]$",    P("model")),
        # MLA
        (r"mixer/wq_a$",             P(dat, None)),
        (r"mixer/wq_b$",             P(None, "model")),
        (r"mixer/wkv_a$",            P(dat, None)),
        (r"mixer/wkv_b$",            P(None, "model")),
        (r"mixer/(q|kv)_norm$",      P(None)),
        # dense mlp
        (r"(ffn|mlp|shared)/w[ig]$", P(dat, "model")),
        (r"(ffn|mlp|shared)/wo$",    P("model", dat)),
        # mamba
        (r"mixer/in_proj$",          P(None, "model")),
        (r"mixer/conv_w$",           P("model", None)),
        (r"mixer/conv_b$",           P("model")),
        (r"mixer/x_proj$",           P("model", None)),
        (r"mixer/dt_proj$",          P(None, "model")),
        (r"mixer/dt_bias$",          P("model")),
        (r"mixer/A_log$",            None),  # shape-dependent, see below
        (r"mixer/D$",                P("model")),
        (r"mixer/norm_scale$",       P("model")),
        (r"mixer/out_proj$",         P("model", None)),
        # shared-attn in_proj, norms, everything small: replicate
        (r"shared_attn/in_proj$",    P(None, None)),
        (r".*norm.*",                P()),
        (r".*",                      P()),
    ]


def _spec_for(rules, path: str, ndim: int) -> PartitionSpec:
    """The first rule's spec for a leaf of ``ndim`` dimensions at
    ``path``, padded with ``None`` to ``ndim``."""
    for pat, spec in rules:
        if re.search(pat, path):
            if spec is None:  # A_log: (di,n) for mamba1, (nh,) for m2
                spec = P("model", None) if ndim == 2 else P("model")
            if len(spec) > ndim:
                continue  # rule for a higher-rank leaf (e.g. expert
                          # (E,D,F) rule vs a dense (D,F) ffn)
            return P(*(tuple(spec) + (None,) * (ndim - len(spec))))
    return P()


def param_spec_tree(model, cfg=None, *, fsdp: bool = False,
                    fsdp_axes=("data",),
                    ep_data: bool = False) -> Dict[str, PartitionSpec]:
    """The PartitionSpec of every parameter of the port's ``model`` (a
    :class:`~repro_torch.models.model.Model`, on any device, ``meta``
    included), by the port's parameter name.  A per-layer tensor of a
    stacked JAX group (``blocks/...``) gets the JAX package's stacked
    spec without its leading ``None``; every other leaf its spec as it
    is.  ``cfg`` is taken for the JAX package's signature; the model's
    own config decides the layout."""
    from repro_torch.models.convert import jax_paths
    rules = _rules(tuple(fsdp_axes) if fsdp else None, ep_data=ep_data)
    paths = jax_paths(model)
    return {name: _spec_for(rules, paths[name], p.ndim)
            for name, p in model.named_parameters()}


def named_sharding_tree(spec_tree, mesh):
    """``spec_tree`` (a dict, list or tuple of PartitionSpecs, nested)
    with every spec paired with ``mesh``."""
    if isinstance(spec_tree, PartitionSpec):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named_sharding_tree(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(named_sharding_tree(v, mesh)
                               for v in spec_tree)
    raise TypeError(f"not a spec tree leaf: {spec_tree!r}")


# ---------------------------------------------------------------------------
# batch / cache / activation specs
# ---------------------------------------------------------------------------

def batch_specs(mesh, input_mode: str):
    """Input shardings for a train/prefill batch."""
    dp = dp_axes(mesh)
    if input_mode == "tokens":
        inp = P(dp, None)
    else:
        inp = P(dp, None, None)
    return {"inputs": NamedSharding(mesh, inp),
            "labels": NamedSharding(mesh, P(dp, None))}


def act_specs(mesh, *, seq_shard: bool = False, ep_data: bool = False):
    """Residual-stream activation constraint.  seq_shard=True shards the
    sequence over 'model' (sequence parallelism between blocks)."""
    dp = dp_axes(mesh)
    spec = P(dp, "model", None) if seq_shard else P(dp, None, None)
    all_axes = dp + ("model",)
    ep_ax = "data" if ep_data else "model"
    return {"residual": NamedSharding(mesh, spec),
            # MoE dispatch buffer: expert-major rows (EP axis)
            "moe_experts": NamedSharding(mesh, P(ep_ax, None, None)),
            # flat token tables: rows over every mesh axis
            "moe_tokens": NamedSharding(mesh, P(all_axes, None)),
            # Megatron TP intermediates (see ModelConfig.megatron_sp)
            "mlp_hidden": NamedSharding(mesh, P(dp, None, "model")),
            "attn_heads": NamedSharding(mesh, P(dp, "model", None, None))}


_ACT_SPECS: contextvars.ContextVar[Optional[Dict[str, NamedSharding]]] = \
    contextvars.ContextVar("activation_specs", default=None)


@contextlib.contextmanager
def activation_specs(specs: Dict[str, NamedSharding]):
    """Install ``specs`` (:func:`act_specs`') for the block."""
    tok = _ACT_SPECS.set(specs)
    try:
        yield
    finally:
        _ACT_SPECS.reset(tok)


def recompute_context():
    """``context_fn`` for ``torch.utils.checkpoint``: the recomputation
    in the backward (on the autograd engine's thread, which does not see
    this thread's context) runs under the specs installed now."""
    return contextlib.nullcontext(), activation_specs(_ACT_SPECS.get())


def _seq_cut(specs):
    """(the group, its size) of the axis the residual spec cuts the
    sequence (dim 1) over, when it is larger than 1; else None."""
    if specs is None or "residual" not in specs:
        return None
    sh = specs["residual"]
    from repro_torch.launch.mesh import axis_group
    for dim, axis, size, _ in _dims(sh.spec, sh.mesh):
        if dim == 1:
            return axis_group(sh.mesh, axis), size
    return None


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` laid out as the installed spec ``name`` says, from the
    layout the one-device code gives it (the rank's batch rows, the whole
    sequence).  ``"residual"`` under ``seq_shard``: the rank's piece of
    the sequence (the gradient all-gathered back).  Any other name, or
    no specs: ``x`` (see the module docstring)."""
    if name != "residual":
        return x
    cut = _seq_cut(_ACT_SPECS.get())
    if cut is None:
        return x
    from .tensor_parallel import split
    group, size = cut
    if x.shape[1] % size:
        raise ValueError(f"seq_shard: a sequence of {x.shape[1]} does not "
                         f"tile the model axis of {size}")
    return split(x, 1, group)


def whole_sequence(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`constrain` on the residual: the whole
    sequence from the rank's piece (all-gathered over the model axis),
    for a block that needs it; every rank of the axis then computes the
    block alike, so the gradient is cut back to the piece.  ``x`` itself
    without ``seq_shard``."""
    cut = _seq_cut(_ACT_SPECS.get())
    if cut is None:
        return x
    from .tensor_parallel import gather_along
    group, size = cut
    return gather_along(x, 1, group, x.shape[1] * size)


def global_tokens(x: torch.Tensor):
    """(the global batch's (B, S, ...) tensor on every DP rank, this
    rank's rows) from its rows ``x``, while specs are installed on a
    mesh whose DP axes are larger than 1; ``(x, None)`` otherwise.  The
    MoE routes the global batch as the JAX package's GSPMD step does
    (capacity, the within-expert ranks and the aux loss follow every
    token); the gradient of the gathered tokens is summed over the DP
    ranks (each adds its own loss's part)."""
    specs = _ACT_SPECS.get()
    if specs is None or "residual" not in specs:
        return x, None
    mesh = specs["residual"].mesh
    axes, size = live_dp_axes(mesh)
    if size == 1:
        return x, None
    from repro_torch.launch.mesh import axes_group, axes_rank
    from .tensor_parallel import gather_along
    b = x.shape[0]
    index = axes_rank(mesh, axes)
    xg = gather_along(x, 0, axes_group(mesh, axes), b * size,
                      backward="sum")
    return xg, (index * b, (index + 1) * b)


def local_rows(x: torch.Tensor, rows) -> torch.Tensor:
    """This rank's rows of a :func:`global_tokens` result (``x`` when
    ``rows`` is None)."""
    return x if rows is None else x[rows[0]:rows[1]]


def _cache_spec(shape, cfg, bax, sax, tp) -> PartitionSpec:
    """The JAX package's cache rule for one unstacked cache leaf."""
    nd = len(shape)
    if nd == 4 and shape[1] == cfg.n_kv_heads and shape[3] == cfg.hd:
        # attn kv (B, Hkv, S, hd): heads over model when divisible,
        # else the head dim (GQA kv=8 on tp=16)
        if cfg.n_kv_heads % tp == 0:
            return P(bax, "model", sax, None)
        return P(bax, None, sax, "model")
    if nd == 4:
        # mamba2 h (B, nh, N, P): heads over model
        return P(bax, "model" if cfg.ssd_heads % tp == 0 else None,
                 None, None)
    if nd == 3 and shape[1] == cfg.d_inner and cfg.ssm_kind:
        # mamba1 h (B, di, n): channels over model
        return P(bax, "model", None)
    if nd == 3 and cfg.ssm_kind and shape[1] == cfg.conv_kernel - 1:
        # conv cache (B, K-1, C): channels over model
        return P(bax, None, "model")
    if nd == 3:
        # mla latents (B, S, L/dr): seq over data when not batch-sharded
        return P(bax, sax, None)
    return P(*([bax] + [None] * (nd - 1)))


def cache_spec_tree(caches: Sequence[Sequence[Any]], cfg, mesh,
                    batch: int) -> List[tuple]:
    """KV/state cache shardings, matched on exact shapes from the config,
    for the port's cache layout (a list, one tuple per layer, of
    tensors or anything with a ``shape``: :func:`repro_torch.models.
    model.init_cache`'s).  Batch >= dp size -> shard batch; else shard
    the sequence axis over 'data' (long-context single-request
    serving).  A layer's leaves get the JAX package's stacked specs
    without their leading ``None``, as :func:`param_spec_tree`'s."""
    dp = dp_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= axis_size(mesh, a)
    batch_sharded = batch >= dp_size and batch % dp_size == 0
    bax = dp if batch_sharded else None
    sax = None if batch_sharded else "data"
    tp = axis_size(mesh, "model")
    return [tuple(NamedSharding(mesh, _cache_spec(tuple(x.shape), cfg, bax,
                                                  sax, tp))
                  for x in layer)
            for layer in caches]


# ---------------------------------------------------------------------------
# placing tensors on a DeviceMesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """How a rank's tensor sits in the global one: the mesh, the spec and
    the global shape."""
    mesh: Any
    spec: PartitionSpec
    shape: tuple


def shard_bounds(n: int, size: int, index: int) -> tuple:
    """[lo, hi) of piece ``index`` of ``size`` pieces of a dimension of
    ``n``: pieces of ``ceil(n / size)``, the last ones shorter or
    empty."""
    chunk = -(-n // size)
    return min(n, index * chunk), min(n, (index + 1) * chunk)


def _dims(spec: PartitionSpec, mesh):
    """(dim, axis, size, this rank's coordinate) of every dimension of
    ``spec`` sharded over axes of ``mesh`` larger than 1.  An entry that
    names several axes cuts its dimension over their product, the first
    axis major (JAX's order): ``axis`` is then the tuple of those of
    them larger than 1 (a name when one is left)."""
    from repro_torch.launch.mesh import axes_rank
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        names = tuple(a for a in names if axis_size(mesh, a) > 1)
        if not names:
            continue
        axis = names if len(names) > 1 else names[0]
        size = 1
        for a in names:
            size *= axis_size(mesh, a)
        out.append((dim, axis, size, axes_rank(mesh, axis)))
    return out


def is_sharded(spec: PartitionSpec, mesh) -> bool:
    """Whether ``spec`` cuts a dimension over an axis of ``mesh`` larger
    than 1."""
    return bool(_dims(spec, mesh))


def shard_tensor(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's piece of the global tensor ``t`` under ``sharding``:
    a contiguous copy holding no reference to ``t`` (``t`` itself when
    no dimension is cut)."""
    dims = _dims(sharding.spec, sharding.mesh)
    if len(sharding.spec) > t.ndim:
        raise ValueError(f"spec {sharding.spec} has more entries than the "
                         f"tensor's {t.ndim} dimensions")
    if not dims:
        return t
    out = t
    for dim, _, size, index in dims:
        lo, hi = shard_bounds(t.shape[dim], size, index)
        out = out.narrow(dim, lo, hi - lo)
    return out.contiguous().clone()


def gather_tensor(t: torch.Tensor, layout: Layout,
                  keep=None) -> torch.Tensor:
    """The global tensor of ``layout`` from every rank's piece ``t``: an
    all-gather along each cut dimension over its axis (the pieces padded
    to ``ceil(n / size)`` for the collective and trimmed after).  Its
    gradient is ``t``'s piece of the global one: as it is over the model
    axis (every rank of it computes alike), summed over the ranks of a
    DP axis (each computes its own batch's part); a dimension cut over
    DP and other axes together has none.  A dimension cut over ``keep``
    (an axis name, or a tuple of them as ``_dims`` gives it) stays
    cut."""
    from repro_torch.launch.mesh import axis_group
    from .tensor_parallel import gather_along
    out = t
    for dim, axis, _, _ in _dims(layout.spec, layout.mesh):
        if keep is not None and axis == keep:
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        dp = [a in DP_AXES for a in names]
        mode = "sum" if all(dp) else "slice" if not any(dp) else "none"
        out = gather_along(out, dim, axis_group(layout.mesh, axis),
                           layout.shape[dim], backward=mode)
    return out


def shard_model(model, mesh, specs: Optional[Dict[str, PartitionSpec]] = None):
    """Lay ``model`` out on ``mesh`` in place (the port's
    ``device_put(params, NamedSharding)``): every rank holds the full
    model (built from the same seed, or restored) and keeps, of each
    parameter ``specs`` cuts over an axis larger than 1, only its piece,
    the rest freed.  ``specs`` defaults to :func:`param_spec_tree`'s
    (``fsdp=False``, the serving layout).  Modules whose pieces the
    tensor-parallel forward runs on are marked for it
    (:func:`repro_torch.distributed.tensor_parallel.mark`); every other
    sharded parameter is gathered at use.  Raises unless the parameters
    lie on this rank's device of ``mesh``, when the model is already
    laid out, or when the vocabulary does not tile the model axis.
    Returns ``model``."""
    from repro_torch.distributed import tensor_parallel
    from repro_torch.launch.mesh import check_mesh_device
    if getattr(model, "mesh", None) is not None:
        raise ValueError("the model is already laid out on a mesh")
    if specs is None:
        specs = param_spec_tree(model, model.cfg)
    named = dict(model.named_parameters())
    missing = sorted(set(named) - set(specs))
    if missing:
        raise KeyError(f"no spec for parameters {missing[:4]}")
    check_mesh_device(mesh, *named.values())
    tensor_parallel.check_vocab(model.cfg, axis_size(mesh, "model"))
    with torch.no_grad():
        for name, p in named.items():
            spec = specs[name]
            if not is_sharded(spec, mesh):
                continue
            layout = Layout(mesh, spec, tuple(p.shape))
            p.data = shard_tensor(p.data, NamedSharding(mesh, spec))
            p._layout = layout
    for mod in model.modules():
        mod._sharded = any(hasattr(p, "_layout") for p in mod.parameters())
    model.mesh = mesh
    tensor_parallel.mark(model, mesh)
    if mesh.device_type == "cuda":
        torch.cuda.empty_cache()  # the full tensors' memory, for the
        # other ranks that share the card
    return model


__all__ = ["DP_AXES", "Layout", "NamedSharding", "P", "PartitionSpec",
           "act_specs", "activation_specs", "axis_names", "batch_specs",
           "cache_spec_tree", "constrain", "dp_axes", "gather_tensor",
           "global_tokens", "is_sharded", "live_dp_axes", "local_rows",
           "named_sharding_tree", "param_spec_tree", "recompute_context",
           "shard_bounds", "shard_model", "shard_tensor", "whole_sequence"]
