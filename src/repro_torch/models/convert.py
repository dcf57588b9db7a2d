"""Carry a JAX parameter tree across to the port's model, and back.

The JAX package's ``repro.models.init`` returns a nested dict; dense
layers sit under ``prefix_i`` or, stacked along a leading group axis,
under ``blocks/slot_s`` (layer ``prefix + g * period + s`` is row ``g``
of slot ``s``).  :func:`params_from_jax` unstacks the groups into the
port's per-layer modules; :func:`params_to_jax` rebuilds the JAX layout
(the round trip is exact).  Names match the JAX tree's leaves, so the
Mamba mixers (``in_proj``, ``conv_w``, ``conv_b``, ``x_proj``,
``dt_proj``, ``dt_bias``, ``A_log``, ``D``, ``norm_scale``,
``out_proj``), zamba2's unstacked ``shared_attn`` subtree and an
embedding-input stack's missing ``embed`` carry across as they are.
Gradients and the optimizer's moments,
dicts keyed by the port's parameter names, cross the same way
(:func:`tree_to_jax`, :func:`fill_from_jax`), and :func:`jax_paths`
gives each parameter's JAX path for AdamW's decay mask.  Arrays cross as
numpy: this module imports neither ``jax`` nor the JAX package.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .config import ModelConfig
from .model import Model, group_layout


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = np.asarray(val)
    return out


def _layer_sources(cfg: ModelConfig):
    """Layer index -> (tree prefix, group row or None)."""
    prefix, period, n_groups = group_layout(cfg)
    src = {i: (f"prefix_{i}.", None) for i in range(prefix)}
    for g in range(n_groups):
        for s in range(period):
            src[prefix + g * period + s] = (f"blocks.slot_{s}.", g)
    return src


def _jax_key(name: str, layer_src) -> tuple:
    """A port parameter name -> (dotted JAX key, group row or None)."""
    if name.startswith("layers."):
        _, i, rest = name.split(".", 2)
        tprefix, g = layer_src[int(i)]
        return tprefix + rest, g
    return name, None


def jax_paths(model: Model) -> Dict[str, str]:
    """Each parameter's JAX path, ``/``-joined as ``jax.tree_util`` paths
    print (``blocks/slot_0/mixer/bq``), by the port's name."""
    layer_src = _layer_sources(model.cfg)
    return {name: _jax_key(name, layer_src)[0].replace(".", "/")
            for name, _ in model.named_parameters()}


def fill_from_jax(named: Mapping[str, torch.Tensor], tree,
                  cfg: ModelConfig) -> None:
    """Copy the JAX-layout tree ``tree`` (arrays or numpy arrays) into
    the tensors ``named`` (port names, e.g. a model's parameters or an
    optimizer moment), in place.  Raises ValueError on a shape mismatch
    and KeyError on a missing or an extra key."""
    flat = _flatten(tree)
    used = set()
    layer_src = _layer_sources(cfg)
    for name, dst in named.items():
        key, g = _jax_key(name, layer_src)
        if key not in flat:
            raise KeyError(f"JAX parameter tree has no {key!r} (for "
                           f"{name})")
        used.add(key)
        arr = flat[key] if g is None else flat[key][g]
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: JAX shape {tuple(arr.shape)} != port "
                             f"shape {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(torch.from_numpy(
                np.array(arr, dtype=np.float32)).to(dst.dtype))
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"JAX parameter tree has keys the port does not "
                       f"hold: {extra}")


def _nest(flat: Dict[str, object]) -> dict:
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return tree


def _to_jax_layout(named: Mapping[str, torch.Tensor], cfg: ModelConfig,
                   leaf) -> dict:
    layer_src = _layer_sources(cfg)
    flat: Dict[str, object] = {}
    stacks: Dict[str, Dict[int, object]] = {}
    for name, t in named.items():
        key, g = _jax_key(name, layer_src)
        if g is None:
            flat[key] = leaf(t)
        else:
            stacks.setdefault(key, {})[g] = t
    for key, rows in stacks.items():
        flat[key] = leaf([rows[g] for g in sorted(rows)])
    return _nest(flat)


def _numpy(t) -> np.ndarray:
    if isinstance(t, list):
        return np.stack([_numpy(x) for x in t])
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.to("cpu").numpy()


def tree_to_jax(named: Mapping[str, torch.Tensor], cfg: ModelConfig) -> dict:
    """The JAX package's parameter-tree layout (nested dict of numpy
    arrays, groups stacked along their leading axis) of the tensors
    ``named`` (port names); bf16 leaves become f32, as in a checkpoint."""
    return _to_jax_layout(named, cfg, _numpy)


def tree_like_jax(named: Mapping[str, torch.Tensor],
                  cfg: ModelConfig) -> dict:
    """A restore template of :func:`tree_to_jax`'s layout: f32 leaves of
    the right shapes that hold no memory of their own."""
    def leaf(t):
        shape = ((len(t),) + tuple(t[0].shape) if isinstance(t, list)
                 else tuple(t.shape))
        return np.broadcast_to(np.float32(0), shape)
    return _to_jax_layout(named, cfg, leaf)


def params_from_jax(tree, cfg: ModelConfig, device=None) -> Model:
    """The port's :class:`~repro_torch.models.model.Model` on ``device``
    (the card unless the caller names another) holding the values of
    the JAX parameter tree ``tree`` (arrays or numpy arrays).  Raises
    ValueError on a shape mismatch and KeyError on a missing or an extra
    key."""
    model = Model(cfg, device)
    fill_from_jax(dict(model.named_parameters()), tree, cfg)
    return model


def params_to_jax(model: Model) -> dict:
    """The JAX package's parameter tree (nested dict of numpy arrays) of
    ``model``: groups restacked along their leading axis."""
    return tree_to_jax(dict(model.named_parameters()), model.cfg)
