"""Carry a JAX parameter tree across to the port's model, and back.

The JAX package's ``repro.models.init`` returns a nested dict; dense
layers sit under ``prefix_i`` or, stacked along a leading group axis,
under ``blocks/slot_s`` (layer ``prefix + g * period + s`` is row ``g``
of slot ``s``).  :func:`params_from_jax` unstacks the groups into the
port's per-layer modules; :func:`params_to_jax` rebuilds the JAX layout
(the round trip is exact).  Arrays cross as numpy: this module imports
neither ``jax`` nor the JAX package.
"""
from __future__ import annotations

from typing import Dict

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


def params_from_jax(tree, cfg: ModelConfig, device=None) -> Model:
    """The port's :class:`~repro_torch.models.model.Model` on ``device``
    (the card unless the caller names another) holding the values of the JAX parameter tree ``tree`` (arrays or
    numpy arrays).  Raises ValueError on a shape mismatch and KeyError
    on a missing or an extra key."""
    flat = _flatten(tree)
    model = Model(cfg, device)
    used = set()
    layer_src = _layer_sources(cfg)
    for name, param in model.named_parameters():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            tprefix, g = layer_src[int(i)]
            key = tprefix + rest
        else:
            key, g = name, None
        if key not in flat:
            raise KeyError(f"JAX parameter tree has no {key!r} (for "
                           f"{name})")
        used.add(key)
        arr = flat[key] if g is None else flat[key][g]
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{key}: JAX shape {tuple(arr.shape)} != port "
                             f"shape {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(
                np.array(arr, dtype=np.float32)).to(param.dtype))
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"JAX parameter tree has keys the port does not "
                       f"hold: {extra}")
    return model


def params_to_jax(model: Model) -> dict:
    """The JAX package's parameter tree (nested dict of numpy arrays) of
    ``model``: groups restacked along their leading axis."""
    cfg = model.cfg
    layer_src = _layer_sources(cfg)
    flat: Dict[str, object] = {}
    stacks: Dict[str, Dict[int, np.ndarray]] = {}
    for name, param in model.named_parameters():
        arr = param.detach().to("cpu").numpy()
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            tprefix, g = layer_src[int(i)]
            if g is not None:
                stacks.setdefault(tprefix + rest, {})[g] = arr
                continue
            name = tprefix + rest
        flat[name] = arr
    for key, rows in stacks.items():
        flat[key] = np.stack([rows[g] for g in sorted(rows)])
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return tree
