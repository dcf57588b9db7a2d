"""Fault-tolerant checkpointing: atomic writes, keep-k GC and exact
resume, in the JAX package's on-disk format, so a checkpoint written by
either package restores in the other.

Format: one directory per step, ``step_<10 digits>``, holding
``params.npz`` (flattened ``path -> array``, paths ``/``-joined: dict
keys, list indices, and an ``nn.Module``'s state-dict names with their
dots as ``/``), an optional ``opt.npz`` of the same form, and a
``meta.json`` sidecar (step, time, data state, extras).  Writes go to
``<dir>.tmp`` then ``os.replace`` (atomic on POSIX), so a preemption
mid-save never corrupts the latest checkpoint.

Templates (what a restore fills) are nested dicts / lists / tuples of
tensors or numpy arrays, or an ``nn.Module``.  Restored leaves take the
template's device and dtype; bf16 tensors are stored as f32 (numpy has
no bf16) and cast back, which is exact.  A module template is filled in
place and returned.  ``restore(shardings=)`` restores onto a mesh: each
rank reads the full leaves and keeps its shard on its device.  A model
laid out on a mesh is saved by gathering it first: saving its pieces
raises.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.runtime.guard import (path_name, tree_leaves_with_path,
                                       tree_map_with_path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _leaves(tree):
    """``(key, leaf)`` pairs of a template or a tree to save."""
    if isinstance(tree, nn.Module):
        if getattr(tree, "mesh", None) is not None:
            raise ValueError("the module is laid out on a mesh: a rank "
                             "holds pieces of its parameters, not a "
                             "template or a checkpoint of the model")
        return [(k.replace(".", "/"), v)
                for k, v in tree.state_dict().items()]
    return [(path_name(p), x) for p, x in tree_leaves_with_path(tree)]


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(x) for k, x in _leaves(tree)}


def _restore_leaf(key: str, arr: np.ndarray, leaf):
    if tuple(arr.shape) != tuple(leaf.shape):
        raise ValueError(
            f"shape mismatch for {key}: ckpt {arr.shape} vs "
            f"model {tuple(leaf.shape)}")
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                                 dtype=leaf.dtype)
    return np.asarray(arr, np.asarray(leaf).dtype)


def _unflatten_like(template, flat: Dict[str, np.ndarray]):
    """``template`` filled from ``flat``: a module in place, any other
    tree as a new tree of the template's structure."""
    pairs = _leaves(template)
    for key, _ in pairs:
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
    if isinstance(template, nn.Module):
        state = {k.replace("/", "."): _restore_leaf(k, flat[k], leaf)
                 for k, leaf in pairs}
        template.load_state_dict(state)
        return template

    def fill(path, leaf):
        key = path_name(path)
        return _restore_leaf(key, flat[key], leaf)

    return tree_map_with_path(fill, template)


def _place(params, shardings):
    """``params`` (restored whole) on the mesh of ``shardings``."""
    from repro_torch.distributed import sharding as shard_lib
    if isinstance(params, nn.Module):
        specs = {k: s.spec for k, s in shardings.items()}
        meshes = {id(s.mesh) for s in shardings.values()}
        if len(meshes) != 1:
            raise ValueError("a model's shardings must share one mesh")
        mesh = next(iter(shardings.values())).mesh
        return shard_lib.shard_model(params, mesh, specs)

    def cut(path, leaf):
        sh = shardings
        for k in path:
            sh = sh[k]
        return shard_lib.shard_tensor(torch.as_tensor(leaf), sh)

    return tree_map_with_path(cut, params)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, params, opt_state=None, data_state=None,
             extra: Optional[Dict[str, Any]] = None):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "params.npz"), **_flatten(params))
        if opt_state is not None:
            np.savez(os.path.join(tmp, "opt.npz"), **_flatten(opt_state))
        meta = {"step": step, "time": time.time(),
                "data_state": data_state or {}, "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # torn .tmp dirs are debris from a save that never published
        # (preemption mid-write); any still present belong to no
        # in-flight save
        for name in os.listdir(self.dir):
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def read_meta(self, step: Optional[int] = None) -> Dict:
        """The JSON metadata sidecar of ``step`` (default: latest) --
        readable without knowing the parameter tree, which is how the
        serving layer discovers the shapes of a decode-state checkpoint
        before restoring it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with open(os.path.join(self._step_dir(step), "meta.json")) as f:
            return json.load(f)

    def _restore_one(self, step: int, params_template, opt_template):
        d = self._step_dir(step)
        with np.load(os.path.join(d, "params.npz")) as z:
            params = _unflatten_like(params_template, dict(z))
        opt_state = None
        if opt_template is not None and os.path.exists(
                os.path.join(d, "opt.npz")):
            with np.load(os.path.join(d, "opt.npz")) as z:
                opt_state = _unflatten_like(opt_template, dict(z))
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return params, opt_state, meta

    def restore(self, step: Optional[int], params_template,
                opt_template=None, shardings=None
                ) -> Tuple[int, Any, Any, Dict]:
        """Restore ``step`` (None: the latest readable one) into the
        templates; returns ``(step, params, opt_state, meta)``.

        A torn checkpoint (truncated archive / missing sidecar from a
        crash mid-write) is skipped when the step was auto-selected:
        the restore falls back to the next older readable step and
        records the skipped steps under ``meta["skipped_torn_steps"]``.
        An explicitly requested step is never substituted -- a torn one
        raises.

        ``shardings`` (restoring onto a mesh): NamedShardings of the
        *new* mesh (:func:`repro_torch.distributed.sharding.
        named_sharding_tree`), keyed like the template -- for a
        :class:`~repro_torch.models.model.Model` template a dict by
        parameter name, which lays the filled model out on their mesh
        (:func:`~repro_torch.distributed.sharding.shard_model`); for any
        other tree the same structure, each leaf cut to this rank's
        piece.  Each rank reads the full leaves."""
        explicit = step is not None
        candidates = [step] if explicit else list(reversed(self.all_steps()))
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        skipped = []
        for s in candidates:
            try:
                params, opt_state, meta = self._restore_one(
                    s, params_template, opt_template)
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile, zlib.error) as e:
                if explicit:
                    raise
                skipped.append((s, f"{type(e).__name__}: {e}"))
                continue
            if shardings is not None:
                params = _place(params, shardings)
            if skipped:
                meta = dict(meta)
                meta["skipped_torn_steps"] = [t for t, _ in skipped]
                meta["skipped_torn_errors"] = [err for _, err in skipped]
            return s, params, opt_state, meta
        raise FileNotFoundError(
            f"no readable checkpoints in {self.dir}: all "
            f"{len(skipped)} candidates torn "
            f"({'; '.join(err for _, err in skipped)})")
