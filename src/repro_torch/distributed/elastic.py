"""Elastic scaling: rebuild the mesh from the ranks that are there and
re-lay-out a checkpoint onto it (the JAX package's
``repro.distributed.elastic``).

The checkpoint format stores parameters unsharded by tree path
(:mod:`repro_torch.checkpoint.manager`), and the sharding rules are
pure functions of (parameters, mesh), so scaling after losing a host
is: build the largest valid mesh over the process group's world,
recompute the specs, restore with ``shardings=``.  The model axis must
keep dividing the tensor-parallel dimensions: :func:`candidate_meshes`
enumerates the shapes largest-first (as the JAX package's does), and
:func:`make_elastic_mesh` takes the first whose model axis the
configuration's vocabulary tiles (the port's tensor-parallel embedding
and LM head split it, :func:`~repro_torch.distributed.tensor_parallel.
check_vocab`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from . import sharding as shard_lib


def candidate_meshes(n_devices: int, max_model: int = 16
                     ) -> List[Tuple[int, int]]:
    """(data, model) shapes using as many devices as possible, preferring
    larger model-parallel degree (keeps per-device weight shards small)."""
    out = []
    for model in range(min(max_model, n_devices), 0, -1):
        data = n_devices // model
        if data * model >= 1:
            out.append((data, model))
    out.sort(key=lambda dm: (-(dm[0] * dm[1]), -dm[1]))
    return out


def elastic_shape(n_devices: int, cfg=None, max_model: int = 16
                  ) -> Tuple[int, int]:
    """The first of :func:`candidate_meshes` whose model axis tiles
    ``cfg``'s padded vocabulary (any, without a config)."""
    for data, model in candidate_meshes(n_devices, max_model):
        if cfg is None or cfg.padded_vocab % model == 0:
            return data, model
    raise ValueError(f"no mesh of {n_devices} devices")


def make_elastic_mesh(cfg=None, max_model: int = 16, *,
                      device: str = "cuda"):
    """A (data, model) mesh of :func:`elastic_shape` over the process
    group's world (the first candidate always uses every rank: model 1
    qualifies)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import AXES, make_mesh
    data, model = elastic_shape(dist.get_world_size(), cfg, max_model)
    return make_mesh((data, model), AXES, device=device)


def elastic_restore(ckpt_manager, params_template, cfg=None, *,
                    mesh=None, fsdp: bool = False,
                    step: Optional[int] = None, device: str = "cuda"):
    """Restore the latest checkpoint (or ``step``) onto a (possibly
    different) mesh, :func:`make_elastic_mesh`'s by default.
    ``params_template`` is a :class:`~repro_torch.models.model.Model`
    on this rank's device of that mesh; it is filled and laid out in
    place.  Returns ``(mesh, step, model, meta)``."""
    mesh = mesh or make_elastic_mesh(cfg or params_template.cfg,
                                     device=device)
    specs = shard_lib.param_spec_tree(params_template, cfg, fsdp=fsdp)
    shardings = shard_lib.named_sharding_tree(specs, mesh)
    step, params, _, meta = ckpt_manager.restore(
        step, params_template, None, shardings=shardings)
    return mesh, step, params, meta
