"""Trainer of the port: the JAX package's ``repro.launch.train`` on one
device -- gradient accumulation over micro-batches, remat, AdamW,
checkpoint/restart, a straggler watchdog and a preemption-safe exit.

The step is eager PyTorch: ``loss_fn``'s backward fills each parameter's
``.grad`` (adding up over the micro-batches under ``grad_accum``), then
:func:`~repro_torch.optim.adamw.apply_updates` updates the parameters
and moments in place.  The two parts are retried apart (a transient
error, such as running out of memory, in the update would otherwise
rerun the backward on weights already partly updated).  Checkpoints
hold the parameters and the optimizer state ``{m, v, count}`` in the JAX
package's tree layout, and the pipeline's state beside them, so a
checkpoint of either package's ``Trainer`` resumes in the other.

The MoE stacks' aux loss (the MoE layers' Switch load-balance terms) is
part of the loss and reported as ``aux_loss``.  Kept from the JAX
package, quirks included: under ``grad_accum > 1`` the metrics report
``aux_loss`` 0 and ``tokens`` 0 (the aux loss stays in the loss); a
checkpoint taken every ``ckpt_every`` steps is labelled with the index
of the step just taken (so a resume from it repeats no batch and takes
one step more than the uninterrupted run); the final save happens at
exit.

On a mesh (``Trainer(mesh=)``: a ``DeviceMesh`` of ``(data, model)`` or
``(pod, data, model)`` axes over ``torch.distributed``, one process a
rank) the step computes the global batch's math, as the JAX package's
GSPMD step does:

* each rank takes its rows of the global batch (the batch cut over the
  DP axes, ``batch_specs``); the model is laid out by the sharding
  rules (``param_spec_tree(fsdp=tcfg.fsdp)``): attention, MLP,
  embedding and head tensor-parallel over ``model``, every other cut
  leaf -- under ``fsdp`` also those cut over the DP axes -- gathered at
  use (:mod:`repro_torch.distributed.tensor_parallel`);
* ``seq_shard_acts`` keeps the residual cut along the sequence over
  ``model`` between blocks (``act_specs(seq_shard=True)``);
* the MoE routes every rank's tokens (global capacity, ranks within an
  expert and aux loss); the cross entropy is each rank's mean, and the
  ranks' means are averaged;
* after the backward each gradient is averaged over the DP axes (a
  leaf cut over a DP axis was summed over it by its gather's backward),
  the clip uses the norm over the whole mesh, each piece counted once
  (:func:`mesh_global_norm`), and AdamW updates each rank's pieces in
  place; the metrics are the global ones.

Weights are built (or restored) whole and cut, one rank at a time, so
the ranks of one card never hold several whole models at once.
Checkpoints are gathered to rank 0 and written in the JAX package's
layout, so a mesh checkpoint resumes on one device, on another mesh
shape and in the JAX package's ``Trainer``.  A SIGTERM on any rank
checkpoints on all of them.

Runnable directly (the card unless ``--device cpu``):
    PYTHONPATH=src python -m repro_torch.launch.train --arch quickstart \\
        --smoke --steps 4 --device cpu
and on a mesh, one process a rank:
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch quickstart --smoke --steps 4 \\
        --mesh 2x2 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.backend import default_device
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.distributed import sharding as shard_lib
from repro_torch.distributed.fault_tolerance import (Heartbeat,
                                                     PreemptionGuard,
                                                     retry_step)
from repro_torch.models import ModelConfig, convert, loss_fn
from repro_torch.models import model as model_lib
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    grad_accum: int = 1
    log_every: int = 10
    ckpt_every: int = 0            # 0 = only at exit
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_keep: int = 3
    seed: int = 0
    fsdp: bool = False
    seq_shard_acts: bool = False
    straggler_deadline_s: float = 600.0
    step_retries: int = 3          # transient-classified retries per step
    retry_backoff_s: float = 0.5   # jittered-exponential backoff base
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


# ---------------------------------------------------------------------------
# the mesh's reductions
# ---------------------------------------------------------------------------

def _cut_axes(p, mesh) -> tuple:
    """The axes of ``mesh`` (larger than 1, in the mesh's order) that the
    parameter ``p``'s layout cuts it over."""
    lay = getattr(p, "_layout", None)
    if lay is None:
        return ()
    names = set()
    for _, axis, _, _ in shard_lib._dims(lay.spec, mesh):
        names.update(axis if isinstance(axis, tuple) else (axis,))
    return tuple(a for a in shard_lib.axis_names(mesh) if a in names)


#: values of one all-reduce of the DP gradient mean: bounds its f32 and
#: pinned host buffers
SYNC_CHUNK = 1 << 25


def _sum_flat(tensors, group) -> None:
    """Add each tensor over ``group``'s ranks, in place, packed into f32
    buffers of at most :data:`SYNC_CHUNK` values (bf16 summed in f32 and
    rounded once)."""
    from repro_torch.distributed import collectives
    chunk, size = [], 0

    def flush():
        if not chunk:
            return
        buf = torch.cat([t.reshape(-1).to(torch.float32) for t in chunk])
        collectives.all_reduce_sum(buf, group)
        lo = 0
        for t in chunk:
            t.copy_(buf[lo:lo + t.numel()].view(t.shape))
            lo += t.numel()
        chunk.clear()
    for t in tensors:
        if size + t.numel() > SYNC_CHUNK:
            flush()
            size = 0
        if t.numel() > SYNC_CHUNK:  # alone, in pieces
            flat = t.view(-1)
            for lo in range(0, flat.numel(), SYNC_CHUNK):
                _sum_flat([flat[lo:lo + SYNC_CHUNK]], group)
            continue
        chunk.append(t)
        size += t.numel()
    flush()


def sync_grads(params: Dict[str, torch.Tensor], mesh) -> None:
    """Average each parameter's ``.grad`` over the DP axes of ``mesh``,
    in place: summed over the DP axes it is not cut over (a leaf cut
    over a DP axis was summed over that axis by its gather's backward),
    then divided by the DP size.  Over ``model`` nothing moves: every
    rank of it holds the same gradient of a leaf it does not cut."""
    from repro_torch.launch.mesh import axes_group
    axes, size = shard_lib.live_dp_axes(mesh)
    if size == 1:
        return
    buckets: Dict[tuple, list] = {}
    for p in params.values():
        rest = tuple(a for a in axes if a not in _cut_axes(p, mesh))
        buckets.setdefault(rest, []).append(p.grad)
    for rest in sorted(buckets):
        if rest:
            _sum_flat(buckets[rest], axes_group(mesh, rest))
    for p in params.values():
        p.grad.mul_(1.0 / size)


def mesh_global_norm(grads: Dict[str, torch.Tensor],
                     params: Dict[str, torch.Tensor], mesh) -> torch.Tensor:
    """The global norm of the gradients of a model laid out on ``mesh``
    (f32): each leaf's sum of squares added over the axes its piece is
    cut on (each piece counted once; a leaf held whole on several ranks
    once), then the leaves summed in order, as
    :func:`repro_torch.optim.adamw.global_norm` on one device."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import axes_group
    names = list(grads)
    sums = [torch.sum(torch.square(grads[n].to(torch.float32)))
            for n in names]
    by_axes: Dict[tuple, list] = {}
    for i, n in enumerate(names):
        cut = _cut_axes(params[n], mesh)
        if cut:
            by_axes.setdefault(cut, []).append(i)
    for cut in sorted(by_axes):
        idx = by_axes[cut]
        vec = torch.stack([sums[i] for i in idx])
        collectives.all_reduce_sum(vec, axes_group(mesh, cut))
        for j, i in enumerate(idx):
            sums[i] = vec[j]
    return torch.sqrt(sum(sums))


def _global_metrics(metrics: Dict[str, torch.Tensor], mesh):
    """The step's metrics over the global batch: ``loss`` averaged and
    ``tokens`` added over the DP ranks (``aux_loss`` is global already:
    the MoE routes the global batch)."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import axes_group
    axes, size = shard_lib.live_dp_axes(mesh)
    if size == 1:
        return metrics
    vec = torch.stack([metrics["loss"].to(torch.float32),
                       metrics["tokens"].to(torch.float32)])
    collectives.all_reduce_sum(vec, axes_group(mesh, axes))
    out = dict(metrics)
    out["loss"], out["tokens"] = vec[0] / size, vec[1]
    return out


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, retry=None,
                    mesh=None):
    """Returns ``train_step(model, opt_state, batch) -> (model,
    opt_state, metrics)``; the parameters and moments are updated in
    place.  Batch tensors have a leading grad_accum axis when accum > 1.
    With ``mesh`` the model is laid out on it, the batch is this rank's
    rows, and the step runs under the activation specs
    (``act_specs(seq_shard=tcfg.seq_shard_acts)``), averages the
    gradients over the DP axes, clips by the mesh's global norm and
    reports the global metrics.

    ``retry(fn, *args)`` (default: one call) runs each of the step's two
    parts, each of which a failed attempt leaves fit to run again: the
    gradients (forward and backward from cleared ``.grad``), then the
    update (:func:`apply_updates` with a ``done`` set, so each parameter
    is updated once).  The step as a whole is not: its update is in
    place, and a second attempt would take its gradients on weights
    already partly updated."""
    retry = retry or (lambda fn, *args: fn(*args))
    specs = (shard_lib.act_specs(mesh, seq_shard=tcfg.seq_shard_acts)
             if mesh is not None else None)

    def on_mesh():
        return (shard_lib.activation_specs(specs) if specs is not None
                else contextlib.nullcontext())

    def local_gradients(model, batch):
        params = list(model.parameters())
        for p in params:
            p.grad = None
        if tcfg.grad_accum == 1:
            loss, metrics = loss_fn(model, batch, cfg)
            loss.backward()
            return {k: v.detach() for k, v in metrics.items()}
        total = torch.zeros((), dtype=torch.float32, device=model.device)
        for a in range(tcfg.grad_accum):
            loss, _ = loss_fn(model, {k: v[a] for k, v in batch.items()},
                              cfg)
            loss.backward()
            total = total + loss.detach()
        inv = 1.0 / tcfg.grad_accum
        for p in params:
            p.grad.mul_(inv)
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        return {"loss": total * inv, "aux_loss": zero, "tokens": zero}

    def gradients(model, batch):
        with on_mesh():
            metrics = local_gradients(model, batch)
        if mesh is None:
            return metrics
        sync_grads(dict(model.named_parameters()), mesh)
        return _global_metrics(metrics, mesh)

    def step(model, opt_state, batch):
        metrics = retry(gradients, model, batch)
        params = dict(model.named_parameters())
        grads = {k: p.grad for k, p in params.items()}
        gnorm = (mesh_global_norm(grads, params, mesh) if mesh is not None
                 else None)
        _, opt_state, opt_metrics = retry(
            apply_updates, params, grads, opt_state, tcfg.optimizer,
            convert.jax_paths(model), set(), gnorm)
        for p in params.values():
            p.grad = None
        metrics.update(opt_metrics)
        return model, opt_state, metrics

    return step


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


class Trainer:
    """The trainer on ``device`` (the card unless the caller names
    another; raises without one -- it never moves to the CPU on its
    own), or on ``mesh`` (a ``DeviceMesh``; each rank on its device of
    it, see the module docstring).  ``tcfg.fsdp`` and
    ``tcfg.seq_shard_acts`` lay the mesh out; on one device they change
    nothing, as in the JAX package."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                 device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.param_specs = None
        if mesh is not None:
            from repro_torch.launch.mesh import mesh_device
            if not _is_device_mesh(mesh):
                raise TypeError(f"mesh= takes a torch.distributed "
                                f"DeviceMesh (repro_torch.launch.mesh."
                                f"make_mesh), got {type(mesh).__name__}")
            self.device = mesh_device(mesh)
            if device is not None and torch.device(device) != self.device:
                raise ValueError(f"this rank of the mesh computes on "
                                 f"{self.device}, not {device}")
            self.param_specs = shard_lib.param_spec_tree(
                model_lib.Model(cfg, "meta"), cfg, fsdp=tcfg.fsdp)
        else:
            self.device = default_device(device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self._step = make_train_step(cfg, tcfg, retry=self._retry, mesh=mesh)

    def _retry(self, fn, *args):
        return retry_step(fn, *args, retries=self.tcfg.step_retries,
                          backoff_s=self.tcfg.retry_backoff_s,
                          seed=self.tcfg.seed,
                          on_retry=lambda a, e: print(
                              f"[retry] {fn.__name__} attempt {a}: {e}"))

    # ------------------------------------------------------------------
    def _built(self, fill):
        """A model filled by ``fill(model)`` (whole, on the device); on a
        mesh then laid out on it, one rank after another, so the ranks
        sharing a card never hold several whole models at once."""
        if self.mesh is None:
            model = model_lib.Model(self.cfg, self.device)
            fill(model)
            return model
        model = None
        for r in range(dist.get_world_size()):
            if r == dist.get_rank():
                model = model_lib.Model(self.cfg, self.device)
                fill(model)
                shard_lib.shard_model(model, self.mesh, self.param_specs)
            dist.barrier()
        return model

    def init_params(self):
        """Random weights from ``tcfg.seed`` (a generator on the device;
        the numbers differ from ``jax.random``'s) and a zero optimizer
        state; on a mesh every rank draws the same whole model and keeps
        its pieces."""
        def draw(model):
            gen = torch.Generator(device=self.device).manual_seed(
                self.tcfg.seed)
            model_lib.init_into(model, gen)
        model = self._built(draw).requires_grad_()
        return model, init_state(dict(model.named_parameters()),
                                 self.tcfg.optimizer)

    def _shapes(self) -> Dict[str, torch.Tensor]:
        return dict(model_lib.Model(self.cfg, "meta").named_parameters())

    def _fill_pieces(self, named: Dict[str, torch.Tensor], tree) -> None:
        """Copy the JAX-layout tree ``tree`` (whole leaves) into
        ``named``, this rank's pieces on the mesh (whole tensors off
        it)."""
        if self.mesh is None:
            convert.fill_from_jax(named, tree, self.cfg)
            return
        shapes = self._shapes()
        whole = {k: torch.empty(shapes[k].shape, dtype=torch.float32)
                 for k in named}
        convert.fill_from_jax(whole, tree, self.cfg)
        with torch.no_grad():
            for k, t in named.items():
                sh = shard_lib.NamedSharding(self.mesh, self.param_specs[k])
                t.copy_(shard_lib.shard_tensor(whole[k], sh))

    def restore_or_init(self, pipeline=None):
        """``(step, model, opt_state)`` from the latest readable
        checkpoint (a missing optimizer state starts at zero), the
        pipeline's state restored too; else fresh ones at step 0.  On a
        mesh every rank reads the whole checkpoint and keeps its pieces
        (a checkpoint of one device, of another mesh or of the JAX
        package's ``Trainer``)."""
        cfg = self.cfg
        like = convert.tree_like_jax(self._shapes(), cfg)
        try:
            step, ptree, otree, meta = self.ckpt.restore(
                None, like, {"m": like, "v": like,
                             "count": np.zeros((), np.int32)})
        except FileNotFoundError:
            model, opt_state = self.init_params()
            return 0, model, opt_state

        model = self._built(lambda m: convert.fill_from_jax(
            dict(m.named_parameters()), ptree, cfg)).requires_grad_()
        params = dict(model.named_parameters())
        opt_state = init_state(params, self.tcfg.optimizer)
        if otree is not None:
            self._fill_pieces(opt_state["m"], otree["m"])
            self._fill_pieces(opt_state["v"], otree["v"])
            opt_state["count"].fill_(int(otree["count"]))
        if pipeline is not None and meta.get("data_state"):
            pipeline.load_state_dict(meta["data_state"])
        return step, model, opt_state

    def _whole(self, model, named: Dict[str, torch.Tensor]):
        """``named`` (pieces of ``model``'s parameters' layouts, by
        name) gathered whole; as they are off a mesh."""
        if self.mesh is None:
            return named
        params = dict(model.named_parameters())
        with torch.no_grad():
            return {k: (shard_lib.gather_tensor(t, params[k]._layout)
                        if hasattr(params[k], "_layout") else t)
                    for k, t in named.items()}

    def save(self, step: int, model, opt_state, pipeline) -> str:
        """Write a checkpoint in the JAX package's layout; on a mesh the
        pieces are gathered and rank 0 writes (every rank returns its
        path once it is written)."""
        params = self._whole(model, dict(model.named_parameters()))
        m = self._whole(model, opt_state["m"])
        v = self._whole(model, opt_state["v"])
        path = self.ckpt._step_dir(step)
        if self.mesh is None or dist.get_rank() == 0:
            path = self.ckpt.save(
                step, convert.tree_to_jax(params, self.cfg),
                {"m": convert.tree_to_jax(m, self.cfg),
                 "v": convert.tree_to_jax(v, self.cfg),
                 "count": opt_state["count"].to("cpu").numpy()},
                pipeline.state_dict())
        if self.mesh is not None:
            dist.barrier()
        return path

    def _device_batch(self, batch: Dict[str, np.ndarray]):
        if self.tcfg.grad_accum > 1:
            def reshape(x):
                a = self.tcfg.grad_accum
                return x.reshape((a, x.shape[0] // a) + x.shape[1:])
            batch = {k: reshape(v) for k, v in batch.items()}
        if self.mesh is not None:
            batch = {k: self._rows(v) for k, v in batch.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def _rows(self, x: np.ndarray) -> np.ndarray:
        """This rank's rows of the global batch ``x`` (the batch axis:
        after the grad_accum axis when there is one), cut over the DP
        axes (``batch_specs``)."""
        from repro_torch.launch.mesh import axes_rank
        axes, size = shard_lib.live_dp_axes(self.mesh)
        if size == 1:
            return x
        dim = 1 if self.tcfg.grad_accum > 1 else 0
        if x.shape[dim] % size:
            raise ValueError(f"a batch of {x.shape[dim]} rows does not tile "
                             f"the DP axes {axes} of {size}")
        n = x.shape[dim] // size
        i = axes_rank(self.mesh, axes)
        return np.take(x, np.arange(i * n, (i + 1) * n), axis=dim)

    def _any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (every rank calls)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([float(flag)])
        dist.all_reduce(t)
        return bool(t.item() > 0)

    def _write_failure(self, step: int, exc: BaseException) -> str:
        """Publish a machine-readable failure report next to the
        checkpoints before the train loop dies."""
        from repro_torch.runtime.guard import FailureReport, classify_error
        report = FailureReport(
            name="train.step", error=str(exc),
            error_type=type(exc).__name__,
            classification=classify_error(exc),
            attempts=1 + self.tcfg.step_retries, time=time.time())
        rank = (f"_rank{dist.get_rank()}" if self.mesh is not None
                else "")
        path = os.path.join(self.tcfg.ckpt_dir,
                            f"failure_step_{step:010d}{rank}.json")
        try:
            return report.write(path)
        except OSError:
            return ""

    def run(self, pipeline: SyntheticPipeline, steps: Optional[int] = None):
        """Train from the latest checkpoint (or fresh weights) up to
        ``steps``; returns ``(model, opt_state, history)``, one metrics
        dict of floats per step taken."""
        steps = steps or self.tcfg.steps
        start, model, opt_state = self.restore_or_init(pipeline)
        hb = Heartbeat(self.tcfg.straggler_deadline_s,
                       on_straggle=lambda dt: print(
                           f"[straggler] step exceeded deadline: {dt:.1f}s"))
        history = []
        with PreemptionGuard() as guard:
            step = start - 1  # a restored ckpt at/past `steps` skips the loop
            for step in range(start, steps):
                batch = self._device_batch(pipeline.next_batch())
                t0 = time.perf_counter()
                try:
                    model, opt_state, metrics = self._step(model, opt_state,
                                                           batch)
                except Exception as e:
                    self._write_failure(step, e)
                    raise
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["step_time_s"] = time.perf_counter() - t0
                hb.beat()
                history.append(metrics)
                if step % self.tcfg.log_every == 0:
                    print(f"step {step}: loss={metrics['loss']:.4f} "
                          f"gnorm={metrics['grad_norm']:.3f} "
                          f"lr={metrics['lr']:.2e} "
                          f"t={metrics['step_time_s']:.3f}s")
                if (self.tcfg.ckpt_every
                        and step and step % self.tcfg.ckpt_every == 0):
                    self.save(step, model, opt_state, pipeline)
                fired = self._any_rank(guard.fired)
                if fired:
                    print("[preemption] SIGTERM received; checkpointing")
                    break
            else:
                fired = False
            final_step = step + 1 if not fired else step
            self.save(final_step, model, opt_state, pipeline)
        return model, opt_state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="quickstart")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=_default_ckpt_dir())
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced smoke config")
    ap.add_argument("--grid-lowering", default="",
                    choices=("", "closed_form", "prefetch_lut", "bounding",
                             "mma", "compact"),
                    help="GridPlan lowering for the attention block "
                         "domain (default: the arch's attn_schedule)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "trains on the CPU)")
    ap.add_argument("--mesh", default="",
                    help="train on a mesh of the ranks this command runs "
                         "as (torch.distributed.run, one process a "
                         "rank): 'host' (every rank as data, model=1) or "
                         "'DATAxMODEL' (e.g. '2x2')")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    cfg = get_config(args.arch, smoke=True if args.smoke else None)
    if args.grid_lowering:
        cfg = cfg.replace(grid_lowering=args.grid_lowering)
        print(f"grid lowering: {cfg.grid_mode} "
              f"(schedule: {cfg.attn_schedule_resolved})")
    tcfg = TrainConfig(
        steps=args.steps, grad_accum=args.grad_accum,
        ckpt_dir=args.ckpt_dir,
        optimizer=AdamWConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(1, args.steps // 10)))
    pipe = SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, input_mode=cfg.input_mode,
        d_model=cfg.d_model))
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import resolve_cli_mesh
        if not dist.is_initialized():
            dist.init_process_group("gloo")  # the launcher's environment
        mesh = resolve_cli_mesh(args.mesh, device=torch.device(
            default_device(args.device)).type)
    trainer = Trainer(cfg, tcfg, mesh=mesh,
                      device=None if mesh is not None else args.device)
    print(f"device: {trainer.device}")
    if mesh is not None:
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}, rank "
              f"{dist.get_rank()} of {dist.get_world_size()}")
    trainer.run(pipe)


if __name__ == "__main__":
    main()
