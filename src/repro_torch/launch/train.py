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
exit.  Training on a mesh
(``mesh=``, ``fsdp``, ``seq_shard_acts``) comes with ROADMAP A12.

Runnable directly (the card unless ``--device cpu``):
    PYTHONPATH=src python -m repro_torch.launch.train --arch quickstart \\
        --smoke --steps 4 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.backend import default_device
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, retry=None):
    """Returns ``train_step(model, opt_state, batch) -> (model,
    opt_state, metrics)``; the parameters and moments are updated in
    place.  Batch tensors have a leading grad_accum axis when accum > 1.

    ``retry(fn, *args)`` (default: one call) runs each of the step's two
    parts, each of which a failed attempt leaves fit to run again: the
    gradients (forward and backward from cleared ``.grad``), then the
    update (:func:`apply_updates` with a ``done`` set, so each parameter
    is updated once).  The step as a whole is not: its update is in
    place, and a second attempt would take its gradients on weights
    already partly updated."""
    retry = retry or (lambda fn, *args: fn(*args))

    def gradients(model, batch):
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

    def step(model, opt_state, batch):
        metrics = retry(gradients, model, batch)
        params = dict(model.named_parameters())
        grads = {k: p.grad for k, p in params.items()}
        _, opt_state, opt_metrics = retry(
            apply_updates, params, grads, opt_state, tcfg.optimizer,
            convert.jax_paths(model), set())
        for p in params.values():
            p.grad = None
        metrics.update(opt_metrics)
        return model, opt_state, metrics

    return step


def _opt_to_jax(opt_state, cfg: ModelConfig) -> dict:
    return {"m": convert.tree_to_jax(opt_state["m"], cfg),
            "v": convert.tree_to_jax(opt_state["v"], cfg),
            "count": opt_state["count"].to("cpu").numpy()}


class Trainer:
    """One-device trainer on ``device`` (the card unless the caller
    names another; raises without one -- it never moves to the CPU on
    its own)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                 device=None):
        if mesh is not None or tcfg.fsdp or tcfg.seq_shard_acts:
            raise NotImplementedError(
                "training on a mesh (mesh=, fsdp, seq_shard_acts) is not "
                "ported yet (ROADMAP A12)")
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = None
        self.device = default_device(device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self._step = make_train_step(cfg, tcfg, retry=self._retry)

    def _retry(self, fn, *args):
        return retry_step(fn, *args, retries=self.tcfg.step_retries,
                          backoff_s=self.tcfg.retry_backoff_s,
                          seed=self.tcfg.seed,
                          on_retry=lambda a, e: print(
                              f"[retry] {fn.__name__} attempt {a}: {e}"))

    # ------------------------------------------------------------------
    def init_params(self):
        """Random weights from ``tcfg.seed`` (a generator on the device;
        the numbers differ from ``jax.random``'s) and a zero optimizer
        state."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        model = model_lib.init(self.cfg, gen, self.device).requires_grad_()
        return model, init_state(dict(model.named_parameters()),
                                 self.tcfg.optimizer)

    def restore_or_init(self, pipeline=None):
        """``(step, model, opt_state)`` from the latest readable
        checkpoint (a missing optimizer state starts at zero), the
        pipeline's state restored too; else fresh ones at step 0."""
        cfg = self.cfg
        shapes = dict(model_lib.Model(cfg, "meta").named_parameters())
        like = convert.tree_like_jax(shapes, cfg)
        try:
            step, ptree, otree, meta = self.ckpt.restore(
                None, like, {"m": like, "v": like,
                             "count": np.zeros((), np.int32)})
        except FileNotFoundError:
            model, opt_state = self.init_params()
            return 0, model, opt_state
        model = model_lib.Model(cfg, self.device)
        params = dict(model.named_parameters())
        convert.fill_from_jax(params, ptree, cfg)
        model.requires_grad_()
        opt_state = init_state(params, self.tcfg.optimizer)
        if otree is not None:
            convert.fill_from_jax(opt_state["m"], otree["m"], cfg)
            convert.fill_from_jax(opt_state["v"], otree["v"], cfg)
            opt_state["count"].fill_(int(otree["count"]))
        if pipeline is not None and meta.get("data_state"):
            pipeline.load_state_dict(meta["data_state"])
        return step, model, opt_state

    def save(self, step: int, model, opt_state, pipeline) -> str:
        return self.ckpt.save(step, convert.params_to_jax(model),
                              _opt_to_jax(opt_state, self.cfg),
                              pipeline.state_dict())

    def _device_batch(self, batch: Dict[str, np.ndarray]):
        if self.tcfg.grad_accum > 1:
            def reshape(x):
                a = self.tcfg.grad_accum
                return x.reshape((a, x.shape[0] // a) + x.shape[1:])
            batch = {k: reshape(v) for k, v in batch.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def _write_failure(self, step: int, exc: BaseException) -> str:
        """Publish a machine-readable failure report next to the
        checkpoints before the train loop dies."""
        from repro_torch.runtime.guard import FailureReport, classify_error
        report = FailureReport(
            name="train.step", error=str(exc),
            error_type=type(exc).__name__,
            classification=classify_error(exc),
            attempts=1 + self.tcfg.step_retries, time=time.time())
        path = os.path.join(self.tcfg.ckpt_dir,
                            f"failure_step_{step:010d}.json")
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
                if guard.fired:
                    print("[preemption] SIGTERM received; checkpointing")
                    break
            final_step = step + 1 if not guard.fired else step
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
    trainer = Trainer(cfg, tcfg, device=args.device)
    print(f"device: {trainer.device}")
    trainer.run(pipe)


if __name__ == "__main__":
    main()
