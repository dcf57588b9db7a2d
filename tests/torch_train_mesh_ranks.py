"""Rank bodies of tests/test_torch_train_mesh.py and
tests/test_torch_compression.py: each runs in one of the gloo ranks
that :func:`repro_torch.launch.mesh.run_ranks` spawns on the CPU, so
this module imports torch and the port only (no JAX).  Weights arrive
through checkpoints in the JAX package's layout, batches come from the
port's pipeline (bit-equal to the JAX package's), and every body returns
numpy or plain Python for the test to hold against single-device
runs."""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.launch import train as TT
from repro_torch.optim import adamw as TO
from repro_torch.optim import compression as TCMP


def axes_of(shape):
    """The axis names of a mesh of ``shape``: (data, model), or (pod,
    data, model) for three axes."""
    return M.AXES if len(shape) == 2 else ("pod",) + M.AXES


def trainer(run):
    """The port's Trainer of one run (a dict: arch, replace, shape,
    tcfg, opt, ckpt) on a CPU mesh of ``shape``, and its pipeline."""
    cfg = get_config(run["arch"], smoke=True).replace(**run["replace"])
    mesh = M.make_mesh(run["shape"], axes_of(run["shape"]), device="cpu")
    tr = TT.Trainer(cfg, TT.TrainConfig(
        ckpt_dir=run["ckpt"], log_every=100, **run["tcfg"],
        optimizer=TO.AdamWConfig(**run["opt"])), mesh=mesh)
    pipe = SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=run["seq"],
        global_batch=run["batch"], input_mode=cfg.input_mode,
        d_model=cfg.d_model))
    return tr, pipe


class _Sigterm:
    """A pipeline that sends this process SIGTERM as it hands out batch
    ``at``."""

    def __init__(self, pipe, at):
        self.pipe, self.at, self.n = pipe, at, 0

    def next_batch(self):
        if self.n == self.at:
            import os
            import signal
            os.kill(os.getpid(), signal.SIGTERM)
        self.n += 1
        return self.pipe.next_batch()

    def state_dict(self):
        return self.pipe.state_dict()

    def load_state_dict(self, state):
        self.pipe.load_state_dict(state)


def train(rank, world, runs):
    """Trainer.run of each run from its checkpoint directory (which holds
    the step-0 weights); returns per run the metrics of every step (rank
    0 writes the final checkpoint) and whether every rank saw the same
    losses.  A run with ``sigterm_rank`` sends that rank SIGTERM as it
    takes the batch of step ``sigterm_step``."""
    out = []
    for run in runs:
        tr, pipe = trainer(run)
        if run.get("sigterm_rank") == rank:
            pipe = _Sigterm(pipe, run["sigterm_step"])
        _, _, hist = tr.run(pipe)
        losses = torch.tensor([h["loss"] for h in hist], dtype=torch.float64)
        first = losses.clone()
        dist.broadcast(first, 0)
        out.append({"hist": [{k: v for k, v in h.items()
                              if k != "step_time_s"} for h in hist],
                    "same": bool(torch.equal(first, losses))})
    return out


def placement(rank, world, cases):
    """For each (mesh shape, spec, global shape): ``shard_tensor`` of an
    arange tensor of the global shape under the spec on a mesh of that
    shape, ``_dims`` of the spec, and the tensor gathered back: (piece,
    dims, whole)."""
    out, meshes = [], {}
    for shape, spec, global_shape in cases:
        if shape not in meshes:
            meshes[shape] = M.make_mesh(shape, axes_of(shape), device="cpu")
        mesh = meshes[shape]
        t = torch.arange(int(np.prod(global_shape)),
                         dtype=torch.float32).reshape(global_shape)
        spec = SH.P(*spec)
        piece = SH.shard_tensor(t, SH.NamedSharding(mesh, spec))
        whole = SH.gather_tensor(piece, SH.Layout(mesh, spec, tuple(t.shape)))
        out.append((piece.numpy(), SH._dims(spec, mesh), whole.numpy()))
    return out


def compressed(rank, world, grads, residual):
    """``compressed_psum_grads`` of this rank's gradients and residuals
    (numpy dicts, one per rank) over every rank, and over a (world, 1)
    mesh's DP axis: (synced, new residual) for each, as numpy."""
    g = {k: torch.from_numpy(v) for k, v in grads[rank].items()}
    r = {k: torch.from_numpy(v) for k, v in residual[rank].items()}
    out = []
    synced, res = TCMP.compressed_psum_grads(g, r)
    out.append(({k: v.numpy() for k, v in synced.items()},
                {k: v.numpy() for k, v in res.items()}))
    mesh = M.make_mesh((world, 1), M.AXES, device="cpu")
    synced, res = TCMP.compressed_psum_grads(g, r, mesh=mesh)
    out.append(({k: v.numpy() for k, v in synced.items()},
                {k: v.numpy() for k, v in res.items()}))
    return out
