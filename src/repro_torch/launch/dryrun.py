"""Dry run of every (architecture x input-shape) cell on the production
meshes, with per-rank FLOPs, bytes, collective bytes and memory, and the
roofline terms on an H100: the port's counterpart of the JAX package's
``repro/launch/dryrun.py``.

The JAX package lowers and compiles each cell for a 512-device host
platform and reads XLA's memory analysis and the compiled HLO.  The port
has no compiler to ask: it runs rank 0's program itself, eagerly, on
``meta`` tensors (shapes and dtypes, no data) under torch's ``fake``
process group, at the full width of the configuration, and counts each
aten op as it runs (:mod:`repro_torch.launch.op_analysis`).  Per cell:

  * the process joins a ``fake`` group of 256 ranks (16 x 16, ``(data,
    model)``) or 512 (2 x 16 x 16, ``(pod, data, model)``) as rank 0, and
    :func:`~repro_torch.launch.mesh.make_production_mesh` builds the mesh
    over it (``device="cpu"``: the fake group moves nothing);
  * the model is built on ``meta`` and laid out with
    :func:`~repro_torch.distributed.sharding.shard_model` under
    ``param_spec_tree(fsdp=META[arch]["fsdp"], fsdp_axes=...)``: rank 0
    keeps its pieces;
  * rank 0's program runs under :func:`~repro_torch.launch.op_analysis.
    count`: for ``train`` the ``Trainer(mesh=)`` step
    (:func:`~repro_torch.launch.train.make_train_step`: loss, backward,
    ``sync_grads``, the clip by the mesh's norm, the AdamW update; no
    guard) on rank 0's rows of the batch; for ``prefill`` the model's
    ``prefill``; for ``decode`` one ``decode_step`` at the last position
    of a full cache.  Prefill and decode run as ``Server(mesh=)`` runs
    them: every rank over the whole batch, tensor-parallel over
    ``model``, its caches whole but for a tensor-parallel attention
    layer's own KV heads (``models/attention.py``'s module docstring);
  * the collectives record their operand and wire bytes instead of
    moving anything (:mod:`repro_torch.distributed.collectives`), and
    the hand-written kernels' entry points charge their schedule's work
    (:func:`repro_torch.kernels.flash_attention.flash_meta`).

The record has the JAX package's keys, with ``ops`` in place of ``hlo``
and ``trace_s`` (seconds to run the counted program) in place of
``compile_s``.  ``ops`` keeps ``hlo``'s sub-keys;
``xla_cost_flops_unrolled_once`` is -1, the JAX package's own value when
XLA gives no cost analysis (there is none here).  ``mem`` keeps its
meaning as far as an eager program allows:

  * ``argument_gib``: what rank 0 holds before the step -- its
    parameter pieces, for ``train`` the AdamW moments and count, its
    inputs, and for ``decode`` the caches;
  * ``output_gib``: the storages the step returns that it allocated,
    plus the arguments it updates in place (AdamW's parameters and
    moments, a decode step's attention caches): the port's updates are
    in place, where XLA's are outputs donated onto their inputs;
  * ``alias_gib``: those updated arguments (XLA's aliased donations);
  * ``temp_gib``: the most bytes the step allocated alive at once, less
    the new outputs;
  * ``peak_est_gib``: argument + output + temp - alias, as in the JAX
    package: the arguments plus the step's own peak.

Two records more for ``decode``: ``cache_gib`` (the caches the port's
rank holds) and ``cache_reference_gib`` (rank 0's piece under the JAX
package's ``cache_spec_tree`` layout: the batch over the DP axes, or the
sequence over ``data`` when the batch does not tile them).

The constants are one H100 SXM's (the ``hopper-kernels`` guide):
989 TFLOP/s dense bf16, 3.35 TB/s of HBM.  ``ICI_BW`` is the bandwidth
of the one link a ring collective is bound by: on hosts of 8 cards a
16-rank ring of the mesh's ``model`` or ``data`` axis crosses between
hosts, and a card's share of that crossing is one 400 Gb/s NDR link,
50 GB/s (the 450 GB/s of NVLink inside a host would make the same ring
no faster, since its slowest hop sets its rate).  The roofline's
``collective_s`` is the wire bytes over that link.  Bytes are eager
bytes, every op on its own: an upper bound on a fused program's.

Run as a module; under ``--all`` each cell runs in a process of its own
(the fake group is global to the process), forked from a server process
that imported torch once:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --results-dir /tmp/dryrun
The JAX package's ``DRYRUN_HLO_OUT`` (the HLO text written beside each
record) has no counterpart: there is no HLO.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import META, SHAPES, cells, get_config

# NVIDIA H100 SXM constants (per card)
PEAK_FLOPS = 989e12         # bf16, dense tensor cores
HBM_BW = 3.35e12            # bytes/s
ICI_BW = 50e9               # bytes/s: one 400 Gb/s NDR link (docstring)

GIB = 2 ** 30


def input_specs(cfg, shape_name: str, grad_accum: int = 1):
    """``meta`` stand-ins for every model input of the cell, at the
    global batch (as the JAX package's ``ShapeDtypeStruct``\\ s): train
    inputs and labels (with a leading ``grad_accum`` axis when it is
    above 1), prefill inputs, or a decode step's one new token, its
    ``init_cache`` on ``meta`` and its position."""
    sh = SHAPES[shape_name]
    return step_inputs(cfg, sh["kind"], sh["batch"], sh["seq"], grad_accum)


def step_inputs(cfg, kind: str, b: int, s: int, grad_accum: int = 1):
    """:func:`input_specs` of a ``kind`` step at batch ``b`` and sequence
    (or cache) length ``s``."""
    from repro_torch.models.model import init_cache
    tok = torch.int32
    emb = getattr(torch, cfg.dtype)

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def inputs(seq):
        if cfg.input_mode == "tokens":
            return spec((b, seq), tok)
        return spec((b, seq, cfg.d_model), emb)
    if kind == "train":
        batch = {"inputs": inputs(s), "labels": spec((b, s), tok)}
        if grad_accum > 1:
            batch = {k: spec((grad_accum, v.shape[0] // grad_accum)
                             + tuple(v.shape[1:]), v.dtype)
                     for k, v in batch.items()}
        return batch
    if kind == "prefill":
        return {"inputs": inputs(s)}
    # decode: one new token against a seq_len cache
    return {"inputs": inputs(1), "cache": init_cache(cfg, b, s, "meta"),
            "pos": spec((), torch.int32)}


def model_flops(cfg, shape_name: str) -> float:
    """Useful FLOPs: 6*N_active*D train / 2*N_active*D inference, plus
    attention O(S^2 d) for the causal/local pattern actually configured."""
    sh = SHAPES[shape_name]
    return step_model_flops(cfg, sh["kind"], sh["batch"], sh["seq"])


def step_model_flops(cfg, kind: str, b: int, s: int) -> float:
    """:func:`model_flops` of a ``kind`` step at batch ``b`` and sequence
    (decode: cache) length ``s``: the JAX package's formula, quirks
    included (an SSM or hybrid stack counts no attention)."""
    n_act = cfg.active_param_count()
    attn = 0.0
    if cfg.ssm_kind is None:
        hd, h = cfg.hd, cfg.n_heads
        for i in range(cfg.n_layers):
            akind = cfg.attn_kind(i)
            if kind == "decode":
                kv = min(s, cfg.local_window) if akind == "local" else s
                attn += 2 * 2 * b * h * hd * kv          # qk + pv
            else:
                kv = min(s, cfg.local_window) if akind == "local" else s
                attn += 2 * 2 * b * h * hd * s * kv / (
                    1 if akind == "local" else 2)         # causal half
    if kind == "train":
        return 6 * n_act * b * s + 3 * attn
    if kind == "prefill":
        return 2 * n_act * b * s + attn
    return 2 * n_act * b + attn                            # decode: 1 tok


def _parse_overrides(s):
    """--opt 'attn_schedule=triangular,megatron_sp=true,grad_accum=4'."""
    out = {}
    if not s:
        return out
    for kv in s.split(","):
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


# ---------------------------------------------------------------------------
# the fake group and rank 0's layout
# ---------------------------------------------------------------------------

def join_fake_group(world: int) -> None:
    """Join torch's ``fake`` process group of ``world`` ranks as rank 0,
    leaving a fake group of another size first.  Raises when the backend
    is missing or when the process belongs to a real group."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a dry run needs a process of its own: this "
                               "one is in a real process group")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _nbytes(tensors) -> int:
    """Bytes of the distinct storages of ``tensors``."""
    seen = {}
    for t in tensors:
        seen[t.untyped_storage()._cdata] = t.untyped_storage().nbytes()
    return sum(seen.values())


def _leaves(tree) -> list:
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _rank_rows(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """Rank 0's rows of ``t``: the first ``1 / size`` along ``dim``."""
    if t.shape[dim] % size:
        raise ValueError(f"a batch of {t.shape[dim]} rows does not tile "
                         f"the DP axes of {size}")
    return t.narrow(dim, 0, t.shape[dim] // size).clone()


def _port_cache(model, cfg, cache):
    """The caches a rank of ``Server(mesh=)`` holds, from the global
    ones: whole, but a tensor-parallel attention layer's (K, V) hold its
    own KV heads."""
    from repro_torch.distributed import tensor_parallel as tp_lib
    from repro_torch.models import layers as L
    out = []
    for layer, c in zip(model.layers, cache):
        mixer = layer.mixer
        if isinstance(mixer, L.Attention) and tp_lib.group_of(mixer):
            h = tp_lib.kv_heads(mixer, cfg)
            c = tuple(t.new_empty((t.shape[0], h) + tuple(t.shape[2:]))
                      if i < 2 else t for i, t in enumerate(c))
        out.append(c)
    return out


def _piece_bytes(t, sharding) -> int:
    """Bytes of rank 0's piece of ``t`` under ``sharding`` (pieces of
    ``ceil(n / size)`` along each cut dimension)."""
    from repro_torch.distributed.sharding import _dims
    shape = list(t.shape)
    for dim, _, size, _ in _dims(sharding.spec, sharding.mesh):
        shape[dim] = -(-shape[dim] // size)
    return math.prod(shape) * t.element_size()


def _mem_record(args_bytes: int, out, cost, arg_keys: set) -> dict:
    """``mem`` (module docstring) from the argument bytes, the step's
    result and its counter."""
    new_out = {}
    for t in _leaves(out):
        key = t.untyped_storage()._cdata
        if key not in arg_keys:
            new_out[key] = t.untyped_storage().nbytes()
    out_b = sum(new_out.values())
    alias = cost.mutated_bytes
    temp = max(0.0, cost.peak_bytes - out_b)
    return {"argument_gib": args_bytes / GIB,
            "output_gib": (out_b + alias) / GIB,
            "temp_gib": temp / GIB,
            "alias_gib": alias / GIB,
            "peak_est_gib": (args_bytes + out_b + temp) / GIB}


def _roofline(cost, useful: float, chips: int) -> dict:
    per_dev_useful = useful / chips
    compute_s = cost.flops / PEAK_FLOPS
    memory_s = cost.bytes_accessed / HBM_BW
    coll_s = cost.coll_wire_bytes / ICI_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", coll_s)), key=lambda kv: kv[1])[0]
    bound = max(compute_s, memory_s, coll_s)
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "dominant": dominant,
            "model_flops_total": useful,
            "model_flops_per_dev": per_dev_useful,
            "useful_ratio": per_dev_useful / max(cost.flops, 1.0),
            "roofline_s": bound,
            "roofline_frac": min(1.0, per_dev_useful / PEAK_FLOPS
                                 / max(bound, 1e-30))}


def _ops_record(cost) -> dict:
    return {"flops_per_dev": cost.flops,
            "bytes_per_dev": cost.bytes_accessed,
            "coll_bytes_per_dev": cost.coll_bytes,
            "coll_wire_bytes_per_dev": cost.coll_wire_bytes,
            "coll_by_type": dict(cost.coll_by_type),
            "coll_count": dict(cost.coll_count),
            "xla_cost_flops_unrolled_once": -1}


# ---------------------------------------------------------------------------
# one program, counted
# ---------------------------------------------------------------------------

def rank_model(cfg, mesh=None, *, fsdp: bool = False, fsdp_axes=("data",),
               ep_data: bool = False):
    """The model of ``cfg`` on ``meta``, laid out on ``mesh`` under
    ``param_spec_tree(fsdp=, fsdp_axes=, ep_data=)``: this rank's pieces
    (the whole model without a mesh)."""
    from repro_torch.distributed import sharding as shard_lib
    from repro_torch.models import model as model_lib
    model = model_lib.Model(cfg, "meta")
    if mesh is not None:
        specs = shard_lib.param_spec_tree(model, cfg, fsdp=fsdp,
                                          fsdp_axes=fsdp_axes,
                                          ep_data=ep_data)
        shard_lib.shard_model(model, mesh, specs)
    return model


def dry_run(cfg, kind: str, *, inputs, mesh=None, grad_accum: int = 1,
            fsdp: bool = False, fsdp_axes=("data",), seq_shard: bool = False,
            moments: str = "float32", ep_data: bool = False,
            pos: int = 0):
    """Run one step of ``kind`` (``"train"``, ``"prefill"`` or
    ``"decode"``) of ``cfg`` on ``meta`` under the counter, as rank 0 of
    ``mesh`` (None: one device, no process group), and return ``(cost,
    mem, extra, seconds)``.  ``inputs`` are :func:`input_specs`'
    (global) tensors; a mesh's rank takes its rows of a train batch.  A
    decode step runs at position ``pos``."""
    from repro_torch.distributed import sharding as shard_lib
    from repro_torch.launch.op_analysis import count
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import model as model_lib
    model = rank_model(cfg, mesh, fsdp=fsdp, fsdp_axes=fsdp_axes,
                       ep_data=ep_data)
    params = list(model.parameters())
    extra = {}
    if kind == "train":
        from repro_torch.launch.train import TrainConfig, make_train_step
        from repro_torch.optim.adamw import AdamWConfig, init_state
        tcfg = TrainConfig(grad_accum=grad_accum, fsdp=fsdp,
                           seq_shard_acts=seq_shard,
                           optimizer=AdamWConfig(moment_dtype=moments))
        batch = dict(inputs)
        if mesh is not None:
            _, size = shard_lib.live_dp_axes(mesh)
            if size > 1:
                dim = 1 if grad_accum > 1 else 0
                batch = {k: _rank_rows(v, dim, size)
                         for k, v in batch.items()}
        model.requires_grad_()
        opt = init_state(dict(model.named_parameters()), tcfg.optimizer)
        step = make_train_step(cfg, tcfg, mesh=mesh)
        args = params + _leaves(opt) + _leaves(batch)
        fn, fargs = step, (model, opt, batch)
    elif kind == "prefill":
        args = params + _leaves(inputs)
        fn, fargs = model_lib.prefill, (model, inputs["inputs"])
    else:
        cache = inputs["cache"]
        if mesh is not None:
            extra["cache_reference_gib"] = sum(
                _piece_bytes(t, sh) for layer, shs in zip(
                    cache, shard_lib.cache_spec_tree(
                        cache, cfg, mesh, inputs["inputs"].shape[0]))
                for t, sh in zip(layer, shs)) / GIB
            cache = _port_cache(model, cfg, cache)
        extra["cache_gib"] = _nbytes(_leaves(cache)) / GIB
        args = params + _leaves(cache) + [inputs["inputs"]]
        fn, fargs = model_lib.decode_step, (model, inputs["inputs"], cache,
                                            pos)
    arg_keys = {t.untyped_storage()._cdata for t in args}
    ctx = (attn_lib.decode_mesh(mesh) if mesh is not None and kind !=
           "train" else contextlib.nullcontext())
    t0 = time.perf_counter()
    with ctx:
        out, cost = count(fn, *fargs)
    seconds = time.perf_counter() - t0
    return cost, _mem_record(_nbytes(args), out, cost, arg_keys), extra, \
        seconds


def dry_serve(cfg, batch: int, prompt_len: int, max_len: int):
    """``Server.generate``'s program on one device, on ``meta``: the
    prefill of ``batch`` prompts of ``prompt_len`` tokens into caches of
    ``max_len``, then the first decode step on them.  Returns ``(the
    decode step's cost, the run's peak bytes: the parameters plus the
    larger of the prefill's peak and the decode step's peak over the
    caches the prefill left, seconds)``."""
    from repro_torch.launch.op_analysis import count
    from repro_torch.models import model as model_lib
    model = model_lib.Model(cfg, "meta")
    prompts = step_inputs(cfg, "prefill", batch, prompt_len)["inputs"]
    t0 = time.perf_counter()
    (_, caches), pre = count(model_lib.prefill, model, prompts, max_len)
    new = prompts[:, :1].clone()
    _, step = count(model_lib.decode_step, model, new, caches, prompt_len)
    peak = _nbytes(list(model.parameters())) + max(
        pre.peak_bytes, pre.live_bytes + step.peak_bytes)
    return step, peak, time.perf_counter() - t0


def folded(cfg, run):
    """``run(cfg)``'s ``(cost, mem, extra, seconds)`` for the whole layer
    stack, from runs of its first two and three layer groups.

    The JAX package's walker multiplies a scanned loop's body by its
    trip count; the port's layer stack is a Python loop over ``groups``
    groups of ``period`` identical layers after a ``prefix``
    (:func:`~repro_torch.models.model.group_layout`), and every group
    costs what the others cost: the same ops on the same shapes, forward,
    recomputation, backward, the gradient sync and the update.  So the
    stack of ``G`` groups costs ``c(2) + (G - 2) * (c(3) - c(2))``,
    exactly for FLOPs, bytes and collective bytes (the gradient sync's
    call count moves with how the gradients pack into its buffers).  The
    memory record is extrapolated the same way: exact for what scales
    with the groups (parameters, moments, gradients, caches, the saved
    group inputs) as long as the step's peak falls at the same point of
    the program at 3 groups as at ``G``.  From one group to two it need
    not (a one-group step peaks in transients that a longer stack
    outgrows), hence two and three.  A stack of three groups or fewer
    runs as it is."""
    from repro_torch.launch.op_analysis import OpCost
    from repro_torch.models.model import group_layout
    prefix, period, groups = group_layout(cfg)
    if groups <= 3:
        return run(cfg)
    two, three = (run(cfg.replace(n_layers=prefix + period * g))
                  for g in (2, 3))
    cost = OpCost()
    cost.add(two[0], 3 - groups)
    cost.add(three[0], groups - 2)

    def line(a, b):
        return {k: (3 - groups) * a[k] + (groups - 2) * b[k] for k in a}
    return cost, line(two[1], three[1]), line(two[2], three[2]), \
        two[3] + three[3]


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides=None):
    """The record of one cell on the single-pod (16 x 16) or multi-pod
    (2 x 16 x 16) mesh (module docstring); the layer stack
    :func:`folded`."""
    from repro_torch.distributed import sharding as shard_lib
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import group_layout
    meta = dict(META[arch])
    cfg = get_config(arch)
    ov = dict(overrides or {})
    for k in ("grad_accum", "fsdp", "seq_shard", "moments"):
        if k in ov:
            meta[k] = ov.pop(k)
    ep_data = bool(ov.pop("ep_data", False))
    if ov:
        cfg = cfg.replace(**ov)
    chips = 512 if multi_pod else 256
    join_fake_group(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    sh = SHAPES[shape_name]
    kind = sh["kind"]
    accum = meta["grad_accum"] if kind == "train" else 1
    # each microbatch must still cover the DP axes
    dp_size = math.prod(int(mesh.size(mesh.mesh_dim_names.index(a)))
                        for a in shard_lib.dp_axes(mesh))
    accum = max(1, min(accum, sh["batch"] // dp_size))
    fsdp_axes = ("pod", "data") if multi_pod else ("data",)

    def run(c):
        return dry_run(
            c, kind, inputs=input_specs(c, shape_name, grad_accum=accum),
            mesh=mesh, grad_accum=accum, fsdp=meta["fsdp"],
            fsdp_axes=fsdp_axes, seq_shard=meta["seq_shard"],
            moments=meta.get("moments", "float32"), ep_data=ep_data,
            pos=sh["seq"] - 1)
    cost, mem, extra, trace_s = folded(cfg, run)
    mem.update(extra)
    prefix, period, groups = group_layout(cfg)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips, "kind": kind, "grad_accum": accum,
        "trace_s": round(trace_s, 1),
        "layers_run": ([prefix + 2 * period, prefix + 3 * period]
                       if groups > 3 else [cfg.n_layers]),
        "mem": mem,
        "ops": _ops_record(cost),
        "roofline": _roofline(cost, model_flops(cfg, shape_name), chips),
    }


#: imported once by the server process the cells fork from
PRELOAD = ["torch", "torch._dynamo", "torch.utils.checkpoint",
           "torch.utils.flop_counter",
           "torch.testing._internal.distributed.fake_pg", __name__,
           "repro_torch.launch.train", "repro_torch.launch.op_analysis"]


def cell_line(rec) -> str:
    """One record's summary: rank 0's peak, FLOPs and wire bytes, and
    the dominant roofline term."""
    r = rec["roofline"]
    return (f"{rec['arch']} {rec['shape']} {rec['mesh']}: peak "
            f"{rec['mem']['peak_est_gib']:.2f} GiB/rank, "
            f"{rec['ops']['flops_per_dev']:.4g} FLOPs/rank, wire "
            f"{rec['ops']['coll_wire_bytes_per_dev']:.4g} B/rank, "
            f"{r['dominant']}-bound")


def run_cell(arch, shape, mesh_kind, out_path, opt=None) -> str:
    """One cell on one mesh (``"single"`` or ``"multi"``), its record
    written to ``out_path``; returns its summary line.  The JAX package
    runs each cell as a subprocess (``run_cell_subprocess``); :func:`main`
    runs this in a process of its own, forked from a server that has
    imported torch once (:data:`PRELOAD`)."""
    rec = lower_cell(arch, shape, multi_pod=mesh_kind == "multi",
                     overrides=_parse_overrides(opt))
    if opt:
        rec["overrides"] = opt
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=2)
    return cell_line(rec)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--results-dir", default="results/dryrun")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--opt", default=None,
                    help="cfg/meta overrides, e.g. "
                         "attn_schedule=triangular,megatron_sp=true")
    args = ap.parse_args(argv)

    if args.all:
        os.makedirs(args.results_dir, exist_ok=True)
        meshes = (["single", "multi"] if args.mesh == "both"
                  else [args.mesh])
        jobs = []
        for arch, shape, skipped in cells():
            for mk in meshes:
                out = os.path.join(args.results_dir,
                                   f"{arch}__{shape}__{mk}.json")
                if os.path.exists(out):
                    print(f"skip (cached): {out}")
                    continue
                jobs.append((arch, shape, mk, out))
        import concurrent.futures as cf
        import multiprocessing
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload(PRELOAD)
        failed = 0
        with cf.ProcessPoolExecutor(args.jobs, mp_context=ctx,
                                    max_tasks_per_child=1) as ex:
            futs = {ex.submit(run_cell, *j, args.opt): j for j in jobs}
            for f in cf.as_completed(futs):
                arch, shape, mk, out = futs[f]
                try:
                    line = f.result()
                except Exception:
                    failed += 1
                    print(f"[FAIL] {arch} {shape} {mk}\n"
                          f"{traceback.format_exc()[-4000:]}", flush=True)
                    continue
                print(f"[OK] {line}", flush=True)
        print(f"[all] {len(jobs) - failed} of {len(jobs)} cells OK in "
              f"{time.perf_counter() - t0:.1f} s ({args.jobs} jobs)")
        if failed:
            raise SystemExit(f"{failed} of {len(jobs)} cells failed")
        return

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    records = []
    for mp in meshes:
        try:
            rec = lower_cell(args.arch, args.shape, multi_pod=mp,
                             overrides=_parse_overrides(args.opt))
        except Exception as e:
            raise RuntimeError(
                f"cell {args.arch} {args.shape} "
                f"{'multi' if mp else 'single'}: {e}") from e
        if args.opt:
            rec["overrides"] = args.opt
        records.append(rec)
        r = rec["roofline"]
        print(f"== {args.arch} {args.shape} mesh={rec['mesh']} "
              f"trace={rec['trace_s']}s")
        print(f"   mem/device: {rec['mem']['peak_est_gib']:.2f} GiB "
              f"(args {rec['mem']['argument_gib']:.2f} + temps "
              f"{rec['mem']['temp_gib']:.2f})")
        print(f"   roofline: compute={r['compute_s']:.4f}s "
              f"memory={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s "
              f"-> {r['dominant']}-bound, useful_ratio="
              f"{r['useful_ratio']:.3f} frac={r['roofline_frac']:.3f}")
        print(f"   collectives: {rec['ops']['coll_count']}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(records if len(records) > 1 else records[0], f,
                      indent=2)


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
