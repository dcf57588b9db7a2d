"""Meshes for the port's sharded paths, over ``torch.distributed``.

The JAX package builds ``jax.sharding.Mesh`` objects; the port builds a
:class:`torch.distributed.device_mesh.DeviceMesh` with the same axis
names (``"data"``, ``"model"``) over the default process group, which
the caller initializes (one process per rank; :func:`run_ranks` spawns
them).  Each function is a plain function, so importing this module
touches no process group.

Ranks compute on ``cuda`` unless the caller asks for ``cpu`` (the CPU
tests run gloo ranks on the CPU): rank ``r`` takes ``cuda:(r %
device_count)``, so several ranks may share one card.  The collectives
between them stage through host memory where gloo needs it
(:mod:`repro_torch.distributed.collectives`).

``mesh=`` arguments of the kernel entry points take a ``DeviceMesh``;
the host geometry of :class:`~repro_torch.core.shard.ShardedPlan` also
takes any object whose ``shape`` maps an axis name to its size, as the
JAX package's plan reads ``mesh.shape[axis]`` (:func:`axis_size`).
"""
from __future__ import annotations

import math
import multiprocessing
import queue as queue_mod
import socket
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

#: the axis names of the meshes this module builds
AXES = ("data", "model")


def rank_device(rank: Optional[int] = None,
                device_type: str = "cuda") -> torch.device:
    """The device rank ``rank`` (this process's rank by default)
    computes on: ``cuda:(rank % device_count)``, or the CPU when
    ``device_type`` is ``"cpu"``.  Raises when ``cuda`` is asked for and
    no card is present: a mesh run never falls back to the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA card; pass "
                           "device='cpu' for CPU ranks")
    if rank is None:
        rank = dist.get_rank()
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: str = "cuda"):
    """A DeviceMesh of ``shape`` named ``axes`` over the default process
    group.  Raises ``ValueError`` when the world size does not equal the
    product of ``shape`` (as ``jax.make_mesh`` does when the devices do
    not fill it)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ "
                         f"in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"Number of devices {world} must equal the product "
                         f"of mesh_shape {shape}")
    dev = rank_device(dist.get_rank(), device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # before the mesh: no device heuristic
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16 x 16 ranks ('data' x 'model'); 2 pods of them when
    ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    return make_mesh(shape, axes, device=device)


def make_host_mesh(model_parallel: int = 1, *, device: str = "cuda"):
    """A (data, model) mesh over every rank of the process group."""
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by tp={model_parallel}")
    return make_mesh((n // model_parallel, model_parallel), AXES,
                     device=device)


def resolve_cli_mesh(spec: str, *, device: str = "cuda"):
    """One mesh for the whole process, from a CLI flag: '' -> None (one
    device); 'host' -> every rank as (data, model=1); 'DxM' -> an
    explicit (data, model) shape.  The block-space kernels shard over
    its 'data' axis (their ``shard_axis`` default)."""
    if not spec:
        return None
    if spec == "host":
        return make_host_mesh(device=device)
    try:
        data, model = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(
            f"--mesh expects '', 'host' or 'DATAxMODEL' (e.g. '4x2'); "
            f"got {spec!r}") from None
    return make_mesh((data, model), AXES, device=device)


# ---------------------------------------------------------------------------
# reading a mesh
# ---------------------------------------------------------------------------

def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


def axis_size(mesh, axis: str) -> int:
    """The size of ``mesh``'s axis ``axis``: a DeviceMesh's dimension,
    or ``mesh.shape[axis]`` of a stand-in object."""
    if _is_device_mesh(mesh):
        names = tuple(mesh.mesh_dim_names or ())
        if axis not in names:
            raise ValueError(f"mesh has no axis {axis!r}; its axes are "
                             f"{names}")
        return int(mesh.size(names.index(axis)))
    return int(mesh.shape[axis])


def axis_rank(mesh, axis: str) -> int:
    """This process's coordinate along ``axis`` of a DeviceMesh."""
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis):
    """The process group of ``axis`` of a DeviceMesh, or of several axes
    taken together (a tuple of names, in the mesh's order): its ranks
    in the order of the combined coordinate, the first axis major
    (:func:`axes_group`)."""
    if isinstance(axis, tuple):
        return axes_group(mesh, axis)
    return mesh.get_group(axis)


def axes_rank(mesh, axes) -> int:
    """This process's coordinate along several axes taken together (the
    first axis major); its coordinate along one axis for a name."""
    if isinstance(axes, str):
        return axis_rank(mesh, axes)
    index = 0
    for a in axes:
        index = index * axis_size(mesh, a) + axis_rank(mesh, a)
    return index


def axes_group(mesh, axes):
    """The process group spanning ``axes`` of a DeviceMesh (the mesh's
    own group for one axis).  A group of several axes is made once per
    mesh: every rank creates every such group, in one order, so the
    first call must be made on every rank.  ``axes`` must follow the
    mesh's axis order, so that the group's ranks (which
    ``torch.distributed`` sorts) run in the combined coordinate's
    order."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = tuple(mesh.mesh_dim_names)
    order = [names.index(a) for a in axes]
    if order != sorted(order):
        raise ValueError(f"axes {axes} are not in the mesh's order {names}")
    cache = mesh.__dict__.setdefault("_axes_groups", {})
    if axes not in cache:
        rest = [i for i in range(len(names)) if i not in order]
        ids = mesh.mesh.permute(rest + order).reshape(
            -1, math.prod(int(mesh.mesh.shape[i]) for i in order))
        me = dist.get_rank()
        for row in ids.tolist():
            group = dist.new_group(row)
            if me in row:
                cache[axes] = group
    return cache[axes]


def mesh_device(mesh) -> torch.device:
    """The device this rank of ``mesh`` computes on."""
    return rank_device(dist.get_rank(), mesh.device_type)


def check_mesh_device(mesh, *tensors) -> None:
    """Raise unless every tensor lies on this rank's device of ``mesh``:
    a cuda mesh computes nothing on the CPU.  ``meta`` tensors (the dry
    run's, :mod:`repro_torch.launch.dryrun`) hold no data and pass."""
    want = mesh_device(mesh)
    for t in tensors:
        if t.device != want and t.device.type != "meta":
            raise ValueError(f"a {mesh.device_type} mesh computes on "
                             f"{want}, got a tensor on {t.device}")


# ---------------------------------------------------------------------------
# spawning ranks
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, init_method, threads, args, queue):
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world)
        try:
            out = fn(rank, world, *args)
            # rank 0 hosts the TCP store: no rank tears the group down
            # while another is still in a collective or a group handshake
            dist.barrier()
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, *args, threads: int = 1,
              timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` processes joined by a
    gloo process group, and return the ranks' results in rank order.
    ``fn`` must be importable by name (a module-level function) and its
    result picklable; each rank imports the caller's main module, so a
    script that calls this keeps its top-level work under ``if __name__
    == "__main__":``.  The ranks fork from a server process that has
    imported torch and ``fn``'s module once (``forkserver``), so a world
    starts in well under a second after the first; no rank inherits its
    parent's state (its CUDA context, its other imports).
    The ranks meet at ``tcp://127.0.0.1:<a free port>``; each rank runs
    torch on ``threads`` threads (0: torch's default).  Raises
    ``RuntimeError`` with the failing ranks' tracebacks when any rank
    fails or does not finish in ``timeout`` seconds; every process is
    ended before it returns."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch.distributed", __name__,
                                fn.__module__])
    init_method = f"tcp://127.0.0.1:{free_port()}"
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init_method, threads, args,
                               queue), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    try:
        for _ in range(world):
            try:
                rank, ok, out = queue.get(timeout=timeout)
            except queue_mod.Empty:
                missing = sorted(set(range(world)) - set(results)
                                 - set(errors))
                errors[-1] = f"ranks {missing} gave no result in {timeout} s"
                break
            (results if ok else errors)[rank] = out
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    bad = [r for r, p in enumerate(procs) if p.exitcode not in (0, None)]
    if errors or bad:
        detail = "\n".join(f"rank {r}:\n{e}"
                           for r, e in sorted(errors.items()))
        raise RuntimeError(f"{len(errors) or len(bad)} of {world} ranks "
                           f"failed (exit codes "
                           f"{[p.exitcode for p in procs]}):\n{detail}")
    return [results[r] for r in range(world)]
