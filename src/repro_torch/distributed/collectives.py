"""The collectives of the sharded paths, over a gloo group: the
block-space kernels' exchanges and gathers, and the serving mesh's
tensor-parallel reductions and gathers (:func:`all_reduce`,
:func:`all_gather` along any dimension, on a sub-group of the mesh).

The H100 machine has one card, and NCCL will not put two ranks of one
communicator on one GPU, so the ranks of a mesh share the card over
gloo.  gloo moves host tensors (its send/recv and all-gather refuse CUDA
ones), so each collective here stages a CUDA tensor through a pinned
host buffer: one copy to the host before, one back after.  Every byte
is counted in :data:`TRAFFIC`: what crossed between ranks (``sent``,
``received``) and what crossed the PCIe link to get there (``staged``),
so a run reports its host staging as bytes, and the host seconds spent
in the all-reduces and all-gathers (``seconds``: staging, gloo and the
wait for the stream's earlier work, which the copy to the host implies).

CPU tensors (the CPU tests' gloo ranks) are handed to gloo as they are
and stage nothing.

``meta`` tensors (the dry run, :mod:`repro_torch.launch.dryrun`) move
nothing: each collective records the call into the active cost counter
(:func:`repro_torch.launch.op_analysis.charge_collective`: operand
bytes, wire bytes by the group's size, the count by type; an
all-gather's operand is the rank's piece, as in the JAX package's HLO)
and returns an empty ``meta`` result of the right shape.  It stages
nothing, calls no process group collective and leaves :data:`TRAFFIC`
as it is; the group's size is read from the process group (the dry run
runs on torch's ``fake`` backend).  :func:`all_reduce` and
:func:`masked_all_reduce` take it through :func:`all_reduce_sum`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Traffic:
    """Bytes moved by this process's collectives since :meth:`reset`."""

    sent: int = 0
    received: int = 0
    staged: int = 0
    calls: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.sent = self.received = self.staged = self.calls = 0
        self.seconds = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


#: this process's counters
TRAFFIC = Traffic()


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous host tensor: itself on the CPU, else a
    pinned copy (counted as staged bytes)."""
    if t.device.type == "cpu":
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    TRAFFIC.staged += t.numel() * t.element_size()
    return host


def from_host(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``host`` on ``like``'s device (counted as staged bytes when that
    is a card)."""
    if like.device.type == "cpu":
        return host
    TRAFFIC.staged += host.numel() * host.element_size()
    return host.to(like.device, non_blocking=False)


def _global(group, rank: int) -> int:
    """The global rank of ``group``'s rank ``rank``."""
    if group is None or group == dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def _is_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def _record(op: str, operand: torch.Tensor, result_bytes: int,
            group) -> None:
    """A ``meta`` call's record in the dry run's cost counter."""
    from repro_torch.launch.op_analysis import charge_collective, nbytes
    charge_collective(op, nbytes(operand), result_bytes,
                      dist.get_world_size(group))


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group's ranks, in place; returns ``t``."""
    if _is_meta(t):
        _record("all-reduce", t, t.numel() * t.element_size(), group)
        return t
    t0 = time.perf_counter()
    host = to_host(t)
    dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
    nbytes = t.numel() * t.element_size()
    TRAFFIC.sent += nbytes
    TRAFFIC.received += nbytes
    TRAFFIC.calls += 1
    if host is not t:
        t.copy_(from_host(host, t))
    TRAFFIC.seconds += time.perf_counter() - t0
    return t


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks, as a new tensor of
    ``t``'s dtype; bf16 and f16 are summed in f32 and rounded once (a
    tensor-parallel rank's partial product, or a masked piece of which
    each element has one owner: exact)."""
    acc = t.to(torch.float32) if t.dtype in (torch.bfloat16,
                                             torch.float16) else t.clone()
    return all_reduce_sum(acc, group).to(t.dtype)


def masked_all_reduce(part: torch.Tensor, owned: torch.Tensor,
                      group) -> torch.Tensor:
    """The sum over the ranks of ``where(owned, part, 0)``: exact, each
    cell has one owner (bf16 is summed in f32, which holds it exactly)."""
    return all_reduce(torch.where(owned, part, torch.zeros(
        (), dtype=part.dtype, device=part.device)), group)


def all_gather(t: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank) concatenated along
    ``dim`` in group-rank order, on ``t``'s device.  The bytes cross as
    they are (as uint8, which every gloo build takes, whatever ``t``'s
    dtype: concatenating the byte views along any dimension is
    concatenating the values)."""
    if _is_meta(t):
        size = dist.get_world_size(group)
        shape = list(t.shape)
        shape[dim] *= size
        _record("all-gather", t, t.numel() * t.element_size() * size, group)
        return t.new_empty(shape)
    t0 = time.perf_counter()
    host = to_host(t)
    if t.ndim:
        host = host.view(torch.uint8)
    size = dist.get_world_size(group)
    parts = [torch.empty_like(host) for _ in range(size)]
    dist.all_gather(parts, host, group=group)
    nbytes = t.numel() * t.element_size()
    TRAFFIC.sent += nbytes
    TRAFFIC.received += nbytes * (size - 1)
    TRAFFIC.calls += 1
    out = from_host(torch.cat(parts, dim).view(t.dtype), t)
    TRAFFIC.seconds += time.perf_counter() - t0
    return out


class Pending:
    """A batch of point-to-point messages in flight (:func:`start`)."""

    def __init__(self, works, got, keep, device):
        self._works, self._got, self._keep = works, got, keep
        self._device = torch.device(device)

    def wait(self) -> List[torch.Tensor]:
        """Wait for the batch; the received tensors on the device, in
        the order of the ``recvs`` that started it."""
        for work in self._works:
            work.wait()
        self._keep = None
        if self._device.type in ("cpu", "meta"):
            return self._got
        out = []
        for buf in self._got:
            TRAFFIC.staged += buf.numel() * buf.element_size()
            out.append(buf.to(self._device))
        return out


def start(sends: Sequence[Tuple[int, torch.Tensor]],
          recvs: Sequence[Tuple[int, Tuple[int, ...]]], dtype, device,
          group=None) -> Pending:
    """Start one batch of point-to-point messages: ``sends`` are (group
    rank, tensor) pairs, ``recvs`` (group rank, shape) pairs, all in
    flight together (``batch_isend_irecv``); :meth:`Pending.wait`
    returns what arrived.  On ``meta`` each send is recorded as a
    permute of its bytes and the receives come back empty."""
    if torch.device(device).type == "meta":
        for _, t in sends:
            _record("collective-permute", t, t.numel() * t.element_size(),
                    group)
        return Pending([], [torch.empty(shape, dtype=dtype, device="meta")
                            for _, shape in recvs], None, "meta")
    ops, keep, got = [], [], []
    pinned = torch.device(device).type == "cuda"
    for peer, t in sends:
        host = to_host(t)
        keep.append(host)  # alive until the batch completes
        ops.append(dist.P2POp(dist.isend, host, _global(group, peer),
                              group=group))
        TRAFFIC.sent += t.numel() * t.element_size()
    for peer, shape in recvs:
        buf = torch.empty(shape, dtype=dtype, pin_memory=pinned)
        got.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, _global(group, peer),
                              group=group))
        TRAFFIC.received += buf.numel() * buf.element_size()
    TRAFFIC.calls += 1
    works = dist.batch_isend_irecv(ops) if ops else []
    return Pending(works, got, keep, device)
