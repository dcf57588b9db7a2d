"""Per-op cost counter of the dry run: the port's counterpart of the
JAX package's ``repro/launch/hlo_analysis.py``.

The JAX package compiles each cell and walks the optimized, SPMD-
partitioned HLO text: loops multiplied by their trip counts, fusions
charged inputs + outputs, collectives tallied by type.  Eager PyTorch
has no compiled module to walk, so there is no HLO text here: the
counts are taken per aten op while the program runs on ``meta``
tensors (shapes and dtypes, no data), under a ``TorchDispatchMode``
(:func:`count`).  Every op the program runs reaches the mode -- the
backward's, the recomputation's and the optimizer's too -- so a Python
loop over layers or micro-batches is counted as many times as it runs,
with no trip counts to recover.

What :func:`count` charges, per op:

  * FLOPs from ``torch.utils.flop_counter``'s registered formulas (the
    matrix products, convolutions and library attention ops; elementwise
    ops and reductions count none);
  * bytes as the op's tensor inputs plus its outputs, for every op that
    is neither a view nor in :data:`ZERO_COST` (the counterpart of the
    walker's ``_ZERO_COST``).  These are eager bytes, every op on its
    own, unfused: an upper bound on what XLA's fusion model charges (a
    chain of elementwise ops that XLA fuses into one pass is charged
    here once per op);
  * live bytes: every storage an op allocates is tracked from its
    creation until its last tensor dies, so the run has a peak of the
    bytes it allocated (``peak_bytes``) beside the bytes it wrote in
    place into storages that existed before it (``mutated_bytes``: the
    parameters and moments AdamW updates, a decode step's caches).

Work that no aten op describes is charged by the code that does it, into
the counters of the :func:`count` calls in progress:

  * the hand-written kernels' entry points, given ``meta`` tensors,
    charge the work their kernel's schedule does and return an empty
    output (:func:`charge_kernel`);
  * the collectives of :mod:`repro_torch.distributed.collectives`,
    given ``meta`` tensors, record the call: operand bytes, wire bytes
    by the group's size (:func:`wire_multiplier`, the walker's ring
    estimates) and the count by type (:func:`charge_collective`).

All quantities are per rank: the program counted is one rank's.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

#: ops that move no data: allocation without a fill, shape and metadata
#: ops, random fills and host scalars (the walker's parameter /
#: constant / iota / bitcast / rng-bit-generator ...)
ZERO_COST = frozenset(op for op in (
    aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
    aten.new_empty_strided, aten.arange, aten.detach, aten.alias,
    aten.lift_fresh, aten.lift_fresh_copy, aten._local_scalar_dense,
    aten.scalar_tensor, aten.normal_, aten.uniform_, aten.bernoulli_,
    aten.random_, aten.sym_size, aten.sym_stride, aten.sym_numel,
    aten.sym_storage_offset, aten.is_same_size))

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def wire_multiplier(op: str, n: int) -> float:
    """Wire bytes per operand byte of collective ``op`` over ``n`` ranks
    (ring algorithms), the walker's ``_wire_multiplier``: all-reduce
    2(n-1)/n; all-gather and reduce-scatter n-1 (the operand is the
    shard, n-1 shards cross); all-to-all (n-1)/n; a permute 1."""
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op in ("all-gather", "reduce-scatter"):
        return float(n - 1)
    if op == "all-to-all":
        return (n - 1) / n
    return 1.0  # collective-permute


@dataclasses.dataclass
class OpCost:
    """The walker's ``HloCost`` (fields, :meth:`add`, :meth:`charge`),
    with the port's memory record: ``peak_bytes`` (the most bytes of
    the storages the run allocated alive at once), ``live_bytes`` (those
    still alive at the end) and ``mutated_bytes`` (the storages that
    existed before the run and were written in place)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    coll_bytes: float = 0.0          # raw operand bytes
    coll_wire_bytes: float = 0.0     # algorithm-aware wire traffic
    coll_by_type: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    coll_count: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    bytes_by_op: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    flops_by_op: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    peak_bytes: float = 0.0
    live_bytes: float = 0.0
    mutated_bytes: float = 0.0

    def add(self, other: "OpCost", mult: float = 1.0):
        self.flops += mult * other.flops
        self.bytes_accessed += mult * other.bytes_accessed
        self.coll_bytes += mult * other.coll_bytes
        self.coll_wire_bytes += mult * other.coll_wire_bytes
        for k, v in other.coll_by_type.items():
            self.coll_by_type[k] += mult * v
        for k, v in other.coll_count.items():
            self.coll_count[k] += int(mult * v)
        for k, v in other.bytes_by_op.items():
            self.bytes_by_op[k] += mult * v
        for k, v in other.flops_by_op.items():
            self.flops_by_op[k] += mult * v

    def charge(self, op: str, *, flops: float = 0.0, byts: float = 0.0):
        self.flops += flops
        self.bytes_accessed += byts
        if flops:
            self.flops_by_op[op] += flops
        if byts:
            self.bytes_by_op[op] += byts


#: the counters of the :func:`count` calls in progress, innermost last
_ACTIVE: List[OpCost] = []


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def charge_kernel(name: str, flops: float, byts: float) -> None:
    """Charge a hand-written kernel's work (its schedule's FLOPs, the
    bytes it reads and writes) to the active counters, under its name."""
    for cost in _ACTIVE:
        cost.charge(name, flops=float(flops), byts=float(byts))


def charge_collective(op: str, operand_bytes: float, result_bytes: float,
                      n: int) -> None:
    """Record one collective ``op`` over ``n`` ranks in the active
    counters, as the walker does: ``operand_bytes`` (the shard of an
    all-gather, the tensor of an all-reduce) as raw bytes and, times
    :func:`wire_multiplier`, as wire bytes; the result's bytes as bytes
    accessed."""
    if op not in _COLLECTIVES:
        raise ValueError(f"unknown collective {op!r}; expected one of "
                         f"{_COLLECTIVES}")
    w = operand_bytes * wire_multiplier(op, n)
    for cost in _ACTIVE:
        cost.coll_bytes += operand_bytes
        cost.coll_wire_bytes += w
        cost.coll_by_type[op] += w
        cost.coll_count[op] += 1
        cost.charge(op, byts=result_bytes)


#: in-place ops that change their tensor's shape or storage, not only
#: its values: never answered from the memo
_RESHAPES_IN_PLACE = frozenset(op for op in (
    aten.resize_, aten.resize_as_, aten.set_, aten._resize_output_))


class _Plan:
    """What the counter needs to know of one aten overload, once."""

    def __init__(self, func, registry):
        schema = func._schema
        self.names = [a.name for a in schema.arguments]
        self.written = {a.name for a in schema.arguments
                        if a.alias_info is not None and a.alias_info.is_write}
        packet = func.overloadpacket
        self.name = str(packet)
        self.flops = registry.get(packet)
        self.free = func.is_view or packet in ZERO_COST
        returns_alias = any(r.alias_info is not None for r in schema.returns)
        inplace = (schema.name.endswith("_") and self.written == {"self"}
                   and torch.Tag.inplace_view not in func.tags
                   and packet not in _RESHAPES_IN_PLACE)
        # answered from the memo: a functional op (fresh outputs), or an
        # in-place op on ``self`` that changes only its values
        self.memo = ((not returns_alias and not self.written) or inplace)
        self.inplace = inplace


def _sig(a):
    """A hashable key of one argument: a tensor's shape, strides, dtype
    and device; anything else as itself."""
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.dtype, a.device.type)
    if isinstance(a, (list, tuple)):
        return tuple(_sig(x) for x in a)
    return (type(a), a)


class _Counter(TorchDispatchMode):
    """Charges every aten op it sees into ``cost`` (:func:`count`).

    On ``meta`` tensors the outputs of an op depend only on its
    arguments' shapes, strides and dtypes, so each functional or
    in-place op is run once per such signature and answered from a memo
    after (fresh ``empty_strided`` outputs of the recorded layout, or
    ``self``): a 48-layer step repeats each signature many times, and
    many meta kernels run as Python references."""

    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost
        self.live: Dict[int, list] = {}   # storage -> [bytes, tensors]
        self.mutated: set = set()
        self.registry = _flop_registry()
        self.plans: Dict = {}
        self.memo: Dict = {}
        self.refs: Dict = {}     # weak reference -> its tensor's storage

    def _release(self, key: int) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            del self.live[key]
            self.cost.live_bytes -= entry[0]

    def _dead(self, ref) -> None:
        self._release(self.refs.pop(ref))

    def _track(self, t: torch.Tensor, inputs: set) -> None:
        """Count a new tensor: a storage of its own is live from now; a
        tensor of a live storage holds it a while longer."""
        st = t.untyped_storage()
        key = st._cdata
        entry = self.live.get(key)
        if entry is not None:
            entry[1] += 1
        elif key in inputs:   # a view of, or written into, an older one
            return
        else:
            size = st.nbytes()
            self.live[key] = [size, 1]
            cost = self.cost
            cost.live_bytes += size
            if cost.live_bytes > cost.peak_bytes:
                cost.peak_bytes = cost.live_bytes
        self.refs[weakref.ref(t, self._dead)] = key

    def _mutate(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self.live and key not in self.mutated:
            self.mutated.add(key)
            self.cost.mutated_bytes += st.nbytes()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        plan = self.plans.get(func)
        if plan is None:
            plan = self.plans[func] = _Plan(func, self.registry)
        tensors, read, keys = [], 0, set()
        names, written = plan.names, plan.written
        for i, a in enumerate(args):
            read += self._gather(a, names[i] if i < len(names) else "",
                                 written, tensors, keys)
        for name, a in kwargs.items():
            read += self._gather(a, name, written, tensors, keys)
        key = hit = None
        if plan.memo and tensors and all(t.device.type == "meta"
                                         for t in tensors):
            try:
                key = (func, _sig(args), _sig(tuple(kwargs.items())))
                hit = self.memo.get(key)
            except TypeError:   # an unhashable argument: run it
                key = None
        if hit is not None:
            flops, out_spec = hit
            out = args[0] if plan.inplace else _rebuild(out_spec)
        else:
            out = func(*args, **kwargs)
            flops = (self.flops_of(plan, args, kwargs, out)
                     if plan.flops is not None else 0.0)
            if key is not None:
                try:
                    self.memo[key] = (flops, None if plan.inplace
                                      else _spec(out))
                except TypeError:   # not tensors: never answered
                    pass
        if isinstance(out, torch.Tensor):
            outs = (out,)
        else:
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
        wrote = 0
        for t in outs:
            wrote += t.numel() * t.element_size()
            if not any(t is x for x in tensors):
                self._track(t, keys)
        if flops:
            self.cost.charge(plan.name, flops=flops)
        if not plan.free:
            self.cost.charge(plan.name, byts=read + wrote)
        return out

    def _gather(self, a, name, written, tensors, keys) -> int:
        """Note the tensors of argument ``a`` (named ``name``), their
        storages and those written; returns the bytes it reads (none for
        an ``out=``)."""
        if isinstance(a, torch.Tensor):
            found = (a,)
        elif isinstance(a, (list, tuple)):
            found = [t for t in a if isinstance(t, torch.Tensor)]
            if not found:
                return 0
        else:
            return 0
        read = 0
        for t in found:
            tensors.append(t)
            keys.add(t.untyped_storage()._cdata)
            if name in written:
                self._mutate(t)
            if name != "out":
                read += t.numel() * t.element_size()
        return read

    @staticmethod
    def flops_of(plan, args, kwargs, out) -> float:
        return float(plan.flops(*args, **kwargs, out_val=out))


def _spec(out):
    """The layout of an op's outputs (a tensor, or a tuple or list of
    tensors), for :func:`_rebuild`; None when it is anything else."""
    if isinstance(out, torch.Tensor):
        return (out.shape, out.stride(), out.dtype)
    if isinstance(out, (list, tuple)) and all(isinstance(t, torch.Tensor)
                                              for t in out):
        return type(out)(_spec(t) for t in out)
    raise TypeError("not a tensor output")


def _rebuild(spec):
    if isinstance(spec, tuple) and len(spec) == 3 and isinstance(
            spec[2], torch.dtype):
        return torch.empty_strided(spec[0], spec[1], dtype=spec[2],
                                   device="meta")
    return type(spec)(_rebuild(s) for s in spec)


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def count(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the counter; returns ``(its
    result, the OpCost)``.  Meant for ``meta`` tensors (a dry run), but
    counts any tensors.  A call inside another counts into both."""
    cost = OpCost()
    mode = _Counter(cost)
    _ACTIVE.append(cost)
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    return out, cost


__all__ = ["OpCost", "ZERO_COST", "charge_collective",
           "charge_kernel", "count", "nbytes", "wire_multiplier"]
