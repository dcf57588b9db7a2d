"""The paper's SS IV microbenchmark: write (or sum) every member cell of
an embedded n x n fractal, over a :class:`~repro_torch.core.plan.GridPlan`.

Four lowerings, as in the JAX package:

* ``closed_form`` (alias ``compact``) -- the lambda(w) map: one warp per
  member block, the block decoded in registers by the digit loop (a
  row-major domain's blocks walked along their rows).
* ``prefetch_lut`` -- the same enumeration read from a device int32
  coordinate table: an O(1) decode.
* ``bounding`` -- the bounding-box baseline: nbx * nby steps, with the
  run-time discard of non-member blocks.
* ``mma`` -- the closed_form grid, each block decoded by the digit-basis
  chains on the tensor cores (:mod:`repro_torch.core.mma`): lambda and
  the own compact slot, or a row-major domain's row chain.

Two storages: ``embedded`` (the state ``m`` is the dense (n, n) array)
and ``compact`` (``m`` is the packed Lemma 2 orthotope array of
:class:`~repro_torch.core.compact.CompactLayout`; pass ``n=``).  Cells
outside the fractal keep their contents.  ``coarsen=s`` makes each grid
step own an s x s superblock of fine blocks (the lambda decode runs once
per superblock); the sum then has one partial per superblock.
``domain=`` takes any block domain with a device-side decode instead of
the fractal: the triangular, band and bounding-box domains of attention
(every cell of a member block is written), or a fractal domain.

Each kernel sits beside its plain PyTorch version.  The entry points
follow the state's device: a CUDA tensor launches the kernel of
``repro_torch/csrc/sierpinski_write.cu`` (or raises), a CPU tensor runs
the plain version.  Each CUDA wrapper counts its launches in a plain
integer attribute, ``launches``.  When a launch hook is installed
(:func:`repro_torch.kernels._cuda.set_launch_hook`, the fault injector's)
each write, and each sum's tile reduce, runs through it.

The entry points take the JAX package's keywords.  ``num_stages`` is
an integer >= 1: these kernels have no ring, so every depth gives the
same bits.  ``grid_mode``, ``coarsen`` and ``num_stages`` (its default)
accept ``"auto"``: a lookup of the ``"write"`` entry of the tune cache
(:mod:`repro_torch.core.tune`) under ``{fractal, n, block}`` and the
state's target, never a measurement; an untuned problem gets the JAX
package's defaults (closed_form, coarsen 1, one stage), an explicit
value is never overridden, and a cached ``storage`` is not applied (the
state's layout is given).  As in the JAX package the key names the
``fractal`` argument even when ``domain=`` is given; under ``mesh=`` it
also names the shard count (``"devices"``, :func:`repro_torch.core.tune.
shard_params`).

``mesh=`` (a DeviceMesh, :mod:`repro_torch.launch.mesh`) shards the
domain over its ``shard_axis`` (:class:`repro_torch.core.shard.
ShardedPlan`).  Every rank passes the global state and gets the global
result back, as with the JAX package's ``shard_map``.  Compact storage
writes each rank's slab of packed rows in place, then gathers the slabs;
embedded storage runs each rank's range of the lambda enumeration on a
copy of the replicated state and combines the copies with an
ownership-masked sum (every member block has exactly one owner;
non-member cells pass through).  The sum runs each rank's partials and
its in-order combine, then one sum over the ranks: exact on
integer-valued states, a float reassociation otherwise.  On the card each
rank launches the sharded kernels (``sw_write_sharded``,
``sw_sum_partials_sharded``); :func:`write_rank` / :func:`sum_rank` run
one rank's share without a process group.

``verify=True`` statically verifies the plan before any launch
(:func:`repro_torch.analysis.verify_or_raise`, the ``"write"`` or
``"sum"`` access model): the tables the launch will read are copied from
the state's device and checked, and a failing plan raises
``PlanVerificationError`` (a ``ValueError``) with nothing launched.
Under ``mesh=`` each rank verifies the sharded plan it launches.  The
flag never changes what is computed.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.compact import compact_layout
from repro_torch.core.domain import BlockDomain, make_fractal_domain
from repro_torch.core.plan import GridPlan, LaunchParams, normalize_storage

from . import _cuda

#: dtype -> the kernel's dtype code (csrc/sierpinski_write.cu ``DType``)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
#: cells per chunk of the plain versions (bounds their temporaries)
PLAIN_CHUNK_CELLS = 1 << 24


def resolve_fractal_domain(fractal: str, n: int, block: int) -> BlockDomain:
    """Validated block-grid domain for an embedded n x n fractal state.

    Raises a clear ValueError when ``block`` does not divide ``n`` (a
    truncated block grid would silently drop fractal coverage: e.g. a
    16 x 16 gasket at block=6 only reaches 45 of its 81 member cells) or
    when the resulting blocks-per-side is not a power of the fractal's
    subdivision factor.
    """
    if n % block:
        raise ValueError(
            f"block={block} must divide n={n} (remainder {n % block}): "
            f"the {n // block}-block grid would silently truncate "
            f"fractal coverage")
    n_b = n // block
    try:
        return make_fractal_domain(fractal, n_b)
    except ValueError as e:
        raise ValueError(
            f"n/block = {n_b} blocks per side is not a valid scale level "
            f"of fractal {fractal!r}: {e}") from None


def resolve_storage_args(m, block, fractal, storage, n, domain=None):
    """Shared entry-point validation for the fractal-state kernels.

    Returns (domain, n, block, storage) with the state array ``m``
    checked against the storage layout's expected shape.  ``n`` (the
    embedded side length) must be passed under compact storage when no
    ``domain`` is given, since the packed array's shape no longer
    determines it; with a ``domain`` it defaults to ``nby * block``."""
    storage = normalize_storage(storage)
    if domain is None:
        if n is None:
            if storage == "compact":
                raise ValueError(
                    "storage='compact' needs the embedded size n= (or an "
                    "explicit domain=): the packed array shape does not "
                    "determine it")
            if m.ndim != 2 or m.shape[0] != m.shape[1]:
                raise ValueError(
                    f"expected square 2-D state, got {tuple(m.shape)}")
            n = m.shape[0]
        block = min(block, n)
        domain = resolve_fractal_domain(fractal, n, block)
    elif n is None:
        n = domain.bounding_box[1] * block
    layout = compact_layout(domain)
    want = layout.array_shape(block) if storage == "compact" \
        else layout.embedded_shape(block)
    if tuple(m.shape) != want:
        raise ValueError(
            f"{storage} state shape {tuple(m.shape)} does not match the "
            f"expected {want} for block={block}")
    return domain, n, block, storage


def _check_state(m: torch.Tensor) -> None:
    if m.dtype not in DTYPES:
        raise TypeError(
            f"state dtype {m.dtype} is not supported; expected one of "
            f"{tuple(DTYPES)}")
    if not m.is_contiguous():
        raise ValueError(
            "the state must be contiguous (the kernels address it as a "
            "dense row-major array); pass m.contiguous()")


def prepare_launch(m: torch.Tensor, *, block: int = 128,
                   grid_mode: str = "compact",
                   fractal: str = "sierpinski-gasket",
                   storage: str = "embedded", n: int | None = None,
                   domain: BlockDomain | None = None, coarsen: int = 1):
    """Validate the state and the options of a write/sum; returns
    ``(plan, n, block)`` for the kernel wrappers and plain versions."""
    _check_state(m)
    domain, n, block, storage = resolve_storage_args(m, block, fractal,
                                                     storage, n, domain)
    plan = GridPlan(domain, grid_mode, storage=storage, coarsen=coarsen,
                    backend=m)
    return plan, n, block


def verify_launch(plan: GridPlan, kernel: str, device) -> None:
    """``verify=True``: statically verify ``plan`` under the access model
    ``kernel`` against the tables its launch reads on ``device``; raises
    ``PlanVerificationError`` on any finding."""
    from repro_torch.analysis.verifier import verify_or_raise
    verify_or_raise(plan, kernel=kernel, device=device)


def resolve_auto_schedule(kernel: str, params: dict, *, device=None,
                          **knobs):
    """Resolve ``"auto"`` scheduling knobs from the tune cache.

    ``knobs`` maps knob name -> (current value, config key, default);
    returns the knob values with every ``"auto"`` replaced by the tuned
    value for ``params`` on ``device``'s target (or the default when
    this problem was never tuned there).  Values the caller fixed
    explicitly are passed through untouched, so a tuned lowering never
    overrides an explicit ``coarsen=``."""
    def is_auto(v):
        return isinstance(v, str) and v == "auto"

    if not any(is_auto(v) for v, _, _ in knobs.values()):
        return tuple(v for v, _, _ in knobs.values())
    from repro_torch.core import tune
    cfg = tune.best(kernel, params, device=device) or {}
    return tuple(cfg.get(key, default) if is_auto(value) else value
                 for value, key, default in knobs.values())


def _write_schedule(m: torch.Tensor, fractal: str, n, block: int,
                    grid_mode, coarsen, num_stages, mesh=None,
                    shard_axis: str = "data"):
    """The write/sum schedule with its ``"auto"`` knobs resolved from the
    tune cache's ``"write"`` entry (the JAX package's key: ``fractal``,
    ``n or m.shape[0]``, ``block``, and the shard count under a mesh),
    the depth checked."""
    from repro_torch.core import tune
    grid_mode, coarsen, num_stages = resolve_auto_schedule(
        "write", tune.shard_params(
            {"fractal": fractal, "n": n or m.shape[0], "block": block},
            mesh, shard_axis),
        device=m.device,
        grid_mode=(grid_mode, "lowering", "closed_form"),
        coarsen=(coarsen, "coarsen", 1),
        num_stages=(num_stages, "stages", 1))
    _check_stages(num_stages)
    return grid_mode, coarsen


def _check_stages(num_stages) -> None:
    """Write and sum have no ring: any integer depth >= 1 gives the same
    bits; anything else is refused."""
    if isinstance(num_stages, bool) or not isinstance(num_stages, int) \
            or num_stages < 1:
        raise ValueError(f"num_stages must be an integer >= 1, got "
                         f"{num_stages!r}")


def _value_of(value, dtype) -> torch.Tensor:
    """``value`` converted as ``torch.tensor(value, dtype=dtype)`` does."""
    return torch.tensor(value, dtype=dtype)


# ---------------------------------------------------------------------------
# plain versions: the lowering's own decode as tensor index math
# ---------------------------------------------------------------------------

def supertile_offsets(plan: GridPlan, block: int, device):
    """(OY, OX) int64 tensors shaped like one storage supertile: the
    embedded cell offset of each of its cells from the superblock's
    embedded origin (the fine-block permutation baked in under compact
    coarsening)."""
    oy, ox = plan.cell_offset_grids(block)
    return (torch.from_numpy(oy).to(device, torch.int64),
            torch.from_numpy(ox).to(device, torch.int64))


def storage_offsets(plan: GridPlan, row, col, block: int, device):
    """int64 flat offsets into the state array of every cell of the
    storage supertiles at (row, col) (supertile units), shaped
    (steps, th, tw)."""
    th, tw = plan.supertile_shape((block, block))
    pitch = plan.state_shape(block)[1]
    iy = torch.arange(th, dtype=torch.int64, device=device)[:, None]
    ix = torch.arange(tw, dtype=torch.int64, device=device)[None, :]
    return (row[:, None, None] * th + iy) * pitch \
        + col[:, None, None] * tw + ix


def record_trace(trace: torch.Tensor, start: int, bx, by, valid, *,
                 store=None, loads=(), slot: bool = False,
                 live_only: bool = False) -> None:
    """Fill the trace rows of steps [start, start + len(bx)) from the
    index tensors a plain version addresses memory with, as the trace
    builds of the kernels fill them (:data:`_cuda.TRACE_COLUMNS`): one
    visit a step (a live step only, with ``live_only``: the CA), live,
    the block and ``store`` = (row, col) of a live step, ``loads`` =
    ((origin slot, row, col, valid or None), ...) of a live step (-1
    where not valid), and with ``slot`` the step's own id."""
    stop = start + len(bx)
    rows = trace[start:stop]
    live = torch.ones(len(bx), dtype=torch.bool, device=bx.device) \
        if valid is None else valid
    if live_only:
        rows[live, 0] += 1
        rows[live, 1] = 1
    else:
        rows[:, 0] += 1
        rows[:, 1] = live.to(torch.int32)
    cols = [(2, bx), (3, by)]
    if store is not None:
        cols += [(4, store[0]), (5, store[1])]
    for o, r, c, ok in loads:
        k = _cuda.TRACE_LOADS + 2 * o
        if ok is not None:
            r = torch.where(ok, r, -1)
            c = torch.where(ok, c, -1)
        cols += [(k, r), (k + 1, c)]
    for col, v in cols:
        rows[live, col] = v[live].to(torch.int32)
    if slot:
        rows[:, 6] = torch.arange(start, stop, dtype=torch.int32,
                                  device=bx.device)


def _record_tiles(trace, kind: str, start: int, bx, by, valid, row,
                  col) -> None:
    """The trace rows of a chunk of write (``kind`` "write": the stored
    tile) or sum steps (the read tile and the partial)."""
    if kind == "write":
        record_trace(trace, start, bx, by, valid, store=(row, col))
    else:
        record_trace(trace, start, bx, by, valid, slot=True,
                     loads=((4, row, col, None),))


def trace_plain(plan: GridPlan, kind: str, device) -> torch.Tensor:
    """The trace rows a write (``kind`` "write") or sum launch of
    ``plan`` fills, from the plain version's index tensors, without
    touching a state: what the kernel's trace build must write for the
    same plan."""
    steps = plan.steps_per_launch
    trace = _cuda.trace_rows(steps, device)
    per = 1 << 20
    for start in range(0, steps, per):
        stop = min(steps, start + per)
        bx, by, valid = plan.step_coords(start, stop, device)
        row, col = plan.storage_index(start, stop, device)
        _record_tiles(trace, kind, start, bx, by, valid, row, col)
    return trace


def _tile_chunks(plan: GridPlan, n: int, block: int, device, trace=None,
                 kind: str = "write"):
    """Yield ``(flat, mask)`` per chunk of grid steps, in step order:
    the int64 offsets into the state array of every cell of each step's
    storage supertile, shaped (steps, th, tw), and its cell-membership
    mask (all False for a discarded bounding step).  With ``trace``
    rows, each chunk's rows are filled from the same index tensors: the
    stored tile of a write, the read tile and the partial of a sum."""
    th, tw = plan.supertile_shape((block, block))
    span = plan.coarsen * block
    oy, ox = supertile_offsets(plan, block, device)
    steps = plan.steps_per_launch
    per = max(1, PLAIN_CHUNK_CELLS // (th * tw))
    for start in range(0, steps, per):
        stop = min(steps, start + per)
        bx, by, valid = plan.step_coords(start, stop, device)
        row, col = plan.storage_index(start, stop, device)
        if trace is not None:
            _record_tiles(trace, kind, start, bx, by, valid, row, col)
        gx = bx[:, None, None] * span + ox
        gy = by[:, None, None] * span + oy
        mask = plan.domain.cell_member(gx, gy, n)
        if valid is not None:
            mask = mask & valid[:, None, None]
        yield storage_offsets(plan, row, col, block, device), mask


def sierpinski_write_plain(m: torch.Tensor, value, plan: GridPlan, n: int,
                           block: int, trace=None) -> torch.Tensor:
    """Plain version of the write kernel, in place like it: decode every
    step, mask its tile, scatter ``value`` into the member cells (and
    fill ``trace`` rows, when given, as the trace build does)."""
    v = _value_of(value, m.dtype).item()
    flat = m.view(-1)
    for offs, mask in _tile_chunks(plan, n, block, m.device, trace,
                                   "write"):
        flat.index_fill_(0, offs[mask], v)
    return m


def sum_partials_plain(m: torch.Tensor, plan: GridPlan, n: int,
                       block: int, trace=None) -> torch.Tensor:
    """Plain version of the tile-reduce kernel: the (steps,) f32 sums of
    each step's member cells (0 for a discarded bounding step); fills
    ``trace`` rows when given."""
    flat = m.view(-1)
    parts = []
    for offs, mask in _tile_chunks(plan, n, block, m.device, trace, "sum"):
        tiles = torch.where(mask, flat[offs], 0).to(torch.float32)
        parts.append(tiles.sum(dim=(1, 2)))
    if not parts:  # a rank of a sharded plan that owns nothing
        return torch.zeros(0, dtype=torch.float32, device=m.device)
    return torch.cat(parts)


def sum_combine_plain(partials: torch.Tensor) -> torch.Tensor:
    """Plain version of the combine kernel: the partials added one by
    one in step order, in f32, as a 0-d tensor on their device.

    PyTorch has no sequential f32 scan (its CPU ``cumsum`` accumulates
    in float64 and its CUDA ``cumsum`` is a parallel scan), so the chain
    runs in numpy on the host, whose ``add.accumulate`` is a strict
    left-to-right f32 loop."""
    host = partials.detach().to("cpu", torch.float32).numpy()
    total = np.add.accumulate(host, dtype=np.float32)[-1]
    return torch.tensor(total, dtype=torch.float32, device=partials.device)


def sierpinski_sum_plain(m: torch.Tensor, plan: GridPlan, n: int,
                         block: int) -> torch.Tensor:
    """Plain version of the sum: partials, then the in-order combine."""
    return sum_combine_plain(sum_partials_plain(m, plan, n, block))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
#: library -> its C entry points' argument types
_SIGNATURES = {
    "sierpinski_write": {
        "sw_write": [_P, _I, ctypes.c_uint, _P, _P, _P, _P, _P],
        "sw_sum_partials": [_P, _I, _P, _P, _P, _P, _P, _P],
        "sw_sum_combine": [_P, _LL, _P, _P]},
    "sierpinski_write_sharded": {
        "sw_write_sharded": [_P, _I, ctypes.c_uint] + [_P] * 8,
        "sw_sum_partials_sharded": [_P, _I] + [_P] * 9},
    "sierpinski_write_trace": {
        "sw_write_trace": [_P, _I, ctypes.c_uint, _P, _P, _P, _P, _P, _P],
        "sw_sum_partials_trace": [_P, _I, _P, _P, _P, _P, _P, _P, _P]},
}


def _lib(name: str = "sierpinski_write") -> ctypes.CDLL:
    """The loaded library ``name`` (or its sharded half,
    ``"sierpinski_write_sharded"``, or its trace build,
    ``"sierpinski_write_trace"``), its entry points typed."""
    lib = _cuda.load(name)
    if not getattr(lib, "_repro_bound", False):
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check_kernel_args(m: torch.Tensor, p: LaunchParams) -> None:
    """What the kernels take: a contiguous state of a supported dtype
    and of the plan's storage shape on a CUDA device, with the decode
    tables on the same device."""
    _cuda.check_tables(m, p)
    if m.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel needs a CUDA tensor, got one on {m.device}")
    _check_state(m)
    if tuple(m.shape) != (p.rows, p.pitch):
        raise ValueError(
            f"state shape {tuple(m.shape)} != ({p.rows}, {p.pitch})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _value_bits(m: torch.Tensor, value) -> int:
    """The bits of ``value`` in ``m``'s dtype, as the kernels store
    them."""
    v = _value_of(value, m.dtype)
    bits = int(v.view(torch.int32 if m.element_size() == 4 else torch.int16))
    return bits & ((1 << (8 * m.element_size())) - 1)


def write_cuda(m: torch.Tensor, value, p: LaunchParams,
               trace=None) -> torch.Tensor:
    """Launch the write kernel on ``m`` in place (predicated stores of
    ``value`` into member cells; nothing else is read or written); with
    ``trace`` rows, its trace build (:func:`write_trace_cuda`)."""
    if trace is not None:
        return write_trace_cuda(m, value, p, trace)
    _check_kernel_args(m, p)
    bits = _value_bits(m, value)
    lib = _lib()
    with torch.cuda.device(m.device):
        status = lib.sw_write(m.data_ptr(), m.element_size(), bits,
                              _cuda.param_array(p), _cuda.ptr(p.lut),
                              _cuda.ptr(p.tile_perm), _cuda.ptr(p.mma_ops),
                              _stream(m.device))
    write_cuda.launches += 1
    _cuda.count_mma(p)
    _cuda.raise_on(lib, status, "sierpinski write kernel")
    return m


write_cuda.launches = 0


def write_trace_cuda(m: torch.Tensor, value, p: LaunchParams,
                     trace: torch.Tensor) -> torch.Tensor:
    """Launch the write kernel's trace build: the write of
    :func:`write_cuda`, bit for bit, which also fills each grid step's
    ``trace`` row (:data:`_cuda.TRACE_COLUMNS`)."""
    _check_kernel_args(m, p)
    _cuda.check_trace(m, p.steps, trace)
    bits = _value_bits(m, value)
    lib = _lib("sierpinski_write_trace")
    with torch.cuda.device(m.device):
        status = lib.sw_write_trace(
            m.data_ptr(), m.element_size(), bits, _cuda.param_array(p),
            _cuda.ptr(p.lut), _cuda.ptr(p.tile_perm), _cuda.ptr(p.mma_ops),
            trace.data_ptr(), _stream(m.device))
    write_trace_cuda.launches += 1
    _cuda.raise_on(lib, status, "sierpinski write trace kernel")
    return m


write_trace_cuda.launches = 0


def sum_partials_cuda(m: torch.Tensor, p: LaunchParams,
                      trace=None) -> torch.Tensor:
    """Launch the tile-reduce kernel: (steps,) f32 partial sums; with
    ``trace`` rows, its trace build (:func:`sum_partials_trace_cuda`)."""
    if trace is not None:
        return sum_partials_trace_cuda(m, p, trace)
    _check_kernel_args(m, p)
    partials = torch.empty(p.steps, dtype=torch.float32, device=m.device)
    lib = _lib()
    with torch.cuda.device(m.device):
        status = lib.sw_sum_partials(m.data_ptr(), DTYPES[m.dtype],
                                     partials.data_ptr(),
                                     _cuda.param_array(p), _cuda.ptr(p.lut),
                                     _cuda.ptr(p.tile_perm),
                                     _cuda.ptr(p.mma_ops), _stream(m.device))
    sum_partials_cuda.launches += 1
    _cuda.count_mma(p)
    _cuda.raise_on(lib, status, "sierpinski sum partials kernel")
    return partials


sum_partials_cuda.launches = 0


def sum_partials_trace_cuda(m: torch.Tensor, p: LaunchParams,
                            trace: torch.Tensor) -> torch.Tensor:
    """Launch the tile-reduce kernel's trace build: the partials of
    :func:`sum_partials_cuda`, bit for bit, and each step's ``trace``
    row."""
    _check_kernel_args(m, p)
    _cuda.check_trace(m, p.steps, trace)
    partials = torch.empty(p.steps, dtype=torch.float32, device=m.device)
    lib = _lib("sierpinski_write_trace")
    with torch.cuda.device(m.device):
        status = lib.sw_sum_partials_trace(
            m.data_ptr(), DTYPES[m.dtype], partials.data_ptr(),
            _cuda.param_array(p), _cuda.ptr(p.lut), _cuda.ptr(p.tile_perm),
            _cuda.ptr(p.mma_ops), trace.data_ptr(), _stream(m.device))
    sum_partials_trace_cuda.launches += 1
    _cuda.raise_on(lib, status, "sierpinski sum partials trace kernel")
    return partials


sum_partials_trace_cuda.launches = 0


def sum_combine_cuda(partials: torch.Tensor) -> torch.Tensor:
    """Launch the in-order combine kernel: a 0-d f32 tensor."""
    if partials.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel needs a CUDA tensor, got one on "
            f"{partials.device}")
    if (partials.dtype != torch.float32 or partials.ndim != 1
            or not partials.is_contiguous()):
        raise ValueError("partials must be a contiguous 1-D f32 tensor")
    out = torch.empty((), dtype=torch.float32, device=partials.device)
    lib = _lib()
    with torch.cuda.device(partials.device):
        status = lib.sw_sum_combine(partials.data_ptr(), partials.numel(),
                                    out.data_ptr(),
                                    _stream(partials.device))
    sum_combine_cuda.launches += 1
    _cuda.raise_on(lib, status, "sierpinski sum combine kernel")
    return out


sum_combine_cuda.launches = 0


def write_shard_cuda(m: torch.Tensor, value, p: LaunchParams,
                     view) -> torch.Tensor:
    """Launch the sharded write kernel: the steps of the rank ``view`` is
    bound to, on that rank's local state ``m`` (its slab, or the
    replicated array) in place."""
    _check_state(m)
    shard, gmap, phase = _cuda.shard_args(m, p, view)
    bits = _value_bits(m, value)
    lib = _lib("sierpinski_write_sharded")
    with torch.cuda.device(m.device):
        status = lib.sw_write_sharded(
            m.data_ptr(), m.element_size(), bits, _cuda.param_array(p),
            _cuda.ptr(p.lut), _cuda.ptr(p.tile_perm), _cuda.ptr(p.mma_ops),
            shard, gmap, phase, _stream(m.device))
    write_shard_cuda.launches += 1
    _cuda.count_mma(p)
    _cuda.raise_on(lib, status, "sharded sierpinski write kernel")
    return m


write_shard_cuda.launches = 0


def sum_partials_shard_cuda(m: torch.Tensor, p: LaunchParams,
                            view) -> torch.Tensor:
    """Launch the sharded tile-reduce kernel: the (steps,) f32 partials
    of the rank ``view`` is bound to, in its step order."""
    _check_state(m)
    shard, gmap, phase = _cuda.shard_args(m, p, view)
    partials = torch.empty(p.steps, dtype=torch.float32, device=m.device)
    lib = _lib("sierpinski_write_sharded")
    with torch.cuda.device(m.device):
        status = lib.sw_sum_partials_sharded(
            m.data_ptr(), DTYPES[m.dtype], partials.data_ptr(),
            _cuda.param_array(p), _cuda.ptr(p.lut), _cuda.ptr(p.tile_perm),
            _cuda.ptr(p.mma_ops), shard, gmap, phase, _stream(m.device))
    sum_partials_shard_cuda.launches += 1
    _cuda.count_mma(p)
    _cuda.raise_on(lib, status, "sharded sierpinski sum partials kernel")
    return partials


sum_partials_shard_cuda.launches = 0

#: kernel name -> its CUDA wrapper (each carries ``launches``); the mma
#: lowering's decode chains count the write and partials launches that
#: run them
KERNELS = {"sierpinski_write": write_cuda,
           "sierpinski_sum_partials": sum_partials_cuda,
           "sierpinski_sum_combine": sum_combine_cuda,
           "mma_decode_chains": _cuda.MMA_CHAINS}
#: the sharded kernels' wrappers (the mesh paths), counted apart
SHARDED_KERNELS = {"sierpinski_write_sharded": write_shard_cuda,
                   "sierpinski_sum_partials_sharded": sum_partials_shard_cuda}
#: the trace builds' wrappers (the access sanitizer's), counted apart
TRACE_KERNELS = {"sierpinski_write_trace": write_trace_cuda,
                 "sierpinski_sum_partials_trace": sum_partials_trace_cuda}


def reset_launch_counts() -> None:
    for fn in (*KERNELS.values(), *SHARDED_KERNELS.values(),
               *TRACE_KERNELS.values()):
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def shard_launch_counts() -> dict:
    return {name: fn.launches for name, fn in SHARDED_KERNELS.items()}


def trace_launch_counts() -> dict:
    return {name: fn.launches for name, fn in TRACE_KERNELS.items()}


# ---------------------------------------------------------------------------
# kernels against their plain versions (chip_smoke.py, the cuda tests)
# ---------------------------------------------------------------------------

def _what(plan: GridPlan, n: int, block: int, m: torch.Tensor) -> str:
    return (f"{plan.domain.name}, {plan.lowering}, {plan.storage}, "
            f"coarsen={plan.coarsen}, n={n}, block={block}, {m.dtype}")


def check_write_against_plain(m: torch.Tensor, value, plan: GridPlan, n: int,
                              block: int, p: LaunchParams) -> None:
    """Run the write kernel and its plain version on two copies of ``m``;
    raise AssertionError unless the results are bit-equal."""
    got = write_cuda(m.clone(), value, p)
    want = sierpinski_write_plain(m.clone(), value, plan, n, block)
    if not torch.equal(got, want):
        raise AssertionError(
            f"write kernel != plain version ({_what(plan, n, block, m)})")


def check_sum_against_plain(m: torch.Tensor, plan: GridPlan, n: int,
                            block: int, p: LaunchParams,
                            rtol: float | None = None):
    """Run both sum kernels and their plain versions on ``m``.

    With ``rtol=None`` the state must be integer valued and the partials
    must be bit-equal, slot by slot.  Otherwise each partial must lie
    within ``rtol`` of its tile's sum of magnitudes (the in-tile order
    differs).  The combine of the same partials is bit-equal either way.
    Raises AssertionError on a disagreement; returns ``({kernel name:
    max |kernel - plain|}, the plain version's total)``."""
    what = f"({_what(plan, n, block, m)})"
    kp = sum_partials_cuda(m, p)
    pp = sum_partials_plain(m, plan, n, block)
    diff = (kp - pp).abs()
    if rtol is None:
        ok = torch.equal(kp, pp)
    else:
        ok = bool((diff <= rtol * sum_partials_plain(m.abs(), plan, n,
                                                     block)).all())
    if not ok:
        raise AssertionError(f"sum partials kernel != plain version {what}: "
                             f"max |diff| {float(diff.max())}")
    kc = sum_combine_cuda(pp)
    pc = sum_combine_plain(pp)
    if not torch.equal(kc, pc):
        raise AssertionError(f"sum combine kernel {float(kc)} != plain "
                             f"version {float(pc)} {what}")
    return ({"sierpinski_write": 0.0,
             "sierpinski_sum_partials": float(diff.max()),
             "sierpinski_sum_combine": 0.0}, pc)


def check_shard_against_plain(m: torch.Tensor, value, view, n: int,
                              block: int) -> dict:
    """Run the sharded write and partials kernels of the rank ``view`` is
    bound to, and their plain versions, on its local state ``m`` (integer
    valued); raise AssertionError unless both are bit-equal.  Returns
    {kernel name: max |kernel - plain|}."""
    p = view.launch_params(n, block, m.device)
    what = (f"({_what(view, n, block, m)}, {view.partition} rank "
            f"{view.rank} of {view.num_shards})")
    got = write_shard_cuda(m.clone(), value, p, view)
    want = sierpinski_write_plain(m.clone(), value, view, n, block)
    if not torch.equal(got, want):
        raise AssertionError(f"sharded write kernel != plain version {what}")
    kp = sum_partials_shard_cuda(m, p, view)
    pp = sum_partials_plain(m, view, n, block)
    if not torch.equal(kp, pp):
        raise AssertionError(f"sharded partials kernel != plain version "
                             f"{what}: max |diff| "
                             f"{float((kp - pp).abs().max())}")
    return {"sierpinski_write_sharded": 0.0,
            "sierpinski_sum_partials_sharded": 0.0}


# ---------------------------------------------------------------------------
# sharded write / sum: one rank's share, and the mesh paths
# ---------------------------------------------------------------------------

def shard_plan(m: torch.Tensor, *, block: int, grid_mode: str,
               fractal: str, storage: str, n, domain, coarsen: int, mesh,
               shard_axis: str, rank: int, halo: bool = False):
    """Validate a sharded write/sum/CA of the *global* state ``m`` and
    return ``(plan bound to rank, n, block)``; ``mesh`` is a DeviceMesh
    or any object whose ``shape`` maps ``shard_axis`` to its size."""
    from repro_torch.core.shard import ShardedPlan
    _check_state(m)
    domain, n, block, storage = resolve_storage_args(
        m, block, fractal, storage, n, domain)
    plan = ShardedPlan(domain, grid_mode, storage=storage, coarsen=coarsen,
                       backend=m, mesh=mesh, axis=shard_axis, halo=halo)
    return plan.for_rank(rank).bind_block(block), n, block


def write_rank(local: torch.Tensor, value, view, n: int,
               block: int) -> torch.Tensor:
    """One rank's share of a sharded write, in place on its local state
    (its slab under compact storage, the replicated array under
    embedded): the sharded kernel on the card, the plain version on the
    CPU.  Returns ``local``."""
    if not view.target.kernels:
        return _cuda.launch("sierpinski_write", view, block, local,
                            sierpinski_write_plain, local, value, view, n,
                            block)
    p = view.launch_params(n, block, local.device)
    return _cuda.launch("sierpinski_write", view, block, local,
                        write_shard_cuda, local, value, p, view)


def sum_rank(local: torch.Tensor, view, n: int, block: int) -> torch.Tensor:
    """One rank's share of a sharded sum: its partials, then their
    in-order combine (a 0-d f32 tensor; 0 for a rank that owns
    nothing)."""
    if view.steps_per_launch == 0:
        return torch.zeros((), dtype=torch.float32, device=local.device)
    if not view.target.kernels:
        return sum_combine_plain(_cuda.launch(
            "sierpinski_sum", view, block, None, sum_partials_plain, local,
            view, n, block))
    p = view.launch_params(n, block, local.device)
    return sum_combine_cuda(_cuda.launch("sierpinski_sum", view, block,
                                         None, sum_partials_shard_cuda,
                                         local, p, view))


def mesh_plan(m, mesh, shard_axis, **kw):
    """A mesh run's :func:`shard_plan` for this process's rank: (plan
    bound to the rank, n, block, the axis's process group)."""
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.check_mesh_device(mesh, m)
    view, n, block = shard_plan(m, mesh=mesh, shard_axis=shard_axis,
                                rank=mesh_lib.axis_rank(mesh, shard_axis),
                                **kw)
    return view, n, block, mesh_lib.axis_group(mesh, shard_axis)


def _write_sharded(m: torch.Tensor, value, mesh, shard_axis: str,
                   verify: bool = False, **kw) -> torch.Tensor:
    """The mesh write of :func:`sierpinski_write_`: ``m`` in place."""
    from repro_torch.distributed import collectives
    view, n, block, group = mesh_plan(m, mesh, shard_axis, **kw)
    if verify:
        verify_launch(view, "write", m.device)
    if view.storage == "compact":
        local = view.slab(m, block).clone()
        write_rank(local, value, view, n, block)
        out = view.unpad_rows(collectives.all_gather(local, 0, group),
                              block)
    else:
        part = write_rank(m.clone(), value, view, n, block)
        owned = view.owned_cell_mask(n, block, m.device)
        member = view.member_cell_block_mask(n, block, m.device)
        out = torch.where(
            member, collectives.masked_all_reduce(part, owned, group), m)
    return m.copy_(out)


def _sum_sharded(m: torch.Tensor, mesh, shard_axis: str,
                 verify: bool = False, **kw) -> torch.Tensor:
    """The mesh sum of :func:`sierpinski_sum`."""
    from repro_torch.distributed import collectives
    view, n, block, group = mesh_plan(m, mesh, shard_axis, **kw)
    if verify:
        verify_launch(view, "sum", m.device)
    local = view.slab(m, block) if view.storage == "compact" else m
    return collectives.all_reduce_sum(sum_rank(local, view, n, block),
                                      group)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def sierpinski_write_(m: torch.Tensor, value=1.0, *, block: int = 128,
                      grid_mode: str = "compact",
                      fractal: str = "sierpinski-gasket",
                      storage: str = "embedded", n: int | None = None,
                      domain: BlockDomain | None = None,
                      coarsen: int | str = 1,
                      num_stages: int | str = "auto", mesh=None,
                      shard_axis: str = "data",
                      verify: bool = False) -> torch.Tensor:
    """Write ``value`` to every fractal cell of the (n, n) state ``m``,
    **in place**, and return ``m``.  Cells outside the fractal are not
    touched.  This is the form the paper times.

    grid_mode: closed_form (alias compact) | prefetch_lut | bounding |
    mma | auto; fractal: any registered FractalSpec name; domain: an
    explicit block domain instead (triangular, band, bounding box, or a
    fractal).  ``"auto"``, ``num_stages``, ``mesh``, ``shard_axis`` and
    ``verify`` as in the module docstring.  A CUDA ``m`` launches the
    kernel; a CPU ``m`` runs the plain version."""
    grid_mode, coarsen = _write_schedule(m, fractal, n, block, grid_mode,
                                         coarsen, num_stages, mesh,
                                         shard_axis)
    if mesh is not None:
        return _write_sharded(m, value, mesh, shard_axis, verify,
                              block=block, grid_mode=grid_mode,
                              fractal=fractal, storage=storage, n=n,
                              domain=domain, coarsen=coarsen)
    plan, n, block = prepare_launch(m, block=block, grid_mode=grid_mode,
                                    fractal=fractal, storage=storage, n=n,
                                    domain=domain, coarsen=coarsen)
    if verify:
        verify_launch(plan, "write", m.device)
    if not plan.target.kernels:
        return _cuda.launch("sierpinski_write", plan, block, m,
                            sierpinski_write_plain, m, value, plan, n, block)
    p = plan.launch_params(n, block, m.device)
    return _cuda.launch("sierpinski_write", plan, block, m, write_cuda, m,
                        value, p)


def sierpinski_write(m: torch.Tensor, value=1.0, **kw) -> torch.Tensor:
    """Functional write, as in the JAX package: a copy of ``m`` with
    ``value`` in every fractal cell (see :func:`sierpinski_write_` for
    the options and the in-place form)."""
    _check_state(m)
    return sierpinski_write_(m.clone(), value, **kw)


def sierpinski_sum(m: torch.Tensor, *, block: int = 128,
                   grid_mode: str = "compact",
                   fractal: str = "sierpinski-gasket",
                   storage: str = "embedded", n: int | None = None,
                   domain: BlockDomain | None = None,
                   coarsen: int | str = 1,
                   num_stages: int | str = "auto", mesh=None,
                   shard_axis: str = "data",
                   verify: bool = False) -> torch.Tensor:
    """f32 sum over the fractal cells of ``m``, as a 0-d tensor on its
    device: each step's tile is reduced, then the tiles are added in
    grid-step order (lambda order, or row-major over the bounding box),
    the JAX package's order.  Options (and the ``"write"`` tune entry) as
    :func:`sierpinski_write_`."""
    grid_mode, coarsen = _write_schedule(m, fractal, n, block, grid_mode,
                                         coarsen, num_stages, mesh,
                                         shard_axis)
    if mesh is not None:
        return _sum_sharded(m, mesh, shard_axis, verify, block=block,
                            grid_mode=grid_mode, fractal=fractal,
                            storage=storage, n=n, domain=domain,
                            coarsen=coarsen)
    plan, n, block = prepare_launch(m, block=block, grid_mode=grid_mode,
                                    fractal=fractal, storage=storage, n=n,
                                    domain=domain, coarsen=coarsen)
    if verify:
        verify_launch(plan, "sum", m.device)
    if not plan.target.kernels:
        return sum_combine_plain(_cuda.launch(
            "sierpinski_sum", plan, block, None, sum_partials_plain, m, plan,
            n, block))
    p = plan.launch_params(n, block, m.device)
    return sum_combine_cuda(_cuda.launch(
        "sierpinski_sum", plan, block, None, sum_partials_cuda, m, p))
