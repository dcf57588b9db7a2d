"""Cellular-automaton / diffusion stepping on an embedded fractal, as a
temporally fused block-space kernel (the application class the paper
motivates: nearest-neighbour data-parallel simulation over the
fractal).

One launch advances every (super)block by up to ``fuse`` steps: the
kernel assembles the block plus a ``fuse``-cell halo ring from the 8
neighbour supertiles (corners matter from the second step on, when the
dependency footprint grows past the von-Neumann cross), then advances the
*shrinking trapezoid* in the CTA -- after k iterations the outer k rings
of the working tile are stale, and after ``fuse`` iterations the interior
block is exact.  A launch's step count is a run-time argument, so the
final launch of a ``steps % fuse`` remainder is the same kernel.

:func:`ca_run` drives T steps as ``ceil(T / fuse)`` launches over two
rotating buffers; :func:`ca_step` is the one-step case.  Under
``storage="compact"`` both buffers live in the packed orthotope layout
and every halo gather resolves the *embedded* neighbour's packed slot
through lambda^-1 (in registers, from the 28-column LUT under
``prefetch_lut``, or by the digit-basis chains on the tensor cores under
``mma``).  Out-of-range and non-member neighbour cells are
masked at fine-block granularity, values at cell granularity -- the JAX
package's semantics, so fused and per-step runs are bit-identical.

``coarsen=s`` makes the center tile an s x s superblock (lambda decoded
once per superblock); under compact storage the supertile arrives in
packed fine-block arrangement and goes through the plan's static
``tile_map``.  Every lowering visits the member blocks only, or discards
the others at run time; the *stale* buffer (zero outside the fractal) is
written in place, so unvisited blocks stay zero.

The kernel (``repro_torch/csrc/sierpinski_ca.cu``) sits beside its plain
PyTorch version :func:`ca_launch_plain`.  The entry points follow the
state's device: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version; each launch runs through the launch hook
of :mod:`repro_torch.kernels._cuda` when one is installed.

``domain=`` runs the CA over any block domain with a device-side decode
(triangular, band, bounding box, or a fractal), with the JAX package's
tile semantics: every cell of the in-range n x n square is live, and
values pass at the granularity of the domain's member blocks.

``num_stages=k`` is the depth of the kernel's ring, the JAX package's
``stream_tiles`` schedule: persistent CTAs gather the working tile of
step i + k - 1 with ``cp.async`` while step i's trapezoid runs (k = 1
gathers, waits and computes).  Every depth gives the same bits; the plain
version ignores it.

``fuse``, ``coarsen``, ``grid_mode`` and ``num_stages`` accept
``"auto"`` (``fuse`` and ``num_stages`` by default, as in the JAX
package): a lookup of the ``"ca"`` entry of the tune cache
(:mod:`repro_torch.core.tune`, :func:`auto_schedule`) under ``{fractal,
n, block, rule}`` and the state's target, never a measurement.  An
untuned problem gets the JAX package's defaults (closed_form, fuse 1,
coarsen 1, one stage), an explicit value is never overridden, a cached
``storage`` is not applied, and a tuned depth is clamped to
``MAX_STAGES`` like any other.

``mesh=`` (a DeviceMesh, :mod:`repro_torch.launch.mesh`) shards the run
over its ``shard_axis`` (:class:`repro_torch.core.shard.ShardedPlan`);
every rank passes the global buffers and gets the global result back.
Compact storage: each rank holds only its slab of packed rows, in an
extended array ``[slab ++ ghost rows ++ dump row]``, and every launch is
a halo exchange (:class:`~repro_torch.core.shard.HaloPlan`) then a launch
over the rank's slots; with ``num_stages > 1`` and a step-indexed
lowering the rank runs its interior steps while the exchange is in
flight and its boundary steps after it.  Embedded storage: the state
stays replicated, and each launch is followed by an ownership-masked sum
over the ranks.  Every block is computed by exactly one rank from the
same operands, so the result is bit-identical to the single-device run.
:func:`ca_rank` runs one rank's launch without a process group.

``verify=True`` statically verifies the plan (the ``"ca"`` access model:
the stencil reads the state, writes the stale buffer, never reads it)
against the tables its launches will read, before the first launch; a
failing plan raises ``PlanVerificationError`` (a ``ValueError``) with
nothing launched.  Under ``mesh=`` each rank verifies its sharded plan.

Not ported yet: CA states other than f32 (the JAX package's CA follows
the state's dtype; the port's runs f32 only for now, and bf16 states are
ROADMAP A16).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.compact import NEIGHBOR_OFFSETS8
from repro_torch.core.domain import BlockDomain
from repro_torch.core.plan import GridPlan, LaunchParams

from . import _cuda
from .sierpinski_write import (PLAIN_CHUNK_CELLS, mesh_plan, record_trace,
                               resolve_auto_schedule, resolve_storage_args,
                               storage_offsets, supertile_offsets,
                               verify_launch)

RULES = {"parity": 0, "diffusion": 1}
#: the deepest ring of the kernel (csrc/sierpinski_ca.cu kMaxStages); the
#: JAX package's gpu target clamps num_stages to the same 4
MAX_STAGES = 4


def effective_fuse(fuse: int, steps: int, block: int,
                   coarsen: int = 1) -> int:
    """The fuse depth :func:`ca_run` actually executes: clamped so the
    halo ring fits one neighbour supertile (``coarsen * block``) and
    never exceeds the step count."""
    return max(1, min(int(fuse), coarsen * block,
                      steps if steps else 1))


def launch_schedule(steps: int, fuse: int) -> list:
    """Per-launch step counts for T steps at fuse depth k:
    ``ceil(T/k)`` launches of k steps, the last carrying the
    remainder."""
    steps, fuse = int(steps), int(fuse)
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if fuse < 1:
        raise ValueError(f"fuse must be >= 1, got {fuse}")
    full, rem = divmod(steps, fuse)
    return [fuse] * full + ([rem] if rem else [])


# ---------------------------------------------------------------------------
# plain version: the trapezoid over chunks of grid steps, as tensor ops
# ---------------------------------------------------------------------------

def _floor_mod2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mod(x, 2)`` on floats: fmod, then + 2 where the sign
    differs from the divisor's."""
    r = torch.fmod(x, 2.0)
    return torch.where((r != 0) & (r < 0), r + 2.0, r)


def _nsum(a: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 neighbours of every cell of a batch of working
    tiles (zero past the tile's edge), in the order up + down + left +
    right."""
    zrow = torch.zeros_like(a[:, :1, :])
    zcol = torch.zeros_like(a[:, :, :1])
    up = torch.cat([zrow, a[:, :-1, :]], 1)
    down = torch.cat([a[:, 1:, :], zrow], 1)
    left = torch.cat([zcol, a[:, :, :-1]], 2)
    right = torch.cat([a[:, :, 1:], zcol], 2)
    return up + down + left + right


def record_ca_trace(trace: torch.Tensor, plan: GridPlan, start: int, bx,
                    by, valid, tiles) -> None:
    """Fill the trace rows of a chunk of CA steps from the supertiles
    its gather addresses, ``tiles`` = ((dx, dy, row, col), ...) with the
    centre first, as the kernel's trace build fills them: a live step's
    block, the centre as its store, and per origin slot the supertile
    read, -1 for a neighbour out of range or not a member."""
    dom = plan.sched_domain
    nbx, nby = dom.bounding_box
    loads = []
    for dx, dy, row, col in tiles:
        x, y = bx + dx, by + dy
        ok = (x >= 0) & (x < nbx) & (y >= 0) & (y < nby) & torch.as_tensor(
            dom.contains(torch.clamp(x, 0, nbx - 1),
                         torch.clamp(y, 0, nby - 1)), device=bx.device)
        loads.append(((dy + 1) * 3 + dx + 1, row, col, ok))
    record_trace(trace, start, bx, by, valid, store=tiles[0][2:],
                 loads=loads, live_only=True)


def _ca_tiles(plan: GridPlan, start: int, stop: int, device):
    """((dx, dy, row, col), ...): the centre's storage supertile, then the
    8 neighbours' (NEIGHBOR_OFFSETS8 order) of the steps [start, stop)."""
    out = [(0, 0) + tuple(plan.storage_index(start, stop, device))]
    for j, (dx, dy) in enumerate(NEIGHBOR_OFFSETS8):
        out.append((dx, dy) + tuple(plan.neighbor_index(j, start, stop,
                                                        device)))
    return out


def ca_trace_plain(plan: GridPlan, device) -> torch.Tensor:
    """The trace rows a launch of ``plan`` fills (:func:`record_ca_trace`,
    the plain version's index tensors), without its arithmetic: what the
    kernel's trace build must write for the same plan."""
    trace = _cuda.trace_rows(plan.steps_per_launch, device)
    per = 1 << 20   # index tensors only: no working tiles to bound
    for start in range(0, plan.steps_per_launch, per):
        stop = min(plan.steps_per_launch, start + per)
        bx, by, valid = plan.step_coords(start, stop, device)
        record_ca_trace(trace, plan, start, bx, by, valid,
                        _ca_tiles(plan, start, stop, device))
    return trace


def ca_launch_plain(src: torch.Tensor, dst: torch.Tensor, plan: GridPlan,
                    n: int, block: int, halo: int, steps: int, rule: str,
                    alpha: float, trace=None) -> torch.Tensor:
    """Plain version of one fused launch: for every scheduled
    (super)block gather the center + 8 neighbour supertiles into the
    (span + 2h)^2 working tile, mask it, advance ``steps`` iterations of
    the trapezoid, and scatter the span^2 interior into ``dst`` in
    place (the stale buffer); fills ``trace`` rows when given.  Returns
    ``dst``."""
    dev = src.device
    span = plan.coarsen * block
    h = halo
    wid = span + 2 * h
    th, tw = plan.supertile_shape((block, block))
    oy, ox = supertile_offsets(plan, block, dev)
    al = torch.tensor(alpha, dtype=src.dtype)
    # strip geometry: which rows/cols of a neighbour's embedded view land
    # where in the working tile (relative offset -1/0/+1)
    spans = {-1: (span - h, 0, h), 0: (0, h, span), 1: (0, span + h, h)}
    iy = torch.arange(wid, dtype=torch.int64, device=dev)[:, None]
    ix = torch.arange(wid, dtype=torch.int64, device=dev)[None, :]
    flat_src, flat_dst = src.view(-1), dst.view(-1)
    total = plan.steps_per_launch
    per = max(1, PLAIN_CHUNK_CELLS // (9 * th * tw + 3 * wid * wid))
    for start in range(0, total, per):
        stop = min(total, start + per)
        bx, by, valid = plan.step_coords(start, stop, dev)
        T = stop - start
        P = torch.zeros((T, wid, wid), dtype=src.dtype, device=dev)
        tiles = _ca_tiles(plan, start, stop, dev)
        if trace is not None:
            record_ca_trace(trace, plan, start, bx, by, valid, tiles)
        for dx, dy, row, col in tiles:
            tile = flat_src[storage_offsets(plan, row, col, block, dev)]
            e = torch.zeros((T, span, span), dtype=src.dtype, device=dev)
            e[:, oy, ox] = tile  # packed -> embedded arrangement
            r_src, r_dst, nr = spans[dy]
            c_src, c_dst, nc = spans[dx]
            P[:, r_dst:r_dst + nr, c_dst:c_dst + nc] = \
                e[:, r_src:r_src + nr, c_src:c_src + nc]
        gx = bx[:, None, None] * span - h + ix
        gy = by[:, None, None] * span - h + iy
        inr = (gx >= 0) & (gx < n) & (gy >= 0) & (gy < n)
        gxc = torch.clamp(gx, 0, n - 1)
        gyc = torch.clamp(gy, 0, n - 1)
        cell_ok = inr & plan.domain.cell_member(gxc, gyc, n)
        block_ok = inr & plan.domain.contains(gxc // block, gyc // block)
        P = torch.where(block_ok, P, 0)
        if rule == "parity":
            for _ in range(steps):
                P = torch.where(cell_ok, _floor_mod2(P + _nsum(P)), 0)
        else:
            deg = _nsum(cell_ok.to(P.dtype))
            for _ in range(steps):
                P = torch.where(cell_ok, P + al * (_nsum(P) - deg * P), 0)
        out = P[:, h:h + span, h:h + span][:, oy, ox]  # storage arrangement
        row, col = plan.storage_index(start, stop, dev)
        offs = storage_offsets(plan, row, col, block, dev)
        if valid is not None:
            offs, out = offs[valid], out[valid]
        flat_dst[offs.reshape(-1)] = out.reshape(-1)
    return dst


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


#: library -> its C entry points' (argument types, result type)
_SIGNATURES = {
    "sierpinski_ca": {
        "sc_ca_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I,
                          ctypes.c_float, _I, _P, _P], ctypes.c_int),
        "sc_scratch_bytes": ([_P, _I, _I], _LL),
        "sc_ring_depth": ([_P, _I, _I], ctypes.c_int),
        "sc_grid_ctas": ([_P, _I, _I], _LL)},
    "sierpinski_ca_sharded": {
        "sc_ca_launch_sharded": ([_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  ctypes.c_float, _I] + [_P] * 5,
                                 ctypes.c_int),
        "sc_scratch_bytes": ([_P, _I, _I], _LL)},
    "sierpinski_ca_trace": {
        "sc_ca_launch_trace": ([_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                ctypes.c_float, _I, _P, _P, _P],
                               ctypes.c_int),
        "sc_scratch_bytes": ([_P, _I, _I], _LL)},
}


def _lib(name: str = "sierpinski_ca") -> ctypes.CDLL:
    """The loaded library ``name`` (or its sharded half,
    ``"sierpinski_ca_sharded"``, or its trace build,
    ``"sierpinski_ca_trace"``), its entry points typed."""
    lib = _cuda.load(name)
    if not getattr(lib, "_repro_bound", False):
        for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check_buffers(src: torch.Tensor, dst: torch.Tensor,
                   shape=None) -> None:
    """Both CA buffers: contiguous f32 tensors of one shape on one
    device, and not the same memory."""
    for t in (src, dst):
        if t.dtype != torch.float32:
            raise TypeError(
                f"CA states must be float32, got {t.dtype}: the port's CA "
                f"runs f32 only for now (bf16 states are ROADMAP A16)")
        if not t.is_contiguous():
            raise ValueError("CA buffers must be contiguous")
    if src.shape != dst.shape or src.device != dst.device:
        raise ValueError(
            f"state {tuple(src.shape)} on {src.device} and stale buffer "
            f"{tuple(dst.shape)} on {dst.device} must match")
    if shape is not None and tuple(src.shape) != tuple(shape):
        raise ValueError(f"state shape {tuple(src.shape)} != {tuple(shape)}")
    if src.data_ptr() == dst.data_ptr():
        raise ValueError("the state and the stale buffer must be distinct")


def _launch(lib, entry: str, src: torch.Tensor, dst: torch.Tensor,
            p: LaunchParams, halo: int, steps: int, rule: str, alpha: float,
            num_stages: int, shard=()) -> int:
    """Check a launch's geometry and run the C entry point ``entry`` of
    ``lib`` (``shard``: the sharded entry's extra arguments); returns its
    status."""
    if not 1 <= steps <= halo <= p.span:
        raise ValueError(
            f"a launch takes 1 <= steps <= halo <= coarsen * block, got "
            f"steps={steps}, halo={halo}, span={p.span}")
    if not 1 <= num_stages <= MAX_STAGES:
        raise ValueError(f"the kernel's ring takes 1 to {MAX_STAGES} "
                         f"slots, got num_stages={num_stages}")
    params = _cuda.param_array(p)
    with torch.cuda.device(src.device):
        nbytes = lib.sc_scratch_bytes(params, halo, num_stages)
        scratch = (torch.empty(nbytes, dtype=torch.uint8, device=src.device)
                   if nbytes else None)
        return getattr(lib, entry)(
            src.data_ptr(), dst.data_ptr(), params,
            _cuda.ptr(p.lut), _cuda.ptr(p.tile_perm), _cuda.ptr(p.mma_ops),
            halo, steps, RULES[rule], alpha, num_stages, _cuda.ptr(scratch),
            *shard, torch.cuda.current_stream(src.device).cuda_stream)


def _check_cuda(src: torch.Tensor, dst: torch.Tensor,
                p: LaunchParams) -> None:
    if src.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel needs a CUDA tensor, got one on {src.device}")
    _check_buffers(src, dst, (p.rows, p.pitch))


def ca_cuda(src: torch.Tensor, dst: torch.Tensor, p: LaunchParams,
            halo: int, steps: int, rule: str, alpha: float,
            num_stages: int = 1, trace=None) -> torch.Tensor:
    """Launch the fused CA kernel once: read ``src``, write the advanced
    member supertiles into ``dst`` in place, gathering the working tiles
    through a ring of ``num_stages`` slots (1 to ``MAX_STAGES``); with
    ``trace`` rows, its trace build (:func:`ca_trace_cuda`).  Returns
    ``dst``."""
    if trace is not None:
        return ca_trace_cuda(src, dst, p, halo, steps, rule, alpha,
                             num_stages, trace)
    _check_cuda(src, dst, p)
    _cuda.check_tables(src, p)
    lib = _lib()
    status = _launch(lib, "sc_ca_launch", src, dst, p, halo, steps, rule,
                     alpha, num_stages)
    ca_cuda.launches += 1
    _cuda.count_mma(p)
    _cuda.raise_on(lib, status, "fused CA kernel")
    return dst


ca_cuda.launches = 0


def ca_trace_cuda(src: torch.Tensor, dst: torch.Tensor, p: LaunchParams,
                  halo: int, steps: int, rule: str, alpha: float,
                  num_stages: int, trace: torch.Tensor) -> torch.Tensor:
    """Launch the fused CA kernel's trace build once: the launch of
    :func:`ca_cuda`, bit for bit, which also fills the ``trace`` row of
    every step it computes (:data:`_cuda.TRACE_COLUMNS`).  Returns
    ``dst``."""
    _check_cuda(src, dst, p)
    _cuda.check_tables(src, p)
    _cuda.check_trace(src, p.steps, trace)
    lib = _lib("sierpinski_ca_trace")
    status = _launch(lib, "sc_ca_launch_trace", src, dst, p, halo, steps,
                     rule, alpha, num_stages, (trace.data_ptr(),))
    ca_trace_cuda.launches += 1
    _cuda.raise_on(lib, status, "fused CA trace kernel")
    return dst


ca_trace_cuda.launches = 0


def ca_shard_cuda(src: torch.Tensor, dst: torch.Tensor, p: LaunchParams,
                  view, halo: int, steps: int, rule: str, alpha: float,
                  num_stages: int = 1) -> torch.Tensor:
    """Launch the sharded CA kernel once for the rank ``view`` is bound
    to (its phase's steps on a phase view): ``src`` and ``dst`` are the
    rank's local buffers -- the replicated arrays (embedded), or the
    extended arrays ``[slab ++ ghosts ++ dump]`` whose slab rows ``dst``
    receives (compact).  Returns ``dst``."""
    _check_cuda(src, dst, p)
    shard = _cuda.shard_args(src, p, view)
    lib = _lib("sierpinski_ca_sharded")
    status = _launch(lib, "sc_ca_launch_sharded", src, dst, p, halo, steps,
                     rule, alpha, num_stages, shard)
    ca_shard_cuda.launches += 1
    _cuda.count_mma(p)
    _cuda.raise_on(lib, status, "sharded fused CA kernel")
    return dst


ca_shard_cuda.launches = 0


def ring_geometry(p: LaunchParams, halo: int, num_stages: int):
    """(ring slots, persistent CTAs) of a launch of :func:`ca_cuda`: the
    slots are ``num_stages``, or fewer where that many working tiles do
    not fit one CTA's shared memory (the same result), 0 on the
    global-scratch path (depth 1); the CTAs as many as reside on the
    card, at most one a step."""
    params = _cuda.param_array(p)
    lib = _lib()
    return (lib.sc_ring_depth(params, halo, num_stages),
            lib.sc_grid_ctas(params, halo, num_stages))


#: kernel name -> its CUDA wrapper (each carries ``launches``); the mma
#: lowering's decode chains count the launches that run them
KERNELS = {"sierpinski_ca_fused": ca_cuda,
           "mma_decode_chains": _cuda.MMA_CHAINS}
#: the sharded kernel's wrapper (the mesh path), counted apart
SHARDED_KERNELS = {"sierpinski_ca_fused_sharded": ca_shard_cuda}
#: the trace build's wrapper (the access sanitizer's), counted apart
TRACE_KERNELS = {"sierpinski_ca_fused_trace": ca_trace_cuda}


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


def check_ca_against_plain(src: torch.Tensor, dst: torch.Tensor,
                           plan: GridPlan, n: int, block: int, halo: int,
                           steps: int, rule: str, alpha: float,
                           num_stages: int = 1) -> None:
    """Run one kernel launch (a ring of ``num_stages`` slots) and its
    plain version on copies of the same buffers; raise AssertionError
    unless the results are bit-equal."""
    p = plan.launch_params(n, block, src.device)
    got = ca_cuda(src, dst.clone(), p, halo, steps, rule, alpha, num_stages)
    want = ca_launch_plain(src, dst.clone(), plan, n, block, halo, steps,
                           rule, alpha)
    if not torch.equal(got, want):
        diff = (got - want).abs().max()
        raise AssertionError(
            f"CA kernel != plain version ({plan.domain.name}, "
            f"{plan.lowering}, {plan.storage}, "
            f"coarsen={plan.coarsen}, n={n}, block={block}, halo={halo}, "
            f"steps={steps}, {rule}, num_stages={num_stages}): max |diff| "
            f"{float(diff)}")


def check_ca_shard_against_plain(src: torch.Tensor, dst: torch.Tensor,
                                 view, n: int, block: int, halo: int,
                                 steps: int, rule: str, alpha: float,
                                 num_stages: int = 1) -> None:
    """Run the sharded kernel of the rank ``view`` is bound to and its
    plain version on copies of the same local buffers; raise
    AssertionError unless the results are bit-equal."""
    p = view.launch_params(n, block, src.device)
    got = ca_shard_cuda(src, dst.clone(), p, view, halo, steps, rule, alpha,
                        num_stages)
    want = ca_launch_plain(src, dst.clone(), view, n, block, halo, steps,
                           rule, alpha)
    if not torch.equal(got, want):
        diff = (got - want).abs().max()
        raise AssertionError(
            f"sharded CA kernel != plain version ({view.domain.name}, "
            f"{view.lowering}, {view.storage}, coarsen={view.coarsen}, "
            f"{view.partition} rank {view.rank} of {view.num_shards}, "
            f"phase {view.phase}, n={n}, block={block}, halo={halo}, "
            f"steps={steps}, {rule}, num_stages={num_stages}): max |diff| "
            f"{float(diff)}")


# ---------------------------------------------------------------------------
# the sharded run: one rank's launch, and the mesh run
# ---------------------------------------------------------------------------

def ca_rank(src: torch.Tensor, dst: torch.Tensor, view, n: int, block: int,
            halo: int, steps: int, rule: str, alpha: float,
            num_stages: int = 1) -> torch.Tensor:
    """One rank's fused launch (its phase's steps on a phase view) on its
    local buffers, into ``dst`` in place: the sharded kernel on the
    card, the plain version on the CPU.  Returns ``dst``."""
    if not view.target.kernels:
        return _cuda.launch("sierpinski_ca", view, block, dst,
                            ca_launch_plain, src, dst, view, n, block, halo,
                            steps, rule, alpha)
    p = view.launch_params(n, block, src.device)
    return _cuda.launch("sierpinski_ca", view, block, dst, ca_shard_cuda,
                        src, dst, p, view, halo, steps, rule, alpha,
                        num_stages)


def ca_run_rank_compact(a: torch.Tensor, b: torch.Tensor, view, n: int,
                        block: int, sched, fuse: int, rule: str,
                        alpha: float, stages: int,
                        group=None) -> torch.Tensor:
    """Advance one rank's extended buffers ``a`` (state) and ``b``
    (stale) through the launches ``sched``: each an exchange of ghost
    rows, then the launch; with ``stages > 1`` and a step-indexed
    lowering the interior steps run while the exchange is in flight.
    Returns the buffer holding the final state."""
    halo, rank = view.halo, view.rank
    rows = view.rpd * view.row_unit
    phases = None
    if stages > 1 and view.lowering != "bounding" \
            and view.phase_tables_host() is not None:
        phases = (view.phase_view("interior"), view.phase_view("boundary"))
    for k in sched:
        if phases is None:
            halo.exchange(view, a[:rows], rank, fuse, group, out=a[rows:])
        else:
            x, y = a, b
            halo.exchange(view, x[:rows], rank, fuse, group, out=x[rows:],
                          between=lambda: ca_rank(x, y, phases[0], n, block,
                                                  fuse, k, rule, alpha,
                                                  stages))
        ca_rank(a, b, view if phases is None else phases[1], n, block, fuse,
                k, rule, alpha, stages)
        a, b = b, a
    return a


def _ca_run_sharded(state, stale_buf, steps, *, fuse, rule, alpha, block,
                    grid_mode, fractal, storage, n, domain, coarsen,
                    stages, mesh, shard_axis, verify=False):
    """The mesh run of :func:`ca_run` (bit-identical to the
    single-device run)."""
    from repro_torch.distributed import collectives
    _check_buffers(state, stale_buf)
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}; expected one of "
                         f"{tuple(RULES)}")
    view, n, block, group = mesh_plan(
        state, mesh, shard_axis, block=block, grid_mode=grid_mode,
        fractal=fractal, storage=storage, n=n, domain=domain,
        coarsen=coarsen, halo=storage == "compact")
    if verify:
        verify_launch(view, "ca", state.device)
    fuse = effective_fuse(fuse, steps, block, view.coarsen)
    sched = launch_schedule(steps, fuse)
    if not sched:
        return state
    if view.storage == "compact":
        rows = view.rpd * view.row_unit
        a = state.new_zeros(view.extended_shape(block))
        b = torch.zeros_like(a)
        a[:rows] = view.slab(state, block)
        b[:rows] = view.slab(stale_buf, block)
        a = ca_run_rank_compact(a, b, view, n, block, sched, fuse, rule,
                                alpha, stages, group)
        return view.unpad_rows(collectives.all_gather(a[:rows], 0, group),
                               block)
    owned = view.owned_cell_mask(n, block, state.device)
    a, b = state.clone(), stale_buf.clone()
    for k in sched:
        b = collectives.masked_all_reduce(
            ca_rank(a, b, view, n, block, fuse, k, rule, alpha, stages),
            owned, group)
        a, b = b, a
    return a


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def auto_schedule(*, fractal: str = "sierpinski-gasket", n: int,
                  block: int, rule: str = "parity",
                  grid_mode: str = "auto", fuse: int | str = "auto",
                  coarsen: int | str = "auto",
                  num_stages: int | str = "auto", mesh=None,
                  shard_axis: str = "data", device=None):
    """Resolve the (grid_mode, fuse, coarsen, num_stages) schedule for a
    CA problem from the tune cache -- the exact lookup :func:`ca_run` /
    :func:`ca_step` perform for tensors on ``device`` (the card unless
    the caller names another), exposed so callers can report the
    schedule they are about to run without re-deriving the cache key."""
    from repro_torch.core import tune
    return resolve_auto_schedule(
        "ca", tune.shard_params({"fractal": fractal, "n": n,
                                 "block": block, "rule": rule},
                                mesh, shard_axis),
        device=device,
        grid_mode=(grid_mode, "lowering", "closed_form"),
        fuse=(fuse, "fuse", 1),
        coarsen=(coarsen, "coarsen", 1),
        num_stages=(num_stages, "stages", 1))


def _check_stages(num_stages) -> int:
    """The ring depth: ``num_stages`` (an integer >= 1) clamped to
    ``MAX_STAGES``, as the JAX package's gpu target clamps deeper
    requests."""
    if isinstance(num_stages, bool) or not isinstance(num_stages, int) \
            or num_stages < 1:
        raise ValueError(f"num_stages must be an integer >= 1, got "
                         f"{num_stages!r}")
    return min(num_stages, MAX_STAGES)


def prepare_run(state: torch.Tensor, stale_buf: torch.Tensor, *,
                block: int = 128, grid_mode: str = "compact",
                fractal: str = "sierpinski-gasket",
                storage: str = "embedded", n: int | None = None,
                domain: BlockDomain | None = None, coarsen: int = 1):
    """Validate the buffers and the options of a CA run; returns
    ``(plan, n, block)`` for the kernel wrapper and the plain version."""
    _check_buffers(state, stale_buf)
    domain, n, block, storage = resolve_storage_args(state, block, fractal,
                                                     storage, n, domain)
    plan = GridPlan(domain, grid_mode, storage=storage, coarsen=coarsen,
                    backend=state)
    return plan, n, block


def check_run(state: torch.Tensor, stale_buf: torch.Tensor, *,
              rule: str = "parity", block: int = 128,
              grid_mode: str = "compact",
              fractal: str = "sierpinski-gasket", storage: str = "embedded",
              n: int | None = None, domain: BlockDomain | None = None,
              coarsen: int = 1, num_stages: int = 1):
    """Every refusal a :func:`ca_run` of this explicit schedule raises
    before its first launch (the options, the buffers, the plan and, on
    the card, its launch parameters), without running a step.  Returns
    ``(plan, n, block, ring depth, launch params or None)``."""
    stages = _check_stages(num_stages)
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}; expected one of "
                         f"{tuple(RULES)}")
    plan, n, block = prepare_run(state, stale_buf, block=block,
                                 grid_mode=grid_mode, fractal=fractal,
                                 storage=storage, n=n, domain=domain,
                                 coarsen=coarsen)
    p = plan.launch_params(n, block, state.device) \
        if plan.target.kernels else None
    return plan, n, block, stages, p


def ca_run(state: torch.Tensor, stale_buf: torch.Tensor, steps: int, *,
           fuse: int | str = "auto", rule: str = "parity",
           alpha: float = 0.25, block: int = 128,
           grid_mode: str = "compact",
           fractal: str = "sierpinski-gasket", storage: str = "embedded",
           n: int | None = None, domain: BlockDomain | None = None,
           coarsen: int | str = 1, num_stages: int | str = "auto",
           donate: bool | None = None, mesh=None, shard_axis: str = "data",
           verify: bool = False) -> torch.Tensor:
    """Advance the CA ``steps`` steps and return the final state.

    ``fuse=k`` executes k steps per kernel launch (one in-CTA trapezoid
    loop), so the whole run costs ceil(steps/k) launches -- bit-identical
    to ``steps`` sequential :func:`ca_step` calls.  ``fuse`` is clamped
    to ``coarsen * block`` and to ``steps`` (:func:`effective_fuse`).

    ``stale_buf`` must be zero outside the fractal (the double-buffer
    invariant).  With ``donate`` (the default on the card) both buffers
    are advanced in place and the result is one of them; with
    ``donate=False`` (the default on the CPU) they are cloned first and
    left untouched.  Under ``storage="compact"`` both tensors are packed
    orthotope-resident (pass ``n=`` or ``domain=``).  ``grid_mode`` is
    closed_form (alias compact), prefetch_lut, bounding or mma.

    ``num_stages`` (an integer >= 1, clamped to ``MAX_STAGES`` as the
    JAX package's gpu target clamps it) is the depth of the kernel's
    ``cp.async`` ring of working tiles; every depth is bit-identical.

    ``fuse`` / ``grid_mode`` / ``coarsen`` / ``num_stages`` set to
    ``"auto"`` resolve from the tune cache (:func:`auto_schedule`;
    untuned: fuse 1, closed_form, coarsen 1, one stage; under a mesh the
    key names the shard count).  ``mesh=`` shards the run (module
    docstring); ``donate`` does not apply there: the result is always a
    new tensor and both buffers are left as they were.  ``verify=True``
    statically verifies the plan before the first launch (module
    docstring)."""
    grid_mode, fuse, coarsen, num_stages = auto_schedule(
        fractal=fractal, n=n or state.shape[0], block=block, rule=rule,
        grid_mode=grid_mode, fuse=fuse, coarsen=coarsen,
        num_stages=num_stages, mesh=mesh, shard_axis=shard_axis,
        device=state.device)
    if mesh is not None:
        return _ca_run_sharded(
            state, stale_buf, steps, fuse=fuse, rule=rule, alpha=alpha,
            block=block, grid_mode=grid_mode, fractal=fractal,
            storage=storage, n=n, domain=domain, coarsen=coarsen,
            stages=_check_stages(num_stages), mesh=mesh,
            shard_axis=shard_axis, verify=verify)
    plan, n, block, stages, p = check_run(
        state, stale_buf, rule=rule, block=block, grid_mode=grid_mode,
        fractal=fractal, storage=storage, n=n, domain=domain,
        coarsen=coarsen, num_stages=num_stages)
    if verify:
        verify_launch(plan, "ca", state.device)
    fuse = effective_fuse(fuse, steps, block, plan.coarsen)
    sched = launch_schedule(steps, fuse)
    if not sched:
        return state
    if donate is None:
        donate = plan.target.kernels
    a, b = (state, stale_buf) if donate else (state.clone(),
                                              stale_buf.clone())
    for k in sched:
        if p is not None:
            _cuda.launch("sierpinski_ca", plan, block, b, ca_cuda, a, b, p,
                         fuse, k, rule, alpha, stages)
        else:
            _cuda.launch("sierpinski_ca", plan, block, b, ca_launch_plain, a,
                         b, plan, n, block, fuse, k, rule, alpha)
        a, b = b, a
    return a


def ca_step(state: torch.Tensor, stale_buf: torch.Tensor, *,
            rule: str = "parity", alpha: float = 0.25, block: int = 128,
            grid_mode: str = "compact", fractal: str = "sierpinski-gasket",
            storage: str = "embedded", n: int | None = None,
            domain: BlockDomain | None = None, coarsen: int | str = 1,
            num_stages: int | str = "auto", mesh=None,
            shard_axis: str = "data",
            verify: bool = False) -> torch.Tensor:
    """One CA step (the ``steps=1`` case of :func:`ca_run`), functional
    as in the JAX package: neither argument is modified.

    ``stale_buf`` must be zero outside the fractal (e.g. the state from
    two steps ago, or zeros); blocks a compact grid never visits keep
    its contents."""
    return ca_run(state, stale_buf, 1, fuse=1, rule=rule, alpha=alpha,
                  block=block, grid_mode=grid_mode, fractal=fractal,
                  storage=storage, n=n, domain=domain, coarsen=coarsen,
                  num_stages=num_stages, donate=False, mesh=mesh,
                  shard_axis=shard_axis, verify=verify)
