"""Build and load the port's CUDA kernels.

Each source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries
are built at first use into ``build/repro_torch/`` at the root of the
checkout (or ``$REPRO_TORCH_BUILD_DIR``), named by a hash of the
sources and flags, so an edited source is rebuilt and a stale library
is never loaded.  Nothing is built or imported at module import: the
CPU tests import every module on machines without ``nvcc``.

The module also holds the launch hook (:func:`set_launch_hook`), the
counterpart of the JAX package's emit hook: the fault injector of
:mod:`repro_torch.runtime.chaos` and the access sanitizer of
:mod:`repro_torch.analysis.sanitizer` see every launch of the write, sum
and CA entry points through it, on the card and on the CPU alike.  A
hook that sets a launch's ``trace`` rows (:func:`trace_rows`,
:data:`TRACE_COLUMNS`) gets them filled by the kernel's trace build on
the card, or by the plain version on the CPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import torch

from repro_torch.core.plan import C_PARAMS, LOWERING_CODES

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: library name -> (its one .cu source, extra nvcc flags) (headers: every
#: .cuh in csrc/).  Each source builds twice: its unsharded entry points,
#: and with ``-DREPRO_SHARDED`` only its sharded ones (the kShard
#: instantiations of core/shard.py's mesh), so that the two halves
#: compile in parallel and the unsharded library holds what it held
#: before the mesh came.  The write and CA sources build a third time,
#: with ``-DREPRO_TRACE``: only their trace entry points (the kTrace
#: instantiations the access sanitizer launches).
SHARDED_FLAGS = ("-DREPRO_SHARDED",)
TRACE_FLAGS = ("-DREPRO_TRACE",)
SOURCES = {"sierpinski_write": ("sierpinski_write.cu", ()),
           "sierpinski_ca": ("sierpinski_ca.cu", ()),
           "flash_attention": ("flash_attention.cu", ()),
           "sierpinski_write_sharded": ("sierpinski_write.cu",
                                        SHARDED_FLAGS),
           "sierpinski_ca_sharded": ("sierpinski_ca.cu", SHARDED_FLAGS),
           "flash_attention_sharded": ("flash_attention.cu",
                                       SHARDED_FLAGS),
           "sierpinski_write_trace": ("sierpinski_write.cu", TRACE_FLAGS),
           "sierpinski_ca_trace": ("sierpinski_ca.cu", TRACE_FLAGS)}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
#: per library: nvcc's output of the build this process ran (the ptxas
#: register / shared-memory report)
BUILD_LOG: Dict[str, str] = {}
#: per library: wall seconds from the start of the (parallel) build until
#: its nvcc finished
BUILD_SECONDS: Dict[str, float] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_cuda.py -> the checkout root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or nvcc on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from source at first use")
    return found


def library_path(name: str) -> Path:
    source, flags = SOURCES[name]
    h = hashlib.sha256()
    for path in [CSRC / source] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + flags).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every named library that is not built yet, one ``nvcc``
    per library, all started together.  Returns name -> library path;
    raises with the compiler's output when a build fails."""
    out = {name: library_path(name) for name in names}
    todo = {name: path for name, path in out.items() if not path.is_file()}
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        source, flags = SOURCES[name]
        cmd = [compiler, *NVCC_FLAGS, *flags, "-o", str(tmp),
               str(CSRC / source)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])  # atomic: readers see all or nothing
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib


def param_array(p) -> ctypes.Array:
    """A plan's :class:`~repro_torch.core.plan.LaunchParams` as the int64
    array the kernels read (``C_PARAMS`` order), after checking what the
    kernels' decode takes."""
    if p.k > 16 or p.m > 8 or p.n >= 2 ** 31 or p.pitch >= 2 ** 31:
        raise ValueError(
            f"the kernels take k <= 16 copies, m <= 8 and sides < 2**31, "
            f"got k={p.k}, m={p.m}, n={p.n}, pitch={p.pitch}")
    if p.lowering == LOWERING_CODES["closed_form"] and p.steps >= 2 ** 32:
        raise ValueError(
            f"closed_form decodes 32-bit step ids, got {p.steps} steps")
    vals = [v - (1 << 64) if v >= 1 << 63 else v for v in p.c_params()]
    return (ctypes.c_longlong * len(C_PARAMS))(*vals)


class LaunchCounter:
    """A launch count kept beside the wrappers' own ``launches``."""

    def __init__(self):
        self.launches = 0


#: launches of the fractal kernels (write, sum partials, CA) under the mma
#: lowering: each runs the tensor-core decode chains of
#: ``csrc/mma_decode.cuh`` in its prologue
MMA_CHAINS = LaunchCounter()


def count_mma(p) -> None:
    """Count a launch of ``p``'s kernel toward :data:`MMA_CHAINS` when it
    runs the mma lowering (call where the wrapper counts its own)."""
    if p.lowering == LOWERING_CODES["mma"]:
        MMA_CHAINS.launches += 1


def ptr(t):
    """A tensor's device address for ctypes, or None (a null pointer)."""
    return None if t is None else t.data_ptr()


def raise_on(lib, status: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if status != 0:
        msg = lib.cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def check_tables(m, p, lut_rows: Optional[int] = None) -> None:
    """The decode tables and the mma operands of ``p`` must lie on the
    state's device, as contiguous int32 tensors of the expected size:
    one LUT row a step, or at least ``lut_rows`` rows (a rank's LUT
    chunk, which a sharded launch reads through its own step ids)."""
    for name, t in (("decode table", p.lut), ("tile permutation",
                                              p.tile_perm),
                    ("mma operand", p.mma_ops)):
        if t is None:
            continue
        if t.device != m.device:
            raise ValueError(
                f"state on {m.device} but the {name} on {t.device}: "
                f"both must lie on the same device")
    rows = None if p.lut is None else p.lut.shape[0]
    if p.lut is not None and (p.lut.dtype != torch.int32
                              or not p.lut.is_contiguous()
                              or (rows != p.steps if lut_rows is None
                                  else rows < lut_rows)):
        raise ValueError("the decode table must be a contiguous "
                         f"({p.steps}, {p.lut_cols}) int32 tensor")
    if p.mma_ops is not None and (p.mma_ops.dtype != torch.int32
                                  or not p.mma_ops.is_contiguous()):
        raise ValueError("the mma operands must be a contiguous int32 "
                         "tensor")
    if (p.lowering == LOWERING_CODES["mma"]) != (p.mma_ops is not None):
        raise ValueError("the mma lowering needs its operands, and only "
                         "it takes them")
    want = 2 * p.nfine + p.coarsen ** 2
    if p.tile_perm is not None and (p.tile_perm.dtype != torch.int32
                                    or not p.tile_perm.is_contiguous()
                                    or p.tile_perm.numel() != want):
        raise ValueError("the tile permutation must be a contiguous "
                         f"int32 tensor of {want} entries")


# ---------------------------------------------------------------------------
# the launch hook
# ---------------------------------------------------------------------------

#: the columns of a launch's access-trace rows, one int32 row per grid
#: step (csrc/trace_rows.cuh): the visits of the step, live (1) or
#: discarded (0), its block, the (row, col) supertile it stored (write,
#: CA), the partial it wrote (sum), then per origin slot
#: (dy + 1) * 3 + dx + 1 the supertile it read (the sum's and the CA's
#: centre 4, the CA's neighbours; -1: none).  Untouched entries keep the
#: initial row of :func:`trace_rows`.
TRACE_COLUMNS = ("visits", "live", "bx", "by", "store_row", "store_col",
                 "slot") + tuple(f"load{o}_{rc}" for o in range(9)
                                 for rc in ("row", "col"))
TRACE_LOADS = TRACE_COLUMNS.index("load0_row")


def check_trace(state: torch.Tensor, steps: int,
                trace: torch.Tensor) -> None:
    """Trace rows a wrapper hands its trace build: a contiguous (steps,
    len(TRACE_COLUMNS)) int32 tensor on the state's device."""
    if (trace.dtype != torch.int32 or not trace.is_contiguous()
            or tuple(trace.shape) != (steps, len(TRACE_COLUMNS))
            or trace.device != state.device):
        raise ValueError(
            f"trace rows must be a contiguous ({steps}, "
            f"{len(TRACE_COLUMNS)}) int32 tensor on {state.device}")


def trace_rows(steps: int, device) -> torch.Tensor:
    """The initial trace rows of a launch of ``steps`` grid steps on
    ``device``: visits and live 0, every other column -1."""
    rows = torch.full((steps, len(TRACE_COLUMNS)), -1, dtype=torch.int32,
                      device=device)
    rows[:, :2] = 0
    return rows


class LaunchRecord:
    """What one launch of a fractal kernel is about to do, handed to the
    installed launch hook.

    kernel: ``"sierpinski_write"``, ``"sierpinski_sum"`` (the tile
            reduce; its output is the (steps,) partials, before the
            combine) or ``"sierpinski_ca"`` (one fused launch).
    plan, block: the launch's grid plan and block side.
    dst:    the tensor the launch writes in place (the state of a write,
            the stale buffer of a CA launch), or None when the launch
            returns a fresh tensor (the sum's partials).
    trace:  None, or the (steps, len(TRACE_COLUMNS)) int32 rows a hook
            sets before ``run()`` on the launch's device: the launch then
            fills them (the kernel's trace build on the card, the plain
            version on the CPU).  Only unsharded launches take rows.
    """

    __slots__ = ("kernel", "plan", "block", "dst", "trace")

    def __init__(self, kernel: str, plan, block: int,
                 dst: Optional[torch.Tensor] = None):
        self.kernel, self.plan, self.block, self.dst = kernel, plan, block, dst
        self.trace: Optional[torch.Tensor] = None


#: ``hook(record, run) -> output``: called around each launch of the
#: write, sum and CA entry points; ``run()`` performs the launch (the
#: kernel on the card, its plain version on the CPU) and returns its
#: output, which the hook returns, possibly edited.  None: no hook.
LAUNCH_HOOK: Optional[Callable] = None


def set_launch_hook(hook: Optional[Callable]) -> Optional[Callable]:
    """Install a launch hook (see :data:`LAUNCH_HOOK`); returns the
    previous one.  ``None`` uninstalls."""
    global LAUNCH_HOOK
    prev = LAUNCH_HOOK
    LAUNCH_HOOK = hook
    return prev


def shard_args(m: torch.Tensor, p, view) -> tuple:
    """Check a sharded launch's operands and return its shard arguments
    (the SHARD_PARAMS array, the ghost map's and the phase list's
    addresses) for the rank ``view`` is bound to."""
    arr, gmap, phase = view.shard_params(m.device)
    check_tables(m, p, lut_rows=int(view._count[view.rank]))
    if m.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel needs a CUDA tensor, got one on {m.device}")
    if tuple(m.shape) != (p.rows, p.pitch):
        raise ValueError(
            f"state shape {tuple(m.shape)} != ({p.rows}, {p.pitch})")
    return arr, ptr(gmap), ptr(phase)


def launch(kernel: str, plan, block: int, dst, fn: Callable, *args):
    """``fn(*args)``: one launch of a fractal kernel (the kernel on the
    card, its plain version on the CPU), through the installed launch
    hook when there is one.  ``kernel``, ``plan``, ``block`` and ``dst``
    are the hook's :class:`LaunchRecord`.  With no hook installed this
    is one ``is None`` test and the call.  Rows a hook sets in the
    record's ``trace`` reach ``fn`` as its ``trace`` keyword."""
    if LAUNCH_HOOK is None:
        return fn(*args)
    record = LaunchRecord(kernel, plan, block, dst)

    def run():
        if record.trace is None:
            return fn(*args)
        return fn(*args, trace=record.trace)
    return LAUNCH_HOOK(record, run)
