"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Drives the port's main path -- the paper's SS IV experiment: enumerate
the member blocks of an n x n Sierpinski gasket with lambda(w), launch
exactly those blocks, write (and sum) every member cell, and compare
with the bounding-box launch -- through the hand-written CUDA kernels,
at the paper's largest size (n = 2**16, a 16 GiB f32 state).

Phases, each printing its own lines:

1. card   -- name and power limit (nvidia-smi), torch and CUDA versions;
2. build  -- nvcc builds every kernel from the sources in the checkout;
3. parity -- every kernel against its plain PyTorch version on the card:
             gasket, carpet and Vicsek x closed_form / prefetch_lut /
             bounding x several (n, rho); writes bit-equal in
             f32/bf16/int32, sums bit-equal on integer-valued states and
             within a stated tolerance on normal ones;
4. main   -- launch counts set to 0, then sierpinski_write_ and
             sierpinski_sum at n = 2**16 under the three lowerings at
             rho in {8, 16, 32}, each write checked against the bit test
             in row bands; counts read; then, at the same shapes, the
             sum kernels against their plain versions slot by slot on
             position-dependent integers (bit-equal) and on a normal
             state (within the tolerance); CUDA-event timings of every
             kernel beside its plain version and one library call of
             the same function (masked_fill_, torch.masked.sum,
             Tensor.sum), and the rho = 1 grids (3**16 and 2**32 steps)
             launched once;
5. kernels line, then the result line.

Any failed check raises: the script exits non-zero and prints no
result line.  It needs one CUDA card and nvcc; full results are written
to chiprun_out/chip_smoke.json.

Run:  python3 chip_smoke.py
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

#: H100 SXM device-memory rate and f32 (non-tensor-core) peak, from
#: NVIDIA's data sheet at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

N_MAIN = 1 << 16
RHOS = (8, 16, 32)
REPORT_AT = ("closed_form", 32)   # the (lowering, rho) of the kernels line
PARITY_CASES = [
    ("sierpinski-gasket", 64, 1), ("sierpinski-gasket", 64, 4),
    ("sierpinski-gasket", 1024, 8), ("sierpinski-gasket", 1024, 128),
    ("sierpinski-gasket", 4096, 2), ("sierpinski-gasket", 16384, 32),
    ("sierpinski-gasket", 16384, 4),
    ("sierpinski-carpet", 81, 1), ("sierpinski-carpet", 81, 3),
    ("sierpinski-carpet", 729, 9), ("sierpinski-carpet", 6561, 27),
    ("vicsek-cross", 81, 3), ("vicsek-cross", 729, 27),
    ("vicsek-cross", 6561, 9),
]
DTYPES = (torch.float32, torch.bfloat16, torch.int32)
#: normal-state tolerance of a tile sum: two f32 reductions of <= 1024
#: terms in different orders each err by <= ~1e-6 of the tile's sum of
#: magnitudes
NORMAL_RTOL = 1e-5
SEED = 0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps, warmup=1):
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, nops=0):
    """Least time in ms for the work: bytes over the memory rate or f32
    operations over the f32 peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    return card


def phase_build(_cuda):
    t0 = time.perf_counter()
    paths = _cuda.build()
    secs = time.perf_counter() - t0
    for name, path in paths.items():
        print(f"[build] {name}: {path.name} in {secs:.1f} s")
        for line in _cuda.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    return secs


def random_state(n, dtype, seed, integer, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        x = torch.randint(-8, 9, (n, n), generator=g, device=dev)
    else:
        x = torch.randn((n, n), generator=g, device=dev)
    return x.to(dtype)


def merge_err(into, errs):
    for name, e in errs.items():
        into[name] = max(into[name], e)


def phase_parity(TW, LOWERINGS, dev):
    """Every kernel against its plain version on the same inputs."""
    err = {name: 0.0 for name in TW.KERNELS}
    ncmp = 0
    for ci, (fractal, n, block) in enumerate(PARITY_CASES):
        for gm in LOWERINGS:
            # integer-valued states: writes, partials and totals bit-equal;
            # then a normal f32 state: partials within the tolerance
            for di, dtype in enumerate(DTYPES + (None,)):
                integer = dtype is not None
                base = random_state(n, dtype or torch.float32,
                                    1000 * ci + di, integer, dev)
                plan, n_, blk = TW.prepare_launch(
                    base, block=block, grid_mode=gm, fractal=fractal)
                p = plan.launch_params(n_, blk, dev)
                if integer:
                    TW.check_write_against_plain(base, 7.3, plan, n_, blk, p)
                    ncmp += 1
                errs, _ = TW.check_sum_against_plain(
                    base, plan, n_, blk, p,
                    rtol=None if integer else NORMAL_RTOL)
                merge_err(err, errs)
                ncmp += 2
        torch.cuda.synchronize()
        print(f"[parity] {fractal} n={n} rho={block}: ok "
              f"(3 lowerings x {len(DTYPES)} dtypes + normal f32)")
    print(f"[parity] {ncmp} kernel-vs-plain comparisons passed; "
          f"max |err| {err}")
    return err


def gasket_mask(n, dev, band):
    """The bit-test membership of the (n, n) gasket, built in row bands."""
    mask = torch.empty((n, n), dtype=torch.bool, device=dev)
    x = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    for y0 in range(0, n, band):
        y = torch.arange(y0, y0 + band, dtype=torch.int32, device=dev)[:, None]
        mask[y0:y0 + band] = (x & (n - 1 - y)) == 0
    return mask


def check_bands(m, mask, band, what):
    """Members hold 1.0, every other cell still 2.0, band by band."""
    for y0 in range(0, m.shape[0], band):
        want = torch.where(mask[y0:y0 + band], 1.0, 2.0)
        check(torch.equal(m[y0:y0 + band], want),
              f"{what}: rows {y0}..{y0 + band} differ from the bit test")


def phase_main(ops, TW, F, LOWERINGS, dev):
    n, band = N_MAIN, 2048
    members = F.gasket_volume(n)
    torch.cuda.reset_peak_memory_stats()
    m = torch.full((n, n), 2.0, dtype=torch.float32, device=dev)
    mask = gasket_mask(n, dev, band)
    print(f"[main] gasket n={n}: state {m.numel() * 4 / 2 ** 30:.0f} GiB "
          f"f32, {members} member cells")

    # -- the main path, counted --------------------------------------------
    # The writes run on a state of 2.0 and are checked against the bit
    # test.  The sums run on position-dependent integers in [-8, 8], so a
    # partial in the wrong slot or a wrong step order changes the total.
    sums = {}
    gen = torch.Generator(device=dev)
    TW.reset_launch_counts()
    for rho in RHOS:
        for gm in LOWERINGS:
            m.fill_(2.0)
            ops.sierpinski_write_(m, 1.0, block=rho, grid_mode=gm)
            check_bands(m, mask, band, f"write {gm} rho={rho}")
    m.random_(-8, 9, generator=gen.manual_seed(SEED))
    for rho in RHOS:
        for gm in LOWERINGS:
            sums[(gm, rho)] = ops.sierpinski_sum(m, block=rho, grid_mode=gm)
    torch.cuda.synchronize()
    launches = TW.launch_counts()
    print(f"[main] launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    # -- checks at the main path's shapes (not counted) --------------------
    exact = sum(float(m[y0:y0 + band][mask[y0:y0 + band]].double().sum())
                for y0 in range(0, n, band))
    err = {name: 0.0 for name in TW.KERNELS}
    for rho in RHOS:
        for gm in LOWERINGS:
            plan, _, blk = TW.prepare_launch(m, block=rho, grid_mode=gm)
            p = plan.launch_params(n, blk, dev)
            errs, plain_sum = TW.check_sum_against_plain(m, plan, n, blk, p)
            merge_err(err, errs)
            check(torch.equal(sums[(gm, rho)], plain_sum),
                  f"sum {gm} rho={rho}: kernel {float(sums[(gm, rho)])} "
                  f"!= plain {float(plain_sum)}")
            parts = TW.sum_partials_cuda(m, p)
            check(float(parts.double().sum()) == exact,
                  f"partials {gm} rho={rho}: f64 total "
                  f"{float(parts.double().sum())} != {exact}")
    print(f"[main] integer state: partials bit-equal to the plain version "
          f"slot by slot, totals equal, f64 member total {exact}")
    m.normal_(generator=gen.manual_seed(SEED + 1))
    for rho in RHOS:
        for gm in LOWERINGS:
            plan, _, blk = TW.prepare_launch(m, block=rho, grid_mode=gm)
            p = plan.launch_params(n, blk, dev)
            errs, _ = TW.check_sum_against_plain(m, plan, n, blk, p,
                                                 rtol=NORMAL_RTOL)
            merge_err(err, errs)
    print(f"[main] normal state: partials within {NORMAL_RTOL} of each "
          f"tile's sum of magnitudes; max |err| {err}")

    # -- timings (not counted) ---------------------------------------------
    rows = []
    yard_ms = time_ms(lambda: m.masked_fill_(mask, 1.0), reps=5)
    msum_ms = time_ms(lambda: torch.masked.sum(m, mask=mask), reps=5)
    print(f"[main] yardsticks: masked_fill_ {yard_ms:.4f} ms, "
          f"torch.masked.sum {msum_ms:.4f} ms")
    for rho in RHOS:
        for gm in LOWERINGS:
            plan, _, blk = TW.prepare_launch(m, block=rho, grid_mode=gm)
            p = plan.launch_params(n, blk, dev)
            parts = TW.sum_partials_cuda(m, p)
            steps = p.steps
            fast = 20 if steps < 1 << 22 else 5  # the serial combine
            row = {
                "lowering": gm, "rho": rho, "steps": steps,
                "sum": float(sums[(gm, rho)]),
                "write_ms": time_ms(lambda: TW.write_cuda(m, 1.0, p), 20),
                "write_plain_ms": time_ms(
                    lambda: TW.sierpinski_write_plain(m, 1.0, plan, n, blk),
                    2),
                "write_library_ms": yard_ms,
                "partials_ms": time_ms(lambda: TW.sum_partials_cuda(m, p),
                                       20),
                "partials_plain_ms": time_ms(
                    lambda: TW.sum_partials_plain(m, plan, n, blk), 2),
                "partials_library_ms": msum_ms,
                "combine_ms": time_ms(lambda: TW.sum_combine_cuda(parts),
                                      fast),
                "combine_plain_ms": time_ms(
                    lambda: TW.sum_combine_plain(parts), 2),
                "combine_library_ms": time_ms(lambda: parts.sum(), 20),
                "sum_ms": time_ms(
                    lambda: ops.sierpinski_sum(m, block=rho, grid_mode=gm),
                    fast),
                "sum_plain_ms": time_ms(
                    lambda: TW.sierpinski_sum_plain(m, plan, n, blk), 2),
            }
            # bytes: member cells written / read once, partials once
            for key, b in (("write", bound(members * 4)),
                           ("partials", bound(members * 4 + steps * 4,
                                              members)),
                           ("combine", bound(steps * 4 + 4, steps))):
                row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = b
            rows.append(row)
            print(f"[main] {json.dumps(row)}")
    for rho in RHOS:
        by = {r["lowering"]: r for r in rows if r["rho"] == rho}
        print(f"[main] rho={rho}: lambda/bounding write time "
              f"{by['closed_form']['write_ms'] / by['bounding']['write_ms']:.4f}"
              f", LUT/bounding "
              f"{by['prefetch_lut']['write_ms'] / by['bounding']['write_ms']:.4f}"
              f", lambda/bounding sum time "
              f"{by['closed_form']['sum_ms'] / by['bounding']['sum_ms']:.4f}")

    # -- the rho = 1 grids: 3**16 closed-form steps, 2**32 bounding steps
    rho1 = {}
    for gm in ("closed_form", "bounding"):
        m.fill_(2.0)
        plan, _, blk = TW.prepare_launch(m, block=1, grid_mode=gm)
        p = plan.launch_params(n, blk, dev)
        rho1[gm] = time_ms(lambda: TW.write_cuda(m, 1.0, p), 1, warmup=0)
        check_bands(m, mask, band, f"write {gm} rho=1")
        print(f"[main] rho=1 {gm}: {p.steps} steps, one launch "
              f"{rho1[gm]:.3f} ms, checked against the bit test")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[main] peak device memory {peak:.2f} GiB")
    return rows, launches, err, rho1, peak


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    import importlib

    from repro_torch.core import fractal as F
    from repro_torch.core.plan import LOWERINGS
    from repro_torch.kernels import _cuda, ops
    TW = importlib.import_module("repro_torch.kernels.sierpinski_write")

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = phase_card()
    build_s = phase_build(_cuda)
    errs = phase_parity(TW, LOWERINGS, dev)
    rows, launches, main_errs, rho1, peak = phase_main(ops, TW, F,
                                                       LOWERINGS, dev)
    merge_err(errs, main_errs)
    at = next(r for r in rows
              if (r["lowering"], r["rho"]) == REPORT_AT)
    source = "src/repro_torch/csrc/sierpinski_write.cu"
    ref = "src/repro/kernels/sierpinski_write.py"
    kernels = []
    for name, key, replaces in [
            ("sierpinski_write", "write", f"{ref}:171"),
            ("sierpinski_sum_partials", "partials", f"{ref}:418"),
            ("sierpinski_sum_combine", "combine", f"{ref}:513")]:
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": at[f"{key}_ms"],
            "plain_ms": at[f"{key}_plain_ms"],
            "bound_ms": at[f"{key}_bound_ms"],
            "bound_by": at[f"{key}_bound_by"],
            "library_ms": at[f"{key}_library_ms"],
            "at": f"gasket n={N_MAIN} f32 {REPORT_AT[0]} rho={REPORT_AT[1]}",
        })
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "parity_max_abs_err": errs, "sweep": rows,
        "rho1_write_ms": rho1, "peak_gib": peak, "kernels": kernels,
        "seconds": time.perf_counter() - t_start}, indent=1))
    print(f"[done] {time.perf_counter() - t_start:.1f} s; results in "
          f"{OUT.relative_to(ROOT)}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
