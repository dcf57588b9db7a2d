"""CLI: statically verify every plan the kernels can launch, and trace
real launches through the access sanitizer.

``python -m repro_torch.analysis.verify --matrix`` sweeps the registered
domain zoo across every lowering, storage, coarsening factor and shard
count (host meshes: no process group), runs the static checks of
:mod:`repro_torch.analysis.verifier` on each plan, then drives the
access sanitizer (:mod:`repro_torch.analysis.sanitizer`) over real
write, sum and CA launches.  ``--device cuda`` (the default) checks the
tables as they lie on the card and traces the trace builds of the
kernels there, and fails without a card; ``--device cpu`` checks the CPU
tables and traces the plain versions.  The result is a JSON report
(``--out``) and a nonzero exit status when any combination produced a
finding.

``--smoke`` cuts the sweep to a representative subset so the check runs
in seconds; ``--no-sanitize`` runs the static checks only.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Iterator, Optional, Tuple

from .verifier import HostMesh, verify_plan

#: domains whose lambda map is a digit-unrolled fractal -- the ones
#: with a compact storage layout and a coarsening axis.
FRACTAL_DOMAINS = ("sierpinski", "carpet", "vicsek")

#: coarsening factor exercised per fractal (one supertile level: the
#: gasket contracts by 2, the k=8/k=5 carpets by 3).
COARSEN = {"sierpinski": 2, "carpet": 3, "vicsek": 3}

#: shard counts emulated through :class:`HostMesh`
SHARD_COUNTS = (1, 2, 3)


def matrix_plans(smoke: bool = False,
                 device="cpu") -> Iterator[Tuple[str, object, str]]:
    """Yield ``(label, plan, kernel_model)`` for every combination the
    matrix covers, with the JAX package's labels: unsharded x {lowering,
    storage}, coarsened fractals, and sharded plans across partitions /
    halo modes / shard counts, each plan's tables on ``device``."""
    from repro_torch.core.plan import LOWERINGS, GridPlan, registered_domains
    from repro_torch.core.shard import ShardedPlan

    domains = registered_domains("small")
    names = ("sierpinski", "triangular") if smoke else tuple(domains)
    for name in names:
        dom = domains[name]
        storages = ("embedded", "compact") if name in FRACTAL_DOMAINS \
            else ("embedded",)
        for lowering in LOWERINGS:
            for storage in storages:
                plan = GridPlan(dom, lowering, storage=storage,
                                backend=device)
                yield (f"{name}/{lowering}/{storage}", plan, "write")
    coarse = ("sierpinski",) if smoke else FRACTAL_DOMAINS
    for name in coarse:
        dom, c = domains[name], COARSEN[name]
        for lowering in LOWERINGS:
            for storage in ("embedded", "compact"):
                plan = GridPlan(dom, lowering, storage=storage, coarsen=c,
                                backend=device)
                yield (f"{name}/{lowering}/{storage}/coarsen={c}",
                       plan, "write")
    sharded = ("sierpinski",) if smoke else ("sierpinski", "carpet")
    counts = (1, 2) if smoke else SHARD_COUNTS
    variants = (("compact", "storage-rows", True),
                ("compact", "storage-rows", False),
                ("embedded", "linear", False))
    for name in sharded:
        dom = domains[name]
        for d in counts:
            mesh = HostMesh(d, axis="data")
            for lowering in LOWERINGS:
                for storage, partition, halo in variants:
                    plan = ShardedPlan(dom, lowering, storage=storage,
                                       backend=device, mesh=mesh,
                                       axis="data", partition=partition,
                                       halo=halo)
                    tag = f"halo={int(halo)}" if partition == \
                        "storage-rows" else partition
                    yield (f"{name}/{lowering}/{storage}/D={d}/{tag}",
                           plan, "write")


def run_static_matrix(smoke: bool = False, verbose: bool = True,
                      device="cpu") -> list:
    """Verify every matrix plan; returns ``[(label, Report)]``."""
    out = []
    for label, plan, kernel in matrix_plans(smoke=smoke, device=device):
        report = verify_plan(plan, kernel=kernel, device=device)
        out.append((label, report))
        if verbose:
            status = "ok" if report.ok else \
                f"FAIL ({len(report.findings)} findings)"
            print(f"  static {label}: {status}")
            for f in report.findings:
                print(f"    - {f}")
    return out


def run_sanitizer_smoke(smoke: bool = False, verbose: bool = True,
                        device="cpu") -> list:
    """Drive real write, sum and CA launches on ``device`` under the
    access sanitizer (the trace kernels on the card, the plain versions
    on the CPU); returns ``[(label, findings)]``."""
    import torch

    from repro_torch.core.compact import compact_layout
    from repro_torch.core.domain import make_fractal_domain
    from repro_torch.kernels.sierpinski_ca import ca_run
    from repro_torch.kernels.sierpinski_write import (sierpinski_sum,
                                                      sierpinski_write)
    from .sanitizer import verify_launches

    dom = make_fractal_domain("sierpinski-gasket", 8)
    block = 3
    shapes = {"embedded": (24, 24),
              "compact": compact_layout(dom).array_shape(block)}
    grid_modes = ("closed_form", "mma") if smoke \
        else ("closed_form", "prefetch_lut", "bounding", "mma")
    out = []
    for storage in ("embedded", "compact"):
        m = torch.zeros(shapes[storage], dtype=torch.float32, device=device)
        for gm in grid_modes:
            kw = dict(block=block, grid_mode=gm, storage=storage,
                      domain=dom, num_stages=1)
            for kernel, fn, args in (
                    ("write", sierpinski_write, (m, 1.0)),
                    ("sum", sierpinski_sum, (m,)),
                    ("ca", ca_run, (m, torch.zeros_like(m), 2))):
                extra = dict(fuse=1, donate=False) if kernel == "ca" else {}
                label = f"{kernel}/{device}/{storage}/{gm}"
                _, findings = verify_launches(fn, *args, kernel=kernel,
                                              strict=False, **kw, **extra)
                out.append((label, findings))
                _say(label, findings, verbose)
    return out


def _say(label: str, findings: list, verbose: bool) -> None:
    if verbose:
        status = "ok" if not findings else f"FAIL ({len(findings)})"
        print(f"  sanitize {label}: {status}")
        for f in findings:
            print(f"    - {f}")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.verify",
        description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", action="store_true",
                    help="sweep the full domain/lowering/storage/shard "
                         "matrix")
    ap.add_argument("--smoke", action="store_true",
                    help="representative subset")
    ap.add_argument("--no-sanitize", action="store_true",
                    help="static checks only, no traced launches")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the tables lie and the launches run "
                         "(default: the card)")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    if not args.matrix:
        ap.error("nothing to do: pass --matrix")
    from repro_torch.core.backend import default_device
    device = default_device(args.device)
    verbose = not args.quiet

    static = run_static_matrix(smoke=args.smoke, verbose=verbose,
                               device=device)
    sanitized = [] if args.no_sanitize else \
        run_sanitizer_smoke(smoke=args.smoke, verbose=verbose,
                            device=device)

    n_findings = sum(len(r.findings) for _, r in static) + \
        sum(len(fs) for _, fs in sanitized)
    report = {
        "ok": n_findings == 0,
        "num_static": len(static),
        "num_sanitized": len(sanitized),
        "num_findings": n_findings,
        "static": [{"label": label, **r.to_json()} for label, r in static],
        "sanitizer": [{"label": label, "ok": not fs,
                       "findings": [f.to_json() for f in fs]}
                      for label, fs in sanitized],
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    print(f"verified {len(static)} plans statically, "
          f"{len(sanitized)} sanitized launches: "
          f"{n_findings} findings")
    return 0 if n_findings == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
