"""Cellular-automaton simulation on the embedded Sierpinski gasket with the
PyTorch/CUDA port -- the data-parallel application class from the
paper's introduction (Wolfram-style parity CA + heat diffusion), running
on the fused block-space CA kernel with the classic double-buffer
scheme.

``--fuse k`` advances k steps per kernel launch (the in-CTA trapezoid
loop), so ``--steps T`` costs ceil(T/k) launches.  ``--coarsen s`` makes
every launch step own an s x s superblock (lambda decoded once per
superblock).

With ``--storage compact`` (the default) the state never materializes
the dense n x n array after the initial seed: both CA buffers live in
the packed orthotope layout of Lemma 2 (O(n^H) memory), and the kernel
resolves its halo gathers through lambda^-1.  ``--storage embedded``
keeps the dense layout for A/B.

Runs on the card by default; ``--device cpu`` runs the kernel's plain
PyTorch version.  ``--fuse``, ``--coarsen`` and ``--grid-mode`` take
``auto``: the schedule the tune cache holds for this problem on the
device (:mod:`repro_torch.core.tune`), or the JAX package's untuned one
(fuse 1, coarsen 1, closed_form).  ``--autotune`` first searches the
schedule axes for this problem and storage, persists the winner and runs
with it (on the CPU it times the plain version).

Run:  PYTHONPATH=src python examples/torch_ca_simulation.py [--steps 16]
      [--autotune]
"""
import argparse

import torch

from repro_torch.core import backend
from repro_torch.core import fractal as F
from repro_torch.core import tune
from repro_torch.core.compact import CompactLayout
from repro_torch.core.domain import make_fractal_domain
from repro_torch.kernels import ops, sierpinski_ca


def simulate(*, n=64, steps=16, block=8, rule="parity", storage="compact",
             fuse=1, coarsen=1, grid_mode="compact", device=None,
             verbose=False):
    """Seed one live cell at the gasket's bottom-left corner (100 units
    of heat under diffusion) and run ``steps`` steps.  Returns the final
    state (packed under compact storage) and a dict of what the run
    checked: launches, active cells, heat before and after."""
    device = backend.default_device(device)
    mask = torch.from_numpy(F.membership_grid(n).copy()).to(device)
    state = torch.zeros((n, n), dtype=torch.float32, device=device)
    state[n - 1, 0] = 100.0 if rule == "diffusion" else 1.0
    a = torch.where(mask, state, 0)
    b = torch.zeros_like(a)
    layout = None
    if storage == "compact":
        layout = CompactLayout(make_fractal_domain("sierpinski-gasket",
                                                   n // block))
        a, b = layout.pack(a, block), layout.pack(b, block)
        if verbose:
            emb, pk = n * n, layout.num_cells(block)
            print(f"orthotope-resident: {pk} cells ({4 * pk} B f32) "
                  f"instead of {emb} ({4 * emb} B), x{emb / pk:.2f} smaller")

    heat0 = float(a.double().sum())
    final = ops.ca_run(a, b, steps, fuse=fuse, rule=rule, block=block,
                       grid_mode=grid_mode, storage=storage, n=n,
                       coarsen=coarsen)
    eff = sierpinski_ca.effective_fuse(fuse, steps, min(block, n), coarsen)
    info = {"launches": len(ops.launch_schedule(steps, eff)),
            "active": int((final > 0).sum()),
            "heat0": heat0, "heat": float(final.double().sum())}
    # zero outside the fractal is an invariant of the kernel
    emb_final = layout.unpack(final, block) if layout is not None else final
    assert not emb_final[~mask].any(), "state is nonzero outside the gasket"
    if rule == "diffusion":
        # the graph Laplacian conserves heat (to f32 rounding)
        assert abs(info["heat"] - heat0) <= 1e-4 * abs(heat0), info
    return final, info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--block", type=int, default=8)
    ap.add_argument("--rule", default="parity",
                    choices=["parity", "diffusion"])
    ap.add_argument("--storage", default="compact",
                    choices=["embedded", "compact"])
    ap.add_argument("--fuse", default="1",
                    help="steps per kernel launch (int, or 'auto' for the "
                         "tuned value; untuned default 1)")
    ap.add_argument("--coarsen", default="1",
                    help="superblock side in blocks (int or 'auto')")
    ap.add_argument("--grid-mode", default="compact",
                    choices=["compact", "closed_form", "prefetch_lut",
                             "bounding", "mma", "auto"])
    ap.add_argument("--autotune", action="store_true",
                    help="search the schedule axes for this problem "
                         "first, persist the winner, and run with it")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = backend.default_device(args.device)
    fuse = args.fuse if args.fuse == "auto" else int(args.fuse)
    coarsen = args.coarsen if args.coarsen == "auto" else int(args.coarsen)
    grid_mode = args.grid_mode
    if args.autotune:
        cfg, us, trials = tune.autotune_ca(
            n=args.n, block=args.block, rule=args.rule,
            storages=(args.storage,), device=device)
        why = f"measured {us:.0f} us over {len(trials)} configs" \
            if us is not None else "tune-cache hit"
        print(f"autotuned: {cfg} ({why})")
        grid_mode, fuse, coarsen = cfg["lowering"], cfg["fuse"], \
            cfg["coarsen"]
    # the same cache lookup ca_run performs, done here so the example can
    # report the schedule it is about to run
    grid_mode, fuse, coarsen, num_stages = sierpinski_ca.auto_schedule(
        n=args.n, block=args.block, rule=args.rule, grid_mode=grid_mode,
        fuse=fuse, coarsen=coarsen, device=device)
    print(f"schedule: grid_mode={grid_mode} fuse={fuse} coarsen={coarsen} "
          f"num_stages={num_stages}")
    final, info = simulate(n=args.n, steps=args.steps, block=args.block,
                           rule=args.rule, storage=args.storage,
                           fuse=fuse, coarsen=coarsen,
                           grid_mode=grid_mode, device=device,
                           verbose=True)
    print(f"{args.steps} steps in {info['launches']} fused launches on "
          f"{final.device}")
    print(f"final active cells = {info['active']}")
    if args.rule == "diffusion":
        print(f"heat conserved: {info['heat0']:.3f} -> {info['heat']:.3f}")
    print("invariant OK: state is zero outside the gasket")


if __name__ == "__main__":
    main()
