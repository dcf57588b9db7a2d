"""Quickstart on the PyTorch/CUDA port: the paper's lambda(w) map.

Renders the embedded Sierpinski gasket three ways and checks they agree:
 1. the membership bit test (bounding-box view),
 2. the block-space map lambda(w) (the paper's contribution),
 3. the write kernel (one CTA per member block, on the card).

Runs on the card by default; ``--device cpu`` runs the kernel's plain
PyTorch version instead.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import backend
from repro_torch.core import fractal as F
from repro_torch.core.domain import SierpinskiDomain
from repro_torch.kernels import ops


def ascii_render(grid, max_n=64):
    n = grid.shape[0]
    step = max(1, n // max_n)
    for y in range(0, n, step):
        print("".join("#" if grid[y, x] else "." for x in
                      range(0, n, step)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = backend.default_device(args.device)

    r = 6
    n = 2 ** r
    print(f"Sierpinski gasket, n={n} (scale level r={r}) on {device}")
    print(f"cells: {F.gasket_volume(n)} = n^H with H={F.HAUSDORFF:.4f}")
    ox, oy = F.orthotope_shape(r)
    print(f"packs into a {ox} x {oy} orthotope (Lemma 2)\n")

    # 1. bounding-box membership
    bb = F.membership_grid(n)

    # 2. lambda map: paint cells enumerated by the compact map
    lam = torch.zeros((n, n), dtype=torch.bool, device=device)
    lx, ly = F.lambda_map_linear(torch.arange(3 ** r, device=device), r)
    lam[ly, lx] = True
    assert np.array_equal(bb, lam.cpu().numpy()), "lambda image != membership set"

    # 3. the write kernel (compact grid over 3^r_b blocks)
    m = torch.zeros((n, n), dtype=torch.float32, device=device)
    out = ops.sierpinski_write(m, 1.0, block=8).cpu().numpy() > 0
    assert np.array_equal(bb, out), "kernel != membership set"

    ascii_render(bb)
    d = SierpinskiDomain(n)
    print(f"\nparallel-space efficiency vs bounding box: "
          f"{d.space_efficiency():.4f} "
          f"({d.num_blocks} of {n * n} blocks)")
    print("all three constructions agree ✓")


if __name__ == "__main__":
    main()
