"""Ising-model Monte Carlo on the Sierpinski gasket with the PyTorch port
-- the spin-lattice application from the paper's introduction (Gefen et
al., phase transitions on fractals); the JAX package's
``examples/ising_gasket.py`` on tensors.

Checkerboard Metropolis sweeps over the gasket, **orthotope-resident**:
spins live in the compact linear-lambda layout (exactly n^H = 3^r
sites), neighbour sums are gathers through the host-built
lambda^-1-resolved cell neighbour tables, and the checkerboard parity
comes from the embedded coordinates of each packed site.  No n x n
array exists at any point.  It runs no kernel: a sweep is a few gathers
and elementwise ops.  The gasket has NO finite-temperature phase
transition (H < 2): magnetization decays at every T > 0, which the demo
shows qualitatively.

The acceptance draws come from a ``torch.Generator`` (the numbers differ
from ``jax.random``'s); :func:`metropolis_sweep` takes them as
arguments, so given the same draws it flips the same spins as the JAX
package's sweep.

Runs on the card by default; ``--device cpu`` runs on the CPU.

Run:  PYTHONPATH=src python examples/torch_ising_gasket.py [--sweeps 50]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import fractal as F
from repro_torch.core.backend import default_device
from repro_torch.core.compact import cell_neighbor_tables


def packed_neighbor_sum(s, tables):
    """Sum of the 4 embedded neighbours of each packed site (ghost
    slot 3^r reads the appended 0)."""
    z = torch.cat([s, torch.zeros((1,), dtype=s.dtype, device=s.device)])
    return z[tables[0]] + z[tables[1]] + z[tables[2]] + z[tables[3]]


def metropolis_sweep(spins, parity_bits, tables, beta, draws):
    """Two checkerboard half-sweeps (parallel Metropolis) on the packed
    spin vector; ``draws`` holds the two half-sweeps' uniform draws, one
    per site each."""
    for parity, u in zip((0, 1), draws):
        nb = packed_neighbor_sum(spins, tables)
        dE = 2.0 * spins * nb
        accept = u < torch.exp(-beta * dE)
        flip = accept & (parity_bits == parity)
        spins = torch.where(flip, -spins, spins)
    return spins


def setup(r: int, device):
    """(neighbour tables, parity bits) of the gasket of level ``r``."""
    n_sites = F.gasket_volume(2 ** r)
    tables = torch.as_tensor(np.asarray(cell_neighbor_tables(r)),
                             dtype=torch.int64, device=device)
    lx, ly = F.lambda_map_linear(np.arange(n_sites), r)
    parity = torch.as_tensor((np.asarray(lx) + np.asarray(ly)) % 2,
                             dtype=torch.int32, device=device)
    return tables, parity


def observables(spins, tables):
    """(|m|, E per site) of the packed spins."""
    n = spins.numel()
    mag = float(torch.abs(torch.sum(spins)) / n)
    energy = float(-torch.sum(spins * packed_neighbor_sum(spins, tables))
                   / 2 / n)
    return mag, energy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--r", type=int, default=6)
    ap.add_argument("--sweeps", type=int, default=50)
    ap.add_argument("--betas", default="1.0,0.5,0.2")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    r = args.r
    n = 2 ** r
    n_sites = F.gasket_volume(n)
    print(f"gasket n={n}, sites={n_sites} (n^{F.HAUSDORFF:.3f}), "
          f"packed {4 * n_sites} B f32 vs embedded {4 * n * n} B")
    tables, parity = setup(r, dev)
    for beta in [float(b) for b in args.betas.split(",")]:
        gen = torch.Generator(device=dev).manual_seed(0)
        spins = torch.ones((n_sites,), dtype=torch.float32, device=dev)
        for _ in range(args.sweeps):
            draws = [torch.rand(n_sites, generator=gen, device=dev)
                     for _ in range(2)]
            spins = metropolis_sweep(spins, parity, tables, beta, draws)
        mag, energy = observables(spins, tables)
        print(f"beta={beta:4.2f}:  |m| = {mag:.4f}   E/site = {energy:.4f}")
    print("note: magnetization decays for every beta -- the gasket has no "
          "finite-T transition (H < 2)")


if __name__ == "__main__":
    main()
