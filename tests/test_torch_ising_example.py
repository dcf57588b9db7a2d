"""``examples/torch_ising_gasket.py`` against the JAX package's
``examples/ising_gasket.py`` on a small gasket (r = 4, 81 sites): the
same neighbour tables and parity bits, and, fed the reference's own
``jax.random`` draws, the same spins after every sweep and the same
magnetization and energy at each temperature; the script's CLI runs on
the CPU."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ising_example_matches_reference_sweeps(capsys):
    ref, port = _load("ising_gasket"), _load("torch_ising_gasket")
    r, sweeps = 4, 6
    n_sites = 3 ** r
    tables, parity = port.setup(r, "cpu")
    jtables = jnp.asarray(ref.cell_neighbor_tables(r))
    np.testing.assert_array_equal(tables.numpy(), np.asarray(jtables))
    lx, ly = ref.F.lambda_map_linear(np.arange(n_sites), r)
    jparity = jnp.asarray((np.asarray(lx) + np.asarray(ly)) % 2, jnp.int32)
    np.testing.assert_array_equal(parity.numpy(), np.asarray(jparity))
    for beta in (1.0, 0.2):
        key = jax.random.PRNGKey(0)
        jspins = jnp.ones((n_sites,), jnp.float32)
        spins = torch.ones(n_sites)
        for _ in range(sweeps):
            # the reference's draws, as its sweep takes them
            k, draws = key, []
            for _ in range(2):
                k, sub = jax.random.split(k)
                draws.append(torch.from_numpy(np.array(
                    jax.random.uniform(sub, (n_sites,)))))
            key, jspins = ref.metropolis_sweep(key, jspins, jparity,
                                               jtables, beta)
            spins = port.metropolis_sweep(spins, parity, tables, beta,
                                          draws)
            np.testing.assert_array_equal(spins.numpy(), np.asarray(jspins))
        mag, energy = port.observables(spins, tables)
        assert mag == float(jnp.abs(jnp.sum(jspins)) / n_sites)
        assert energy == float(-jnp.sum(
            jspins * ref.packed_neighbor_sum(jspins, jtables)) / 2 / n_sites)
    port.main(["--r", "4", "--sweeps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "sites=81" in out and out.count("|m| =") == 3
