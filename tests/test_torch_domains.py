"""The write, sum and CA entry points under ``domain=`` (the triangular,
band and bounding-box domains of attention, and the fractals as explicit
domains) and under ``grid_mode="mma"``, against the JAX package run under
tpu-interpret, in both storages: integer and parity results bit for bit,
diffusion within rtol 1e-5 / atol 1e-6.  Also the same ``ValueError``\\ s
as ``resolve_storage_args``, raised before any launch.

The JAX package's lowerings give the same bits on every case here (its
tests/test_plan.py holds them to each other on the fractals), so each
case's reference runs once,
under closed_form, and the port under every lowering is held to it --
and, where a tolerance applies, to the port's own closed_form result bit
for bit."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as JP
from repro.core.compact import CompactLayout as JLayout
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.core import plan as TP
from repro_torch.kernels import ops as TO

from torch_parity import assert_rule_close

LOWERINGS = ("closed_form", "prefetch_lut", "bounding", "mma")
ROW_DOMAINS = ("triangular", "band", "bounding-box")
FRACTAL_DOMAINS = ("sierpinski", "carpet", "vicsek")
STORAGES = ("embedded", "compact")


def _block(name):
    return 3 if name in ("carpet", "vicsek") else 4


def _domains(name, size="small"):
    return (JP.registered_domains(size)[name],
            TP.registered_domains(size)[name])


def _state(jd, block, storage, seed, kind="integer"):
    lay = JLayout(jd)
    shape = lay.array_shape(block) if storage == "compact" \
        else lay.embedded_shape(block)
    rng = np.random.default_rng(seed)
    if kind == "integer":
        return rng.integers(-8, 9, shape).astype(np.float32)
    if kind == "binary":
        return rng.integers(0, 2, shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _member_cells(td, block, n):
    """Embedded cell membership of a domain: member blocks, then the
    domain's cell test (all cells for the row-major domains)."""
    nbx, nby = td.bounding_box
    gy, gx = np.mgrid[0:nby * block, 0:nbx * block]
    return np.asarray(td.contains(gx // block, gy // block)) \
        & np.asarray(td.cell_member(gx, gy, n))


# ---------------------------------------------------------------------------
# write / sum
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_write_sum(name, storage):
    """The case's state and the JAX package's write and sum of it (one
    run, under closed_form, for every lowering's case)."""
    jd, _ = _domains(name)
    block = _block(name)
    m = _state(jd, block, storage, seed=10 * len(name) + len(storage))
    kw = dict(block=block, grid_mode="closed_form", storage=storage,
              domain=jd, backend="tpu-interpret")
    want = JO.sierpinski_write(jnp.asarray(m), 7.0, **kw)
    wsum = JO.sierpinski_sum(jnp.asarray(m), **kw)
    return m, np.asarray(want), float(wsum)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("name", ROW_DOMAINS + FRACTAL_DOMAINS)
def test_write_sum_domain_equal_jax(name, lowering, storage):
    jd, td = _domains(name)
    block = _block(name)
    m, want, wsum = _jax_write_sum(name, storage)
    tm = torch.from_numpy(m.copy())
    kw = dict(block=block, grid_mode=lowering, storage=storage)
    got = TO.sierpinski_write(tm, 7.0, domain=td, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tm, torch.from_numpy(m))  # functional
    gsum = TO.sierpinski_sum(tm, domain=td, **kw)
    assert float(gsum) == wsum
    # the value lands exactly on the member cells (the reference's mask)
    n = td.bounding_box[1] * block
    member = _member_cells(td, block, n)
    emb = got.numpy() if storage == "embedded" else np.asarray(
        JLayout(jd).unpack(jnp.asarray(got.numpy()), block, fill=-99))
    assert (emb[member] == 7.0).all()
    if storage == "embedded":
        np.testing.assert_array_equal(emb[~member], m[~member])


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_gasket_mma_equals_the_reference_oracles(lowering):
    """The gasket through ``fractal=`` under every lowering (mma among
    them) equals ``repro.kernels.ref``'s dense oracles."""
    n, block = 64, 8
    m = np.random.default_rng(1).integers(-8, 9, (n, n)).astype(np.float32)
    got = TO.sierpinski_write(torch.from_numpy(m), 3.0, block=block,
                              grid_mode=lowering)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JR.sierpinski_write_ref(jnp.asarray(m), 3.0)))
    assert float(TO.sierpinski_sum(torch.from_numpy(m), block=block,
                                   grid_mode=lowering)) == \
        float(JR.sierpinski_sum_ref(jnp.asarray(m)))


@pytest.mark.parametrize("coarsen", [2, 4])
@pytest.mark.parametrize("storage", STORAGES)
def test_write_sum_mma_coarsened_equal_closed_form(storage, coarsen):
    """mma under coarsening (the odd-level transpose at coarsen 2) gives
    the closed_form results bit for bit, and the JAX package's."""
    jd, td = _domains("sierpinski", "medium")
    block = 2
    m = _state(jd, block, storage, seed=coarsen)
    kw = dict(block=block, storage=storage, coarsen=coarsen)
    outs = [TO.sierpinski_write(torch.from_numpy(m), 5.0, domain=td,
                                grid_mode=gm, **kw).numpy()
            for gm in ("closed_form", "mma")]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[1], np.asarray(JO.sierpinski_write(
        jnp.asarray(m), 5.0, domain=jd, grid_mode="mma",
        backend="tpu-interpret", **kw)))
    sums = [float(TO.sierpinski_sum(torch.from_numpy(m), domain=td,
                                    grid_mode=gm, **kw))
            for gm in ("closed_form", "mma")]
    assert sums[0] == sums[1]


@pytest.mark.parametrize("kw,match", [
    (dict(storage="compact", shape=(16, 16)), "does not match"),
    (dict(shape=(16, 20)), "does not match"),
    (dict(block=3), "does not match"),
])
@pytest.mark.parametrize("entry", ["write", "sum"])
def test_domain_validation_errors_equal_jax(kw, match, entry):
    kw = dict(kw)
    jd, td = _domains("triangular")
    shape = kw.pop("shape", (24, 24))
    kw.setdefault("block", 4)
    m = np.zeros(shape, np.float32)

    def call(ops, dom, arr, **extra):
        if entry == "write":
            return ops.sierpinski_write(arr, 1.0, domain=dom, **kw, **extra)
        return ops.sierpinski_sum(arr, domain=dom, **kw, **extra)
    with pytest.raises(ValueError, match=match) as terr:
        call(TO, td, torch.from_numpy(m))
    with pytest.raises(ValueError) as jerr:
        call(JO, jd, jnp.asarray(m), backend="tpu-interpret")
    assert str(terr.value) == str(jerr.value)


def test_domain_without_device_form_raises_before_launch():
    """A bounding box closed over a membership callable has no kernel
    form: its plain version runs on the CPU, its launch parameters
    raise."""
    from repro_torch.core.domain import BoundingBoxDomain
    d = BoundingBoxDomain(3, 3, member=lambda x, y: x <= y)
    m = torch.zeros((12, 12))
    got = TO.sierpinski_write(m, 1.0, block=4, domain=d,
                              grid_mode="bounding")
    assert float(got.sum()) == 6 * 16
    with pytest.raises(ValueError, match="membership callable"):
        TP.GridPlan(d, backend="cpu").launch_params(12, 4, "cpu")


# ---------------------------------------------------------------------------
# CA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("name", ROW_DOMAINS)
@pytest.mark.parametrize("rule", ["parity", "diffusion"])
def test_ca_domain_equal_jax(rule, name, storage):
    """ca_run over lowering x fuse {1, 3} on a row-major domain: the JAX
    package's tile semantics (clamped embedded neighbours, slot (0, 0)
    for an invalid compact neighbour) bit for bit on parity."""
    jd, td = _domains(name)
    block = 4
    x = _state(jd, block, storage, seed=7,
               kind="binary" if rule == "parity" else "normal")
    z = np.zeros_like(x)
    for fuse in (1, 3):
        kw = dict(fuse=fuse, rule=rule, alpha=0.2, block=block,
                  storage=storage)
        want = JO.ca_run(jnp.asarray(x), jnp.asarray(z), 4, domain=jd,
                         backend="tpu-interpret", grid_mode="closed_form",
                         **kw)
        outs = [TO.ca_run(torch.from_numpy(x), torch.from_numpy(z), 4,
                          domain=td, grid_mode=lowering, **kw)
                for lowering in LOWERINGS]
        for got in outs:
            assert_rule_close(got, want, rule)
            assert torch.equal(got, outs[0])
    step = TO.ca_step(torch.from_numpy(x), torch.from_numpy(z), rule=rule,
                      alpha=0.2, block=block, grid_mode="mma",
                      storage=storage, domain=td)
    assert_rule_close(step, JO.ca_step(
        jnp.asarray(x), jnp.asarray(z), rule=rule, alpha=0.2, block=block,
        grid_mode="mma", storage=storage, domain=jd,
        backend="tpu-interpret"), rule)


@pytest.mark.parametrize("coarsen", [1, 2])
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("rule", ["parity", "diffusion"])
def test_ca_gasket_mma_equal_jax(rule, storage, coarsen):
    """The fractal CA under mma (own slot and neighbour slots from the
    chains), fuse 3, against the JAX package's mma run."""
    from torch_parity import fractal_state, pair
    n, block = 32, 4
    x = fractal_state("sierpinski-gasket", n, rule == "parity", seed=3)
    ja, ta = pair(x, "sierpinski-gasket", n, block, storage)
    kw = dict(fuse=3, rule=rule, alpha=0.2, block=block, grid_mode="mma",
              storage=storage, coarsen=coarsen)
    if storage == "compact":
        kw["n"] = n
    want = JO.ca_run(ja, jnp.zeros_like(ja), 5, backend="tpu-interpret", **kw)
    got = TO.ca_run(ta, torch.zeros_like(ta), 5, **kw)
    assert_rule_close(got, want, rule)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("shape", ["tall-box", "rect-band"])
def test_nonsquare_domains_equal_jax(shape, storage):
    """A bounding box taller than wide (the CA's in-range square then
    reaches past the box: the JAX package clamps the neighbour tile) and
    the rectangular decode band, under every lowering."""
    from repro.core.domain import BandDomain as JBand
    from repro.core.domain import BoundingBoxDomain as JBox
    from repro_torch.core.domain import BandDomain as TBand
    from repro_torch.core.domain import BoundingBoxDomain as TBox
    jd, td = ((JBox(3, 6), TBox(3, 6)) if shape == "tall-box"
              else (JBand(8, 3, 20), TBand(8, 3, 20)))
    block = 4
    x = _state(jd, block, storage, seed=5, kind="binary")
    z = np.zeros_like(x)
    jkw = dict(block=block, grid_mode="closed_form", storage=storage,
               domain=jd, backend="tpu-interpret")
    want_ca = np.asarray(JO.ca_run(jnp.asarray(x), jnp.asarray(z), 3,
                                   fuse=3, **jkw))
    want_w = np.asarray(JO.sierpinski_write(jnp.asarray(x), 5.0, **jkw))
    for lowering in LOWERINGS:
        kw = dict(block=block, grid_mode=lowering, storage=storage)
        got = TO.ca_run(torch.from_numpy(x), torch.from_numpy(z), 3, fuse=3,
                        domain=td, **kw)
        np.testing.assert_array_equal(got.numpy(), want_ca)
        got = TO.sierpinski_write(torch.from_numpy(x), 5.0, domain=td, **kw)
        np.testing.assert_array_equal(got.numpy(), want_w)
