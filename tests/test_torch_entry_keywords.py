"""The write, sum and CA entry points take the JAX package's keywords.

``num_stages``, ``mesh``, ``shard_axis`` and ``verify`` are in the
reference's signatures (``repro.kernels.sierpinski_write`` /
``sierpinski_ca``).  The port takes them all: ``verify=True`` verifies
the plan and gives the bits of the call without it (the reference's
``verify=True`` call runs beside it), a ``mesh`` that is not a mesh
raises the reference's own error (an object with no ``shape``:
``AttributeError``), ``shard_axis`` alone changes nothing, ``"auto"`` on
an untuned problem gives the reference's defaults, and write and sum,
which have no ring, give the bits of the call without ``num_stages`` at
every integer depth.
(Sharded runs on real meshes: ``tests/test_torch_mesh.py``.)
"""
import importlib
import inspect

import pytest
import torch

from torch_parity import isolate_tune_caches

JW = importlib.import_module("repro.kernels.sierpinski_write")
JCA = importlib.import_module("repro.kernels.sierpinski_ca")
TW = importlib.import_module("repro_torch.kernels.sierpinski_write")
TCA = importlib.import_module("repro_torch.kernels.sierpinski_ca")

N, BLOCK = 16, 4
KEYWORDS = ("num_stages", "mesh", "shard_axis", "verify")


def _state():
    g = torch.Generator().manual_seed(7)
    return torch.randint(-8, 9, (N, N), generator=g).to(torch.float32)


def _call(entry, **kw):
    m = _state()
    if entry == "sierpinski_write":
        return TW.sierpinski_write(m, 2.5, block=BLOCK, **kw)
    if entry == "sierpinski_write_":
        return TW.sierpinski_write_(m, 2.5, block=BLOCK, **kw)
    if entry == "sierpinski_sum":
        return TW.sierpinski_sum(m, block=BLOCK, **kw)
    zeros = torch.zeros_like(m)
    if entry == "ca_run":
        return TCA.ca_run(TCA.ca_step(m, zeros, block=BLOCK), zeros, 3,
                          block=BLOCK, **kw)
    return TCA.ca_step(m, zeros, block=BLOCK, **kw)


ENTRIES = ("sierpinski_write", "sierpinski_write_", "sierpinski_sum",
           "ca_run", "ca_step")
def _call_ref(entry, **kw):
    """The reference's call of ``entry`` on the same state."""
    import jax.numpy as jnp
    m = jnp.asarray(_state().numpy())
    if entry in ("sierpinski_write", "sierpinski_write_"):
        return JW.sierpinski_write(m, 2.5, block=BLOCK, **kw)
    if entry == "sierpinski_sum":
        return JW.sierpinski_sum(m, block=BLOCK, **kw)
    zeros = jnp.zeros_like(m)
    if entry == "ca_run":
        return JCA.ca_run(m, zeros, 3, block=BLOCK, **kw)
    return JCA.ca_step(m, zeros, block=BLOCK, **kw)


#: (keywords, the roadmap item named or the reference's own error, or
#: None: the call's bits stand)
CASES = [(dict(num_stages="auto"), None), (dict(coarsen="auto"), None),
         (dict(mesh=object()), AttributeError),
         (dict(mesh=object(), shard_axis="model"), AttributeError),
         (dict(verify=True), None), (dict(shard_axis="model"), None),
         (dict(verify=False, mesh=None), None), (dict(num_stages=1), None),
         (dict(num_stages=3), None)]


@pytest.mark.parametrize("kw,item", CASES, ids=[
    "-".join(f"{k}={'mesh' if k == 'mesh' and v is not None else v}"
             for k, v in c.items()) for c, _ in CASES])
@pytest.mark.parametrize("entry", ENTRIES)
def test_unported_keywords_name_their_roadmap_item(entry, kw, item,
                                                   monkeypatch, tmp_path):
    isolate_tune_caches(monkeypatch, tmp_path)  # "auto" misses
    if isinstance(item, type):
        # an object that is not a mesh: the reference's own error
        with pytest.raises(item):
            _call_ref(entry, **kw)
        with pytest.raises(item):
            _call(entry, **kw)
        return
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            _call(entry, **kw)
        return
    if kw.get("verify"):
        # the reference verifies the same plan and runs
        assert _call_ref(entry, **kw) is not None
    # write and sum have no ring, the CA's depths give the same bits, an
    # untuned "auto" is the default, and verify= changes nothing
    assert torch.equal(_call(entry, **kw), _call(entry))


@pytest.mark.parametrize("entry", ["sierpinski_write", "sierpinski_sum"])
def test_ring_free_entries_refuse_other_depths(entry):
    for bad in (0, -2, 1.5, True):
        with pytest.raises(ValueError, match="num_stages"):
            _call(entry, num_stages=bad)


@pytest.mark.parametrize("port,ref", [
    (TW.sierpinski_write_, JW.sierpinski_write),
    (TW.sierpinski_sum, JW.sierpinski_sum),
    (TCA.ca_run, JCA.ca_run), (TCA.ca_step, JCA.ca_step)])
def test_the_reference_keywords_are_taken(port, ref):
    have = inspect.signature(port).parameters
    for name in KEYWORDS:
        assert name in inspect.signature(ref).parameters
        assert name in have and have[name].kind == \
            inspect.Parameter.KEYWORD_ONLY
    assert have["shard_axis"].default == \
        inspect.signature(ref).parameters["shard_axis"].default
