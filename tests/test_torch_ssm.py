"""The port's state-space blocks (``repro_torch.models.ssm``) against the
JAX package's ``repro.models.ssm`` on the same numpy inputs and
weights: the causal conv and its decode step (K = 1 included), both
scans against ``repro``'s chunked form and its sequential ``*_ref``
(with ``h0`` and ``return_state``, and the same ValueError for a ragged
S), the Mamba-1 / Mamba-2 blocks with their caches, decode steps
against ``repro``'s and against the port's own prefill (as
tests/test_ssm.py), decode steps that leave the cache they are given
untouched, and the chunked scans' gradients against ``jax.grad``.

SSM_TOL is the reference's own (tests/test_ssm.py: rtol 1e-4 / atol
1e-5); the largest difference seen is ~1e-6.  The decode-vs-prefill
check of Mamba-2 uses tests/test_ssm.py's atol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import ssm as TS
from repro_torch.models.config import ModelConfig as TConfig
from torch_parity import as_f32

SSM_TOL = dict(rtol=1e-4, atol=1e-5)
#: gradients of the scans: each leaf's largest error against GRAD_TOL
#: times its largest magnitude (tests/test_torch_train.py's rule)
GRAD_TOL = 1e-5


def _close(got, want, tol=SSM_TOL):
    np.testing.assert_allclose(as_f32(got), np.asarray(want), **tol)


def _pair(*arrays):
    """(jax arrays, torch tensors) of the same f32 numpy arrays."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a.copy()) for a in arrays])


def _s6_inputs(b, s, di, n, seed):
    rng = np.random.default_rng(seed)
    return _pair(rng.normal(size=(b, s, di)),
                 rng.uniform(0.001, 0.1, size=(b, s, di)),
                 -rng.uniform(0.5, 2, size=(di, n)),
                 rng.normal(size=(b, s, n)), rng.normal(size=(b, s, n)))


def _ssd_inputs(b, s, nh, p, n, seed):
    rng = np.random.default_rng(seed)
    return _pair(rng.normal(size=(b, s, nh, p)),
                 rng.uniform(0.001, 0.5, size=(b, s, nh)),
                 -rng.uniform(0.5, 2, size=(nh,)),
                 rng.normal(size=(b, s, n)), rng.normal(size=(b, s, n)))


SCANS = {"selective": (JS.selective_scan, JS.selective_scan_ref,
                       TS.selective_scan, TS.selective_scan_ref,
                       lambda seed: _s6_inputs(2, 64, 16, 8, seed),
                       lambda b: (b, 16, 8)),
         "ssd": (JS.ssd_scan, JS.ssd_scan_ref, TS.ssd_scan, TS.ssd_scan_ref,
                 lambda seed: _ssd_inputs(2, 64, 4, 8, 16, seed),
                 lambda b: (b, 4, 16, 8))}


# ---------------------------------------------------------------------------
# the causal conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 4])
def test_causal_conv_and_conv_step_match_jax(k):
    rng = np.random.default_rng(k)
    (jx, jw, jb), (tx, tw, tb) = _pair(rng.normal(size=(2, 8, 4)),
                                       rng.normal(size=(4, k)),
                                       rng.normal(size=(4,)))
    full = TS.causal_conv1d(tx, tw, tb)
    _close(full, JS.causal_conv1d(jx, jw, jb))
    jstate = jnp.zeros((2, k - 1, 4), jnp.float32)
    tstate = torch.zeros((2, k - 1, 4))
    for t in range(8):
        jy, jstate = JS.conv_step(jstate, jx[:, t:t + 1], jw, jb)
        before = tstate.clone()
        ty, new = TS.conv_step(tstate, tx[:, t:t + 1], tw, tb)
        assert torch.equal(tstate, before)          # the state passed in
        assert tuple(new.shape) == tuple(jstate.shape) == (2, k - 1, 4)
        _close(ty, jy)
        _close(new, jstate)
        _close(ty[:, 0], full[:, t].numpy())
        tstate = new


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(SCANS))
@pytest.mark.parametrize("chunk", [8, 64])
def test_scan_matches_jax_chunked_and_sequential(kind, chunk):
    jscan, jref, tscan, tref, inputs, _ = SCANS[kind]
    jin, tin = inputs(chunk)
    got = tscan(*tin, chunk=chunk)
    _close(got, jscan(*jin, chunk=chunk))
    _close(got, jref(*jin))
    _close(tref(*tin), jref(*jin))


def _cut(inputs, sl):
    """(x, dt, A, B, C) with every sequence-carrying input cut to
    positions ``sl`` (A has none)."""
    return [t if i == 2 else t[:, sl] for i, t in enumerate(inputs)]


@pytest.mark.parametrize("kind", sorted(SCANS))
def test_scan_state_in_and_out_and_ragged_length(kind):
    """h0 and return_state: two halves chained through the state equal
    one scan over the whole; the reference's ValueError for an S that
    is no multiple of the chunk."""
    jscan, _, tscan, _, inputs, state_shape = SCANS[kind]
    jin, tin = inputs(7)
    h0 = np.random.default_rng(8).normal(size=state_shape(2)).astype(
        np.float32)
    jy, jh = jscan(*jin, chunk=8, h0=jnp.asarray(h0), return_state=True)
    ty, th = tscan(*tin, chunk=8, h0=torch.from_numpy(h0),
                   return_state=True)
    _close(ty, jy)
    _close(th, jh)
    half, rest = _cut(tin, slice(0, 32)), _cut(tin, slice(32, None))
    y1, h1 = tscan(*half, chunk=16, h0=torch.from_numpy(h0),
                   return_state=True)
    y2, h2 = tscan(*rest, chunk=16, h0=h1, return_state=True)
    _close(torch.cat([y1, y2], 1), np.asarray(jy))
    _close(h2, jh)
    with pytest.raises(ValueError, match="divisible by chunk"):
        tscan(*_cut(tin, slice(0, 60)), chunk=16)
    with pytest.raises(ValueError, match="divisible by chunk"):
        jscan(*_cut(jin, slice(0, 60)), chunk=16)


@pytest.mark.parametrize("kind", sorted(SCANS))
def test_scan_gradients_match_jax(kind):
    """The chunked scan recomputed chunk by chunk in the backward gives
    jax.grad's gradients for every input."""
    jscan, _, tscan, _, inputs, _ = SCANS[kind]
    jin, tin = inputs(3)
    w = np.random.default_rng(4).normal(size=tuple(jin[0].shape)).astype(
        np.float32)

    def jloss(*args):
        return jnp.sum(jscan(*args, chunk=16) * w)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(*jin)
    tin = [t.requires_grad_() for t in tin]
    torch.sum(tscan(*tin, chunk=16) * torch.from_numpy(w)).backward()
    for name, t, g in zip("x dt A B C".split(), tin, want):
        err = float(np.abs(t.grad.numpy() - np.asarray(g)).max())
        assert err <= GRAD_TOL * float(np.abs(np.asarray(g)).max()), \
            (name, err)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _cfgs(kind):
    kw = dict(d_model=32, d_state=8, expand=2, conv_kernel=4, ssd_chunk=8,
              dtype="float32", param_dtype="float32")
    if kind == "mamba2":
        kw.update(d_state=16, ssd_head_dim=16)
    return JConfig(**kw), TConfig(**kw)


def _jit(fn):
    """A JAX block or decode step compiled once per config (argument 2)
    and ``return_cache``."""
    names = ("return_cache",) if fn.__name__.endswith("block") else ()
    return jax.jit(fn, static_argnums=(2,), static_argnames=names)


#: kind -> (JAX init, block, decode; the port's module, block, decode)
BLOCKS = {"mamba1": (JS.mamba1_init, _jit(JS.mamba1_block),
                     _jit(JS.mamba1_decode), TS.Mamba1, TS.mamba1_block,
                     TS.mamba1_decode),
          "mamba2": (JS.mamba2_init, _jit(JS.mamba2_block),
                     _jit(JS.mamba2_decode), TS.Mamba2, TS.mamba2_block,
                     TS.mamba2_decode)}


@pytest.fixture(scope="module", params=sorted(BLOCKS))
def blocks(request):
    """A mixer's JAX parameters (``mamba*_init``) and the port's module
    holding them, its configs and a (2, 16, 32) input."""
    jinit, _, _, tmod, _, _ = BLOCKS[request.param]
    jcfg, tcfg = _cfgs(request.param)
    jp = jax.jit(jinit, static_argnums=(1,))(jax.random.PRNGKey(0), jcfg)
    m = tmod(tcfg, "cpu")
    assert set(dict(m.named_parameters())) == set(jp)
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_(torch.from_numpy(np.array(jp[name], np.float32)))
    x = np.random.default_rng(11).normal(size=(2, 16, 32)).astype(
        np.float32)
    return request.param, jcfg, jp, tcfg, m, x


def _zero_cache(cfg, kind, b=2):
    if kind == "mamba1":
        return (np.zeros((b, cfg.d_inner, cfg.d_state), np.float32),
                np.zeros((b, cfg.conv_kernel - 1, cfg.d_inner), np.float32))
    return (np.zeros((b, cfg.ssd_heads, cfg.d_state, cfg.ssd_head_dim),
                     np.float32),
            np.zeros((b, cfg.conv_kernel - 1,
                      cfg.d_inner + 2 * cfg.d_state), np.float32))


def test_block_with_cache_matches_jax(blocks):
    kind, jcfg, jp, tcfg, m, x = blocks
    _, jblock, _, _, tblock, _ = BLOCKS[kind]
    jy, (jh, jconv) = jblock(jp, jnp.asarray(x), jcfg, return_cache=True)
    ty, (th, tconv) = tblock(m, torch.from_numpy(x), tcfg,
                             return_cache=True)
    _close(ty, jy)
    _close(th, jh)
    _close(tconv, jconv)
    assert th.dtype == torch.float32
    _close(tblock(m, torch.from_numpy(x), tcfg), jy)
    # a prompt shorter than the conv window: the cache is zero-padded
    jy, (_, jconv) = jblock(jp, jnp.asarray(x[:, :2]), jcfg,
                            return_cache=True)
    ty, (_, tconv) = tblock(m, torch.from_numpy(x[:, :2]), tcfg,
                            return_cache=True)
    _close(ty, jy)
    _close(tconv, jconv)


def test_decode_matches_jax_and_own_prefill(blocks):
    """16 decode steps from zero caches against the JAX package's decode
    and the port's one-shot block (tests/test_ssm.py's consistency
    checks); every step leaves the cache it was given untouched."""
    kind, jcfg, jp, tcfg, m, x = blocks
    _, _, jdecode, _, tblock, tdecode = BLOCKS[kind]
    y_all, (h_all, _) = tblock(m, torch.from_numpy(x), tcfg,
                               return_cache=True)
    jc = tuple(jnp.asarray(c) for c in _zero_cache(jcfg, kind))
    tc = tuple(torch.from_numpy(c) for c in _zero_cache(tcfg, kind))
    ys = []
    for t in range(16):
        jy, jc = jdecode(jp, jnp.asarray(x[:, t:t + 1]), jcfg, jc)
        before = tuple(c.clone() for c in tc)
        ty, new = tdecode(m, torch.from_numpy(x[:, t:t + 1]), tcfg, tc)
        assert all(torch.equal(a, b) for a, b in zip(tc, before))
        assert not any(a.data_ptr() == b.data_ptr() for a, b in
                       zip(new, tc))
        _close(ty, jy)
        _close(new[0], jc[0])
        _close(new[1], jc[1])
        ys.append(ty)
        tc = new
    tol = SSM_TOL if kind == "mamba1" else dict(rtol=1e-4, atol=1e-4)
    _close(torch.cat(ys, 1), y_all.numpy(), tol)
    _close(tc[0], h_all.numpy(), tol)


def test_init_matches_jax_scales(blocks):
    kind, jcfg, jp, tcfg, _, _ = blocks
    m = BLOCKS[kind][3](tcfg, "cpu")
    getattr(TS, f"init_{kind}")(m, torch.Generator().manual_seed(0))
    for name, p in m.named_parameters():
        want = np.asarray(jp[name])
        assert tuple(p.shape) == want.shape, name
        if name in ("A_log", "dt_bias", "D", "conv_b", "norm_scale"):
            np.testing.assert_allclose(p.numpy(), want, rtol=1e-6,
                                       err_msg=name)
        else:   # random: the same scale
            std, jstd = float(p.std()), float(want.std())
            assert abs(std - jstd) < 0.25 * jstd, (name, std, jstd)
