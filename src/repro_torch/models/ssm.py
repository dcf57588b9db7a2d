"""State-space blocks: Mamba-1 (falcon-mamba) selective scan and
Mamba-2 / SSD (zamba2), both in chunked forms whose memory is bounded by
one chunk, O(B * chunk * d * N): the JAX package's ``repro.models.ssm``.

Each scan has a naive sequential reference (``*_scan_ref``) used by the
tests.  Inside a chunk the Mamba-1 scan combines ``(decay, input)``
pairs in ``log2(chunk)`` whole-tensor steps (Hillis-Steele; the JAX
package's ``lax.associative_scan``); SSD's intra-chunk part is one
(L, L) masked-decay product.  The chunks run in sequence, carrying the
state; with gradients on, each chunk is recomputed in the backward, so
autograd keeps only the states between chunks.  No kernel lies on
these paths, as in the JAX package (XLA code there, plain torch here).

Decode steps carry ``(ssm_state, conv_state)`` caches and return new
ones: the states passed in are never written, so a decode step rerun
on the same cache (a guarded retry, the ladder's next rung) gives the
same result.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L

F32 = torch.float32


# ---------------------------------------------------------------------------
# causal depthwise conv1d
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, b):
    """x: (B,S,C); w: (C,K); b: (C,).  Causal: output t sees x[t-K+1..t]."""
    k = w.shape[1]
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))
    return F.conv1d(xp, w[:, None, :], b, groups=w.shape[0]).transpose(1, 2)


def conv_step(conv_state, x_new, w, b):
    """Decode: conv_state (B, K-1, C), x_new (B, 1, C) -> (y, new_state);
    the new state is a new tensor."""
    k = w.shape[1]
    window = torch.cat([conv_state, x_new], dim=1)          # (B,K,C)
    y = torch.einsum("bkc,ck->bc", window, w) + b[None, :]
    return y[:, None, :], window[:, window.shape[1] - (k - 1):, :]


def _conv_cache(x1, k):
    """The last K-1 conv inputs of a prefill (zero-padded in front when
    S < K-1), copied so they hold nothing else of ``x1`` alive."""
    s = x1.shape[1]
    if s >= k - 1:
        return x1[:, s - (k - 1):, :].clone()
    return F.pad(x1, (0, 0, k - 1 - s, 0))


def _chunked(step, h, xs, chunk):
    """Run ``step(h, *chunk_slices) -> (h, y)`` over the chunks of the
    sequence axis (1) of every tensor in ``xs``; returns (h, the ys
    concatenated).  With gradients on, each chunk is recomputed in the
    backward."""
    s = xs[0].shape[1]
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (h,) + tuple(xs))
    ys = []
    for c in range(0, s, chunk):
        args = (h,) + tuple(t[:, c:c + chunk] for t in xs)
        if grad:
            h, y = checkpoint(step, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, y = step(*args)
        ys.append(y)
    return h, torch.cat(ys, dim=1)


# ---------------------------------------------------------------------------
# Mamba-1 selective scan
# ---------------------------------------------------------------------------

def selective_scan_ref(x, dt, A, B, C):
    """Sequential oracle.  x,dt: (b,s,di); A: (di,n); B,C: (b,s,n).
    Returns y (b,s,di) in f32."""
    x, dt, B, C = (t.to(F32) for t in (x, dt, B, C))
    A = A.to(F32)
    b, s, di = x.shape
    h = torch.zeros((b, di, A.shape[1]), dtype=F32, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t, :, None] * A[None])           # (b,di,n)
        h = da * h + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        ys.append(torch.sum(h * C[:, t, None, :], -1))        # (b,di)
    return torch.stack(ys, dim=1)


def _prefix_scan(a, u):
    """Inclusive scan along axis 1 of the pairs (a, u) under the
    combine (a1, u1), (a2, u2) -> (a1 a2, a2 u1 + u2), in log2(L)
    whole-tensor steps (Hillis-Steele).  Returns (prod a, scanned u)."""
    n = a.shape[1]
    k = 1
    while k < n:
        u = torch.cat([u[:, :k], torch.addcmul(u[:, k:], a[:, k:],
                                               u[:, :-k])], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return a, u


def _s6_chunk(h, xc, dtc, bc, cc, A):
    """One chunk of the selective scan from state ``h`` (b,di,n):
    returns (the state after it, y (b,L,di))."""
    a = torch.exp(dtc[..., None] * A)                         # (b,L,di,n)
    u = (dtc * xc)[..., None] * bc[:, :, None, :]             # (b,L,di,n)
    acc_a, acc_u = _prefix_scan(a, u)
    del a, u
    hs = torch.addcmul(acc_u, acc_a, h[:, None])              # (b,L,di,n)
    y = torch.sum(hs * cc[:, :, None, :], -1)                 # (b,L,di)
    return hs[:, -1].clone(), y


def selective_scan(x, dt, A, B, C, *, chunk=128, h0=None,
                   return_state=False):
    """Chunked selective scan: a log-step pair scan within each chunk,
    the chunks in sequence.  Shapes as in :func:`selective_scan_ref`;
    raises ValueError when S is no multiple of ``min(chunk, S)``."""
    b, s, di = x.shape
    n = A.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError("seq len must be divisible by chunk")
    x, dt, B, C = (t.to(F32) for t in (x, dt, B, C))
    A = A.to(F32)
    h = h0 if h0 is not None else torch.zeros((b, di, n), dtype=F32,
                                              device=x.device)

    def step(h, xc, dtc, bc, cc):
        return _s6_chunk(h, xc, dtc, bc, cc, A)

    h, y = _chunked(step, h, (x, dt, B, C), chunk)
    return (y, h) if return_state else y


class Mamba1(nn.Module):
    """Mamba-1 mixer parameters under the JAX package's names:
    ``in_proj`` (D, 2 di), ``conv_w`` (di, K), ``conv_b``, ``x_proj``
    (di, dt_rank + 2 N), ``dt_proj`` (dt_rank, di), ``dt_bias``,
    ``A_log`` (di, N), ``D``, ``out_proj`` (di, D)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dt = cfg.tparam_dtype()
        d, di, n, dtr, k = (cfg.d_model, cfg.d_inner, cfg.d_state,
                            cfg.dt_rank_, cfg.conv_kernel)
        self.in_proj = L._param((d, 2 * di), dt, device)
        self.conv_w = L._param((di, k), dt, device)
        self.conv_b = L._param((di,), dt, device)
        self.x_proj = L._param((di, dtr + 2 * n), dt, device)
        self.dt_proj = L._param((dtr, di), dt, device)
        self.dt_bias = L._param((di,), dt, device)
        self.A_log = L._param((di, n), dt, device)
        self.D = L._param((di,), dt, device)
        self.out_proj = L._param((di, d), dt, device)


def _dt_bias_init(p: torch.Tensor) -> None:
    with torch.no_grad():
        p.copy_(torch.full(p.shape, math.log(math.expm1(0.01)), dtype=F32))


def init_mamba1(m: Mamba1, generator) -> None:
    """The JAX package's ``mamba1_init`` scales: the projections normal
    times 1/sqrt(fan-in), ``conv_w`` normal times 0.1, ``conv_b`` 0,
    ``dt_bias`` softplus^-1(0.01), ``A_log`` log(1..N) on every row,
    ``D`` 1."""
    for w in (m.in_proj, m.x_proj, m.dt_proj, m.out_proj):
        L._normal_(w, generator, 1.0 / math.sqrt(w.shape[0]))
    L._normal_(m.conv_w, generator, 0.1)
    with torch.no_grad():
        m.conv_b.zero_()
        n = m.A_log.shape[1]
        m.A_log.copy_(torch.log(torch.arange(1, n + 1, dtype=F32))[None]
                      .expand(m.A_log.shape))
        m.D.fill_(1.0)
    _dt_bias_init(m.dt_bias)


def _mamba1_inner(m: Mamba1, x1, cfg):
    """Common post-conv computation. x1: (B,S,di) already conv+silu'd."""
    n, dtr = cfg.d_state, cfg.dt_rank_
    dbl = x1 @ m.x_proj.to(x1.dtype)
    dt, Bc, Cc = torch.split(dbl, [dtr, n, n], dim=-1)
    dt = F.softplus(dt @ m.dt_proj.to(x1.dtype) + m.dt_bias.to(x1.dtype))
    A = -torch.exp(m.A_log.to(F32))
    return dt, A, Bc, Cc


def mamba1_block(m: Mamba1, x, cfg, *, return_cache=False):
    """x: (B,S,D) -> (B,S,D).  Train/prefill (no incoming state); with
    ``return_cache`` also the (ssm_state f32, conv_state) a decode
    continues from."""
    xz = x @ m.in_proj.to(x.dtype)
    x1, z = torch.chunk(xz, 2, dim=-1)
    if return_cache:
        conv_cache = _conv_cache(x1, cfg.conv_kernel)
    x1 = F.silu(causal_conv1d(x1, m.conv_w.to(x.dtype),
                              m.conv_b.to(x.dtype)))
    dt, A, Bc, Cc = _mamba1_inner(m, x1, cfg)
    y, h = selective_scan(x1, dt, A, Bc, Cc, chunk=cfg.ssd_chunk,
                          return_state=True)
    y = y + x1.to(F32) * m.D.to(F32)
    y = y.to(x.dtype) * F.silu(z)
    out = y @ m.out_proj.to(x.dtype)
    if return_cache:
        return out, (h, conv_cache.to(x.dtype))
    return out


def mamba1_decode(m: Mamba1, x, cfg, cache):
    """x: (B,1,D); cache: (h (B,di,n) f32, conv (B,K-1,di)), left
    untouched.  Returns (out, the new cache)."""
    h, conv_cache = cache
    xz = x @ m.in_proj.to(x.dtype)
    x1, z = torch.chunk(xz, 2, dim=-1)
    x1c, conv_cache = conv_step(conv_cache, x1, m.conv_w.to(x.dtype),
                                m.conv_b.to(x.dtype))
    x1c = F.silu(x1c)
    dt, A, Bc, Cc = _mamba1_inner(m, x1c, cfg)
    xt, dtt = x1c[:, 0].to(F32), dt[:, 0].to(F32)
    bt, ct = Bc[:, 0].to(F32), Cc[:, 0].to(F32)
    da = torch.exp(dtt[..., None] * A[None])
    h = da * h + (dtt * xt)[..., None] * bt[:, None, :]
    y = torch.sum(h * ct[:, None, :], -1) + xt * m.D.to(F32)
    y = y[:, None, :].to(x.dtype) * F.silu(z)
    return y @ m.out_proj.to(x.dtype), (h, conv_cache)


# ---------------------------------------------------------------------------
# Mamba-2 / SSD
# ---------------------------------------------------------------------------

def ssd_scan_ref(x, dt, A, B, C):
    """Sequential oracle.  x: (b,s,nh,P); dt: (b,s,nh); A: (nh,);
    B,C: (b,s,n).  Returns y (b,s,nh,P) f32."""
    x, dt, B, C = (t.to(F32) for t in (x, dt, B, C))
    A = A.to(F32)
    b, s, nh, pdim = x.shape
    h = torch.zeros((b, nh, B.shape[-1], pdim), dtype=F32, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t] * A[None])                    # (b,nh)
        upd = torch.einsum("bn,bhp,bh->bhnp", B[:, t], x[:, t], dt[:, t])
        h = da[..., None, None] * h + upd
        ys.append(torch.einsum("bhnp,bn->bhp", h, C[:, t]))
    return torch.stack(ys, dim=1)


def _segsum(da):
    """(b,L,nh) decay exponents -> (b,i,j,nh): the sum of ``da`` over
    j < k <= i where j <= i, -inf where j > i.  Each segment is summed
    on its own (a cumsum down the masked (L, L) rows), not as cum_i -
    cum_j: that difference of running sums carries their rounding, which
    grows with the sum (at S 512, N 64 it put the chunked scan 1.3e-4
    off its f32 oracle, 17x this form's error)."""
    n = da.shape[1]
    tri = torch.ones((n, n), dtype=torch.bool, device=da.device).tril()
    x = da[:, :, None, :].expand(-1, n, n, -1).masked_fill(
        ~tri.tril(-1)[None, :, :, None], 0.0)
    return torch.cumsum(x, dim=1).masked_fill(~tri[None, :, :, None],
                                              float("-inf"))


def _ssd_chunk(h, xc, dtc, bc, cc, A):
    """One SSD chunk from state ``h`` (b,nh,n,P): the intra-chunk (L,L)
    masked-decay product plus the incoming state's contribution;
    returns (the state after it, y (b,L,nh,P))."""
    da = dtc * A[None, None]                                  # (b,L,nh)
    cum = torch.cumsum(da, dim=1)
    # intra-chunk: scores_ij = (C_i . B_j) * exp(segsum_ij) * dt_j, the
    # masked (j > i) exponents -inf, so neither the value nor its
    # gradient sees an overflowed exp
    decay = torch.exp(_segsum(da))                            # (b,i,j,nh)
    cb = torch.einsum("bin,bjn->bij", cc, bc)                 # (b,L,L)
    w = cb[..., None] * decay * dtc[:, None, :, :]
    y_intra = torch.einsum("bijh,bjhp->bihp", w, xc)
    # inter-chunk: the incoming state's contribution
    y_inter = torch.einsum("bin,bhnp->bihp", cc, h) * \
        torch.exp(cum)[..., None]
    # state update: position j decays by exp(segsum_{L-1, j}) to the end
    edge = decay[:, -1]                                       # (b,L,nh)
    upd = torch.einsum("bjn,bjhp->bhnp", bc,
                       xc * (edge * dtc)[..., None])
    h_new = h * torch.exp(cum[:, -1])[..., None, None] + upd
    return h_new, y_intra + y_inter


def ssd_scan(x, dt, A, B, C, *, chunk=128, h0=None, return_state=False):
    """Chunked SSD (Mamba-2): intra-chunk an (L,L) masked-decay product,
    the state carried across chunks.  Shapes as in :func:`ssd_scan_ref`;
    raises ValueError when S is no multiple of ``min(chunk, S)``."""
    b, s, nh, pdim = x.shape
    n = B.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError("seq len must be divisible by chunk")
    x, dt, B, C = (t.to(F32) for t in (x, dt, B, C))
    A = A.to(F32)
    h = h0 if h0 is not None else torch.zeros((b, nh, n, pdim), dtype=F32,
                                              device=x.device)

    def step(h, xc, dtc, bc, cc):
        return _ssd_chunk(h, xc, dtc, bc, cc, A)

    h, y = _chunked(step, h, (x, dt, B, C), chunk)
    return (y, h) if return_state else y


class Mamba2(nn.Module):
    """Mamba-2 mixer parameters under the JAX package's names:
    ``in_proj`` (D, 2 di + 2 N + heads: z, x, B, C, dt), ``conv_w``
    (di + 2 N, K), ``conv_b``, ``A_log``, ``D``, ``dt_bias`` (heads,),
    ``norm_scale`` (di,), ``out_proj`` (di, D)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dt = cfg.tparam_dtype()
        d, di, n, nh, k = (cfg.d_model, cfg.d_inner, cfg.d_state,
                           cfg.ssd_heads, cfg.conv_kernel)
        self.in_proj = L._param((d, 2 * di + 2 * n + nh), dt, device)
        self.conv_w = L._param((di + 2 * n, k), dt, device)
        self.conv_b = L._param((di + 2 * n,), dt, device)
        self.A_log = L._param((nh,), dt, device)
        self.D = L._param((nh,), dt, device)
        self.dt_bias = L._param((nh,), dt, device)
        self.norm_scale = L._param((di,), dt, device)
        self.out_proj = L._param((di, d), dt, device)


def init_mamba2(m: Mamba2, generator) -> None:
    """The JAX package's ``mamba2_init`` scales: the projections normal
    times 1/sqrt(fan-in), ``conv_w`` normal times 0.1, ``conv_b`` 0,
    ``A_log`` log(linspace(1, 16, heads)), ``D`` 1, ``dt_bias``
    softplus^-1(0.01), ``norm_scale`` 1."""
    for w in (m.in_proj, m.out_proj):
        L._normal_(w, generator, 1.0 / math.sqrt(w.shape[0]))
    L._normal_(m.conv_w, generator, 0.1)
    with torch.no_grad():
        m.conv_b.zero_()
        m.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, m.A_log.shape[0],
                                               dtype=F32)))
        m.D.fill_(1.0)
        m.norm_scale.fill_(1.0)
    _dt_bias_init(m.dt_bias)


def _mamba2_split(m: Mamba2, x, cfg):
    di, n, nh = cfg.d_inner, cfg.d_state, cfg.ssd_heads
    zxbcdt = x @ m.in_proj.to(x.dtype)
    return torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)  # z, xBC, dt


def _gated_norm(m: Mamba2, y, z, eps):
    return L.rmsnorm_scale(m.norm_scale, y * F.silu(z), eps)


def mamba2_block(m: Mamba2, x, cfg, *, return_cache=False):
    """x: (B,S,D) -> (B,S,D).  Train/prefill (no incoming state); with
    ``return_cache`` also the (ssm_state f32, conv_state) a decode
    continues from."""
    b, s, _ = x.shape
    di, n, nh, pdim = cfg.d_inner, cfg.d_state, cfg.ssd_heads, \
        cfg.ssd_head_dim
    z, xBC, dt = _mamba2_split(m, x, cfg)
    if return_cache:
        conv_cache = _conv_cache(xBC, cfg.conv_kernel)
    xBC = F.silu(causal_conv1d(xBC, m.conv_w.to(x.dtype),
                               m.conv_b.to(x.dtype)))
    x1, Bc, Cc = torch.split(xBC, [di, n, n], dim=-1)
    xh = x1.reshape(b, s, nh, pdim)
    dt = F.softplus(dt.to(F32) + m.dt_bias.to(F32))
    A = -torch.exp(m.A_log.to(F32))
    y, h = ssd_scan(xh, dt, A, Bc, Cc, chunk=cfg.ssd_chunk,
                    return_state=True)
    y = y + xh.to(F32) * m.D.to(F32)[None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = _gated_norm(m, y, z, cfg.norm_eps)
    out = y @ m.out_proj.to(x.dtype)
    if return_cache:
        return out, (h, conv_cache.to(x.dtype))
    return out


def mamba2_decode(m: Mamba2, x, cfg, cache):
    """x: (B,1,D); cache: (h (B,heads,N,P) f32, conv (B,K-1,di+2N)), left
    untouched.  Returns (out, the new cache)."""
    b = x.shape[0]
    di, n, nh, pdim = cfg.d_inner, cfg.d_state, cfg.ssd_heads, \
        cfg.ssd_head_dim
    h, conv_cache = cache
    z, xBC, dt = _mamba2_split(m, x, cfg)
    xBCc, conv_cache = conv_step(conv_cache, xBC, m.conv_w.to(x.dtype),
                                 m.conv_b.to(x.dtype))
    xBCc = F.silu(xBCc)
    x1, Bc, Cc = torch.split(xBCc, [di, n, n], dim=-1)
    xt = x1[:, 0].reshape(b, nh, pdim).to(F32)
    dtt = F.softplus(dt[:, 0].to(F32) + m.dt_bias.to(F32))
    A = -torch.exp(m.A_log.to(F32))
    bt, ct = Bc[:, 0].to(F32), Cc[:, 0].to(F32)
    da = torch.exp(dtt * A[None])
    h = da[..., None, None] * h + torch.einsum("bn,bhp,bh->bhnp", bt, xt,
                                               dtt)
    y = torch.einsum("bhnp,bn->bhp", h, ct) + \
        xt * m.D.to(F32)[None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    y = _gated_norm(m, y, z, cfg.norm_eps)
    return y @ m.out_proj.to(x.dtype), (h, conv_cache)
