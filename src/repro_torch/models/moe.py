"""Mixture-of-Experts FFN with top-k routing, shared experts and
capacity-bounded sort-based dispatch: the JAX package's
``repro.models.moe``.

Dispatch: every (token, slot) pair is ranked within its expert's queue
by a stable argsort of the flat expert assignment; ranks at or past the
capacity are dropped (their gate mass is lost, "token dropping").  The
kept tokens are added into an (E*C + 1, D) buffer whose last row takes
the dropped ones, the experts run as one batched SwiGLU over
(E, C, D) x (E, D, F), and the results are gathered back weighted by the
renormalised top-k gates.  Every expert runs its C rows whether or not
tokens filled them (C >= 8), so a step reads all the experts' weights.

The products are plain batched matrix products (``torch.bmm``), as the
JAX package computes them outside any Pallas kernel.

Training on a mesh routes the global batch, as the JAX package's GSPMD
step does: every DP rank gathers every rank's tokens
(:func:`~repro_torch.distributed.sharding.global_tokens`), so the
capacity, each token's rank within its expert and the aux loss follow
all of them, and keeps its own rows of the result; the shared experts
run on its own rows.  Under ``fsdp`` the experts stay cut along their
hidden dimension over the DP axes: each DP rank runs its part of every
expert's SwiGLU on the same dispatch buffer and the parts are added
(:func:`~repro_torch.distributed.tensor_parallel.expert_sum`), so no
rank holds the whole experts.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.distributed.sharding import (constrain, global_tokens,
                                              local_rows)

from . import layers as L

F32 = torch.float32


class MoE(nn.Module):
    """Parameters of one MoE FFN under the JAX package's names: the
    router (f32 whatever the parameter dtype), the stacked experts
    ``wi``, ``wg`` (E, D, F) and ``wo`` (E, F, D), and the shared
    experts' SwiGLU ``shared`` (width F * n_shared_experts)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dt = cfg.tparam_dtype()
        d, e = cfg.d_model, cfg.n_experts
        fe = cfg.d_ff_expert or cfg.d_ff
        self.router = L._param((d, e), F32, device)
        self.wi = L._param((e, d, fe), dt, device)
        self.wg = L._param((e, d, fe), dt, device)
        self.wo = L._param((e, fe, d), dt, device)
        if cfg.n_shared_experts:
            self.shared = L.MLP(d, fe * cfg.n_shared_experts, dt, device)


def init_moe(m: MoE, generator) -> None:
    """The JAX package's ``moe_init`` scales: normals times 1/sqrt(D)
    (``wo``: 1/sqrt(F)), drawn in place in each parameter's dtype."""
    d = m.wi.shape[1]
    L._normal_(m.router, generator, 1.0 / math.sqrt(d))
    L._normal_(m.wi, generator, 1.0 / math.sqrt(d))
    L._normal_(m.wg, generator, 1.0 / math.sqrt(d))
    L._normal_(m.wo, generator, 1.0 / math.sqrt(m.wo.shape[1]))
    if hasattr(m, "shared"):
        L.init_mlp(m.shared, generator)


def _capacity(n_tokens: int, cfg) -> int:
    c = int(math.ceil(cfg.capacity_factor * n_tokens * cfg.top_k
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # pad to multiple of 8


def route(m: MoE, xf, cfg):
    """The f32 router over the (N, D) tokens ``xf``: returns (probs
    (N, E), renormalised gates (N, k), expert indices (N, k))."""
    logits = xf.to(F32) @ m.router
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gates / torch.sum(gates, -1, keepdim=True), idx


def _shared(m: MoE, xf, out):
    if hasattr(m, "shared"):
        out = out + L.mlp(m.shared, xf)
    return out


def moe_block(m: MoE, x, cfg):
    """x: (B,S,D) -> (out (B,S,D), aux_loss ()), the JAX package's
    ``moe_block``; the capacity follows B * S."""
    x_rows = x
    x, rows = global_tokens(x)
    b, s, d = x.shape
    n = b * s
    k, e = cfg.top_k, cfg.n_experts
    cap = _capacity(n, cfg)
    xf = constrain(x.reshape(n, d), "moe_tokens")
    probs, gates, idx = route(m, xf, cfg)

    # load-balance aux loss (Switch): E * mean(frac_tokens * frac_probs)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.nn.functional.one_hot(idx[:, 0], e).to(F32), dim=0)
    aux = e * torch.sum(me * ce)

    # --- sort-based within-expert ranking --------------------------------
    flat_e = idx.reshape(-1)                                    # (N*k,)
    sort_i = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_i]
    starts = torch.searchsorted(
        sorted_e, torch.arange(e, device=x.device, dtype=sorted_e.dtype),
        side="left")
    rank_sorted = torch.arange(n * k, device=x.device) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, sort_i, rank_sorted)
    keep = rank < cap
    slot = torch.where(keep, flat_e * cap + rank, e * cap)      # drop slot

    # --- dispatch ---------------------------------------------------------
    token_id = torch.arange(n, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, slot, xf[token_id])
    he = constrain(buf[:e * cap].reshape(e, cap, d), "moe_experts")

    # --- expert SwiGLU ----------------------------------------------------
    gate = torch.nn.functional.silu(torch.bmm(he, m.wg.to(x.dtype)))
    up = torch.bmm(he, m.wi.to(x.dtype))
    y = tp_lib.expert_sum(m, torch.bmm(gate * up, m.wo.to(x.dtype)))
    y = constrain(y, "moe_experts")
    y = y.reshape(e * cap, d)
    y = torch.cat([y, y.new_zeros((1, d))], dim=0)

    # --- combine ----------------------------------------------------------
    ys = y[slot] * (gates.reshape(-1)[:, None].to(y.dtype) * keep[:, None])
    ys = constrain(ys, "moe_tokens")
    out = constrain(torch.sum(ys.reshape(n, k, d), dim=1), "moe_tokens")
    out = local_rows(out.reshape(b, s, d), rows)
    out = _shared(m, x_rows.reshape(-1, d), out.reshape(-1, d))
    return out.reshape(x_rows.shape), aux * cfg.router_aux_weight


def moe_block_dense_ref(m: MoE, x, cfg):
    """Oracle: every expert on every token, combined with the same top-k
    renormalised gates, no capacity dropping.  O(E) FLOPs -- checks
    only."""
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    _, gates, idx = route(m, xf, cfg)
    gfull = torch.zeros((n, cfg.n_experts), dtype=F32, device=x.device)
    gfull.scatter_(1, idx, gates)
    hg = torch.nn.functional.silu(
        torch.einsum("nd,edf->nef", xf, m.wg.to(x.dtype)))
    hu = torch.einsum("nd,edf->nef", xf, m.wi.to(x.dtype))
    ye = torch.einsum("nef,efd->ned", hg * hu, m.wo.to(x.dtype))
    out = torch.einsum("ned,ne->nd", ye.to(F32), gfull).to(x.dtype)
    out = _shared(m, xf, out)
    return out.reshape(b, s, d)
