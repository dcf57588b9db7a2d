"""Building blocks of the LM stack: norms, RoPE, the SwiGLU MLP, the GQA
attention block (train, prefill, contiguous decode, paged decode),
embeddings and the LM head (MLA and MoE live in :mod:`.mla` and
:mod:`.moe`).

Parameters live in small ``nn.Module``\\ s whose parameter names are the
JAX package's pytree leaves (``wq``, ``scale``, ``table``, ...), so a
JAX parameter tree carries across by name
(:mod:`repro_torch.models.convert`).  The functions take those modules
and tensors, as the JAX functions take parameter dicts and arrays.
Matrices are stored (d_in, d_out) and applied as ``x @ w``, cast to the
activation dtype first, as in the JAX package.

On a model laid out on a mesh (:func:`repro_torch.distributed.sharding.
shard_model`) the attention block, the MLP, the embedding and the LM
head of a module tagged tensor-parallel compute on the rank's pieces
and add or gather over the model axis
(:mod:`repro_torch.distributed.tensor_parallel`); head counts come from
the projections' shapes, so a rank's attention runs over its own heads.
Any other module is called with its gathered copy (``at_use``) and runs
as on one device.  Under ``cfg.megatron_sp`` the MLP hidden and the
attention heads pass ``constrain`` where the JAX package pins them: a
tensor-parallel module already holds them as the rank's pieces.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.distributed.sharding import constrain

from . import attention as attn_lib

F32 = torch.float32


# ---------------------------------------------------------------------------
# parameter modules
# ---------------------------------------------------------------------------

def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, d, dtype=F32, device=None):
        super().__init__()
        self.scale = _param((d,), dtype, device)


class MLP(nn.Module):
    """SwiGLU: wo(silu(x wg) * (x wi))."""

    def __init__(self, d, f, dtype=F32, device=None):
        super().__init__()
        self.wi = _param((d, f), dtype, device)
        self.wg = _param((d, f), dtype, device)
        self.wo = _param((f, d), dtype, device)


class Attention(nn.Module):
    """GQA projections (and biases when ``cfg.qkv_bias``)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dt = cfg.tparam_dtype()
        d, hd = cfg.d_model, cfg.hd
        hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        self.wq = _param((d, hq), dt, device)
        self.wk = _param((d, hkv), dt, device)
        self.wv = _param((d, hkv), dt, device)
        self.wo = _param((hq, d), dt, device)
        if cfg.qkv_bias:
            self.bq = _param((hq,), dt, device)
            self.bk = _param((hkv,), dt, device)
            self.bv = _param((hkv,), dt, device)


class Embed(nn.Module):
    def __init__(self, vocab, d, dtype=F32, device=None):
        super().__init__()
        self.table = _param((vocab, d), dtype, device)


class LMHead(nn.Module):
    def __init__(self, d, vocab, dtype=F32, device=None):
        super().__init__()
        self.w = _param((d, vocab), dtype, device)


# ---------------------------------------------------------------------------
# init (the JAX package's shapes and scales, from an explicit generator)
# ---------------------------------------------------------------------------

def _normal_(p: torch.Tensor, generator, scale: float) -> None:
    with torch.no_grad():
        p.normal_(0.0, 1.0, generator=generator).mul_(scale)


def init_attention(m: Attention, generator) -> None:
    d_in = m.wq.shape[0]
    for w in (m.wq, m.wk, m.wv):
        _normal_(w, generator, 1.0 / np.sqrt(d_in))
    _normal_(m.wo, generator, 1.0 / np.sqrt(m.wo.shape[0]))
    for name in ("bq", "bk", "bv"):
        if hasattr(m, name):
            getattr(m, name).data.zero_()


def init_mlp(m: MLP, generator) -> None:
    _normal_(m.wi, generator, 1.0 / np.sqrt(m.wi.shape[0]))
    _normal_(m.wg, generator, 1.0 / np.sqrt(m.wg.shape[0]))
    _normal_(m.wo, generator, 1.0 / np.sqrt(m.wo.shape[0]))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_scale(scale: torch.Tensor, x, eps=1e-6):
    """RMS norm over the last dim with a bare ``scale`` tensor (MLA's
    ``q_norm`` / ``kv_norm``, which the JAX package keeps as leaves, not
    as ``{"scale": ...}`` dicts)."""
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(F32)).to(x.dtype)


def rmsnorm(norm: RMSNorm, x, eps=1e-6):
    return rmsnorm_scale(norm.scale, x, eps)


# ---------------------------------------------------------------------------
# RoPE (rotate-half convention)
# ---------------------------------------------------------------------------

def _freqs(d: int, theta: float, device):
    return theta ** (-torch.arange(0, d // 2, dtype=F32, device=device)
                     / (d // 2))


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def rope(x, positions, theta=10000.0):
    """x: (B,H,S,D) with even D; positions: (S,) int."""
    angles = positions.to(F32)[:, None] * _freqs(x.shape[-1], theta,
                                                 x.device)[None, :]
    return _rotate(x, torch.cos(angles)[None, None],
                   torch.sin(angles)[None, None])


def rope_rows(x, positions, theta=10000.0):
    """Per-batch-row RoPE for single-token decode: x (B,H,1,D);
    positions (B,), one decode position per slot."""
    angles = positions.to(F32)[:, None] * _freqs(x.shape[-1], theta,
                                                 x.device)[None, :]
    return _rotate(x, torch.cos(angles)[:, None, None, :],
                   torch.sin(angles)[:, None, None, :])


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp(ffn: MLP, x, megatron_sp: bool = False):
    x = tp_lib.enter(ffn, x)
    h = torch.nn.functional.silu(x @ ffn.wg.to(x.dtype)) * (
        x @ ffn.wi.to(x.dtype))
    if megatron_sp:
        h = constrain(h, "mlp_hidden")
    return tp_lib.reduce(ffn, h @ ffn.wo.to(x.dtype))


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def _qkv(a: Attention, x, cfg):
    """q, k, v (B, heads, S, hd) over the module's heads (a tensor-
    parallel rank's share, else all of them)."""
    b, s, _ = x.shape
    hd = cfg.hd
    x = tp_lib.enter(a, x)
    q = x @ a.wq.to(x.dtype)
    k = x @ a.wk.to(x.dtype)
    v = x @ a.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + a.bq.to(x.dtype)
        k = k + a.bk.to(x.dtype)
        v = v + a.bv.to(x.dtype)
    q = q.reshape(b, s, -1, hd).transpose(1, 2)
    k = k.reshape(b, s, -1, hd).transpose(1, 2)
    v = v.reshape(b, s, -1, hd).transpose(1, 2)
    if cfg.megatron_sp:
        q = constrain(q, "attn_heads")
        k = constrain(k, "attn_heads")
        v = constrain(v, "attn_heads")
    return q, k, v


def _out(a: Attention, o, cfg, b, s, dtype):
    o = o.transpose(1, 2).reshape(b, s, a.wo.shape[0])
    return tp_lib.reduce(a, o @ a.wo.to(dtype))


def attn_block_prefill(a: Attention, x, cfg, kind, positions):
    """Self-attention over the full sequence; returns (out, (k, v))."""
    b, s, _ = x.shape
    q, k, v = _qkv(a, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = attn_lib.attention(
        q, k, v, kind=("local" if kind == "local" else "causal"),
        window=cfg.local_window, chunk=cfg.attn_chunk,
        schedule=cfg.attn_schedule_resolved,
        flash_threshold=cfg.flash_threshold)
    return _out(a, o, cfg, b, s, x.dtype), (k, v)


def attn_block_decode(a: Attention, x, cfg, kind, cache, pos: int):
    """One-token step.  cache: (k, v) each (B,Hkv,Smax,hd), written at
    ``pos`` **in place**; pos: int.  Returns (out, cache)."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(a, x, cfg)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k_new = rope(k_new, posv, cfg.rope_theta)
    k_cache, v_cache = cache
    k_cache[:, :, pos] = k_new[:, :, 0].to(k_cache.dtype)
    v_cache[:, :, pos] = v_new[:, :, 0].to(v_cache.dtype)
    decode = (attn_lib.decode_attention_flash
              if cfg.attn_decode_kernel == "blockspace"
              else attn_lib.decode_attention)
    kw = ({"grid_mode": cfg.grid_mode}
          if cfg.attn_decode_kernel == "blockspace" else {})
    o = decode(q, k_cache, v_cache, pos,
               kind=("local" if kind == "local" else "causal"),
               window=cfg.local_window, **kw)
    return _out(a, o, cfg, b, 1, x.dtype), (k_cache, v_cache)


def attn_block_decode_paged(a: Attention, x, cfg, kind, pool, page_table,
                            pos, active=None):
    """One-token step against a paged fused-KV pool (continuous
    batching: every slot at its own position).

    pool: (P, 2*Hkv, page_size, hd), written **in place**; page_table:
    (B, max_pages) int32; pos: (B,) per-slot positions; active: optional
    (B,) bool -- inactive slots write their new KV to the null page and
    their outputs are garbage the scheduler ignores.  Returns (out,
    pool)."""
    from repro_torch.core import paged as paged_lib

    b = x.shape[0]
    q, k_new, v_new = _qkv(a, x, cfg)
    q = rope_rows(q, pos, cfg.rope_theta)
    k_new = rope_rows(k_new, pos, cfg.rope_theta)
    paged_lib.append_token(pool, page_table, pos, k_new, v_new, active)
    decode = (attn_lib.decode_attention_paged
              if cfg.attn_decode_kernel == "blockspace"
              else attn_lib.decode_attention_paged_xla)
    kw = ({"grid_mode": cfg.grid_mode}
          if cfg.attn_decode_kernel == "blockspace" else {})
    o = decode(q, pool, page_table, pos,
               window=(cfg.local_window if kind == "local" else 0), **kw)
    return _out(a, o, cfg, b, 1, x.dtype), pool


# ---------------------------------------------------------------------------
# embedding / lm head
# ---------------------------------------------------------------------------

def embed(e: Embed, tokens, dtype):
    # a row gather then the cast: the same values as casting the table
    return tp_lib.embed_rows(e, tokens).to(dtype)


def lm_head(head: LMHead, x):
    """Logits over the whole vocabulary (a tensor-parallel head's
    columns gathered along it)."""
    x = tp_lib.enter(head, x)
    return tp_lib.gather(head, x @ head.w.to(x.dtype), -1)
