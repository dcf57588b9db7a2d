"""Multi-head Latent Attention (DeepSeek-V2): low-rank compressed KV with
a decoupled RoPE key, and the absorbed decode that attends directly over
the compressed cache (512 + 64 values per token instead of 2 * H * hd):
the JAX package's ``repro.models.mla``.

Prefill and training materialise per-head K (qk dim ``dn + dr``) and V
(``dv``) from the latent and run :func:`.attention.attention` (simple,
or the flash path with its recomputing backward above
``flash_threshold``).  The decode folds ``W_uk`` into the query, attends
over the ``(c_kv, k_rope)`` cache written in place, and applies
``W_uv`` afterwards.  No kernel lies on either path, as in the JAX
package.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import attention as attn_lib
from . import layers as L

F32 = torch.float32


class MLA(nn.Module):
    """Parameters under the JAX package's names: ``wq_a``, ``q_norm``,
    ``wq_b`` (or ``wq`` without a q LoRA rank), ``wkv_a``, ``kv_norm``,
    ``wkv_b``, ``wo``.  The two norms are bare scale tensors, as in the
    JAX tree (``mixer/q_norm``), so AdamW's decay mask exempts them by
    path."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dt = cfg.tparam_dtype()
        d, h = cfg.d_model, cfg.n_heads
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        if cfg.q_lora_rank:
            self.wq_a = L._param((d, cfg.q_lora_rank), dt, device)
            self.q_norm = L._param((cfg.q_lora_rank,), dt, device)
            self.wq_b = L._param((cfg.q_lora_rank, h * (dn + dr)), dt,
                                 device)
        else:
            self.wq = L._param((d, h * (dn + dr)), dt, device)
        self.wkv_a = L._param((d, cfg.kv_lora_rank + dr), dt, device)
        self.kv_norm = L._param((cfg.kv_lora_rank,), dt, device)
        self.wkv_b = L._param((cfg.kv_lora_rank, h * (dn + dv)), dt, device)
        self.wo = L._param((h * dv, d), dt, device)


def init_mla(m: MLA, generator) -> None:
    """The JAX package's ``mla_init`` scales: normal matrices times
    1/sqrt(fan-in), the norms at 1."""
    for name in ("wq_a", "wq_b", "wq", "wkv_a", "wkv_b", "wo"):
        if hasattr(m, name):
            w = getattr(m, name)
            L._normal_(w, generator, 1.0 / math.sqrt(w.shape[0]))
    for name in ("q_norm", "kv_norm"):
        if hasattr(m, name):
            getattr(m, name).data.fill_(1.0)


def _queries(m: MLA, x, cfg, positions):
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        cq = L.rmsnorm_scale(m.q_norm, x @ m.wq_a.to(x.dtype), cfg.norm_eps)
        q = cq @ m.wq_b.to(x.dtype)
    else:
        q = x @ m.wq.to(x.dtype)
    q = q.reshape(b, s, h, dn + dr).transpose(1, 2)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _latents(m: MLA, x, cfg, positions):
    """Compressed kv latent + roped shared key.  c_kv: (B,S,L); k_rope
    (B,1,S,dr)."""
    kv_a = x @ m.wkv_a.to(x.dtype)
    c_kv, k_rope = kv_a[..., :cfg.kv_lora_rank], kv_a[..., cfg.kv_lora_rank:]
    c_kv = L.rmsnorm_scale(m.kv_norm, c_kv, cfg.norm_eps)
    k_rope = L.rope(k_rope[:, None], positions, cfg.rope_theta)
    return c_kv, k_rope


def mla_block(m: MLA, x, cfg, positions, *, return_cache=False):
    """Train/prefill: materialise per-head K/V from the latent.  With
    ``return_cache`` also returns the decode cache ``(c_kv (B,S,L),
    k_rope (B,S,dr))``."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _queries(m, x, cfg, positions)
    c_kv, k_rope = _latents(m, x, cfg, positions)

    kv = (c_kv @ m.wkv_b.to(x.dtype)).reshape(b, s, h, dn + dv)
    kv = kv.transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_rope.expand(b, h, s, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)

    o = attn_lib.attention(
        q, k, v, kind="causal", scale=1.0 / math.sqrt(dn + dr),
        chunk=cfg.attn_chunk, schedule=cfg.attn_schedule_resolved,
        flash_threshold=cfg.flash_threshold)
    o = o.transpose(1, 2).reshape(b, s, h * dv)
    out = o @ m.wo.to(x.dtype)
    if return_cache:
        return out, (c_kv, k_rope[:, 0])
    return out


def mla_decode(m: MLA, x, cfg, cache, pos: int):
    """Absorbed decode: scores = (q_nope W_uk) c_kv^T + q_rope k_rope^T.
    cache: (c_kv (B,Smax,L), k_rope (B,Smax,dr)), written at ``pos`` **in
    place**; pos: int.  Returns (out, cache)."""
    b = x.shape[0]
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    lr = cfg.kv_lora_rank
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(m, x, cfg, posv)       # (B,H,1,dn/dr)
    c_new, kr_new = _latents(m, x, cfg, posv)        # (B,1,L), (B,1,1,dr)

    c_cache, r_cache = cache
    c_cache[:, pos] = c_new[:, 0].to(c_cache.dtype)
    r_cache[:, pos] = kr_new[:, 0, 0].to(r_cache.dtype)

    wkv_b = m.wkv_b.to(x.dtype).reshape(lr, h, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
    # absorb W_uk into q:  (B,H,1,dn) x (L,H,dn) -> (B,H,1,L)
    q_abs = torch.einsum("bhqd,lhd->bhql", q_nope, w_uk)
    s = torch.einsum("bhql,bsl->bhqs", q_abs.to(F32), c_cache.to(F32))
    s = s + torch.einsum("bhqd,bsd->bhqs", q_rope.to(F32),
                         r_cache.to(F32))
    s = s * (1.0 / math.sqrt(dn + dr))
    kpos = torch.arange(c_cache.shape[1], device=x.device)
    s = torch.where(kpos <= pos, s, attn_lib.NEG_INF)
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqs,bsl->bhql", pr.to(c_cache.dtype), c_cache)
    o = torch.einsum("bhql,lhd->bhqd", ctx, w_uv)    # (B,H,1,dv)
    o = o.transpose(1, 2).reshape(b, 1, h * dv)
    return o @ m.wo.to(x.dtype), (c_cache, r_cache)
