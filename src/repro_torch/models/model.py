"""Model assembly of the LM stacks: GQA, MLA, Mamba-1 or Mamba-2 mixers,
dense or MoE FFNs, zamba2's weight-shared attention block, token or
embedding inputs: embeddings -> layers -> head, and the serving entry
points.

The JAX package groups layers by signature and runs ``lax.scan`` over
stacked parameters; here the layers are an ``nn.ModuleList`` walked by
a Python loop, so a layer's cache is one tuple per layer: (K, V) of a
GQA layer, (c_kv, k_rope) of an MLA layer, (ssm_state, conv_state) of
a Mamba layer (or one paged pool), followed by the shared block's (K,
V) on a layer that applies it (:func:`init_cache`).  Layer ``i`` of the
list is the JAX package's layer ``i`` (``prefix_i``, or slot ``s`` of
group ``g`` in ``blocks`` with ``i = prefix + g * period + s``).

Entry points:
  * ``forward`` / ``logits_fn`` -- full-sequence forward (grad-enabled,
                       no caches; ``cfg.remat`` recomputes each group of
                       ``period`` layers in the backward) and the MoE
                       layers' summed aux loss
  * ``loss_fn``     -- the training forward + chunked cross-entropy
                       + the aux loss
  * ``prefill``     -- forward returning per-layer caches + last logits
  * ``decode_step`` -- one token through all layers, caches updated in
                       place
  * ``init_paged_cache`` / ``scatter_prefill_pages`` /
    ``decode_step_paged`` -- the paged KV pool of continuous batching
                       (GQA stacks; MoE FFNs run over every slot)

Embedding-input stacks (``input_mode="embeddings"``) take (B, S, D) and
(B, 1, D) inputs, cast to the compute dtype, and have no embedding
table, as in the JAX package.

A model laid out on a mesh (:func:`repro_torch.distributed.sharding.
shard_model`) runs every entry point with each layer taken through
:func:`~repro_torch.distributed.tensor_parallel.at_use`: its
tensor-parallel modules compute on the rank's pieces, the rest on
gathered copies.  A model on one device runs exactly as before.

Training on a mesh installs the activation specs
(:func:`repro_torch.distributed.sharding.activation_specs`): the
residual passes ``constrain(h, "residual")`` where the JAX package pins
it (after the embedding, each mixer, FFN and shared block), which under
``seq_shard`` keeps the rank's piece of the sequence, and each block
starts from :func:`~repro_torch.distributed.sharding.whole_sequence`.
Without specs both are no-ops.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.backend import default_device
from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.distributed.sharding import (constrain, recompute_context,
                                              whole_sequence)
from repro_torch.distributed.tensor_parallel import at_use

from . import layers as L
from . import mla as mla_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from .config import ModelConfig


# ---------------------------------------------------------------------------
# layer signatures and grouping
# ---------------------------------------------------------------------------

def layer_sig(cfg: ModelConfig, i: int) -> Tuple[str, str, str, bool]:
    mixer = cfg.layer_mixer(i)
    akind = cfg.attn_kind(i) if mixer in ("attn", "mla") else ""
    ffn = cfg.layer_ffn(i) if cfg.d_ff or cfg.moe else "none"
    if cfg.family == "hybrid":
        ffn = "none"  # zamba-style: MLP lives in the shared block
    return (mixer, akind, ffn, cfg.has_shared_attn(i))


def _lcm(*xs):
    out = 1
    for x in xs:
        out = math.lcm(out, max(1, x))
    return out


def group_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """Returns (prefix_len, period, n_groups) of the JAX package's
    parameter layout (prefix layers are unscanned there)."""
    period = _lcm(len(cfg.attn_pattern) if cfg.ssm_kind is None else 1,
                  cfg.moe_period if cfg.moe else 1,
                  cfg.hybrid_attn_period or 1)
    prefix = cfg.first_dense
    rest = cfg.n_layers - prefix
    if rest % period:
        prefix += rest % period
        rest = cfg.n_layers - prefix
    for s in range(period):
        sigs = {layer_sig(cfg, prefix + g * period + s)
                for g in range(rest // period)}
        assert len(sigs) <= 1, f"slot {s} not scan-invariant: {sigs}"
    return prefix, period, rest // period


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

#: the mixer module of each ``layer_sig`` mixer kind
MIXERS = {"attn": L.Attention, "mla": mla_lib.MLA,
          "mamba1": ssm_lib.Mamba1, "mamba2": ssm_lib.Mamba2}
#: a Mamba mixer kind -> (its prefill block, its decode step)
SSM_BLOCKS = {"mamba1": (ssm_lib.mamba1_block, ssm_lib.mamba1_decode),
              "mamba2": (ssm_lib.mamba2_block, ssm_lib.mamba2_decode)}


class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, i: int, device=None):
        super().__init__()
        mixer, _, ffn, _ = layer_sig(cfg, i)
        dt = cfg.tparam_dtype()
        self.norm1 = L.RMSNorm(cfg.d_model, dt, device)
        self.mixer = MIXERS[mixer](cfg, device)
        if ffn != "none":
            self.norm2 = L.RMSNorm(cfg.d_model, dt, device)
            self.ffn = (moe_lib.MoE(cfg, device) if ffn == "moe"
                        else L.MLP(cfg.d_model, cfg.d_ff, dt, device))


class SharedAttn(nn.Module):
    """zamba2's weight-shared attention + MLP block (the JAX package's
    ``shared_attn_init``: one block, the hidden state concatenated with
    the embedding output through ``in_proj`` (2 D, D), no LoRA
    adapters)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = cfg.tparam_dtype()
        self.in_proj = L._param((2 * cfg.d_model, cfg.d_model), dt, device)
        self.norm1 = L.RMSNorm(cfg.d_model, dt, device)
        self.attn = L.Attention(cfg, device)
        self.norm2 = L.RMSNorm(cfg.d_model, dt, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dt, device)


class Model(nn.Module):
    """Parameters of the LM; ``cfg`` rides along.  Built empty on
    ``device`` (the card unless the caller names another; raises without
    one): fill it with :func:`init` or
    :func:`repro_torch.models.convert.params_from_jax`.  An
    embedding-input stack has no ``embed``; a hybrid one has one
    ``shared_attn``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = default_device(device)
        self.cfg = cfg
        dt = cfg.tparam_dtype()
        if cfg.input_mode == "tokens":
            self.embed = L.Embed(cfg.padded_vocab, cfg.d_model, dt, device)
        self.layers = nn.ModuleList(Layer(cfg, i, device)
                                    for i in range(cfg.n_layers))
        if cfg.hybrid_attn_period:
            self.shared_attn = SharedAttn(cfg, device)
        self.final_norm = L.RMSNorm(cfg.d_model, dt, device)
        self.lm_head = L.LMHead(cfg.d_model, cfg.padded_vocab, dt, device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device


def init(cfg: ModelConfig, generator: torch.Generator, device=None) -> Model:
    """Random weights with the JAX package's shapes and scales
    (``model.init``): normal matrices scaled by 1/sqrt(fan-in), the
    embedding by 0.01, norms at 1 and biases at 0, drawn from
    ``generator`` (which must live on ``device``: the card unless the
    caller names another) in place, in each parameter's dtype (one f32
    draw of llama4's (128, 5120, 8192) experts would take 21.5 GB).  The
    numbers differ from ``jax.random``'s."""
    model = Model(cfg, device)
    init_into(model, generator)
    return model


def init_into(model: Model, generator: torch.Generator) -> Model:
    """:func:`init`'s draws into the parameters of ``model`` (built
    empty, on ``generator``'s device), in place; returns ``model``."""
    cfg = model.cfg
    if hasattr(model, "embed"):
        L._normal_(model.embed.table, generator, 0.01)
    mixer_init = {L.Attention: L.init_attention, mla_lib.MLA:
                  mla_lib.init_mla, ssm_lib.Mamba1: ssm_lib.init_mamba1,
                  ssm_lib.Mamba2: ssm_lib.init_mamba2}
    for layer in model.layers:
        layer.norm1.scale.data.fill_(1.0)
        mixer_init[type(layer.mixer)](layer.mixer, generator)
        if hasattr(layer, "ffn"):
            layer.norm2.scale.data.fill_(1.0)
            if isinstance(layer.ffn, moe_lib.MoE):
                moe_lib.init_moe(layer.ffn, generator)
            else:
                L.init_mlp(layer.ffn, generator)
    if hasattr(model, "shared_attn"):
        sa = model.shared_attn
        L._normal_(sa.in_proj, generator, 1.0 / math.sqrt(2 * cfg.d_model))
        sa.norm1.scale.data.fill_(1.0)
        L.init_attention(sa.attn, generator)
        sa.norm2.scale.data.fill_(1.0)
        L.init_mlp(sa.mlp, generator)
    model.final_norm.scale.data.fill_(1.0)
    L._normal_(model.lm_head.w, generator, 1.0 / math.sqrt(cfg.d_model))
    return model


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed_inputs(model: Model, inputs, cfg):
    if cfg.input_mode == "tokens":
        return L.embed(model.embed, inputs, cfg.tdtype())
    return inputs.to(cfg.tdtype())


def _ffn(layer: Layer, h, cfg):
    """The layer's FFN on the residual ``h``: returns (h, aux), aux the
    MoE aux loss (None for a dense FFN)."""
    if not hasattr(layer, "ffn"):
        return h, None
    h = whole_sequence(h)
    hn = L.rmsnorm(layer.norm2, h, cfg.norm_eps)
    if isinstance(layer.ffn, moe_lib.MoE):
        out, aux = moe_lib.moe_block(layer.ffn, hn, cfg)
        return constrain(h + out, "residual"), aux
    out = L.mlp(layer.ffn, hn, megatron_sp=cfg.megatron_sp)
    return constrain(h + out, "residual"), None


def _shared_block(sa: SharedAttn, h, h0, cfg, positions=None, cache=None,
                  pos=None):
    """The weight-shared block on the residual ``h`` and the embedding
    output ``h0``: over the full sequence (``positions``) or, given its
    ``cache`` (K, V), one decode step at ``pos`` (K/V written there in
    place, as a GQA layer's).  Returns (h, its (K, V))."""
    u = torch.cat([h, h0], dim=-1) @ sa.in_proj.to(h.dtype)
    un = L.rmsnorm(sa.norm1, u, cfg.norm_eps)
    if cache is None:
        a, kv = L.attn_block_prefill(sa.attn, un, cfg, "global", positions)
    else:
        a, kv = L.attn_block_decode(sa.attn, un, cfg, "global", cache, pos)
    u = u + a
    u = u + L.mlp(sa.mlp, L.rmsnorm(sa.norm2, u, cfg.norm_eps),
                  megatron_sp=cfg.megatron_sp)
    return h + u, kv


def _pad_seq(x, axis, max_len):
    if max_len is None or x.shape[axis] >= max_len:
        return x
    pad = [0, 0] * (x.ndim - 1 - axis) + [0, max_len - x.shape[axis]]
    return torch.nn.functional.pad(x, pad)


def _layers(model: Model, h, cfg, positions, lo: int, hi: int,
            caches=None, max_len=None, h0=None):
    """Layers ``lo`` .. ``hi - 1`` over the full sequence (``h0``: the
    embedding output, which the shared block reads); returns (h, aux
    summed over their MoE layers, f32).  With a ``caches`` list each
    layer's cache tuple (:func:`init_cache`'s layout; the attention
    pairs padded along their sequence axis to ``max_len``, the SSM
    states as they are) is appended to it (serving's prefill); without
    one none are kept (the training forward)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(lo, hi):
        layer = at_use(model.layers[i])
        mixer, akind, _, shared = layer_sig(cfg, i)
        h = whole_sequence(h)
        hn = L.rmsnorm(layer.norm1, h, cfg.norm_eps)
        if mixer in SSM_BLOCKS:
            block = SSM_BLOCKS[mixer][0]
            if caches is None:
                out, cache = block(layer.mixer, hn, cfg), ()
            else:
                out, cache = block(layer.mixer, hn, cfg, return_cache=True)
        elif mixer == "mla":
            out, cache = mla_lib.mla_block(layer.mixer, hn, cfg, positions,
                                           return_cache=True)
            cache = tuple(_pad_seq(t, 1, max_len) for t in cache)
        else:
            out, cache = L.attn_block_prefill(layer.mixer, hn, cfg, akind,
                                              positions)
            cache = tuple(_pad_seq(t, 2, max_len) for t in cache)
        h, a = _ffn(layer, constrain(h + out, "residual"), cfg)
        if a is not None:
            aux = aux + a
        if shared:
            h, kv = _shared_block(at_use(model.shared_attn),
                                  whole_sequence(h), whole_sequence(h0),
                                  cfg, positions)
            h = constrain(h, "residual")
            cache = cache + tuple(_pad_seq(t, 2, max_len) for t in kv)
        if caches is not None:
            caches.append(cache)
    return h, aux


@torch.no_grad()
def _run(model: Model, inputs, max_len=None, cfg=None):
    """Full-sequence forward; returns (final-normed hidden, caches)."""
    cfg = cfg or model.cfg
    h = _embed_inputs(model, inputs, cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    caches = []
    h, _ = _layers(model, h, cfg, positions, 0, cfg.n_layers, caches,
                   max_len, h)
    return L.rmsnorm(model.final_norm, h, cfg.norm_eps), caches


def forward(model: Model, inputs, cfg: ModelConfig | None = None):
    """Full-sequence forward -> (hidden (B,S,D), aux_loss), the training
    forward: grad-enabled, no caches; aux_loss is the f32 sum of the MoE
    layers' aux losses (0 without MoE).  Under ``cfg.remat`` each group
    of ``period`` layers (the JAX package's ``jax.checkpoint``-ed scan
    body) keeps only its input and is recomputed in the backward; the
    prefix layers are not.  ``cfg`` (default: the model's) may change
    the execution knobs (attention schedule, remat), not the shapes."""
    cfg = cfg or model.cfg
    prefix, period, n_groups = group_layout(cfg)
    h = _embed_inputs(model, inputs, cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    h0 = h = constrain(h, "residual")
    h, aux = _layers(model, h, cfg, positions, 0, prefix, h0=h0)
    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(n_groups):
        lo = prefix + g * period
        if remat:
            h, a = checkpoint(_layers, model, h, cfg, positions, lo,
                              lo + period, None, None, h0,
                              use_reentrant=False, preserve_rng_state=False,
                              context_fn=recompute_context)
        else:
            h, a = _layers(model, h, cfg, positions, lo, lo + period,
                           h0=h0)
        aux = aux + a
    h = L.rmsnorm(model.final_norm, whole_sequence(h), cfg.norm_eps)
    return h, aux


def logits_fn(model: Model, inputs, cfg: ModelConfig | None = None):
    h, aux = forward(model, inputs, cfg)
    return L.lm_head(model.lm_head, h), aux


def _xent(logits, labels):
    """f32 cross entropy; logits (..., V), labels (...) int."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    return lse - gold


def _chunk_ce(h, w, labels, head=None):
    """A chunk's cross entropy (a tensor-parallel ``head``'s columns of
    the logits gathered along the vocabulary)."""
    return _xent(tp_lib.gather(head, h @ w), labels)


def loss_fn(model: Model, batch, cfg: ModelConfig | None = None):
    """batch: {"inputs": (B,S) | (B,S,D), "labels": (B,S)}, tensors on
    the model's device.  Returns (total, {"loss", "aux_loss", "tokens"}).

    With ``cfg.logit_chunk`` dividing S the head and the cross-entropy
    run per chunk of that many positions (the JAX package's
    ``lax.map``), each chunk recomputed in the backward, so the full
    (B, S, V) logits never exist: gemma3-12b's 262,144-entry vocabulary
    would take 4 GiB of f32 logits per 4096 tokens."""
    cfg = cfg or model.cfg
    h, aux = forward(model, batch["inputs"], cfg)
    labels = batch["labels"]
    lc = cfg.logit_chunk
    if lc and h.shape[1] % lc == 0:
        head = model.lm_head
        h = tp_lib.enter(head, h)
        w = head.w.to(h.dtype)
        ces = []
        for c in range(0, h.shape[1], lc):
            args = (h[:, c:c + lc], w, labels[:, c:c + lc], head)
            ces.append(checkpoint(_chunk_ce, *args, use_reentrant=False,
                                  preserve_rng_state=False)
                       if torch.is_grad_enabled() else _chunk_ce(*args))
        loss = torch.mean(torch.stack(ces))
    else:
        logits = L.lm_head(model.lm_head, h)
        loss = torch.mean(_xent(logits, labels))
    total = loss + aux
    return total, {"loss": loss, "aux_loss": aux,
                   "tokens": torch.tensor(float(labels.numel()),
                                          dtype=torch.float32,
                                          device=h.device)}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> List[Tuple[torch.Tensor, ...]]:
    """Zero caches, one tuple per layer, on ``device`` (the card unless
    the caller names another): the mixer's pair -- (K, V) each (B, Hkv,
    max_len, hd) of a GQA layer; (c_kv (B, max_len, kv_lora_rank),
    k_rope (B, max_len, qk_rope_dim)) of an MLA layer; (ssm_state f32,
    conv_state (B, K-1, C)) of a Mamba layer, the state (B, d_inner, N)
    under Mamba-1 and (B, heads, N, head_dim) under Mamba-2, C d_inner
    or d_inner + 2 N, neither padded to ``max_len`` -- then, on a layer
    that applies zamba2's shared block, that block's (K, V), as a GQA
    layer's.  Caches are in the compute dtype but for the SSM states."""
    device = default_device(device)
    dt = cfg.tdtype()
    kv = ((batch, cfg.n_kv_heads, max_len, cfg.hd),) * 2
    out = []
    for i in range(cfg.n_layers):
        mixer, _, _, shared = layer_sig(cfg, i)
        if mixer == "mamba1":
            shapes = ((batch, cfg.d_inner, cfg.d_state),
                      (batch, cfg.conv_kernel - 1, cfg.d_inner))
        elif mixer == "mamba2":
            shapes = ((batch, cfg.ssd_heads, cfg.d_state, cfg.ssd_head_dim),
                      (batch, cfg.conv_kernel - 1,
                       cfg.d_inner + 2 * cfg.d_state))
        elif mixer == "mla":
            shapes = ((batch, max_len, cfg.kv_lora_rank),
                      (batch, max_len, cfg.qk_rope_dim))
        else:
            shapes = kv
        dts = ((torch.float32, dt) if mixer in SSM_BLOCKS else (dt, dt))
        if shared:
            shapes, dts = shapes + kv, dts + (dt, dt)
        out.append(tuple(torch.zeros(s, dtype=d, device=device)
                         for s, d in zip(shapes, dts)))
    return out


def prefill(model: Model, inputs, max_len: int | None = None,
            cfg: ModelConfig | None = None):
    """Full-sequence forward returning last-position logits + per-layer
    caches.  ``max_len`` pre-pads the caches so decode can continue in
    place."""
    h, caches = _run(model, inputs, max_len, cfg)
    return L.lm_head(model.lm_head, h[:, -1:]), caches


@torch.no_grad()
def decode_step(model: Model, inputs, cache, pos,
                cfg: ModelConfig | None = None):
    """One token for the whole batch.  inputs: (B,1) tokens or (B,1,D)
    embeddings; pos: the current position (int).  The attention caches
    (GQA, MLA, the shared block's) are written at ``pos`` in place; the
    SSM states come back as new tensors, the ones passed in untouched,
    so a step rerun on the same cache gives the same result.  Returns
    (logits (B,1,V), cache)."""
    cfg = cfg or model.cfg
    pos = int(pos)
    h0 = h = _embed_inputs(model, inputs, cfg)
    new_cache = []
    for i, layer in enumerate(model.layers):
        layer = at_use(layer)
        mixer, akind, _, shared = layer_sig(cfg, i)
        hn = L.rmsnorm(layer.norm1, h, cfg.norm_eps)
        if mixer in SSM_BLOCKS:
            out, c = SSM_BLOCKS[mixer][1](layer.mixer, hn, cfg,
                                          cache[i][:2])
        elif mixer == "mla":
            out, c = mla_lib.mla_decode(layer.mixer, hn, cfg, cache[i][:2],
                                        pos)
        else:
            out, c = L.attn_block_decode(layer.mixer, hn, cfg, akind,
                                         cache[i][:2], pos)
        h, _ = _ffn(layer, h + out, cfg)
        if shared:
            h, kv = _shared_block(at_use(model.shared_attn), h, h0, cfg,
                                  cache=cache[i][2:], pos=pos)
            c = tuple(c) + tuple(kv)
        new_cache.append(tuple(c))
    h = L.rmsnorm(model.final_norm, h, cfg.norm_eps)
    return L.lm_head(model.lm_head, h), new_cache


# ---------------------------------------------------------------------------
# serving: paged KV (continuous batching)
# ---------------------------------------------------------------------------

def _check_paged(cfg: ModelConfig) -> None:
    """Paged serving covers plain-attention stacks (every mixer 'attn',
    no shared block): MLA/SSM caches are not (K, V) pages."""
    for i in range(cfg.n_layers):
        mixer, _, _, shared = layer_sig(cfg, i)
        if mixer != "attn" or shared:
            raise ValueError(
                f"paged serving needs an attention-only stack; layer "
                f"{i} is {mixer!r}" + (" + shared block" if shared
                                       else ""))


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device=None, kv_heads: int | None = None
                     ) -> List[torch.Tensor]:
    """Per-layer fused-KV page pools.  One *shared* (B, max_pages) page
    table (built by the scheduler) addresses every layer's pool: the
    layers hold different values at identical page indices.  A
    tensor-parallel rank's pools hold its ``kv_heads`` (default: all of
    the config's)."""
    from repro_torch.core import paged as paged_lib

    _check_paged(cfg)
    hkv = cfg.n_kv_heads if kv_heads is None else kv_heads
    return [paged_lib.init_pool(num_pages, hkv, page_size, cfg.hd,
                                cfg.tdtype(), device)
            for _ in range(cfg.n_layers)]


def scatter_prefill_pages(pools, caches, pages, cfg: ModelConfig):
    """Admission: scatter one request's prefill KV (the caches of a
    batch-1 :func:`prefill`) into its allocated pages of every layer
    pool, in place.  ``pages``: (n,) int physical page ids with
    ``n * page_size >= S``.  Returns the pools."""
    from repro_torch.core import paged as paged_lib

    for pool, (k, v) in zip(pools, caches):
        paged_lib.write_prefill_pages(pool, pages, k[0], v[0])
    return pools


@torch.no_grad()
def decode_step_paged(model: Model, inputs, pools, page_table, pos,
                      active, cfg: ModelConfig | None = None):
    """One token for every serving slot against the paged pools.

    inputs: (B,1) tokens; page_table: (B, max_pages) int32; pos: (B,)
    per-slot positions; active: (B,) bool (inactive slots write to the
    null page and their logits are garbage the scheduler ignores; an MoE
    FFN routes them with the rest, as in the JAX package).  The pools
    are written in place.  Returns (logits (B,1,V), pools)."""
    cfg = cfg or model.cfg
    _check_paged(cfg)
    h = _embed_inputs(model, inputs, cfg)
    for i, layer in enumerate(model.layers):
        layer = at_use(layer)
        _, akind, _, _ = layer_sig(cfg, i)
        hn = L.rmsnorm(layer.norm1, h, cfg.norm_eps)
        out, pools[i] = L.attn_block_decode_paged(
            layer.mixer, hn, cfg, akind, pools[i], page_table, pos, active)
        h, _ = _ffn(layer, h + out, cfg)
    h = L.rmsnorm(model.final_norm, h, cfg.norm_eps)
    return L.lm_head(model.lm_head, h), pools
