"""Model configuration covering all assigned architecture families:
dense GQA transformers, local:global interleave, MLA, MoE (uniform and
interleaved, with shared experts), Mamba-1, Mamba-2/SSD hybrids, and
embedding-input (audio/vlm backbone) variants.

The JAX package's ``ModelConfig``, whole, with torch dtypes
(:meth:`ModelConfig.tdtype`, :meth:`ModelConfig.tparam_dtype`) in place
of its jnp ones.  The port's model stack runs every family the fields
describe.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | audio | vlm

    # trunk dims
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # inputs: "tokens" (LM) or "embeddings" (stub modality frontend)
    input_mode: str = "tokens"

    # attention
    attn_pattern: Tuple[str, ...] = ("global",)   # cycled over layers
    local_window: int = 1024
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    # MLA (DeepSeek-V2)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_period: int = 1            # MoE FFN every `period` layers ...
    moe_offset: int = 0            # ... at layer indices i % period == offset
    first_dense: int = 0           # first K layers use dense FFN regardless
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001

    # SSM
    ssm_kind: Optional[str] = None  # None | mamba1 | mamba2
    d_state: int = 16
    expand: int = 2
    conv_kernel: int = 4
    dt_rank: int = 0               # mamba1; 0 -> ceil(d_model/16)
    ssd_head_dim: int = 64         # mamba2
    ssd_chunk: int = 128
    # hybrid: apply a weight-shared attention block every `period` layers
    hybrid_attn_period: int = 0

    # numerics / compute
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    norm_eps: float = 1e-6
    attn_chunk: int = 1024          # kv-chunk for the flash path
    attn_schedule: str = "dense"    # dense (bounding-box) | triangular (compact)
    # GridPlan lowering knob (repro_torch.core.plan): "closed_form" |
    # "prefetch_lut" | "bounding" | "mma" | "" (= derive from
    # attn_schedule).
    # When set it wins over attn_schedule for the XLA flash path; call
    # sites that invoke the Pallas kernels directly read it as
    # grid_mode via the accessor below.
    grid_lowering: str = ""
    # decode attention path: "xla" (the plain masked decode_attention)
    # or "blockspace" (the flash kernel with the run-time seq_pos block
    # skip)
    attn_decode_kernel: str = "xla"
    flash_threshold: int = 8192     # use flash custom-vjp above this seq len
    remat: bool = True
    logit_chunk: int = 0            # 0 = unchunked cross-entropy
    # force the Megatron TP/SP collective pattern (activation gathers,
    # never weight gathers) via explicit intermediate constraints
    megatron_sp: bool = False

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables padded to a multiple of 16 so the vocab
        dim shards evenly over the model axis (Megatron practice).
        Logical vocab_size is unchanged (labels/tokens < vocab_size)."""
        return -(-self.vocab_size // 16) * 16

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def ssd_heads(self) -> int:
        return self.d_inner // self.ssd_head_dim

    @property
    def attn_schedule_resolved(self) -> str:
        """The XLA flash schedule, honoring grid_lowering when set."""
        if self.grid_lowering:
            from repro_torch.core.plan import xla_schedule
            return xla_schedule(self.grid_lowering)
        return self.attn_schedule

    @property
    def grid_mode(self) -> str:
        """grid_mode for call sites that invoke the attention kernels
        directly (the prefill routes through the plain-tensor path via
        attn_schedule_resolved)."""
        return self.grid_lowering or "closed_form"

    def attn_kind(self, layer: int) -> str:
        return self.attn_pattern[layer % len(self.attn_pattern)]

    def layer_mixer(self, layer: int) -> str:
        if self.ssm_kind is not None:
            return self.ssm_kind
        return "mla" if self.use_mla else "attn"

    def layer_ffn(self, layer: int) -> str:
        if not self.moe or layer < self.first_dense:
            return "dense"
        return "moe" if layer % self.moe_period == self.moe_offset else "dense"

    def has_shared_attn(self, layer: int) -> bool:
        p = self.hybrid_attn_period
        return bool(p) and layer % p == p - 1

    def tdtype(self) -> torch.dtype:
        """The compute dtype as a torch dtype."""
        return getattr(torch, self.dtype)

    def tparam_dtype(self) -> torch.dtype:
        """The parameter dtype as a torch dtype."""
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # number of parameters (analytic; used for MODEL_FLOPS roofline term)
    def param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if self.input_mode != "embeddings":
            pass  # tied output head (we keep separate head below)
        total += v * d  # lm head
        for i in range(self.n_layers):
            total += 2 * d  # norms
            mixer = self.layer_mixer(i)
            if mixer == "attn":
                hq = self.n_heads * self.hd
                hkv = self.n_kv_heads * self.hd
                total += d * hq + 2 * d * hkv + hq * d
                if self.qkv_bias:
                    total += hq + 2 * hkv
            elif mixer == "mla":
                ql = self.q_lora_rank or d
                qdim = self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                total += (d * ql if self.q_lora_rank else 0) + ql * qdim
                total += d * (self.kv_lora_rank + self.qk_rope_dim)
                total += self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_dim + self.v_head_dim)
                total += self.n_heads * self.v_head_dim * d
            elif mixer == "mamba1":
                di, n, dtr = self.d_inner, self.d_state, self.dt_rank_
                total += d * 2 * di + di * self.conv_kernel
                total += di * (dtr + 2 * n) + dtr * di + di * n + 2 * di
                total += di * d
            elif mixer == "mamba2":
                di, n, nh = self.d_inner, self.d_state, self.ssd_heads
                total += d * (2 * di + 2 * n + nh)  # in_proj(x,z,B,C,dt)
                total += (di + 2 * n) * self.conv_kernel
                total += 2 * nh + di  # A, D, dt_bias... (approx)
                total += di * d
            ffn = self.layer_ffn(i)
            if self.family == "hybrid":
                ffn = "none"  # zamba-style: MLP lives in the shared block
            if ffn == "none":
                pass
            elif ffn == "dense":
                total += 3 * d * self.d_ff
            else:
                fe = self.d_ff_expert or self.d_ff
                total += d * self.n_experts  # router
                total += self.n_experts * 3 * d * fe
                total += self.n_shared_experts * 3 * d * fe
        if self.hybrid_attn_period:
            hq = self.n_heads * self.hd
            hkv = self.n_kv_heads * self.hd
            total += 2 * d * d  # concat in-proj
            total += d * hq + 2 * d * hkv + hq * d + 3 * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        dense_cfg = self.param_count()
        fe = self.d_ff_expert or self.d_ff
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.layer_ffn(i) == "moe")
        inactive = (self.n_experts - self.top_k) * 3 * self.d_model * fe
        return dense_cfg - n_moe_layers * inactive
