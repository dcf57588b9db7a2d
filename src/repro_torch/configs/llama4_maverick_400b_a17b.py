"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8),
MoE every 2nd layer: 128 routed experts top-1 (d_ff_expert=8192) + 1
shared; dense layers d_ff=16384; vocab=202048; early-fusion multimodal
(text path here)  [hf:meta-llama/Llama-4-*].

Interleave step 2 matches the published 400B total / 17B active split
(128 experts every layer would be ~780B total).
"""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        moe=True, n_experts=128, top_k=1, n_shared_experts=1,
        d_ff_expert=8192, moe_period=2, moe_offset=1, d_ff=16384,
        capacity_factor=1.25, vocab_size=202048,
        attn_chunk=1024, flash_threshold=2048, logit_chunk=512,
        # bf16 parameters, as in the JAX package's config (whose META
        # also trains it with bf16 AdamW moments)
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        n_experts=4, top_k=1, n_shared_experts=1, d_ff_expert=64,
        d_ff=128, vocab_size=512, capacity_factor=2.0,
        flash_threshold=4096, logit_chunk=0,
        dtype="float32", param_dtype="float32", remat=False)
