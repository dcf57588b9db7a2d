"""zamba2-2.7b [hybrid]: 54L d_model=2560 Mamba-2 (ssm_state=64,
head_dim=64) + weight-shared attention blocks (32H, d_ff=10240) applied
every 6 layers, vocab=32000  [arXiv:2411.15242].

Simplified as in the JAX package: a single shared block (the released
model alternates two) and no LoRA adapters on the shared weights.
"""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        ssm_kind="mamba2", d_state=64, expand=2, conv_kernel=4,
        ssd_head_dim=64, ssd_chunk=256, hybrid_attn_period=6,
        d_ff=10240, vocab_size=32000,
        attn_chunk=1024, flash_threshold=2048,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_state=16,
        ssd_head_dim=16, ssd_chunk=16, hybrid_attn_period=2, d_ff=128,
        vocab_size=512, flash_threshold=4096,
        dtype="float32", param_dtype="float32", remat=False)
