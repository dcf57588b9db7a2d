"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) head_dim=256,
d_ff=15360, vocab=262144, 5:1 local:global (window 1024)
[hf:google/gemma-3-*]."""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense",
        n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
        d_ff=15360, vocab_size=262144,
        attn_pattern=("local",) * 5 + ("global",), local_window=1024,
        rope_theta=1e6,
        attn_chunk=1024, flash_threshold=2048, logit_chunk=256,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, local_window=8, attn_chunk=8,
        flash_threshold=4096, logit_chunk=0,
        dtype="float32", param_dtype="float32", remat=False)
