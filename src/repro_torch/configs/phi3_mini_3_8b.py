"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (kv=32) d_ff=8192,
vocab=32064, RoPE + SwiGLU  [arXiv:2404.14219]."""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32064,
        attn_chunk=1024, flash_threshold=2048, logit_chunk=512,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, flash_threshold=4096, logit_chunk=0,
        dtype="float32", param_dtype="float32", remat=False)
