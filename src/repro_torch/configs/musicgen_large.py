"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32) d_ff=8192,
vocab=2048 -- decoder-only over EnCodec tokens [arXiv:2306.05284].

The modality frontend is a stub, as in the JAX package: callers pass
precomputed frame embeddings (B, S, d_model); the backbone is the
transformer only.
"""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=2048, input_mode="embeddings",
        attn_chunk=1024, flash_threshold=2048,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, flash_threshold=4096,
        dtype="float32", param_dtype="float32", remat=False)
