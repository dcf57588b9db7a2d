"""internvl2-26b [vlm]: InternLM2-style backbone, 48L d_model=6144 48H
(GQA kv=8) d_ff=16384, vocab=92553  [arXiv:2404.16821].

The InternViT frontend is a stub, as in the JAX package: callers pass
precomputed patch+text embeddings (B, S, d_model).
"""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=92553, input_mode="embeddings",
        attn_chunk=1024, flash_threshold=2048, logit_chunk=512,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, flash_threshold=4096, logit_chunk=0,
        dtype="float32", param_dtype="float32", remat=False)
