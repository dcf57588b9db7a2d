"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40) d_ff=27392,
vocab=152064, QKV bias  [hf:Qwen/Qwen1.5-*]."""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
        d_ff=27392, vocab_size=152064, qkv_bias=True,
        attn_chunk=1024, flash_threshold=2048, logit_chunk=512,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, flash_threshold=4096, logit_chunk=0,
        dtype="float32", param_dtype="float32", remat=False)
