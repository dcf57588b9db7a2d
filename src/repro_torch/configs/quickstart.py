"""quickstart: a ~100M dense LM for the end-to-end examples."""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="quickstart", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=2048, vocab_size=32768,
        dtype="float32", param_dtype="float32",
        flash_threshold=4096, remat=False,
    )


def smoke() -> ModelConfig:
    return full().replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                          d_ff=256, vocab_size=1024)
