"""falcon-mamba-7b [ssm]: 64L d_model=4096 attention-free Mamba-1,
vocab=65024, ssm_state=16  [arXiv:2410.05355]."""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, d_ff=0, vocab_size=65024,
        ssm_kind="mamba1", d_state=16, expand=2, conv_kernel=4,
        dt_rank=256, ssd_chunk=256,
        logit_chunk=512,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, vocab_size=512, dt_rank=8, ssd_chunk=16,
        dtype="float32", param_dtype="float32", remat=False, logit_chunk=0)
