"""deepseek-v2-236b [moe]: 60L d_model=5120 128H MLA (kv_lora=512,
q_lora=1536, nope=128, rope=64, v=128), 2 shared + 160 routed experts
top-6 (d_ff_expert=1536), first layer dense (d_ff=12288), vocab=102400
[arXiv:2405.04434]."""
from repro_torch.models import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        moe=True, n_experts=160, top_k=6, n_shared_experts=2,
        d_ff_expert=1536, first_dense=1, d_ff=12288,
        capacity_factor=1.25, vocab_size=102400,
        attn_chunk=1024, flash_threshold=2048, logit_chunk=512,
        # bf16 parameters, as in the JAX package's config (whose META
        # also trains it with bf16 AdamW moments)
        param_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=3, d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, n_experts=8, top_k=2,
        n_shared_experts=1, d_ff_expert=32, d_ff=128, vocab_size=512,
        capacity_factor=2.0, flash_threshold=4096, logit_chunk=0,
        dtype="float32", param_dtype="float32", remat=False)
