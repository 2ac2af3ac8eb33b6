"""zamba2-1.2b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig, register


@register("zamba2-1.2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        num_layers=38, d_model=2048,
        num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32000,
        ssm_state=64, shared_attn_every=6,
    )
