"""mixtral-8x7b — MoE 8e top-2, GQA kv=8, sliding-window attn [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig, register


@register("mixtral-8x7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=32000,
        num_experts=8, num_experts_per_tok=2,
        sliding_window=4096, rope_theta=1e6,
    )
