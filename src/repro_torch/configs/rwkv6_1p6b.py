"""rwkv6-1.6b — Finch, attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig, register


@register("rwkv6-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        num_layers=24, d_model=2048,
        num_heads=32, num_kv_heads=32, head_dim=64,  # RWKV heads = d/64
        d_ff=7168, vocab_size=65536,
        rope_style="none", mlp_kind="swiglu",  # channel-mix handled in-block
        norm_kind="layernorm",
    )
