"""arctic-480b — MoE 128e top-2 + dense residual [hf:Snowflake/snowflake-arctic-base].

The assigned spec gives d_ff=4864 for the experts; the parallel dense
residual FFN uses the same hidden size (documented assumption, DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, register


@register("arctic-480b")
def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        num_layers=35, d_model=7168,
        num_heads=56, num_kv_heads=8, d_ff=4864, vocab_size=32000,
        num_experts=128, num_experts_per_tok=2,
        moe_dense_residual=True,
    )
