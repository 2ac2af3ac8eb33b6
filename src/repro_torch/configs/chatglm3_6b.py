"""chatglm3-6b — GQA kv=2, 2d-RoPE (partial rotary) [arXiv:2406.12793]."""
from repro_torch.configs.base import ModelConfig, register


@register("chatglm3-6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        num_layers=28, d_model=4096,
        num_heads=32, num_kv_heads=2, d_ff=13696, vocab_size=65024,
        rope_style="partial",  # rotate half of head_dim only
    )
