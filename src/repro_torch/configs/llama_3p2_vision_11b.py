"""llama-3.2-vision-11b — dense decoder with cross-attn image layers every 5;
vision frontend is a STUB (precomputed patch embeddings)
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from repro_torch.configs.base import ModelConfig, register


@register("llama-3.2-vision-11b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        num_layers=40, d_model=4096,
        num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=128256,
        cross_attn_every=5, num_image_tokens=1601, rope_theta=5e5,
    )
