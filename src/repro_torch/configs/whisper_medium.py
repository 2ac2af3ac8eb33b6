"""whisper-medium — encoder-decoder audio backbone; conv frontend is a STUB
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio",
        num_layers=24, d_model=1024,
        num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=51865,
        is_encoder_decoder=True, encoder_layers=24, encoder_seq=1500,
        rope_style="none", mlp_kind="gelu", norm_kind="layernorm",
    )
