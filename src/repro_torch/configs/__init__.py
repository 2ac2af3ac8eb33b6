"""Architecture configs: one module per assigned architecture + the paper's
own aggregation-engine config.  ``get_config(name)`` is the registry entry."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeSpec, SHAPES, get_config, list_archs, register)

# import for registration side effects
from repro_torch.configs import (  # noqa: F401
    rwkv6_1p6b, internlm2_1p8b, qwen1p5_4b, granite_3_8b, chatglm3_6b,
    mixtral_8x7b, arctic_480b, zamba2_1p2b, whisper_medium,
    llama_3p2_vision_11b, paper_engine)
