"""Config dataclasses + the assigned input-shape grid (a copy of the JAX
package's, with no torch in it: configs are plain data)."""
from __future__ import annotations

import dataclasses
from typing import Callable

_REGISTRY: dict[str, Callable[[], "ModelConfig"]] = {}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads

    # attention
    qkv_bias: bool = False
    rope_style: str = "standard"     # standard | partial | none
    rope_theta: float = 10000.0
    sliding_window: int = 0          # >0: SWA (mixtral)

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_dense_residual: bool = False  # arctic: parallel dense FFN
    capacity_factor: float = 1.25
    moe_dispatch: str = "sorted"      # sorted (paper engine) | onehot (baseline)

    # SSM / hybrid
    ssm_state: int = 0
    shared_attn_every: int = 0        # zamba2: shared attn block cadence

    # encoder-decoder (whisper) / cross-attention (vlm)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0              # stub frontend sequence length
    cross_attn_every: int = 0         # vlm: cross-attn layer cadence
    num_image_tokens: int = 0

    # mlp / norm
    mlp_kind: str = "swiglu"          # swiglu | gelu
    norm_kind: str = "rmsnorm"        # rmsnorm | layernorm
    tie_embeddings: bool = False

    dtype: str = "bfloat16"

    # reduced smoke-test variant knob (None -> full size)
    note: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded to 256 so vocab TP always tiles
        (granite's 49155 / whisper's 51865 don't divide the model axis)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md §5)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        base = dict(
            num_layers=2, d_model=128, num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads,
                                    4 * self.num_kv_heads // self.num_heads
                                    or 1)),
            d_ff=256, vocab_size=512, head_dim=32,
            note=f"reduced({self.name})",
        )
        if self.num_experts:
            base.update(num_experts=4, num_experts_per_tok=2)
        if self.ssm_state:
            base.update(ssm_state=16)
        if self.shared_attn_every:
            base.update(shared_attn_every=2, num_kv_heads=4)
        if self.is_encoder_decoder:
            base.update(encoder_layers=2, encoder_seq=64)
        if self.cross_attn_every:
            base.update(cross_attn_every=2, num_image_tokens=16)
        if self.sliding_window:
            base.update(sliding_window=32)
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; have {sorted(_REGISTRY)}") from None


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch x shape) is a live dry-run cell (DESIGN.md §5)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention (full-attn arch)"
    return True, ""
