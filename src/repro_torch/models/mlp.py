"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper), and the
activations as the JAX package computes them: op by op, so that bf16
rounds after each op as it does there."""
from __future__ import annotations

import math

import torch

from repro_torch.models import params as P


def init_mlp(gen, d_model: int, d_ff: int, kind: str, dtype, device, *,
             out_scale: float | None = None):
    if kind == "swiglu":
        return {
            "w_gate": P.dense_init(gen, d_model, d_ff, dtype, device),
            "w_up": P.dense_init(gen, d_model, d_ff, dtype, device),
            "w_down": P.dense_init(gen, d_ff, d_model, dtype, device,
                                   scale=out_scale),
        }
    if kind == "gelu":
        return {
            "w_up": P.dense_init(gen, d_model, d_ff, dtype, device),
            "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
            "w_down": P.dense_init(gen, d_ff, d_model, dtype, device,
                                   scale=out_scale),
            "b_down": torch.zeros((d_model,), dtype=dtype, device=device),
        }
    raise ValueError(kind)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it: 1 / (1 + exp(-x)), each op
    rounded to the input's dtype."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, with its
    constants in the input's dtype."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype,
                     device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def mlp(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    # activations in the compute dtype, as the JAX package keeps them
    if kind == "swiglu":
        gate = silu(x @ params["w_gate"])
        up = x @ params["w_up"]
        return (gate * up) @ params["w_down"]
    if kind == "gelu":
        h = gelu(x @ params["w_up"] + params["b_up"])
        return h @ params["w_down"] + params["b_down"]
    raise ValueError(kind)
