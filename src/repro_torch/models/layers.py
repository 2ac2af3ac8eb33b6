"""Norms, embeddings and rotary/positional machinery (the JAX package's
``repro.models.layers``: the same casts, so bf16 rounds where it does
there)."""
from __future__ import annotations

import math

import torch

# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # statistics in fp32, application in the input dtype
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"]


def layernorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return (x - mu.to(x.dtype)) * inv * params["scale"] + params["bias"]


def norm_init(kind: str, d: int, dtype, device):
    return (rmsnorm_init(d, dtype, device) if kind == "rmsnorm"
            else layernorm_init(d, dtype, device))


def apply_norm(kind: str, params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


# --------------------------------------------------------------------------
# Rotary position embedding (styles: standard, partial (chatglm), none)
# --------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, rotary_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [*, T] -> (sin, cos) of shape [*, T, rotary_dim/2], fp32."""
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                        device=positions.device) / rotary_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               rotary_dim: int) -> torch.Tensor:
    """x [..., T, H, Dh]; rotates the first ``rotary_dim`` features (the
    "rotate half" convention); the tail passes through (chatglm3's 2d-RoPE
    rotates only Dh/2)."""
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    x1, x2 = rot.float().chunk(2, dim=-1)
    s = sin[..., :, None, :]
    c = cos[..., :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    return torch.cat([out, rest], dim=-1) if rest.shape[-1] else out


def sinusoidal_positions(n: int, d: int, device="cpu") -> torch.Tensor:
    """Whisper-style fixed sinusoidal table [n, d] (fp32)."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=device)
                      / (half - 1))
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] \
        * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
