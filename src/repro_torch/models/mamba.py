"""Mamba2 (SSD) block — zamba2's backbone mixer on the chunked rolling scan
(the JAX package's ``repro.models.mamba``).

SSD recurrence a head:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * (B_t x_t^T)
    y_t = C_t h_t + D . x_t

as the scalar-decay scan with q=C, k=B, v=dt*x, log_w = dt*A, inclusive.
A depthwise causal conv (kernel 4) over the x/B/C channels, SiLU, and a
gated RMSNorm before the output projection.
"""
from __future__ import annotations

import torch

from repro_torch.models import params as P
from repro_torch.models.linear_scan import (chunked_scalar_decay_scan,
                                            decay_scan_step)
from repro_torch.models.mlp import silu

CONV_K = 4
HEAD_DIM = 64


def dims(d_model: int, ssm_state: int, expand: int = 2):
    d_inner = expand * d_model
    return d_inner, d_inner // HEAD_DIM, d_inner + 2 * ssm_state


def init_mamba(gen, d_model: int, ssm_state: int, dtype, device, *,
               expand: int = 2):
    d_inner, nheads, conv_dim = dims(d_model, ssm_state, expand)
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((CONV_K, conv_dim), generator=gen, **f32) * 0.1
    return {
        # fused input projection: [z, x, B, C, dt]
        "w_in": P.dense_init(gen, d_model,
                             2 * d_inner + 2 * ssm_state + nheads, dtype,
                             device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nheads, **f32)),
        "dt_bias": torch.zeros((nheads,), **f32),
        "d_skip": torch.ones((nheads, 1), **f32),
        "gn_scale": torch.ones((d_inner,), dtype=dtype, device=device),
        "w_out": P.dense_init(gen, d_inner, d_model, dtype, device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(e^x + 1), with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_in(xz, d_inner: int, ssm_state: int):
    """[z, x, B, C, dt] along the last axis."""
    return torch.split(xz, [d_inner, d_inner, ssm_state, ssm_state,
                            xz.shape[-1] - 2 * d_inner - 2 * ssm_state],
                       dim=-1)


def _causal_conv(p, u, prev):
    """Depthwise causal conv, kernel CONV_K.  u [B,T,C]; prev [B,K-1,C]."""
    if prev is None:
        prev = u.new_zeros(u.shape[:1] + (CONV_K - 1,) + u.shape[2:])
    up = torch.cat([prev, u], dim=1)
    t = u.shape[1]
    out = sum(up[:, i:i + t] * p["conv_w"][i]
              for i in range(CONV_K)) + p["conv_b"]
    return silu(out), up[:, -(CONV_K - 1):]


def _gated_norm(p, y, z):
    yg = y * silu(z.float()).to(y.dtype)
    var = yg.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + 1e-5).to(y.dtype)
    return yg * inv * p["gn_scale"]


def mamba_mix(p, x_in, *, ssm_state: int, expand: int = 2, state=None,
              chunk: int = 16):
    """Full-sequence Mamba2 mixing.  Returns (out [B,T,D], new_state)."""
    b, t, d_model = x_in.shape
    d_inner, nheads, _ = dims(d_model, ssm_state, expand)
    z, x, bmat, cmat, dt = _split_in(x_in @ p["w_in"], d_inner, ssm_state)
    conv_out, conv_state = _causal_conv(
        p, torch.cat([x, bmat, cmat], dim=-1),
        None if state is None else state["conv"])
    x, bmat, cmat = torch.split(conv_out, [d_inner, ssm_state, ssm_state],
                                dim=-1)
    dt = softplus(dt.float() + p["dt_bias"])                     # [B,T,H]
    log_w = dt * -torch.exp(p["a_log"])                          # [B,T,H]
    xh = x.reshape(b, t, nheads, HEAD_DIM)
    v = xh.float() * dt[..., None]                               # dt-scaled
    y, s_new = chunked_scalar_decay_scan(
        cmat, bmat, v.to(x.dtype), log_w, chunk=chunk,
        initial_state=None if state is None else state["S"],
        return_state=True)
    y = y.float() + p["d_skip"] * xh.float()
    y = y.reshape(b, t, d_inner).to(x_in.dtype)
    out = _gated_norm(p, y, z) @ p["w_out"]
    return out, {"conv": conv_state, "S": s_new}


def mamba_mix_step(p, x_in, state, *, ssm_state: int, expand: int = 2):
    """Single-token decode.  x_in [B, D]."""
    b, d_model = x_in.shape
    d_inner, nheads, _ = dims(d_model, ssm_state, expand)
    z, x, bmat, cmat, dt = _split_in(x_in @ p["w_in"], d_inner, ssm_state)
    conv_out, conv_state = _causal_conv(
        p, torch.cat([x, bmat, cmat], dim=-1)[:, None], state["conv"])
    x, bmat, cmat = torch.split(conv_out[:, 0],
                                [d_inner, ssm_state, ssm_state], dim=-1)
    dt = softplus(dt.float() + p["dt_bias"])                     # [B,H]
    log_w = (dt * -torch.exp(p["a_log"]))[..., None]
    xh = x.reshape(b, nheads, HEAD_DIM)
    v = (xh.float() * dt[..., None]).to(x.dtype)
    q = cmat[:, None, :].expand(b, nheads, ssm_state)
    k = bmat[:, None, :].expand(b, nheads, ssm_state)
    y, s_new = decay_scan_step(q, k, v, log_w, state["S"], inclusive=True)
    y = y.float() + p["d_skip"] * xh.float()
    y = y.reshape(b, d_inner).to(x_in.dtype)
    out = _gated_norm(p, y[:, None], z[:, None])[:, 0] @ p["w_out"]
    return out, {"conv": conv_state, "S": s_new}


def init_mamba_state(batch: int, d_model: int, ssm_state: int, dtype,
                     device, *, expand: int = 2):
    d_inner, nheads, conv_dim = dims(d_model, ssm_state, expand)
    return {
        "conv": torch.zeros((batch, CONV_K - 1, conv_dim), dtype=dtype,
                            device=device),
        "S": torch.zeros((batch, nheads, ssm_state, HEAD_DIM),
                         dtype=torch.float32, device=device),
    }
