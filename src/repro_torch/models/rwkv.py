"""RWKV6 ("Finch") block — attention-free token mixing with data-dependent
decay on the chunked rolling scan (the JAX package's
``repro.models.rwkv``): token-shift ddlerp with a LoRA mix, the decay
w_t = exp(-exp(dd_w(x))), the u-bonus, a per-head GroupNorm and a
SiLU-gated output; channel mixing is a token-shifted squared-ReLU MLP
gated by sigmoid(r).  Head size 64; heads = d_model / 64.
"""
from __future__ import annotations

import torch

from repro_torch.models import params as P
from repro_torch.models.linear_scan import chunked_decay_scan, decay_scan_step
from repro_torch.models.mlp import sigmoid, silu

HEAD_DIM = 64
MIX_NAMES = ("r", "k", "v", "g", "w")


def init_rwkv_time_mix(gen, d: int, d_ff_unused: int, dtype, device, *,
                       lora_rank: int = 32, decay_rank: int = 64):
    h = d // HEAD_DIM

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "mix_base": full((5, d), 0.0),
        "mix_lora_a": P.dense_init(gen, d, 5 * lora_rank, dtype, device),
        "mix_lora_b": full((5, lora_rank, d), 0.0),
        "mix_x": full((d,), 0.0),
        "wr": P.dense_init(gen, d, d, dtype, device),
        "wk": P.dense_init(gen, d, d, dtype, device),
        "wv": P.dense_init(gen, d, d, dtype, device),
        "wg": P.dense_init(gen, d, d, dtype, device),
        "wo": P.dense_init(gen, d, d, dtype, device),
        "w_base": full((d,), -6.0),  # slow decay at init
        "w_lora_a": P.dense_init(gen, d, decay_rank, dtype, device),
        "w_lora_b": full((decay_rank, d), 0.0),
        "u": full((h, HEAD_DIM), 0.0),
        "gn_scale": full((d,), 1.0),
        "gn_bias": full((d,), 0.0),
    }


def _token_shift(x, prev):
    """x_{t-1} per position; ``prev`` is the carried token of a stream."""
    prev = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(p, x, xx, lora_rank: int):
    """Data-dependent lerp of the five signals -> {name: mixed input}."""
    dx = xx - x
    base_in = x + dx * p["mix_x"]
    lora = torch.tanh(base_in @ p["mix_lora_a"])         # [B,T,5R]
    b, t, _ = lora.shape
    lora = lora.reshape(b, t, 5, lora_rank)
    delta = torch.einsum("btsr,srd->btsd", lora, p["mix_lora_b"])
    mixes = p["mix_base"][None, None] + delta            # [B,T,5,D]
    return {name: x + dx * mixes[:, :, i]
            for i, name in enumerate(MIX_NAMES)}


def _signals(p, x, prev, lora_rank: int):
    b, t, d = x.shape
    h = d // HEAD_DIM
    m = _ddlerp(p, x, _token_shift(x, prev), lora_rank)
    r = (m["r"] @ p["wr"]).reshape(b, t, h, HEAD_DIM)
    k = (m["k"] @ p["wk"]).reshape(b, t, h, HEAD_DIM)
    v = (m["v"] @ p["wv"]).reshape(b, t, h, HEAD_DIM)
    g = m["g"] @ p["wg"]
    dd = p["w_base"] + torch.tanh(m["w"] @ p["w_lora_a"]) @ p["w_lora_b"]
    log_w = -torch.exp(dd.float()).reshape(b, t, h, HEAD_DIM)
    return r, k, v, g, log_w


def _head_groupnorm(p, y, out_dtype):
    """GroupNorm with one group a head over [B,T,H,Dh] (fp32 statistics,
    applied in ``out_dtype``)."""
    y32 = y.float()
    mu = y32.mean(-1, keepdim=True)
    var = y32.var(-1, unbiased=False, keepdim=True)
    yn = ((y - mu.to(y.dtype))
          * torch.rsqrt(var + 64e-5).to(y.dtype)).to(out_dtype)
    b, t, h, dh = y.shape
    return yn.reshape(b, t, h * dh) * p["gn_scale"] + p["gn_bias"]


def rwkv_time_mix(p, x, *, lora_rank: int = 32, state=None, chunk: int = 32):
    """Full-sequence (train/prefill) time mixing.  Returns (out,
    new_state)."""
    prev = None if state is None else state["shift_t"]
    s0 = None if state is None else state["S"]
    r, k, v, g, log_w = _signals(p, x, prev, lora_rank)
    y, s_new = chunked_decay_scan(r, k, v, log_w, bonus=p["u"],
                                  inclusive=False, chunk=chunk,
                                  initial_state=s0, return_state=True)
    y = _head_groupnorm(p, y, x.dtype)
    out = (y * silu(g)) @ p["wo"]
    return out, {"shift_t": x[:, -1], "S": s_new}


def rwkv_time_mix_step(p, x, state, *, lora_rank: int = 32):
    """Single-token decode.  x [B, D]."""
    r, k, v, g, log_w = _signals(p, x[:, None, :], state["shift_t"],
                                 lora_rank)
    y, s_new = decay_scan_step(r[:, 0], k[:, 0], v[:, 0], log_w[:, 0],
                               state["S"], bonus=p["u"], inclusive=False)
    y = _head_groupnorm(p, y[:, None], x.dtype)
    out = (y * silu(g))[:, 0] @ p["wo"]
    return out, {"shift_t": x, "S": s_new}


# --------------------------------------------------------------------------
# channel mixing
# --------------------------------------------------------------------------

def init_rwkv_channel_mix(gen, d: int, d_ff: int, dtype, device):
    return {
        "mix_k": torch.full((d,), 0.5, dtype=dtype, device=device),
        "mix_r": torch.full((d,), 0.5, dtype=dtype, device=device),
        "wk": P.dense_init(gen, d, d_ff, dtype, device),
        "wv": P.dense_init(gen, d_ff, d, dtype, device),
        "wr": P.dense_init(gen, d, d, dtype, device),
    }


def rwkv_channel_mix(p, x, *, state=None):
    xx = _token_shift(x, None if state is None else state["shift_c"])
    xk = x + (xx - x) * p["mix_k"]
    xr = x + (xx - x) * p["mix_r"]
    kk = torch.square(torch.relu(xk @ p["wk"]))
    out = sigmoid(xr @ p["wr"]) * (kk @ p["wv"])
    return out, {"shift_c": x[:, -1]}


def rwkv_channel_mix_step(p, x, state):
    out, _ = rwkv_channel_mix(p, x[:, None, :],
                              state={"shift_c": state["shift_c"]})
    return out[:, 0], {"shift_c": x}


def init_rwkv_state(batch: int, d: int, dtype, device):
    h = d // HEAD_DIM
    return {
        "shift_t": torch.zeros((batch, d), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, d), dtype=dtype, device=device),
        "S": torch.zeros((batch, h, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                         device=device),
    }
