"""Attention: GQA/MHA, causal / bidirectional / sliding-window, cross-attn,
KV caches (dense, and a ring buffer for sliding windows), query-blocked
prefill — the JAX package's ``repro.models.attention`` in torch.

Conventions:
  x           [B, T, D]
  q           [B, T, H, Dh]           (H = num query heads)
  k, v        [B, S, Hkv, Dh]         (GQA: H = Hkv * G)
  KV cache    {"k": [B, Smax, Hkv, Dh], "v": ..., "len": 0-d int32}

GQA runs as grouped einsums (KV never repeated to H).  Scores and the
probabilities' products are taken in fp32 (the JAX einsums'
``preferred_element_type``), the softmax in fp32.  Prefill runs in query
blocks (a loop where JAX scans); the sliding-window path slices only the
[window + block] key span of each query block.  The caches are updated in
place (JAX returns new arrays): a decode step writes one slot.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models import params as P

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_attention(gen, d_model: int, num_heads: int, num_kv: int,
                   head_dim: int, dtype, device, *, qkv_bias: bool = False,
                   out_scale: float | None = None):
    p = {
        "wq": P.dense_init(gen, d_model, num_heads * head_dim, dtype, device),
        "wk": P.dense_init(gen, d_model, num_kv * head_dim, dtype, device),
        "wv": P.dense_init(gen, d_model, num_kv * head_dim, dtype, device),
        "wo": P.dense_init(gen, num_heads * head_dim, d_model, dtype, device,
                           scale=out_scale),
    }
    if qkv_bias:
        for name, width in (("bq", num_heads), ("bk", num_kv),
                            ("bv", num_kv)):
            p[name] = torch.zeros((width * head_dim,), dtype=dtype,
                                  device=device)
    return p


# --------------------------------------------------------------------------
# qkv projection + rope
# --------------------------------------------------------------------------

def project_qkv(params, xq: torch.Tensor, xkv: torch.Tensor, *,
                num_heads: int, num_kv: int, head_dim: int,
                positions_q: torch.Tensor | None,
                positions_kv: torch.Tensor | None, rotary_dim: int,
                rope_theta: float):
    b, tq, _ = xq.shape
    tkv = xkv.shape[1]
    q = xq @ params["wq"]
    k = xkv @ params["wk"]
    v = xkv @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, tq, num_heads, head_dim)
    k = k.reshape(b, tkv, num_kv, head_dim)
    v = v.reshape(b, tkv, num_kv, head_dim)
    if rotary_dim:
        if positions_q is not None:
            sin, cos = L.rope_angles(positions_q, rotary_dim, rope_theta)
            q = L.apply_rope(q, sin, cos, rotary_dim)
        if positions_kv is not None:
            sin, cos = L.rope_angles(positions_kv, rotary_dim, rope_theta)
            k = L.apply_rope(k, sin, cos, rotary_dim)
    return q, k, v


# --------------------------------------------------------------------------
# core attention (grouped, blocked over queries)
# --------------------------------------------------------------------------

def _attend_block(q, k, v, bias):
    """q [B,Tq,Hkv,G,Dh], k/v [B,S,Hkv,Dh], bias [Tq,S] or None ->
    [B,Tq,Hkv,G,Dh]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhgd,bshd->bhgqs", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


def _mask_bias(mode: str, q_pos, k_pos, window: int):
    """[Tq, S] additive bias; q_pos/k_pos absolute positions (int32)."""
    if mode == "full":
        return None
    d = q_pos[:, None] - k_pos[None, :]
    allowed = d >= 0
    if mode == "swa":
        allowed = allowed & (d < window)
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(allowed, zero, NEG_INF)


def attend(q, k, v, *, mode: str = "causal", window: int = 0,
           q_positions=None, k_positions=None, q_block: int = 0):
    """Grouped-query attention, looped over query blocks.

    mode: "causal" | "full" | "swa" (requires ``window``).  Positions
    default to aligned arange (self-attention at offset 0).  ``q_block=0``
    sizes the blocks as the JAX package does."""
    b, tq, h, dh = q.shape
    s = k.shape[1]
    hkv = k.shape[2]
    g = h // hkv
    if q_block == 0:
        q_block = 1024 if s <= 8192 else 256
    if tq % q_block:
        # the largest divisor of tq not above q_block (whisper's 1500
        # frames); one block when there is none above 64
        d = q_block
        while d > 64 and tq % d:
            d -= 1
        q_block = d if tq % d == 0 else tq
    qg = q.reshape(b, tq, hkv, g, dh)
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(tq, dtype=torch.int32, device=dev)
    if k_positions is None:
        k_positions = torch.arange(s, dtype=torch.int32, device=dev)

    if tq <= q_block:
        bias = _mask_bias(mode, q_positions, k_positions, window)
        return _attend_block(qg, k, v, bias).reshape(b, tq, h, dh)

    outs = []
    sliced = mode == "swa" and window + q_block < s
    span = _ceil_mult(window + q_block, 128)
    for i in range(tq // q_block):
        qi = qg[:, i * q_block:(i + 1) * q_block]
        pi = q_positions[i * q_block:(i + 1) * q_block]
        if sliced:
            # only the live key span of this block: O(T * (W + blk))
            start = min(max(i * q_block + q_block - span, 0), s - span)
            kp = start + torch.arange(span, dtype=torch.int32, device=dev)
            bias = _mask_bias(mode, pi, kp, window)
            outs.append(_attend_block(qi, k[:, start:start + span],
                                      v[:, start:start + span], bias))
        else:
            bias = _mask_bias(mode, pi, k_positions, window)
            outs.append(_attend_block(qi, k, v, bias))
    return torch.cat(outs, dim=1).reshape(b, tq, h, dh)


def _ceil_mult(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# --------------------------------------------------------------------------
# KV cache
# --------------------------------------------------------------------------

def init_cache(batch: int, max_len: int, num_kv: int, head_dim: int, dtype,
               device):
    shape = (batch, max_len, num_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def cache_prefill(cache, k, v):
    """Write a prefill's k/v [B, T, Hkv, Dh] at the cache's start (in
    place); the cache then holds T entries."""
    t = k.shape[1]
    cache["k"][:, :t] = k
    cache["v"][:, :t] = v
    return {"k": cache["k"], "v": cache["v"],
            "len": torch.full((), t, dtype=torch.int32,
                              device=cache["len"].device)}


def cache_append(cache, k, v, *, ring: bool = False):
    """Append one step (k/v [B, 1, Hkv, Dh]) in place; ``ring=True`` wraps
    (sliding window).  Past a dense cache's end the write lands on its last
    slot, where ``dynamic_update_slice`` clamps it in the JAX package."""
    smax = cache["k"].shape[1]
    pos = cache["len"] % smax if ring else cache["len"].clamp(max=smax - 1)
    idx = pos.long().reshape(1)
    cache["k"].index_copy_(1, idx, k)
    cache["v"].index_copy_(1, idx, v)
    return {"k": cache["k"], "v": cache["v"], "len": cache["len"] + 1}


def decode_attend(q, cache, *, mode: str = "causal", window: int = 0):
    """Single-step attention against the cache.  q [B, 1, H, Dh].

    For ring caches every occupied slot is in-window by construction, so
    the mask is slot occupancy; for dense caches it is ``slot < len``."""
    b, _, h, dh = q.shape
    smax = cache["k"].shape[1]
    hkv = cache["k"].shape[2]
    qg = q.reshape(b, 1, hkv, h // hkv, dh)
    slots = torch.arange(smax, dtype=torch.int32, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(slots < cache["len"], zero, NEG_INF)[None, :]
    out = _attend_block(qg, cache["k"], cache["v"], bias)
    return out.reshape(b, 1, h, dh)
