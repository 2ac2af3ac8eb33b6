"""Chunked decaying linear-attention scan — the engine's rolling prefix scan
reused as a sequence mixer (the JAX package's ``repro.models.linear_scan``).

Per head, the linear recurrence

    S_t = Diag(w_t) S_{t-1} + k_t^T v_t              (w_t = exp(log_w_t) <= 1)
    y_t = q_t S_{t-1} + (q_t . u . k_t) v_t          (exclusive + bonus: RWKV6)
    y_t = q_t S_t                                    (inclusive: Mamba2/SSD)

in two levels: a parallel intra-chunk form and a sequential inter-chunk
carry of S (a loop over chunks where the JAX package runs ``lax.scan``).
Every exponential is exp(L_a - L_b) with a >= b and L non-increasing, so
no exponent is positive; all decay math is fp32.

Shapes: q,k [B,T,H,Dk], v [B,T,H,Dv], log_w [B,T,H,Dk] (or [B,T,H,1]).
"""
from __future__ import annotations

import torch


def _pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros appended along axis 1."""
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])],
                     dim=1)


def _tri(chunk: int, offset: int, device) -> torch.Tensor:
    i = torch.arange(chunk, device=device)
    return i[:, None] >= i[None, :] + offset


def chunked_decay_scan(q, k, v, log_w, *, bonus=None, inclusive: bool = False,
                       chunk: int = 32, initial_state=None,
                       return_state: bool = False):
    """Returns y [B,T,H,Dv] (and the final S [B,H,Dk,Dv] if
    ``return_state``)."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    if log_w.shape[-1] == 1:
        log_w = log_w.expand(b, t, h, dk)
    pad = (-t) % chunk
    q, k, v, log_w = (_pad_time(x, pad) for x in (q, k, v, log_w))
    nc = (t + pad) // chunk
    tri = _tri(chunk, 0 if inclusive else 1, q.device)
    s = initial_state
    if s is None:
        s = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    bonus32 = None if bonus is None else bonus.float()
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qc, kc, vc = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        wc = log_w[:, sl].float()
        lw = torch.cumsum(wc, dim=1)            # inclusive L within chunk
        m = lw if inclusive else lw - wc        # exclusive uses L_{t-1}

        # inter-chunk: the carried state's contribution
        y = torch.einsum("bchd,bhdv->bchv", qc * torch.exp(m), s)

        # intra-chunk: masked pairwise decays (mask inside the exp)
        expo = m[:, :, None] - lw[:, None]      # [B, Ct, Cj, H, Dk]
        expo = torch.where(tri[None, :, :, None, None], expo, -torch.inf)
        a = torch.einsum("bthd,bjhd,btjhd->bthj", qc, kc, torch.exp(expo))
        y = y + torch.einsum("bthj,bjhv->bthv", a, vc)

        if bonus32 is not None:                 # RWKV6 u-bonus
            coeff = torch.sum(qc * bonus32 * kc, dim=-1, keepdim=True)
            y = y + coeff * vc

        # carry update (the rolling n' state)
        ltot = lw[:, -1]                        # [B, H, Dk]
        kd = kc * torch.exp(ltot[:, None] - lw)
        s = (torch.exp(ltot)[..., None] * s
             + torch.einsum("bchd,bchv->bhdv", kd, vc))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :t].to(v.dtype)
    return (y, s) if return_state else y


def chunked_scalar_decay_scan(q, k, v, log_w, *, chunk: int = 32,
                              initial_state=None, return_state: bool = False):
    """Scalar-per-head decay (Mamba2/SSD): q, k [B,T,Dk] are shared across
    heads, the decay log_w [B,T,H] a scalar a head, so the intra-chunk term
    factorises into one [B,C,C] score product and a [B,C,C,H] decay.
    v [B,T,H,Dv]; returns y [B,T,H,Dv]."""
    b, t, dk = q.shape
    h, dv = v.shape[2], v.shape[-1]
    pad = (-t) % chunk
    q, k, v, log_w = (_pad_time(x, pad) for x in (q, k, v, log_w))
    nc = (t + pad) // chunk
    tri = _tri(chunk, 0, q.device)
    s = initial_state
    if s is None:
        s = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qc, kc, vc = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        lw = torch.cumsum(log_w[:, sl].float(), dim=1)   # [B,C,H] inclusive

        # inter-chunk: project through the carry, then the per-head decay
        y = torch.einsum("bcd,bhdv->bchv", qc, s) * torch.exp(lw)[..., None]

        # intra-chunk: shared scores x per-head pairwise decay
        scores = torch.einsum("btd,bjd->btj", qc, kc)
        expo = lw[:, :, None] - lw[:, None, :, :]         # [B,Ct,Cj,H]
        expo = torch.where(tri[None, :, :, None], expo, -torch.inf)
        y = y + torch.einsum("btj,btjh,bjhv->bthv", scores, torch.exp(expo),
                             vc)

        # carry: S' = exp(Ltot) S + sum_j k_j (x) (e^{Ltot-L_j} v_j)
        ltot = lw[:, -1]                                  # [B,H]
        wv = torch.exp(ltot[:, None] - lw)[..., None] * vc
        s = (torch.exp(ltot)[..., None, None] * s
             + torch.einsum("bjd,bjhv->bhdv", kc, wv))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :t].to(v.dtype)
    return (y, s) if return_state else y


def decay_scan_step(q, k, v, log_w, s, *, bonus=None,
                    inclusive: bool = False):
    """Single-token decode step.  q,k [B,H,Dk], v [B,H,Dv], s [B,H,Dk,Dv].
    Returns (y [B,H,Dv], new_s)."""
    if log_w.shape[-1] == 1:
        log_w = log_w.expand(q.shape)
    w = torch.exp(log_w.float())
    q32, k32, v32 = q.float(), k.float(), v.float()
    outer = k32[..., :, None] * v32[..., None, :]
    if inclusive:
        s_new = w[..., None] * s + outer
        y = torch.einsum("bhd,bhdv->bhv", q32, s_new)
    else:
        y = torch.einsum("bhd,bhdv->bhv", q32, s)
        if bonus is not None:
            y = y + torch.sum(q32 * bonus * k32, dim=-1, keepdim=True) * v32
        s_new = w[..., None] * s + outer
    return y.to(v.dtype), s_new

