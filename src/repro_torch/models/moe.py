"""Mixture-of-Experts with sort-based dispatch — the paper's engine as a
model feature (the JAX package's ``repro.models.moe``).

Token-to-expert routing is a streaming group-by with the expert id as the
group.  The ``sorted`` dispatch is the engine's pipeline:

  1. a stable sort of the (expert, token) assignments     (the sorter)
  2. the rank within each expert, a segmented count scan  (the entities n)
  3. per-expert counts for the aux loss and telemetry     (group-by count)
  4. a capacity-clipped scatter into [E, C, D]            (the compaction)

Step 2 runs on **the segmented-scan kernel** on CUDA tensors
(``repro_torch.kernels.segscan.ops.segmented_scan_cuda``, op ``count``),
and on the plain :func:`repro_torch.core.segscan.segmented_scan` on CPU
tensors; the kernel never gives way to the plain version.  The ``onehot``
dispatch (GShard's dense masks) is the baseline.  Gating math in fp32.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import segscan
from repro_torch.core.combiners import get_combiner
from repro_torch.kernels.segscan.ops import segmented_scan_cuda
from repro_torch.models import params as P
from repro_torch.models.mlp import gelu, silu


def init_moe(gen, d_model: int, d_ff: int, num_experts: int, dtype, device,
             *, mlp_kind: str = "swiglu", out_scale: float | None = None):
    def experts(d_in, d_out, scale=None):
        std = scale if scale is not None else 1.0 / math.sqrt(d_in)
        return P.truncated_normal(gen, (num_experts, d_in, d_out), dtype,
                                  device, std=std)

    return {
        "router": P.dense_init(gen, d_model, num_experts, dtype, device),
        "w_gate": experts(d_model, d_ff),
        "w_up": experts(d_model, d_ff),
        "w_down": experts(d_ff, d_model, out_scale),
    }


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor       # load-balance loss (Switch/GShard form)
    expert_counts: torch.Tensor  # [E] tokens routed a expert (pre-capacity)
    dropped: torch.Tensor        # share of assignments dropped by capacity


def route(p, x, num_experts_per_tok: int):
    """Top-k routing.  x [N, D] -> (experts [N, k] int32, gates [N, k]
    fp32, all gates [N, E]).  Ties go to the lower expert id, as
    ``lax.top_k`` breaks them."""
    logits = (x @ p["router"]).float()
    gates_all = torch.softmax(logits, dim=-1)
    order = torch.sort(gates_all, dim=-1, descending=True, stable=True)
    top_gates = order.values[:, :num_experts_per_tok]
    top_experts = order.indices[:, :num_experts_per_tok]
    top_gates = top_gates / top_gates.sum(-1, keepdim=True)
    return top_experts.to(torch.int32), top_gates, gates_all


def _aux_loss(gates_all, experts, num_experts: int):
    """Switch-style load-balance loss: E * sum_e f_e * p_e."""
    n = gates_all.shape[0]
    counts = torch.zeros((num_experts,), dtype=torch.float32,
                         device=gates_all.device)
    counts.index_add_(0, experts.reshape(-1).long(),
                      torch.ones(experts.numel(), dtype=torch.float32,
                                 device=gates_all.device))
    f = counts / max(n * experts.shape[-1], 1)
    return num_experts * torch.sum(f * gates_all.mean(0))


def _expert_ffn(p, xe, mlp_kind: str):
    """xe [E, C, D] -> [E, C, D] through each expert's FFN (batched)."""
    if mlp_kind == "swiglu":
        h = silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
        return torch.bmm(h, p["w_down"])
    return torch.bmm(gelu(torch.bmm(xe, p["w_up"])), p["w_down"])


def _count(n: int, device) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.int32, device=device)


def rank_in_expert(starts: torch.Tensor) -> torch.Tensor:
    """The segmented ``count`` scan over the sorted assignments (each
    segment one expert), less one: every assignment's 0-based rank in its
    expert.  On a CUDA tensor one launch of the segmented-scan kernel; on
    a CPU tensor the wrapper's plain version."""
    ones = _count(starts.shape[-1], starts.device)
    return segmented_scan_cuda(starts, ones, "count") - 1


def rank_in_expert_plain(starts: torch.Tensor) -> torch.Tensor:
    """:func:`rank_in_expert` by the plain scan on any device: what the
    kernel is held to on the card."""
    ones = _count(starts.shape[-1], starts.device)
    return segscan.segmented_scan(starts, ones, get_combiner("count")) - 1


class Dispatch(NamedTuple):
    """Where the sorted dispatch puts each (token, expert) assignment, in
    the sorted order."""
    experts: torch.Tensor   # [N*k] int32 expert ids, sorted (stably)
    perm: torch.Tensor      # [N*k] the sort's permutation of the flat ids
    rank: torch.Tensor      # [N*k] int32 0-based rank within the expert
    keep: torch.Tensor      # [N*k] bool: rank < capacity
    slot: torch.Tensor      # [N*k] int64 row of [E*C+1, D]; E*C if dropped


def dispatch(experts, num_experts: int, capacity: int, *,
             rank_scan: Callable | None = None) -> Dispatch:
    """Steps 1-3 of the sorted dispatch: the stable sort of the flat
    expert ids (``lax.sort(..., is_stable=True)`` in the JAX package), the
    segmented count scan's ranks (``rank_scan``, default
    :func:`rank_in_expert`) and the capacity clip."""
    se, perm = torch.sort(experts.reshape(-1), stable=True)
    rank = (rank_scan or rank_in_expert)(segscan.segment_starts(se))
    keep = rank < capacity
    slot = torch.where(keep, se * capacity + rank,
                       num_experts * capacity).long()
    return Dispatch(se, perm, rank, keep, slot)


def moe_sorted(p, x, *, num_experts: int, num_experts_per_tok: int,
               capacity_factor: float = 1.25, mlp_kind: str = "swiglu",
               rank_scan: Callable | None = None):
    """Sort-based dispatch (the paper's engine).  x [N, D] -> ([N, D],
    stats).  ``rank_scan`` (default :func:`rank_in_expert`) maps the
    sorted stream's segment starts to the ranks."""
    n, d = x.shape
    k = num_experts_per_tok
    capacity = _capacity(n, num_experts, k, capacity_factor)
    slots = num_experts * capacity
    experts, gates, gates_all = route(p, x, k)
    dp = dispatch(experts, num_experts, capacity, rank_scan=rank_scan)
    stok = torch.div(dp.perm, k, rounding_mode="floor")
    sgate = gates.reshape(-1)[dp.perm]

    # the dispatch buffer [E, C, D]: the dropped assignments all land on
    # the sentinel row, which is cut off
    xe = x.new_zeros((slots + 1, d))
    xe[dp.slot] = x[stok]
    ye = _expert_ffn(p, xe[:-1].reshape(num_experts, capacity, d), mlp_kind)

    # 4. combine: the gate-weighted scatter-add back to token order
    yflat = ye.reshape(slots, d)
    gate_w = (sgate * dp.keep.float()).to(yflat.dtype)
    contrib = yflat[dp.slot.clamp(max=slots - 1)] * gate_w[:, None]
    y = yflat.new_zeros((n, d)).index_add_(0, stok, contrib)

    flat_e = experts.reshape(-1)
    counts = torch.zeros((num_experts,), dtype=torch.int32, device=x.device)
    counts.index_add_(0, flat_e.long(), _count(flat_e.numel(), x.device))
    stats = MoEStats(aux_loss=_aux_loss(gates_all, experts, num_experts),
                     expert_counts=counts,
                     dropped=1.0 - dp.keep.float().mean())
    return y.to(x.dtype), stats


def moe_onehot(p, x, *, num_experts: int, num_experts_per_tok: int,
               capacity_factor: float = 1.25, mlp_kind: str = "swiglu"):
    """GShard-style dense one-hot dispatch — the non-sorted baseline."""
    n, d = x.shape
    k = num_experts_per_tok
    capacity = _capacity(n, num_experts, k, capacity_factor)
    experts, gates, gates_all = route(p, x, k)

    onehot = F.one_hot(experts.long(), num_experts).float()      # [N,k,E]
    pos = torch.cumsum(onehot.reshape(n * k, num_experts), dim=0).reshape(
        n, k, num_experts) * onehot - 1.0
    keep = (pos < capacity) & (pos >= 0)
    # jax.nn.one_hot of an out-of-range position is all zeros
    pos_oh = (pos[..., None] == torch.arange(
        capacity, dtype=torch.float32, device=x.device)).float() \
        * keep[..., None].float()                                 # [N,k,E,C]
    dispatch = torch.einsum("nke,nkec->nec", onehot, pos_oh)
    combine = torch.einsum("nk,nke,nkec->nec", gates, onehot, pos_oh)

    xe = torch.einsum("nd,nec->ecd", x.float(), dispatch)
    ye = _expert_ffn(p, xe.to(x.dtype), mlp_kind)
    y = torch.einsum("ecd,nec->nd", ye.float(), combine)

    stats = MoEStats(
        aux_loss=_aux_loss(gates_all, experts, num_experts),
        expert_counts=onehot.sum((0, 1)).to(torch.int32),
        dropped=1.0 - (keep.sum(-1) > 0).float().mean())
    return y.to(x.dtype), stats


def moe_ffn(p, x, *, num_experts: int, num_experts_per_tok: int,
            capacity_factor: float = 1.25, mlp_kind: str = "swiglu",
            dispatch: str = "sorted", ctx=None,
            rank_scan: Callable | None = None):
    """x [B, T, D] -> (y [B, T, D], stats).  dispatch: "sorted" |
    "onehot".  On one device: the expert-parallel engine of the JAX
    package (``moe_sorted_ep``, taken under a mesh-bound ``ctx``) needs
    the sharding scheme, which the port does not have yet; ``ctx`` is
    accepted and not used."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    kw = dict(num_experts=num_experts,
              num_experts_per_tok=num_experts_per_tok,
              capacity_factor=capacity_factor, mlp_kind=mlp_kind)
    if dispatch == "sorted":
        y, stats = moe_sorted(p, xf, rank_scan=rank_scan, **kw)
    else:
        y, stats = moe_onehot(p, xf, **kw)
    return y.reshape(b, t, d), stats


def _capacity(n: int, num_experts: int, k: int, factor: float) -> int:
    cap = int(n * k * factor / num_experts)
    return max(8, ((cap + 7) // 8) * 8)
