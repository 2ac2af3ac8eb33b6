"""Two-stack SWAG, flip-batched: replay-free time windows for ops without
an inverse (the counterpart of ``repro.core.twostack``).

Pane replay re-aggregates every tuple of every window, O(NW * wcap) work.
Tangwongsan et al.'s two-stack keeps a *front* stack of suffix aggregates
of the older tuples and a *back* running prefix of the newer ones; each
window answer is one combine ``op(front_top, back_agg)``, and when the
front empties the back is **flipped** into suffix form.

Over a batch the flip points depend only on the window boundaries, never
on tuple values, so the schedule is computed on the host and the per-tuple
work becomes data-parallel:

  * :func:`epoch_layout` walks the ``NW`` window ranges once: a new
    **epoch** begins at every flip (the first window whose start passes
    the previous flip point ``hi``);
  * per epoch, one inclusive **suffix scan** over the front region
    ``[f_lo, hi)`` and one inclusive **prefix scan** over the back region
    ``[hi, b_hi)``, as ``[NE, wcap]`` Hillis–Steele sweeps
    (:func:`flip_scans`; on the card the ``twostack_flip`` kernel,
    :mod:`repro_torch.kernels.swag.kernel`);
  * each window reads **two lanes**: its front suffix at ``start - f_lo``
    and its back prefix at ``end - hi``, combined with the op's monoid.

Serves ungrouped queries over :data:`repro_torch.core.swag.PARTIAL_OPS`
(single-tensor monoid states); everything else takes the replay strategy.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.combiners import get_combiner, out_dtype, tree_map
from repro_torch.kernels.common import _shift_left, _shift_right


class EpochLayout(NamedTuple):
    """Host-side flip schedule: window ``j`` belongs to epoch
    ``epoch_id[j]``; epoch ``e``'s front region is ``[f_lo[e], hi[e])``
    and its back region ``[hi[e], b_hi[e])``."""
    epoch_id: np.ndarray  # [NW]
    f_lo: np.ndarray      # [NE]
    hi: np.ndarray        # [NE] flip points
    b_hi: np.ndarray      # [NE] back region end (max window end in epoch)


def epoch_layout(starts: np.ndarray, ends: np.ndarray) -> EpochLayout:
    """Walk the window ranges once, flipping whenever the front region
    would be empty (``start >= hi``) — the two-stack flip rule with the
    value-independent schedule made explicit."""
    nw = starts.shape[0]
    epoch_id = np.zeros(nw, np.int64)
    f_lo, hi, b_hi = [], [], []
    cur = 0
    for j in range(nw):
        if not f_lo or starts[j] >= cur:
            f_lo.append(int(starts[j]))
            cur = int(ends[j])
            hi.append(cur)
            b_hi.append(cur)
        epoch_id[j] = len(f_lo) - 1
        b_hi[-1] = max(b_hi[-1], int(ends[j]))
    return EpochLayout(epoch_id, np.asarray(f_lo, np.int64),
                       np.asarray(hi, np.int64), np.asarray(b_hi, np.int64))


def _region(keys: torch.Tensor, lo: torch.Tensor, length: torch.Tensor,
            wcap: int):
    """``[NE, wcap]`` slices ``keys[lo : lo + length]`` with a liveness
    mask (clipped gather)."""
    n = keys.shape[-1]
    lane = torch.arange(wcap, device=keys.device)
    idx = torch.clamp(lo[:, None] + lane[None, :], 0, max(n - 1, 0))
    live = lane[None, :] < length[:, None]
    return keys[idx], live


def flip_scans(kf, vf, kb, vb, names, key_dtype) -> dict:
    """The batched flip: per op, an inclusive *suffix* scan over the front
    slices and an inclusive *prefix* scan over the back slices (masked
    lanes pinned to the op's identity), along the last axis.  Returns
    ``{name: (front_suffix, back_prefix)}``."""
    wcap = kf.shape[-1]
    dev = kf.device
    out = {}
    for name in names:
        comb = get_combiner(name)
        ident = comb.identity((), key_dtype, dev)
        f = tree_map(lambda s, i: torch.where(vf, s, i), comb.lift(kf),
                     ident)
        b = tree_map(lambda s, i: torch.where(vb, s, i), comb.lift(kb),
                     ident)
        fill = tree_map(lambda i: i.item(), ident)
        d = 1
        while d < wcap:
            f = comb.op(f, tree_map(
                lambda s, i: _shift_left(s, d, i), f, fill))
            b = comb.op(tree_map(
                lambda s, i: _shift_right(s, d, i), b, fill), b)
            d *= 2
        out[name] = (f, b)
    return out


def twostack_time_windows(keys_sorted: torch.Tensor, layout,
                          epochs: EpochLayout, names, *,
                          use_kernel: bool = False):
    """Every time window of one batch via the flip-batched two-stack.
    ``keys_sorted`` is the ts-sorted value column; ``layout`` a
    :class:`repro_torch.core.eventtime.TimeLayout`; ``names``
    PARTIAL_OPS names.  ``use_kernel`` runs the flip through the
    ``twostack_flip`` wrapper (its kernel on the card).

    Returns ``(values {name: [NW]}, counts [NW] int32)`` — the ungrouped
    per-window answers (zero where the window is empty) and tuple counts.
    """
    key_dtype = keys_sorted.dtype
    dev = keys_sorted.device
    wcap = layout.wcap
    nw = layout.starts.shape[0]
    if nw == 0:
        return ({name: torch.zeros((0,), dtype=out_dtype(name, key_dtype),
                                   device=dev) for name in names},
                torch.zeros((0,), dtype=torch.int32, device=dev))

    def col(x):
        return torch.as_tensor(x, dtype=torch.int64, device=dev)

    f_lo, hi = col(epochs.f_lo), col(epochs.hi)
    kf, vf = _region(keys_sorted, f_lo, hi - f_lo, wcap)
    kb, vb = _region(keys_sorted, hi, col(epochs.b_hi) - hi, wcap)
    if use_kernel:
        from repro_torch.kernels.swag.kernel import twostack_flip
        scans = twostack_flip(kf, vf, kb, vb, names)
    else:
        scans = flip_scans(kf, vf, kb, vb, names, key_dtype)

    eid = col(epochs.epoch_id)
    cnt = (layout.ends - layout.starts).to(torch.int32)
    df = layout.starts - f_lo[eid]     # front suffix lane, in [0, wcap]
    db = layout.ends - hi[eid]         # back prefix length, in [0, wcap]
    values = {}
    for name in names:
        comb = get_combiner(name)
        ident = comb.identity((), key_dtype, dev)
        fsuf, bpre = scans[name]
        front = tree_map(
            lambda s, i: torch.where(
                df < wcap, s[eid, torch.clamp(df, max=wcap - 1)], i),
            fsuf, ident)
        back = tree_map(
            lambda s, i: torch.where(
                db > 0, s[eid, torch.clamp(db - 1, min=0)], i),
            bpre, ident)
        v = comb.finalize(comb.op(front, back))
        values[name] = torch.where(cnt > 0, v,
                                   torch.zeros((), dtype=v.dtype, device=dev))
    return values, cnt
