"""Segmented (rolling) prefix scan — the paper's adapted PRRA scan network.

Every function works along the last axis, so a leading batch axis (windows,
panes, tiles) is written out instead of ``vmap``-ed.  The scan is
Hillis–Steele: log2(N) rounds of (shift, combine, select) over the product
monoid ``(flag, state)``, which is associative whenever ``op`` is.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.combiners import Combiner, tree_map


def _lane(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


def segment_starts(groups: torch.Tensor) -> torch.Tensor:
    """flags[i] = True iff element i begins a new group."""
    prev = torch.roll(groups, 1, dims=-1)
    return (_lane(groups.shape[-1], groups.device) == 0) | (groups != prev)


def segment_ends(groups: torch.Tensor) -> torch.Tensor:
    """flags[i] = True iff element i is the last of its group in the batch
    (the final element is always marked)."""
    n = groups.shape[-1]
    nxt = torch.roll(groups, -1, dims=-1)
    return (_lane(n, groups.device) == n - 1) | (groups != nxt)


def segmented_scan(flags: torch.Tensor, state: Any,
                   combiner: Combiner) -> Any:
    """Inclusive segmented scan of ``state`` along the last axis;
    ``flags[..., i]`` marks the first element of each segment."""
    n = flags.shape[-1]
    lane = _lane(n, flags.device)
    f = flags
    s = state
    d = 1
    while d < n:
        head = lane < d  # nothing to the left at this distance
        prev_s = tree_map(lambda x: torch.roll(x, d, dims=-1), s)
        prev_f = torch.roll(f, d, dims=-1) | head
        merged = combiner.op(prev_s, s)
        keep = f | head
        s = tree_map(lambda m, x: torch.where(keep, x, m), merged, s)
        f = f | prev_f
        d *= 2
    return s


class Carry(NamedTuple):
    """Rolling state of the last open group (the paper's ``n'`` signals)."""
    group: torch.Tensor     # scalar int32 — group id of the open segment
    state: Any              # combiner state folded so far for that group
    nonempty: torch.Tensor  # scalar bool — False before any tuple was seen
    emitted: torch.Tensor   # scalar int32 — total groups finalized so far


def init_carry(combiner: Combiner, key_dtype, device="cpu") -> Carry:
    return Carry(
        group=torch.tensor(-1, dtype=torch.int32, device=device),
        state=combiner.identity((), key_dtype, device),
        nonempty=torch.tensor(False, device=device),
        emitted=torch.tensor(0, dtype=torch.int32, device=device),
    )


def merge_carry(carry: Carry, groups: torch.Tensor, scanned: Any,
                combiner: Combiner) -> Any:
    """Fold the carried state into the batch's leading segment when its
    group matches the carry.  Empty carries pass through untouched, which
    keeps identity-free monoids (distinct_count) exact."""
    starts = segment_starts(groups)
    in_first_seg = torch.cumsum(starts.to(torch.int32), dim=-1) == 1
    applies = carry.nonempty & (carry.group == groups[..., :1])
    mask = in_first_seg & applies
    carry_b = tree_map(lambda c: c.unsqueeze(-1), carry.state)
    merged = combiner.op(carry_b, scanned)
    return tree_map(lambda m, s: torch.where(mask, m, s), merged, scanned)


def update_carry(carry: Carry, groups: torch.Tensor, merged: Any,
                 ends: torch.Tensor, combiner: Combiner,
                 valid_mask: torch.Tensor | None = None) -> Carry:
    """New carry = scan state of the final element."""
    emit = ends if valid_mask is None else ends & valid_mask
    emitted = carry.emitted + emit.to(torch.int32).sum(dtype=torch.int32)
    return Carry(
        group=groups[..., -1].to(torch.int32),
        state=tree_map(lambda s: s[..., -1], merged),
        nonempty=torch.ones_like(carry.nonempty),
        emitted=emitted.to(torch.int32),
    )


def exclusive_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive scan-add along the last axis, in int32."""
    x = x.to(torch.int32)
    return (torch.cumsum(x, dim=-1) - x).to(torch.int32)
