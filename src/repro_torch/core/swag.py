"""Sliding-window aggregation (SWAG) over count windows — the paper's Fig. 4
pipeline, global-window half.

    window buffer (WS, WA)  ->  small sorter  ->  group-by-aggregate engine

Windows are a strided view of the stream (``unfold``) and run as a batch
axis through the engine.  When ``WA < WS`` (both powers of two, WA dividing
WS) the pane path sorts each WA-pane once and assembles every window from
its P = WS/WA presorted panes: by a bitonic merge (median, mean, dc, float
sums) or, for the incremental sum/count/min/max, by merging the panes'
per-group partials.  A fully (group, key)-sorted window is unique, so every
path feeds identical windows to identical tails.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import engine as _engine
from repro_torch.core import segscan, sorter
from repro_torch.core.combiners import (Combiner, get_combiner,
                                        partial_combiner)

#: ops whose engine state is a single array combined by an associative,
#: commutative op with identity finalize — eligible for shared partials
PARTIAL_OPS = frozenset({"sum", "count", "min", "max"})


def num_windows(n: int, ws: int, wa: int) -> int:
    if ws > n:
        return 0
    return (n - ws) // wa + 1


def frame_windows(x: torch.Tensor, ws: int, wa: int) -> torch.Tensor:
    """[N] -> [num_windows, WS] strided view (tuples reused when WA < WS)."""
    if num_windows(x.shape[-1], ws, wa) == 0:
        return x.new_empty(x.shape[:-1] + (0, ws))
    return x.unfold(-1, ws, wa)


def pane_compatible(ws: int, wa: int) -> bool:
    """True when the pane fast path applies: WS a multiple of WA, both powers
    of two (the bitonic merge network's wiring constraint), WA < WS."""
    return (0 < wa < ws and ws % wa == 0
            and ws & (ws - 1) == 0 and wa & (wa - 1) == 0)


def frame_panes(x: torch.Tensor, wa: int, num_panes: int) -> torch.Tensor:
    """[N] -> [num_panes, WA] non-overlapping panes (the trailing remainder
    that can never complete a window is dropped)."""
    return x[..., :num_panes * wa].reshape(x.shape[:-1] + (num_panes, wa))


def resolve_panes(ws: int, wa: int, n: int, panes: bool | None, *,
                  presorted: bool = False) -> bool:
    """Resolve the ``panes`` tri-state: ``None`` auto-dispatches, ``False``
    forces the re-sort path, ``True`` forces panes and raises when they
    cannot apply — never a silent fallback."""
    if panes is None:
        return ((not presorted) and pane_compatible(ws, wa)
                and num_windows(n, ws, wa) > 0)
    if not panes:
        return False
    if presorted:
        raise ValueError("panes=True cannot apply to presorted windows — "
                         "the pane path frames and sorts the raw stream")
    if not (pane_compatible(ws, wa) or (ws == wa and ws & (ws - 1) == 0)):
        raise ValueError(f"pane path needs power-of-two WS/WA with WA "
                         f"dividing WS, got ws={ws} wa={wa}")
    if num_windows(n, ws, wa) == 0:
        raise ValueError(f"no complete window: n={n} < ws={ws}")
    return True


def _pane_windows(panes: torch.Tensor, nw: int, p: int) -> torch.Tensor:
    """[NP, WA] -> [NW, P*WA]: window w = panes w .. w+P-1."""
    widx = (torch.arange(nw, device=panes.device)[:, None]
            + torch.arange(p, device=panes.device)[None, :])
    return panes[widx].reshape(nw, p * panes.shape[1])


def _swag(groups, keys, *, ws: int, wa: int, op="sum",
          presorted: bool = False,
          panes: bool | None = None) -> _engine.GroupAggResult:
    """Sliding-window group-by-aggregate; arrays carry a leading
    ``[num_windows]`` axis."""
    if op == "median":
        raise ValueError("op='median' is not a combiner — use swag_median "
                         "(or swag_panes, which returns a MedianResult)")
    if resolve_panes(ws, wa, groups.shape[-1], panes, presorted=presorted):
        return swag_panes(groups, keys, ws=ws, wa=wa, op=op)
    g = frame_windows(groups, ws, wa)
    k = frame_windows(keys, ws, wa)
    if not presorted:
        g, k = sorter.sort_pairs(g, k, full_width=True)
    return _engine._group_by_aggregate(g, k, op)


def _sort_panes(groups, keys, *, ws: int, wa: int):
    """Frame + sort each pane once by (group, key). Returns (pg, pk, nw, p)."""
    p = ws // wa
    nw = num_windows(groups.shape[-1], ws, wa)
    np_ = nw + p - 1  # panes that take part in at least one window
    pg = frame_panes(groups, wa, np_)
    pk = frame_panes(keys, wa, np_)
    pg, pk = sorter.sort_pairs(pg, pk, full_width=True)
    return pg, pk, nw, p


def _merged_windows(pg, pk, *, nw: int, p: int, wa: int):
    """Sorted [NW, P*WA] windows from presorted panes: window w merges
    panes w .. w+P-1."""
    g = _pane_windows(pg, nw, p)
    k = _pane_windows(pk, nw, p)
    if p > 1:
        g, k = sorter.merge_presorted((g, k), run=wa, num_keys=2)
    return g, k


def swag_panes(groups, keys, *, ws: int, wa: int, op="sum",
               interpolate: bool = False):
    """Pane-based SWAG: sort each WA-pane once, share it across the P
    windows containing it.  ``op="median"`` returns a :class:`MedianResult`."""
    resolve_panes(ws, wa, groups.shape[-1], True)  # validate or raise
    pg, pk, nw, p = _sort_panes(groups, keys, ws=ws, wa=wa)

    if op == "median":
        g, k = _merged_windows(pg, pk, nw=nw, p=p, wa=wa)
        return _median_sorted_window(g, k, interpolate=interpolate)
    if pane_table_channel((op,), keys.dtype, p)[0]:
        return _swag_shared_partials(pg, pk, nw=nw, p=p, wa=wa, op=op)
    return _engine._group_by_aggregate(
        *_merged_windows(pg, pk, nw=nw, p=p, wa=wa), op)


def _swag_shared_partials(pg, pk, *, nw: int, p: int, wa: int,
                          op: str) -> _engine.GroupAggResult:
    """One engine pass per pane, then per window a merge of P compacted
    partial runs + one combining engine pass (identity-lift combiner)."""
    partial = _engine._group_by_aggregate(pg, pk, op)
    wg = _pane_windows(partial.groups, nw, p)
    wv = _pane_windows(partial.values, nw, p)
    widx = (torch.arange(nw, device=pg.device)[:, None]
            + torch.arange(p, device=pg.device)[None, :])
    n_valid = partial.num_groups[widx].sum(-1, dtype=torch.int32)
    g, v = sorter.merge_presorted((wg, wv), run=wa, num_keys=2)
    return _engine._group_by_aggregate(
        g, v, partial_combiner(get_combiner(op)), n_valid=n_valid)


class MedianResult(NamedTuple):
    groups: torch.Tensor      # [..., WS]
    medians: torch.Tensor     # [..., WS] (float32 if interpolate else key dtype)
    valid: torch.Tensor       # [..., WS]
    num_groups: torch.Tensor  # [...]


def _median_sorted_window(g, k, *, interpolate: bool,
                          n_valid=None) -> MedianResult:
    """Median per group of closed, (group, key)-sorted windows: counts and
    group start offsets from one engine pass, then the middle element(s)
    of each group's run.  Also serves grouped median without a window
    (``n_valid`` marks the real prefix)."""
    counts = _engine._group_by_aggregate(g, k, "count", n_valid=n_valid)
    n = g.shape[-1]
    if n_valid is not None:
        g = torch.where(_engine._prefix_mask(n, n_valid, g.device), g,
                        _engine.PAD_GROUP)
    starts = segscan.segment_starts(g)
    seg_id = torch.cumsum(starts.to(torch.int64), dim=-1) - 1
    lane = torch.arange(n, dtype=torch.int32, device=g.device).expand(g.shape)
    start_pos = torch.full(g.shape, n, dtype=torch.int32,
                           device=g.device).scatter_reduce(
        -1, seg_id, lane, reduce="amin")
    cnt = counts.values.to(torch.int32)
    lo_idx = start_pos + torch.clamp(cnt - 1, min=0) // 2
    hi_idx = start_pos + cnt // 2
    lo = torch.gather(k, -1, torch.clamp(lo_idx, 0, n - 1).long())
    if interpolate:
        hi = torch.gather(k, -1, torch.clamp(hi_idx, 0, n - 1).long())
        med = (lo.to(torch.float32) + hi.to(torch.float32)) / 2.0
    else:
        med = lo  # lower median (stays in the key domain)
    return MedianResult(counts.groups, med, counts.valid, counts.num_groups)


def _swag_median(groups, keys, *, ws: int, wa: int,
                 interpolate: bool = False,
                 panes: bool | None = None) -> MedianResult:
    """Median per group per window (the paper's non-incremental example)."""
    if resolve_panes(ws, wa, groups.shape[-1], panes):
        return swag_panes(groups, keys, ws=ws, wa=wa, op="median",
                          interpolate=interpolate)
    g, k = sorter.sort_pairs(frame_windows(groups, ws, wa),
                             frame_windows(keys, ws, wa), full_width=True)
    return _median_sorted_window(g, k, interpolate=interpolate)


def window_tails(g, k, pairs, *, interpolate: bool = False):
    """All requested tails over closed, (group, key)-sorted windows.
    Non-median ops share one fused engine pass.  ``pairs`` is
    ``((op, name), ...)``."""
    out = {}
    shared = None
    non_median = tuple(op for op, name in pairs if name != "median")
    if non_median:
        (tg, tvalues, tvalid, tnum), _ = _engine.multi_engine_step(
            g, k, non_median)
        out.update(tvalues)
        shared = (tg, tvalid, tnum)
    if any(name == "median" for _, name in pairs):
        t = _median_sorted_window(g, k, interpolate=interpolate)
        out["median"] = t.medians
        shared = shared or (t.groups, t.valid, t.num_groups)
    return shared[0], out, shared[1], shared[2]


def pane_table_channel(ops, key_dtype: torch.dtype, p: int) -> list[bool]:
    """Which ops take the per-pane partial-table channel (True) vs the
    merged-window channel (False) on the pane path: PARTIAL_OPS when panes
    share work (``p > 1``), float sums excepted: combining per-pane partial
    sums reorders float additions."""
    reorder_sensitive = key_dtype.is_floating_point
    return [isinstance(op, str) and op in PARTIAL_OPS and p > 1
            and not (op == "sum" and reorder_sensitive)
            for op in ops]


def swag_multi(groups, keys, *, ws: int, wa: int, ops: tuple,
               interpolate: bool = False, presorted: bool = False,
               panes: bool | None = None):
    """Fused multi-op SWAG: frame + sort (or pane-merge) each window once,
    then every requested tail over the same sorted windows.  Returns
    ``(out_groups, values, valid, num_groups)`` with a leading
    ``[num_windows]`` axis."""
    names = [op.name if isinstance(op, Combiner) else op for op in ops]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate ops in fused SWAG: {names}")

    if resolve_panes(ws, wa, groups.shape[-1], panes, presorted=presorted):
        pg, pk, nw, p = _sort_panes(groups, keys, ws=ws, wa=wa)
        partial_sel = pane_table_channel(ops, keys.dtype, p)
        merge_pairs = tuple((op, name) for (op, name), sel
                            in zip(zip(ops, names), partial_sel) if not sel)
        values: dict = {}
        shared = None
        for op, sel in zip(ops, partial_sel):
            if sel:
                t = _swag_shared_partials(pg, pk, nw=nw, p=p, wa=wa, op=op)
                values[op] = t.values
                shared = shared or (t.groups, t.valid, t.num_groups)
        if merge_pairs:
            mg, mvalues, mvalid, mnum = window_tails(
                *_merged_windows(pg, pk, nw=nw, p=p, wa=wa), merge_pairs,
                interpolate=interpolate)
            values.update(mvalues)
            shared = (mg, mvalid, mnum)
        return shared[0], values, shared[1], shared[2]

    g = frame_windows(groups, ws, wa)
    k = frame_windows(keys, ws, wa)
    if not presorted:
        g, k = sorter.sort_pairs(g, k, full_width=True)
    return window_tails(g, k, tuple(zip(ops, names)),
                        interpolate=interpolate)
