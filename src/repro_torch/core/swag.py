"""Sliding-window aggregation (SWAG) over count windows — the paper's Fig. 4
pipeline: global windows, and per-group windows on the pane store.

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
from repro_torch.core import panestore as _panestore
from repro_torch.core import segscan, sorter
from repro_torch.core.combiners import (Combiner, _acc_dtype, get_combiner,
                                        is_integer, out_dtype,
                                        partial_combiner)

PAD_GROUP = _engine.PAD_GROUP
INT32_MIN = torch.iinfo(torch.int32).min
INT32_MAX = torch.iinfo(torch.int32).max

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


# ----------------------------------------------------------------------
# per-group windows on the shared pane store (repro_torch.core.panestore)
# ----------------------------------------------------------------------

def per_group_chunk_scan(spec, state, groups, keys, emit):
    """Thread a pane store over the WA-sized chunks of the stream (the
    trailing remainder stays unpushed) and apply ``emit`` to the stores
    after every chunk, stacked along a leading ``[NE]`` axis.  Returns
    ``(final_state, emit(stacked states))``."""
    trace = _panestore.scan(spec, state, groups, keys)
    return trace.final, emit(trace.states)


def _group_ranks(groups: torch.Tensor):
    """Within-group arrival rank of every tuple, plus the stable group-sort
    permutation and the group-sorted ids."""
    n = groups.shape[-1]
    order = torch.sort(groups, stable=True).indices
    sg = groups[order]
    pos = torch.arange(n, dtype=torch.int32, device=groups.device)
    starts = torch.ones((n,), dtype=torch.bool, device=groups.device)
    starts[1:] = sg[1:] != sg[:-1]
    seg_start = torch.cummax(torch.where(starts, pos, 0), 0).values
    ranks = torch.empty_like(pos)
    ranks[order] = pos - seg_start
    return ranks, order.to(torch.int32), sg


def _pergroup_dir_scan(spec, groups: torch.Tensor, ranks: torch.Tensor):
    """Directory-only push scan over every full chunk, carrying each slot's
    ``abase`` (the arrival rank of its first tuple; unlike the store-local
    ``base`` it never resets, so windows derived from it map onto positions
    of the group-sorted stream across eviction epochs).  Returns ``(carry,
    (owner, abase, count) snapshots [NE, C])`` with ``carry = (owner,
    count, base, abase, stamp, clock)``."""
    trace = _panestore.scan(spec, _panestore.init_store(
        spec, device=groups.device), groups, ranks=ranks)
    f = trace.final
    carry = (f.owner, f.count, f.base, trace.final_abase, f.stamp, f.clock)
    return carry, (trace.states.owner, trace.abase, trace.states.count)


def _owner_segments(own_s: torch.Tensor):
    """The per-evaluation group directory of ``[NE, C]`` owner snapshots
    (the JAX package's ``_snapshot_directory``), with what per-group
    reductions need in place of its ``[NE, C, C]`` same-owner masks:
    ``(perm, seg, ugroups, num)`` — the owner-sorted slot permutation, each
    sorted position's group row (``C`` for free slots), the unique live ids
    (ascending, PAD tail) and their count."""
    ne, c = own_s.shape
    so, perm = torch.sort(own_s, dim=1, stable=True)
    occupied = so != PAD_GROUP
    lane = torch.arange(c, device=own_s.device)
    prev = torch.cat([torch.full((ne, 1), PAD_GROUP, dtype=torch.int32,
                                 device=own_s.device), so[:, :-1]], 1)
    firsts = occupied & ((so != prev) | (lane == 0))
    f32 = firsts.to(torch.int32)
    num = f32.sum(1, dtype=torch.int32)
    row = torch.cumsum(f32, 1, dtype=torch.int32) - 1
    seg = torch.where(occupied, row, c).to(torch.int64)
    rank = torch.where(firsts, row, c).to(torch.int64)
    ugroups = _engine._scatter_drop(so.shape, PAD_GROUP, torch.int32, rank,
                                    so, c)
    return perm, seg, ugroups, num


def _segment_reduce(perm, seg, vals, reduce: str, fill):
    """Reduce ``vals [NE, C]`` over the slots of each group row: returns
    ``(per_row [NE, C], per_slot [NE, C])`` — the value of row r, and the
    value of each slot's owner (``fill`` for free slots and past ``num``)."""
    ne, c = vals.shape
    out = torch.full((ne, c + 1), fill, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(1, seg, torch.gather(vals, 1, perm), reduce)
    at_sorted = torch.where(seg < c, torch.gather(out, 1, seg), fill)
    per_slot = torch.empty_like(vals).scatter_(1, perm, at_sorted)
    return out[:, :c], per_slot


def _pergroup_eval_windows(spec, own_s, ab_s, cnt_s):
    """Per-(evaluation, group-row) window bounds in arrival-rank units:
    ``m`` is the group's arrival count and ``lo = max(m - ws_g, amin)``,
    ``amin`` the rank of the oldest retained pane (eviction raises the
    lower bound).  Returns ``(ugroups, num, valid, lo, m)``."""
    c = own_s.shape[1]
    perm, seg, ugroups, num = _owner_segments(own_s)
    m, _ = _segment_reduce(perm, seg, ab_s + cnt_s, "amax", INT32_MIN)
    amin, _ = _segment_reduce(perm, seg, ab_s, "amin", INT32_MAX)
    valid = torch.arange(c, device=own_s.device)[None, :] < num[:, None]
    lo = torch.maximum(m - spec.ws_of(ugroups), amin)
    return ugroups, num, valid, torch.where(valid, lo, 0), \
        torch.where(valid, m, 0)


def _sparse_table(x: torch.Tensor, combine, sentinel) -> torch.Tensor:
    """Range-query levels: ``t[l][i] = combine over x[i : i + 2**l]``
    (sentinel-padded past the end)."""
    n = x.shape[-1]
    t = [x]
    step = 1
    while step < n:
        cur = t[-1]
        shifted = torch.cat([cur[step:], torch.full(
            (step,), sentinel, dtype=cur.dtype, device=cur.device)])[:n]
        t.append(combine(cur, shifted))
        step *= 2
    return torch.stack(t)


def _sparse_query(table: torch.Tensor, a, length, combine):
    """``combine`` over ``x[a : a + length]`` (``length >= 1``) as two
    overlapping power-of-two blocks; floor(log2) from the float64
    exponent (exact)."""
    n = table.shape[-1]
    length = torch.clamp(length, min=1)
    lev = torch.frexp(length.to(torch.float64)).exponent - 1
    blk = torch.bitwise_left_shift(torch.ones_like(length), lev)
    a1 = torch.clamp(a, 0, n - 1).long()
    a2 = torch.clamp(a + length - blk, 0, n - 1).long()
    lev = lev.long()
    return combine(table[lev, a1], table[lev, a2])


def _pergroup_partial_values(spec, names, sk, sg, ugroups, lo, m, valid):
    """Each (evaluation, group) window is the slice ``[off_g + lo, off_g +
    m)`` of the group-sorted stream: sums from one prefix sum (integer
    wrap cancels in the difference), min/max from one sparse table, count
    from the bounds."""
    dt = sk.dtype
    n = sk.shape[-1]
    off = torch.searchsorted(sg, ugroups.contiguous()).to(torch.int32)
    a = torch.clamp(off + lo, 0, n)
    b = torch.clamp(off + m, 0, n)
    cnt = torch.where(valid, m - lo, 0)
    rsum = None
    if any(nm in ("sum", "mean") for nm in names):
        acc = _acc_dtype(dt)
        wide = torch.int64 if is_integer(acc) else acc
        ps = torch.cat([torch.zeros((1,), dtype=wide, device=sk.device),
                        torch.cumsum(sk.to(wide), 0)])
        rsum = torch.where(valid, (ps[b.long()] - ps[a.long()]).to(acc), 0)
    out = {}
    for nm in names:
        if nm == "count":
            out[nm] = cnt
        elif nm == "sum":
            out[nm] = rsum
        elif nm == "mean":
            out[nm] = (rsum.to(torch.float32)
                       / torch.clamp(cnt, min=1).to(torch.float32))
        elif nm in ("min", "max"):
            fn, fill = ((torch.minimum, _panestore._key_sentinel(dt))
                        if nm == "min" else
                        (torch.maximum, torch.iinfo(dt).min
                         if is_integer(dt) else float("-inf")))
            v = _sparse_query(_sparse_table(sk, fn, fill), a, b - a, fn)
            out[nm] = torch.where(cnt > 0, v, 0).to(dt)
        else:
            raise ValueError(f"{nm} is not a partial-path op")
    return out


def _reconstruct_store(spec, carry, sg, sk):
    """Rebuild the ``[C, WA]`` ring buffers the directory-only scan never
    materialised: lane ``l`` of an occupied slot holds the key at position
    ``off(owner) + abase + l`` of the group-sorted stream with seq ``base +
    l``, and closed panes re-apply the stable sort at close.  Freed slots
    keep zeros.  The result continues the stream exactly."""
    owner, count, base, abase, stamp, clock = carry
    wa = spec.wa
    n = sg.shape[-1]
    occ = owner != PAD_GROUP
    off = torch.searchsorted(sg, owner).to(torch.int32)
    lanes = torch.arange(wa, dtype=torch.int32, device=sg.device)[None, :]
    fill = occ[:, None] & (lanes < count[:, None])
    pos = torch.clamp(off[:, None] + abase[:, None] + lanes, 0,
                      max(n - 1, 0)).long()
    keys = torch.where(fill, sk[pos], 0).to(sk.dtype)
    seqs = torch.where(fill, base[:, None] + lanes, 0)
    order = torch.sort(keys, dim=-1, stable=True).indices
    closed = (count == wa)[:, None]
    keys = torch.where(closed, torch.gather(keys, -1, order), keys)
    seqs = torch.where(closed, torch.gather(seqs, -1, order), seqs)
    return _panestore.PaneStoreState(owner, keys, seqs, count, base, stamp,
                                     clock)


def write_plan(spec, trace):
    """The fused kernel's inputs from a directory scan: per-tuple write
    coordinates, per-chunk directory snapshots with per-slot staleness
    bounds (store-seq units), the close-sort mask and the per-evaluation
    group directory.  Returns ``(slots, lanes, seqs [NE, WA]; own_s, cnt_s,
    lo_s, sortmask [NE, C]; ugroups [NE, C], num [NE])``."""
    own_s, cnt_s = trace.states.owner, trace.states.count
    written = torch.zeros(own_s.shape, dtype=torch.bool,
                          device=own_s.device)
    written.scatter_(1, trace.slots.long(), True)
    sortmask = (cnt_s == spec.wa) & written
    occ = own_s != PAD_GROUP
    span = torch.where(occ, trace.states.base + cnt_s, INT32_MIN)
    perm, seg, ugroups, num = _owner_segments(own_s)
    _, m = _segment_reduce(perm, seg, span, "amax", INT32_MIN)
    lo_s = torch.where(occ, m - spec.ws_of(own_s), 0)
    return (trace.slots, trace.lanes, trace.seqs, own_s, cnt_s, lo_s,
            sortmask, ugroups, num)


def pergroup_write_plan(spec, groups: torch.Tensor):
    """:func:`write_plan` of the plain placement scan from an empty store."""
    trace = _panestore.scan(spec, _panestore.init_store(
        spec, device=groups.device), groups.to(torch.int32))
    return write_plan(spec, trace)


def _empty_pergroup(spec, names, key_dtype, device, interpolate=False):
    """The result of a stream shorter than one pane: no evaluation."""
    c = spec.capacity

    def dtype(nm):
        if nm == "median" and interpolate:
            return torch.float32
        return out_dtype(nm, key_dtype)

    return (torch.full((0, c), PAD_GROUP, dtype=torch.int32, device=device),
            {nm: torch.zeros((0, c), dtype=dtype(nm), device=device)
             for nm in names},
            torch.zeros((0, c), dtype=torch.bool, device=device),
            torch.zeros((0,), dtype=torch.int32, device=device))


def swag_per_group(groups, keys, *, spec, ops, interpolate: bool = False,
                   state=None, counters=None):
    """Per-group-window SWAG on the shared pane store — batch entry.

    The stream is cut into ``spec.wa``-sized chunks; after each chunk one
    evaluation replays every live group's last ``WS_g`` own tuples.  Two
    regimes, as in the JAX package:

    * partial path (every op in PANE_PARTIAL_OPS, float sum/mean excepted,
      fresh store): a directory-only scan derives each window's bounds in
      arrival-rank units and all NE x C windows come from the group-sorted
      stream (prefix sums, sparse tables); the ring buffers are rebuilt
      once at the end;
    * merge path (anything else, or a continued stream via ``state=``):
      the push scan records the store after every chunk, and one batched
      merge + tails pass evaluates all NE x C replay rows.

    Returns ``((groups, values, valid, num_groups), final_state)`` with a
    leading ``[N // WA]`` axis and ``spec.capacity`` rows per evaluation.
    """
    if counters is not None:
        raise NotImplementedError(
            "swag_per_group(counters=...) is not ported yet; it comes with "
            "ROADMAP queue 1, slice 6 (observability)")
    names = [op.name if isinstance(op, Combiner) else op for op in ops]
    groups = groups.to(torch.int32)
    dev = groups.device
    ne = groups.shape[-1] // spec.wa
    c = spec.capacity
    psel = _panestore.partial_path_names(names, keys.dtype)

    if all(psel) and state is None and ne > 0:
        ranks, order, sg = _group_ranks(groups)
        sk = keys[order.long()]
        carry, (own_s, ab_s, cnt_s) = _pergroup_dir_scan(spec, groups, ranks)
        ugroups, num, valid, lo, m = _pergroup_eval_windows(
            spec, own_s, ab_s, cnt_s)
        values = _pergroup_partial_values(spec, names, sk, sg, ugroups, lo,
                                          m, valid)
        values = {nm: torch.where(valid, v, 0).to(v.dtype)
                  for nm, v in values.items()}
        final = _reconstruct_store(spec, carry, sg, sk)
        return (ugroups, values, valid, num), final

    if state is None:
        state = _panestore.init_store(spec, keys.dtype, device=dev)
    if ne == 0:
        return _empty_pergroup(spec, names, state.keys.dtype, dev,
                               interpolate), state
    final, runs = per_group_chunk_scan(
        spec, state, groups, keys.to(state.keys.dtype),
        lambda st: _panestore.gather_runs(spec, st))
    length = runs.run_keys.shape[-1]
    mvals, _cnts = _panestore.replay_rows(
        spec, runs.run_keys.reshape(ne * c, length),
        runs.run_valid.reshape(ne * c, length), list(ops), names,
        interpolate=interpolate)
    valid = torch.arange(c, device=dev)[None, :] < runs.num_groups[:, None]
    values = {nm: torch.where(valid, v.reshape(ne, c), 0).to(v.dtype)
              for nm, v in mvals.items()}
    return (runs.groups, values, valid, runs.num_groups), final
