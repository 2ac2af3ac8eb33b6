"""Batch time-window framing — the batch half of ``repro.core.eventtime``.

A query with ``Window(range=R, slide=S)`` aggregates by *event time*: one
window ``[e - R, e)`` for every evaluation time ``e`` at a multiple of
``S``.  A batch is sorted by timestamp once and each window becomes a range
of tuple positions of the sorted stream (:func:`time_window_layout`);
:func:`frame_time_windows` gathers those ranges into static-width rows for
the replay strategy, and :mod:`repro_torch.core.twostack` reads them
without replay.

The window count and the row width are shapes, so they are read back from
the device (a few scalars); the sort and the boundary searches run where
the timestamps are.  Window ends use floor division (``ts // slide``), so
negative timestamps frame as they do in numpy.

Event-time streaming rests on the other half of the module:

  * :class:`WatermarkTracker` — the low-watermark of a stream: with every
    tuple within ``max_lateness`` of the largest timestamp seen, ``wm =
    max_ts - max_lateness`` promises that no later tuple is earlier;
    shards merge by the minimum (:func:`merge_watermarks`);
  * the bounded-lateness **reorder buffer** (:class:`ReorderSpec`,
    :func:`reorder_push`): one tuple in and at most one out a cycle, the
    buffered minimum released once the watermark passes it (or forced out
    when the buffer is full), tuples later than the contract flagged and
    dropped, then a drain of everything the final gate has passed, sorted
    by (ts, seq) — so the released set after a push does not depend on
    the arrival order.

:func:`reorder_push` and :func:`reorder_flush` here are the plain versions:
a loop of the cycle on a host copy of the buffer, the result on the
buffer's device.  On the card the same cycle runs as one CUDA kernel
(``repro_torch.kernels.eventtime.kernel.reorder_push``).

A sharded event-time stream keeps one buffer a shard, stacked: every field
of a :class:`ReorderState` gains a leading ``[S]`` axis
(:func:`init_reorder_stacked`, :func:`shard_state`).
:func:`reorder_push_sharded` and :func:`reorder_flush_sharded` are their
plain versions (the JAX package's ``vmap`` of the push over the shards: a
loop of :func:`reorder_push` over them); on the card all S buffers run in
one launch of the reorder kernel.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sorter

#: hard ceiling on the number of time windows one batch may frame (a sparse
#: stream with a tiny slide would otherwise explode the window axis)
MAX_TIME_WINDOWS = 65536

#: initial "no tuple seen" timestamp: low enough that wm = TS_MIN - L never
#: releases anything, high enough that int32 arithmetic cannot wrap
TS_MIN = -(2 ** 30)
INT32_MAX = torch.iinfo(torch.int32).max


def concrete_timestamps(timestamps, device=None) -> torch.Tensor:
    """Timestamps as an int64 column on ``device`` (default: where they
    are; numpy arrays start on the CPU)."""
    if isinstance(timestamps, torch.Tensor):
        ts = timestamps
    else:
        ts = torch.from_numpy(np.ascontiguousarray(np.asarray(timestamps)))
    if ts.dim() != 1:
        raise ValueError(f"timestamps must be a rank-1 column, "
                         f"got shape {tuple(ts.shape)}")
    return ts.to(device=ts.device if device is None else device,
                 dtype=torch.int64)


class TimeLayout(NamedTuple):
    """Layout of one batch's time windows over the ts-sorted stream:
    window ``j`` covers tuple positions ``[starts[j], ends[j])`` and the
    time range ``[end_times[j] - range, end_times[j])``.  Tensors live on
    the timestamps' device."""
    order: torch.Tensor      # [N] int64 ts-ascending stable permutation
    starts: torch.Tensor     # [NW] int64 first tuple index of each window
    ends: torch.Tensor       # [NW] int64 one past the last tuple index
    end_times: torch.Tensor  # [NW] int64 window ends (multiples of slide)
    wcap: int                # power-of-two max tuples per window (>= 1)


def _floor_div(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def time_window_layout(ts: torch.Tensor, time_range: int,
                       slide: int) -> TimeLayout:
    """Window boundaries over the ts-sorted stream: one window per ``slide``
    units, ending at multiples of ``slide``, from the first multiple after
    the earliest tuple through the first multiple after the latest.
    ``ts`` is an int64 column (:func:`concrete_timestamps`)."""
    dev = ts.device
    tss, order = torch.sort(ts, stable=True)
    n = tss.shape[0]
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return TimeLayout(order, empty, empty, empty, 1)
    first, last = _floor_div(tss[[0, -1]], slide).tolist()
    nw = last - first + 1
    if nw > MAX_TIME_WINDOWS:
        raise ValueError(
            f"slide={slide} frames {nw} windows over this batch's "
            f"timestamp span (> {MAX_TIME_WINDOWS}); use a larger slide "
            f"or the streaming path")
    end_times = (torch.arange(nw, dtype=torch.int64, device=dev)
                 + first + 1) * slide
    starts = torch.searchsorted(tss, end_times - time_range, side="left")
    ends = torch.searchsorted(tss, end_times, side="left")
    wcap = sorter.next_pow2(max(1, int((ends - starts).max())))
    return TimeLayout(order, starts, ends, end_times, wcap)


def frame_time_windows(layout: TimeLayout, groups_sorted: torch.Tensor,
                       keys_sorted: torch.Tensor, pad_group: int):
    """Gather the ts-sorted stream into ``[NW, wcap]`` window rows (dead
    lanes carry ``pad_group`` / zero keys).  Returns ``(frame_groups,
    frame_keys, counts)``, counts int32."""
    n = groups_sorted.shape[-1]
    dev = keys_sorted.device
    cnt = (layout.ends - layout.starts).to(torch.int32)
    lane = torch.arange(layout.wcap, device=dev)
    idx = torch.clamp(layout.starts[:, None] + lane[None, :], 0,
                      max(n - 1, 0))
    live = lane[None, :] < cnt[:, None]
    fg = torch.where(live, groups_sorted[idx],
                     torch.tensor(pad_group, dtype=groups_sorted.dtype,
                                  device=dev))
    fk = torch.where(live, keys_sorted[idx],
                     torch.zeros((), dtype=keys_sorted.dtype, device=dev))
    return fg, fk, cnt


# --------------------------------------------------------------- watermarks

class WatermarkTracker(NamedTuple):
    """Low-watermark state of one stream shard: the largest timestamp seen
    so far (0-d int32)."""
    max_ts: torch.Tensor


def _i32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def init_tracker(device="cpu") -> WatermarkTracker:
    return WatermarkTracker(max_ts=_i32(TS_MIN, device))


def observe(tracker: WatermarkTracker, ts,
            live=None) -> WatermarkTracker:
    """Fold a batch of timestamps into the tracker (``live`` masks lanes)."""
    ts = _i32(ts, tracker.max_ts.device)
    if live is not None:
        ts = torch.where(torch.as_tensor(live, device=ts.device), ts,
                         TS_MIN)
    top = ts.max() if ts.numel() else _i32(TS_MIN, ts.device)
    return WatermarkTracker(torch.maximum(tracker.max_ts, top))


def watermark(tracker: WatermarkTracker, max_lateness: int) -> torch.Tensor:
    """``wm = max_ts - max_lateness``: no later in-contract tuple is
    earlier than this."""
    return tracker.max_ts - max_lateness


def merge_watermarks(wms) -> torch.Tensor:
    """The cross-shard merge rule: a stream's watermark is the minimum of
    its shards' (a tuple may still arrive on the slowest).  ``wms`` is a
    sequence of scalars or a stacked tensor."""
    if not isinstance(wms, torch.Tensor):
        wms = torch.stack([_i32(w) for w in wms])
    return wms.min()


# ------------------------------------------- bounded-lateness reorder buffer

@dataclasses.dataclass(frozen=True)
class ReorderSpec:
    """One reorder buffer: ``capacity`` slots (a power of two) and the
    lateness contract ``max_lateness`` (a tuple more than this many time
    units behind the largest timestamp seen is dropped and counted)."""
    capacity: int
    max_lateness: int

    def __post_init__(self):
        if self.capacity <= 0 or self.capacity & (self.capacity - 1):
            raise ValueError(f"reorder capacity must be a positive power of "
                             f"two, got {self.capacity}")
        if self.max_lateness < 0:
            raise ValueError(f"max_lateness must be >= 0, "
                             f"got {self.max_lateness}")


class ReorderState(NamedTuple):
    """The reorder buffer, part of an event-time stream's state.  ``seq``
    is each slot's arrival number (equal timestamps leave in arrival
    order); ``max_ts`` is the embedded watermark tracker; ``last_emit``
    keeps emissions nondecreasing across forced releases; ``dropped``
    counts the late tuples of the stream's lifetime."""
    ts: torch.Tensor         # [C] int32
    grp: torch.Tensor        # [C] int32
    val: torch.Tensor        # [C] key dtype
    seq: torch.Tensor        # [C] int32
    occ: torch.Tensor        # [C] bool
    max_ts: torch.Tensor     # [] int32
    last_emit: torch.Tensor  # [] int32
    seq_clock: torch.Tensor  # [] int32
    dropped: torch.Tensor    # [] int32


class ReorderEmit(NamedTuple):
    """What one push releases: ``N`` lanes, one a cycle, then ``capacity``
    drain lanes.  ``late`` flags input lanes dropped as too late; ``live``
    flags the lanes that carry a released tuple (a dead lane's other
    fields carry whatever the cycle read)."""
    ts: torch.Tensor      # [N + C] int32
    groups: torch.Tensor  # [N + C] int32
    keys: torch.Tensor    # [N + C]
    live: torch.Tensor    # [N + C] bool
    late: torch.Tensor    # [N + C] bool


def init_reorder(spec: ReorderSpec, key_dtype=torch.int32,
                 device="cpu") -> ReorderState:
    c = spec.capacity

    def zeros(dt=torch.int32):
        return torch.zeros((c,), dtype=dt, device=device)

    return ReorderState(
        ts=zeros(), grp=zeros(), val=zeros(key_dtype), seq=zeros(),
        occ=zeros(torch.bool), max_ts=_i32(TS_MIN, device),
        last_emit=_i32(TS_MIN, device), seq_clock=_i32(0, device),
        dropped=_i32(0, device))


def _reorder_cycle(spec: ReorderSpec, st: ReorderState, lanes, t, g, k, lv,
                   release_wm, late_wm, tally=None):
    """One tuple in, at most one out — the JAX package's cycle, updating
    the host copy ``st`` in place (its 0-d scalars included).  The incoming
    tuple (dead when ``lv`` is False) first advances the watermark; the
    buffered (or the incoming) minimum by (ts, seq) is released once the
    gate passes it, or when the buffer would overflow; a tuple earlier than
    the lateness floor or than the last emission is dropped.  Returns the
    cycle's emission ``(ts, group, key, live, late)`` as 0-d tensors.
    ``tally`` (a list ``[forced pops, depth high-water mark or None]``)
    counts a pop forced by a full buffer past the release gate and the
    buffer's depth after the cycle, as the JAX package's counters do."""
    c = spec.capacity
    max_ts = torch.maximum(st.max_ts, torch.where(lv, t, TS_MIN))
    wm = max_ts - spec.max_lateness
    release = wm if release_wm is None else release_wm
    late_floor = wm if late_wm is None else late_wm
    late = lv & ((t < late_floor) | (t < st.last_emit))
    insert = lv & ~late

    # the buffered minimum by (ts, seq), in two int32 steps; with nothing
    # buffered the argmin is slot 0
    mts = torch.where(st.occ, st.ts, INT32_MAX).min()
    any_occ = st.occ.any()
    lane = torch.argmin(torch.where(st.occ & (st.ts == mts), st.seq,
                                    INT32_MAX))
    full = st.occ.sum(dtype=torch.int32) == c

    # the incoming tuple never wins a tie (its seq is the largest)
    inc_min = insert & ((t < mts) | ~any_occ)
    pop_inc = inc_min & ((t <= release) | full)
    pop_buf = ~pop_inc & any_occ & ((mts <= release) | (full & insert))

    et = torch.where(pop_inc, t, st.ts[lane])
    eg = torch.where(pop_inc, g, st.grp[lane])
    ek = torch.where(pop_inc, k, st.val[lane])
    ev = pop_inc | pop_buf

    st.occ[lane] &= ~pop_buf
    do_ins = insert & ~pop_inc
    slot = torch.argmax((~st.occ).to(torch.int32))  # free when do_ins
    at = do_ins & (lanes == slot)
    st.ts.copy_(torch.where(at, t, st.ts))
    st.grp.copy_(torch.where(at, g, st.grp))
    st.val.copy_(torch.where(at, k, st.val))
    st.seq.copy_(torch.where(at, st.seq_clock, st.seq))
    st.occ.logical_or_(at)
    st.max_ts.copy_(max_ts)
    st.last_emit.copy_(torch.where(ev, torch.maximum(st.last_emit, et),
                                   st.last_emit))
    st.seq_clock.add_(do_ins.to(torch.int32))
    st.dropped.add_(late.to(torch.int32))
    if tally is not None:
        forced = (pop_inc & (t > release)) | (pop_buf & (mts > release))
        depth = int(st.occ.sum())
        tally[0] += int(forced)
        tally[1] = depth if tally[1] is None else max(tally[1], depth)
    return et, eg, ek, ev, late


def _reorder_drain(spec: ReorderSpec, st: ReorderState, release,
                   rel=None) -> ReorderEmit:
    """Release every buffered tuple the gate has passed (``ts <=
    release``; or the slots ``rel`` marks), sorted by (ts, seq), as one
    ``[capacity]`` emission batch: its released lanes first, then the
    other slots in slot order.  Updates the host copy ``st`` in place."""
    c = spec.capacity
    if rel is None:
        rel = st.occ & (st.ts <= release)
    ts_m = torch.where(rel, st.ts, INT32_MAX)
    seq_m = torch.where(rel, st.seq, INT32_MAX)
    # (ts, seq) lexicographic and stable: seq first, then ts, both stable
    order = torch.sort(seq_m, stable=True).indices
    order = order[torch.sort(ts_m[order], stable=True).indices]
    num = rel.sum(dtype=torch.int32)
    live = torch.arange(c) < num
    sts = ts_m[order]
    last = torch.where(num > 0, sts[torch.clamp(num - 1, min=0)],
                       st.last_emit)
    st.occ.logical_and_(~rel)
    st.last_emit.copy_(torch.maximum(st.last_emit, last))
    return ReorderEmit(torch.where(live, sts, 0), st.grp[order],
                       st.val[order], live, torch.zeros((c,),
                                                        dtype=torch.bool))


def _host_copy(state: ReorderState) -> ReorderState:
    host = torch.device("cpu")
    return ReorderState(*(x.to(host, copy=True) for x in state))


def _on(dev, emit: ReorderEmit, st: ReorderState):
    return (ReorderEmit(*(x.to(dev) for x in emit)),
            ReorderState(*(x.to(dev) for x in st)))


def reorder_push(spec: ReorderSpec, state: ReorderState, ts, groups, keys,
                 *, n_valid=None, release_wm=None, late_wm=None,
                 drain_wm=None, counters=None):
    """Stream one batch through the reorder buffer: the cycle for every
    tuple (the first ``n_valid`` live), then a drain of everything else the
    final gate has passed, so that after every push the released set is
    exactly the tuples at or below the gate, whatever the arrival order.
    Returns ``(ReorderEmit [N + capacity], new state)``; emissions are
    ts-nondecreasing over the batch.

    ``release_wm`` replaces the per-cycle release gate with an externally
    merged watermark (a sharded stream), and must be causal; ``drain_wm``
    is the gate of the drain (default ``release_wm``, then the local
    watermark after the push); ``late_wm`` replaces the lateness floor.
    The loop runs on a host copy of ``state``, which is not modified.

    With ``counters`` (a :mod:`repro_torch.obs.counters` dict) returns
    ``(emit, state, counters)``, with the buffer-depth high-water mark and
    the capacity-forced pops of every cycle of the push."""
    dev = state.ts.device
    st = _host_copy(state)
    host = torch.device("cpu")
    ts = torch.as_tensor(ts).to(host, torch.int32)
    groups = torch.as_tensor(groups).to(host, torch.int32)
    keys = torch.as_tensor(keys).to(host, st.val.dtype)
    n = ts.shape[-1]
    nv = n if n_valid is None else int(n_valid)

    def gate(x):
        return None if x is None else _i32(x).to(host)

    release_wm, late_wm, drain_wm = (gate(release_wm), gate(late_wm),
                                     gate(drain_wm))
    lanes = torch.arange(spec.capacity)
    true, false = torch.tensor(True), torch.tensor(False)
    tally = None if counters is None else [0, None]
    outs = [_reorder_cycle(spec, st, lanes, ts[i], groups[i], keys[i],
                           true if i < nv else false, release_wm, late_wm,
                           tally)
            for i in range(n)]
    g = drain_wm if drain_wm is not None else release_wm
    release = st.max_ts - spec.max_lateness if g is None else g
    drain = _reorder_drain(spec, st, release)
    cols = [torch.stack([o[f] for o in outs]) if outs else
            torch.zeros((0,), dtype=drain[f].dtype) for f in range(5)]
    emit = ReorderEmit(*(torch.cat([a, b]) for a, b in zip(cols, drain)))
    if counters is None:
        return _on(dev, emit, st)
    return (*_on(dev, emit, st), count_cycles(counters, *tally, dev))


def count_cycles(counters, forced, depth_hwm, device):
    """``counters`` with a push's forced pops and its depth high-water mark
    (a number, a 0-d tensor, or None: no cycle)."""
    from repro_torch.obs import counters as _c
    counters = _c.ensure(counters, ("reorder_depth_hwm",
                                    "reorder_forced_pops"), device=device)
    counters = _c.bump(counters, "reorder_forced_pops", forced)
    if depth_hwm is None:
        return counters
    return _c.high_water(counters, "reorder_depth_hwm", depth_hwm)


def reorder_flush(spec: ReorderSpec, state: ReorderState):
    """Drain the buffer: every held tuple, sorted by (ts, seq), as one
    ``[capacity]`` emission batch; the buffer comes back empty (watermark,
    drop count and emission floor kept).  ``state`` is not modified."""
    dev = state.ts.device
    st = _host_copy(state)
    emit = _reorder_drain(spec, st, None, rel=st.occ.clone())
    return _on(dev, emit, st)


# --------------------------------------------- stacked buffers (shards)

def init_reorder_stacked(spec: ReorderSpec, num_shards: int,
                         key_dtype=torch.int32, device="cpu") -> ReorderState:
    """``num_shards`` fresh buffers stacked: ``[S, C]`` slots, ``[S]``
    scalars (the JAX package's broadcast of one fresh buffer)."""
    one = init_reorder(spec, key_dtype, device)
    return ReorderState(*(x.expand((num_shards,) + x.shape).contiguous()
                          for x in one))


def shard_state(states: ReorderState, s: int) -> ReorderState:
    """Shard ``s``'s buffer of a stacked state (views)."""
    return ReorderState(*(x[s] for x in states))


def _stack(states) -> ReorderState:
    return ReorderState(*(torch.stack(xs) for xs in zip(*states)))


def _shard_valid(n_valid, num_shards: int, length: int) -> list:
    """Each shard's live count, ``clip(n_valid - s L, 0, L)``, as host
    ints (None: every lane)."""
    if n_valid is None:
        return [None] * num_shards
    nv = int(n_valid)
    return [min(max(nv - s * length, 0), length) for s in range(num_shards)]


def reorder_push_sharded(spec: ReorderSpec, states: ReorderState, ts,
                         groups, keys, *, n_valid=None, release_wm=None,
                         late_wm=None, drain_wm=None, counters=None):
    """One push through every shard's buffer: row ``s`` of the ``[S, L]``
    columns (its live count ``clip(n_valid - s L, 0, L)``) through buffer
    ``s`` by :func:`reorder_push`, every shard under the same gates.
    Returns ``(ReorderEmit [S, L + C], new stacked state)``; ``states`` is
    not modified.  With ``counters`` returns ``(emit, state, counters)``:
    the forced pops summed over the shards, the depth mark their
    maximum, as the JAX package reduces its per-shard counters."""
    num_shards, length = ts.shape
    nvs = _shard_valid(n_valid, num_shards, length)
    emits, news, forced, depth = [], [], [], None
    for s in range(num_shards):
        out = reorder_push(spec, shard_state(states, s), ts[s], groups[s],
                           keys[s], n_valid=nvs[s], release_wm=release_wm,
                           late_wm=late_wm, drain_wm=drain_wm,
                           counters=None if counters is None else {})
        emits.append(out[0])
        news.append(out[1])
        if counters is not None:
            forced.append(out[2]["reorder_forced_pops"])
            d = out[2].get("reorder_depth_hwm")
            depth = d if depth is None else torch.maximum(depth, d)
    emit = ReorderEmit(*(torch.stack(xs) for xs in zip(*emits)))
    if counters is None:
        return emit, _stack(news)
    total = torch.stack(forced).sum(dtype=torch.int32)
    return emit, _stack(news), count_cycles(counters, total, depth,
                                            states.ts.device)


def reorder_flush_sharded(spec: ReorderSpec, states: ReorderState):
    """Drain every shard's buffer (:func:`reorder_flush` each): ``(ReorderEmit
    [S, C], the emptied stacked state)``; ``states`` is not modified."""
    outs = [reorder_flush(spec, shard_state(states, s))
            for s in range(states.ts.shape[0])]
    return (ReorderEmit(*(torch.stack(xs) for xs in zip(*(o[0] for o in
                                                          outs)))),
            _stack([o[1] for o in outs]))
