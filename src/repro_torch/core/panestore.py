"""Per-group pane store — the paper's approximation for SWAG with per-group
windows, count mode (the counterpart of ``repro.core.panestore``).

Instead of per-group hash state sized for the worst case, the store keeps
only the last ``WS_g`` tuples *per group* in a shared buffer of
``capacity`` pane slots, each holding up to ``WA`` tuples of one group:

  * a **per-group pane index**: a group's slots are found by their
    ``owner`` tag and ordered by ``base`` (the within-group seq of the
    slot's first tuple);
  * panes are **sorted once**, when the WA-th tuple arrives, so replay
    merges presorted runs;
  * **retirement + eviction**: a slot is freed the moment none of its
    tuples can fall in its group's last ``WS_g``; when an allocation finds
    no free slot the globally **oldest** pane (smallest stamp) is evicted
    and the victim group's window shrinks — the approximation knob;
  * **replay**: gather a group's pane subset, merge it with a per-lane
    liveness mask, compact, and apply every requested operator.

Placement (:func:`_push_decide`) is inherently sequential: each tuple's
slot depends on the global eviction order.  The plain loops here
(:func:`push`, :func:`scan`) are the reference; they loop on a host copy
of the state whatever its device, updating that copy in place.  On the
card the same scan runs as one CUDA kernel
(``repro_torch.kernels.swag.kernel.pergroup_scan``).

**Time mode** (event-time streaming) keys a pane by its time pane ``ts //
slide`` (chaining another slot when a group's pane holds more than ``wa``
tuples), carries each tuple's timestamp through the pane sort, retires a
pane once its interval falls behind ``retire_below`` (the watermark less
the range), and evaluates every group over the shared window
``[eval_time - time_range, eval_time)``: :func:`push_time`,
``gather_runs(eval_time=)`` and ``replay(eval_time=)``.  On the card its
placement is ``repro_torch.kernels.swag.kernel.pergroup_scan_time``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import engine as _engine
from repro_torch.core import sorter
from repro_torch.core.combiners import Combiner, _acc_dtype, is_integer

PAD_GROUP = _engine.PAD_GROUP
INT32_MIN = torch.iinfo(torch.int32).min
INT32_MAX = torch.iinfo(torch.int32).max
#: "no retirement" floor of time-mode pushes (the reorder buffer's TS_MIN)
TS_FLOOR = -(2 ** 30)

#: ops the replay tail computes directly from the merged, compacted window
DIRECT_OPS = frozenset(
    {"sum", "count", "min", "max", "mean", "median", "distinct_count"})

#: ops the per-pane partial fast path serves without tuple replay (their
#: window value is a function of per-pane partial aggregates)
PANE_PARTIAL_OPS = frozenset({"sum", "count", "min", "max", "mean"})


def partial_path_names(names, key_dtype: torch.dtype) -> list:
    """Which ops ride the per-pane partial fast path (True) vs merge-replay
    (False).  Float sums (and mean) combine per-pane partials in another
    order than the merged-window reduction, so on float keys they stay on
    the merge path; float min/max/count keep the fast path."""
    reorder_sensitive = key_dtype.is_floating_point
    return [isinstance(nm, str) and nm in PANE_PARTIAL_OPS
            and not (reorder_sensitive and nm in ("sum", "mean"))
            for nm in names]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PaneStoreSpec:
    """Static configuration of one pane store.

    ``wa``: pane width (a power of two).  ``capacity``: pane slots in the
    shared buffer.  ``default_ws``: window of groups not in ``per_group``,
    a sorted tuple of ``(group_id, ws)`` overrides.

    **Time mode** (``slide`` and ``time_range`` both set): panes are keyed
    by ``ts // slide`` and retire by watermark, every group sharing the
    window ``[eval_time - time_range, eval_time)``; ``wa`` bounds the
    tuples one slot holds of one (group, time pane), and denser traffic
    chains more slots with the same pane id."""
    wa: int
    capacity: int
    default_ws: int
    per_group: tuple = ()
    slide: int | None = None
    time_range: int | None = None

    def __post_init__(self):
        if self.wa <= 0 or self.wa & (self.wa - 1):
            raise ValueError(f"pane width wa must be a positive power of "
                             f"two, got {self.wa}")
        if self.default_ws <= 0:
            raise ValueError(f"default_ws must be positive, got "
                             f"{self.default_ws}")
        if (self.slide is None) != (self.time_range is None):
            raise ValueError("slide and time_range come together (time "
                             "mode) or not at all (count mode)")
        if self.slide is not None:
            if self.slide <= 0 or self.time_range <= 0:
                raise ValueError(f"slide/time_range must be positive, got "
                                 f"{self.slide}/{self.time_range}")
            if self.per_group:
                raise ValueError("time-mode stores share one time range — "
                                 "per_group window overrides do not apply")
        pairs = tuple(sorted((int(g), int(w)) for g, w in self.per_group))
        for g, w in pairs:
            if w <= 0:
                raise ValueError(f"ws_per_group[{g}] must be positive, "
                                 f"got {w}")
        object.__setattr__(self, "per_group", pairs)
        if self.capacity < self.min_capacity:
            raise ValueError(
                f"capacity={self.capacity} cannot hold even one group's "
                f"window (need >= {self.min_capacity} slots)")

    @property
    def is_time(self) -> bool:
        return self.slide is not None

    @property
    def max_ws(self) -> int:
        return max([self.default_ws] + [w for _, w in self.per_group])

    @property
    def max_panes(self) -> int:
        """Most slots one group can hold: ceil(WS_g/WA) full panes plus one
        straddling the window's trailing edge.  Time mode: slots chain when
        a slide interval holds more than ``wa`` tuples, so one group may
        own every slot."""
        if self.is_time:
            return self.capacity
        return _ceil_div(self.max_ws, self.wa) + 1

    @property
    def min_capacity(self) -> int:
        if self.is_time:
            return _ceil_div(self.time_range, self.slide) + 1
        return self.max_panes

    @property
    def runs(self) -> int:
        """Replay width in runs: max_panes padded to a power of two."""
        return sorter.next_pow2(self.max_panes)

    def ws_of(self, gids: torch.Tensor) -> torch.Tensor:
        """Per-group window size of each id in ``gids`` (int32)."""
        ws = torch.full(gids.shape, self.default_ws, dtype=torch.int32,
                        device=gids.device)
        for g, w in self.per_group:
            ws = torch.where(gids == g, w, ws)
        return ws


def default_capacity(wa: int, default_ws: int, per_group: tuple = ()) -> int:
    """Room for every listed group's window plus four default-window groups,
    rounded up to a power of two (min 16)."""
    need = sum(_ceil_div(w, wa) + 1 for _, w in per_group)
    need += 4 * (_ceil_div(default_ws, wa) + 1)
    return sorter.next_pow2(max(16, need))


class PaneStoreState(NamedTuple):
    """The shared, evicting pane buffer.  Slot ``i`` holds up to ``WA``
    tuples of group ``owner[i]`` (``PAD_GROUP``: free).  ``keys`` are
    arrival-ordered while the pane is open and key-sorted once it closes;
    ``seqs`` carries each tuple's within-group seq through the sort.
    ``base`` is the seq of the slot's first tuple, ``stamp`` its allocation
    counter value (the eviction order), ``clock`` the next stamp."""
    owner: torch.Tensor   # [C] int32
    keys: torch.Tensor    # [C, WA]
    seqs: torch.Tensor    # [C, WA] int32
    count: torch.Tensor   # [C] int32
    base: torch.Tensor    # [C] int32
    stamp: torch.Tensor   # [C] int32
    clock: torch.Tensor   # [] int32


def _count_mode(spec: PaneStoreSpec) -> None:
    if spec.is_time:
        raise ValueError("push() and scan() place count-mode panes; a "
                         "time-mode store (slide/time_range set) takes "
                         "push_time()")


def init_store(spec: PaneStoreSpec, key_dtype=torch.int32,
               device="cpu") -> PaneStoreState:
    c, wa = spec.capacity, spec.wa

    def full(shape, v, dt=torch.int32):
        return torch.full(shape, v, dtype=dt, device=device)

    return PaneStoreState(
        owner=full((c,), PAD_GROUP), keys=full((c, wa), 0, key_dtype),
        seqs=full((c, wa), 0), count=full((c,), 0), base=full((c,), 0),
        stamp=full((c,), -1), clock=full((), 0))


def _push_decide(spec: PaneStoreSpec, owner, count, base, stamp, clock,
                 g: torch.Tensor, live):
    """The directory half of one push: slot choice, count/owner/base/stamp
    bookkeeping, retirement and eviction.  Updates ``owner``, ``count``,
    ``base``, ``stamp`` and the 0-d ``clock`` **in place**; reads no ring
    buffer.  ``g`` is a 0-d int32 tensor, ``live`` a 0-d bool tensor.

    Ties follow the JAX package: the first index of the maximum base (the
    group's newest slot), of the first free slot and of the minimum stamp.
    Returns ``(slot, lane, m_g, alloc, closes, evicted, retired)`` as 0-d
    tensors, ``retired`` the number of panes this push retired.
    """
    wa = spec.wa
    mine = owner == g
    any_mine = mine.any()
    newest = torch.argmax(torch.where(mine, base, -1))
    m_g = torch.where(any_mine, base[newest] + count[newest], 0)
    has_open = any_mine & (count[newest] < wa)

    free = owner == PAD_GROUP
    any_free = free.any()
    oldest = torch.argmin(torch.where(free, INT32_MAX, stamp))
    first_free = torch.argmax(free.to(torch.int32))
    slot = torch.where(has_open, newest,
                       torch.where(any_free, first_free, oldest))
    cs = count[slot]
    lane = torch.where(has_open, cs, 0)

    alloc = live & ~has_open
    new_cs = torch.where(live, torch.where(has_open, cs + 1, 1), cs)
    count[slot] = new_cs
    owner[slot] = torch.where(alloc, g, owner[slot])
    base[slot] = torch.where(alloc, m_g, base[slot])
    stamp[slot] = torch.where(alloc, clock, stamp[slot])
    clock += alloc.to(torch.int32)

    # the close test reads the pre-retirement count (a pane that closes and
    # instantly retires still sorts first)
    closes = live & (new_cs == wa)

    # retire this group's panes that no longer intersect its last WS_g
    dead = live & (owner == g) & (base + wa <= m_g + 1 - spec.ws_of(g))
    owner.masked_fill_(dead, PAD_GROUP)
    count.masked_fill_(dead, 0)
    stamp.masked_fill_(dead, -1)

    evicted = live & ~has_open & ~any_free
    return (slot, lane, m_g, alloc, closes, evicted,
            dead.sum(dtype=torch.int32))


def _write_lane(keys, seqs, slot, lane, k, seq, closes):
    """Write one tuple at (slot, lane) and sort the pane if it closed (the
    stable key sort; the seq rides as payload).  In place."""
    keys[slot, lane] = k
    seqs[slot, lane] = seq
    row_k, row_s = keys[slot], seqs[slot]
    order = torch.sort(row_k, stable=True).indices
    keys[slot] = torch.where(closes, row_k[order], row_k)
    seqs[slot] = torch.where(closes, row_s[order], row_s)


def push(spec: PaneStoreSpec, state: PaneStoreState, groups, keys,
         n_valid=None, counters=None):
    """Stream one batch of tuples through the store, one tuple at a time
    (the first ``n_valid`` only, when given: a tuple past them changes
    nothing).  The loop runs on a host copy, as :func:`scan`'s does.
    Returns the new state on the device of ``state``, which is not
    modified.

    With ``counters`` (a :mod:`repro_torch.obs.counters` dict) returns
    ``(state, counters)``: the evictions and the occupancy high-water mark
    after every tuple's step, as the JAX package's scan carries them (a
    dead tuple leaves the occupancy as it was)."""
    groups = torch.as_tensor(groups)
    keys = torch.as_tensor(keys)
    n_all = n = groups.shape[-1]
    if n_valid is not None:
        n = min(max(int(n_valid), 0), n)
    trace = scan(spec, state, groups[..., :n], keys[..., :n], push=True,
                 occupancy=counters is not None)
    if counters is None:
        return trace.final
    hwm = trace.occupancy_hwm
    if hwm is None and n_all > 0:  # dead tuples only
        hwm = (state.owner != PAD_GROUP).sum(dtype=torch.int32)
    return trace.final, count_events(counters, trace.events, hwm,
                                     state.owner.device)


class ScanTrace(NamedTuple):
    """What the chunked placement scan records (``NE`` chunks of WA).

    ``slots``/``lanes``/``seqs`` ``[NE, WA]``: where each tuple was written
    and its within-group seq.  ``states``: the store after every chunk, each field with a leading
    ``[NE]`` axis (``keys``/``seqs`` are ``None`` when the scan kept no
    ring).  ``abase`` ``[NE, C]``: the arrival rank of each slot's first
    tuple (``None`` without ranks).  A push records neither the plan nor
    the stores after every chunk (``None``).  ``final`` and
    ``final_abase``: the store after the last chunk.  ``events`` ``[2]``
    int32: the evictions and retirements of the scan.  ``occupancy_hwm``:
    the most occupied slots after any tuple's step, when the scan was asked
    to count it (``None`` otherwise, or with no tuple)."""
    slots: torch.Tensor | None
    lanes: torch.Tensor | None
    seqs: torch.Tensor | None
    states: PaneStoreState | None
    abase: torch.Tensor | None
    final: PaneStoreState
    final_abase: torch.Tensor | None
    events: torch.Tensor
    occupancy_hwm: int | None = None


def scan(spec: PaneStoreSpec, state: PaneStoreState, groups: torch.Tensor,
         keys: torch.Tensor | None = None,
         ranks: torch.Tensor | None = None, *,
         push: bool = False, occupancy: bool = False) -> ScanTrace:
    """The per-tuple placement scan, one tuple at a time, over the ``N //
    WA`` full chunks of the stream (the trailing remainder stays unpushed).
    A streaming ``push`` places every tuple (the last chunk may be short)
    and records only the store after the last.

    With ``keys`` the ring buffers are written and sorted at close, as
    :func:`push` does; without, only the directory moves.  With ``ranks``
    (each tuple's within-group arrival rank) each slot's ``abase`` records
    the rank of its first tuple.  With ``occupancy`` the trace's
    ``occupancy_hwm`` counts the occupied slots after every tuple.  This
    loop is the plain version of the placement scan kernel.

    One tuple is a few dozen ops on ``[C]`` vectors, microseconds each on
    the host and a kernel launch each on the card, so the loop runs on a
    host copy of its inputs and what it records moves to the device of
    ``state`` at the end."""
    _count_mode(spec)
    wa, c = spec.wa, spec.capacity
    dev = state.owner.device
    host = torch.device("cpu")
    st = PaneStoreState(*(x.to(host, copy=True) for x in state))
    n = groups.shape[-1]
    ne = _ceil_div(n, wa) if push else n // wa
    groups = groups.to(host, torch.int32)
    keys = None if keys is None else keys.to(host, st.keys.dtype)
    ranks = None if ranks is None else ranks.to(host)
    abase = torch.zeros((c,), dtype=torch.int32)
    out = torch.zeros((3, ne, wa), dtype=torch.int32)
    snaps = []
    evictions = retirements = 0
    occ = int((st.owner != PAD_GROUP).sum()) if occupancy else 0
    hwm = None
    true = torch.ones((), dtype=torch.bool)
    for e in range(ne):
        for j in range(min(wa, n - e * wa)):
            i = e * wa + j
            slot, lane, m_g, alloc, closes, ev, ret = _push_decide(
                spec, st.owner, st.count, st.base, st.stamp, st.clock,
                groups[i], true)
            evictions += int(ev)
            retirements += int(ret)
            if occupancy:  # an eviction reuses its slot
                occ += int(alloc) - int(ev) - int(ret)
                hwm = occ if hwm is None else max(hwm, occ)
            out[0, e, j] = slot.to(torch.int32)
            out[1, e, j] = lane
            out[2, e, j] = m_g
            if keys is not None:
                _write_lane(st.keys, st.seqs, slot, lane, keys[i], m_g,
                            closes)
            if ranks is not None:
                abase[slot] = torch.where(alloc, ranks[i], abase[slot])
        if not push:
            snaps.append((st.owner.clone(),
                          st.keys.clone() if keys is not None else None,
                          st.seqs.clone() if keys is not None else None,
                          st.count.clone(), st.base.clone(),
                          st.stamp.clone(), st.clock.clone(),
                          abase.clone()))

    def stack(i, shape, dtype):
        if not snaps:
            return torch.zeros((0,) + shape, dtype=dtype, device=dev)
        return torch.stack([s[i] for s in snaps]).to(dev)

    ring = keys is not None
    with_ranks = ranks is not None
    events = torch.tensor([evictions, retirements], dtype=torch.int32,
                          device=dev)
    final = PaneStoreState(*(x.to(dev) for x in st))
    final_abase = abase.to(dev) if with_ranks else None
    if push:
        return ScanTrace(None, None, None, None, None, final, final_abase,
                         events, hwm)
    states = PaneStoreState(
        owner=stack(0, (c,), torch.int32),
        keys=stack(1, (c, wa), st.keys.dtype) if ring else None,
        seqs=stack(2, (c, wa), torch.int32) if ring else None,
        count=stack(3, (c,), torch.int32), base=stack(4, (c,), torch.int32),
        stamp=stack(5, (c,), torch.int32), clock=stack(6, (), torch.int32))
    return ScanTrace(out[0].to(dev), out[1].to(dev), out[2].to(dev), states,
                     stack(7, (c,), torch.int32) if with_ranks else None,
                     final, final_abase, events, hwm)


def _push_one_time(spec: PaneStoreSpec, st: PaneStoreState, g, k, t, lv: bool,
                   rb) -> tuple[int, int]:
    """Absorb one timestamped tuple into the host copy ``st`` (in place):
    the slot of its (group, time pane) with room left (at most one), else
    the first free slot, else the globally oldest (evicted); the lane
    write; the pane's stable key sort when it closes (the timestamp rides
    along); then the retirement of every pane wholly below ``rb``, on dead
    lanes too.  Returns the evictions, retirements and allocations (0 or
    1, a count, 0 or 1)."""
    wa = spec.wa
    evicted = alloc = 0
    if lv:
        pid = torch.div(t, spec.slide, rounding_mode="floor")
        mine_open = (st.owner == g) & (st.base == pid) & (st.count < wa)
        has_open = bool(mine_open.any())
        free = st.owner == PAD_GROUP
        if has_open:
            slot = int(torch.argmax(mine_open.to(torch.int32)))
        elif bool(free.any()):
            slot = int(torch.argmax(free.to(torch.int32)))
        else:
            slot = int(torch.argmin(st.stamp))  # first index of the oldest
            evicted = 1
        lane = int(st.count[slot]) if has_open else 0
        st.count[slot] = lane + 1
        if not has_open:
            alloc = 1
            st.owner[slot] = g
            st.base[slot] = pid
            st.stamp[slot] = st.clock
            st.clock.add_(1)
        st.keys[slot, lane] = k
        st.seqs[slot, lane] = t
        if lane + 1 == wa:  # the pane closes: sorted once
            order = torch.sort(st.keys[slot], stable=True).indices
            st.keys[slot] = st.keys[slot][order]
            st.seqs[slot] = st.seqs[slot][order]
    dead = (st.owner != PAD_GROUP) & ((st.base + 1) * spec.slide <= rb)
    st.owner.masked_fill_(dead, PAD_GROUP)
    st.count.masked_fill_(dead, 0)
    st.stamp.masked_fill_(dead, -1)
    return evicted, int(dead.sum()), alloc


def push_time_events(spec: PaneStoreSpec, state: PaneStoreState, groups,
                     keys, ts, live=None, retire_below=None, *,
                     occupancy: bool = False):
    """:func:`push_time` with the evictions and retirements it made:
    ``(state, events [2] int32)``, both on the device of ``state``.  With
    ``occupancy``, ``(state, events, hwm)``: ``hwm`` the most occupied
    slots after any tuple's step (``None`` with no tuple)."""
    if not spec.is_time:
        raise ValueError("push_time needs a time-mode PaneStoreSpec "
                         "(slide/time_range set); use push() for "
                         "count-based panes")
    dev = state.owner.device
    host = torch.device("cpu")
    st = PaneStoreState(*(x.to(host, copy=True) for x in state))
    groups = torch.as_tensor(groups).to(host, torch.int32)
    keys = torch.as_tensor(keys).to(host, st.keys.dtype)
    ts = torch.as_tensor(ts).to(host, torch.int32)
    n = groups.shape[-1]
    lv = ([True] * n if live is None
          else torch.as_tensor(live).to(host, torch.bool).tolist())
    rb = torch.as_tensor(TS_FLOOR if retire_below is None else retire_below,
                         dtype=torch.int32).to(host)
    evictions = retirements = 0
    occ = int((st.owner != PAD_GROUP).sum()) if occupancy else 0
    hwm = None
    for i in range(n):
        ev, ret, alloc = _push_one_time(spec, st, groups[i], keys[i], ts[i],
                                        lv[i], rb)
        evictions += ev
        retirements += ret
        if occupancy:  # an eviction reuses its slot
            occ += alloc - ev - ret
            hwm = occ if hwm is None else max(hwm, occ)
    events = torch.tensor([evictions, retirements], dtype=torch.int32)
    out = PaneStoreState(*(x.to(dev) for x in st)), events.to(dev)
    return (*out, hwm) if occupancy else out


def push_time(spec: PaneStoreSpec, state: PaneStoreState, groups, keys, ts,
              live=None, retire_below=None, counters=None):
    """Stream one batch of timestamped tuples through a time-mode store,
    one tuple at a time on a host copy (``state`` is not modified).
    ``live`` is a full per-lane mask (reorder-buffer emissions are not a
    valid prefix); ``retire_below`` the retirement horizon, normally the
    watermark less the range (``None`` retires nothing).  With
    ``counters`` returns ``(state, counters)`` (see :func:`push`)."""
    if counters is None:
        return push_time_events(spec, state, groups, keys, ts, live,
                                retire_below)[0]
    final, events, hwm = push_time_events(spec, state, groups, keys, ts,
                                          live, retire_below, occupancy=True)
    return final, count_events(counters, events, hwm, state.owner.device)


def count_events(counters, events: torch.Tensor, hwm, device):
    """``counters`` with a placement's evictions (``events[0]``) and its
    occupancy high-water mark ``hwm`` (a number, a 0-d tensor, or None: no
    step)."""
    from repro_torch.obs import counters as _c
    counters = _c.ensure(counters, ("pane_evictions", "pane_occupancy_hwm"),
                         device=device)
    counters = _c.bump(counters, "pane_evictions", events[0])
    if hwm is None:
        return counters
    return _c.high_water(counters, "pane_occupancy_hwm", hwm)


class ReplayRuns(NamedTuple):
    """Gathered replay rows: per output row (candidate group), its pane
    subset flattened to ``runs * WA`` lanes of presorted runs; ``run_valid``
    folds slot occupancy, open-pane fill and staleness.  Every field may
    carry leading batch axes (one per evaluation)."""
    groups: torch.Tensor      # [..., C] int32 live group ids, PAD tail
    run_keys: torch.Tensor    # [..., C, runs*WA]
    run_valid: torch.Tensor   # [..., C, runs*WA] bool
    num_groups: torch.Tensor  # [...] int32


def _slot_directory(owner: torch.Tensor, base: torch.Tensor):
    """The per-group pane index over ``[..., C]`` directories: sort the
    slots by (owner, base), dedupe owners.  Returns ``(perm, ugroups,
    offsets, nslots, num, n_occ)`` — the sorted slot permutation, the
    unique live group ids (ascending, PAD tail), each group's first
    position in ``perm`` and its slot count, the live-group count and the
    occupied-slot count.  Ties of (owner, base) keep slot order."""
    c = owner.shape[-1]
    dev = owner.device
    # (owner, base) packed into one int64 that orders like the pair
    key = (owner.to(torch.int64) << 32) | (base.to(torch.int64) - INT32_MIN)
    perm = torch.sort(key, dim=-1, stable=True).indices
    so = torch.gather(owner, -1, perm)
    occupied = so != PAD_GROUP
    lane = torch.arange(c, dtype=torch.int32, device=dev)
    prev = torch.cat([torch.full(so.shape[:-1] + (1,), PAD_GROUP,
                                 dtype=torch.int32, device=dev),
                      so[..., :-1]], -1)
    firsts = occupied & ((so != prev) | (lane == 0))
    f32 = firsts.to(torch.int32)
    num = f32.sum(-1, dtype=torch.int32)
    rank = torch.cumsum(f32, -1, dtype=torch.int32) - f32
    scatter = torch.where(firsts, rank, c).to(torch.int64)
    ugroups = _engine._scatter_drop(so.shape, PAD_GROUP, torch.int32,
                                    scatter, so, c)
    offsets = _engine._scatter_drop(so.shape, c, torch.int32, scatter,
                                    lane.expand(so.shape), c)
    n_occ = occupied.to(torch.int32).sum(-1, dtype=torch.int32)
    next_off = torch.cat([offsets[..., 1:],
                          torch.full(so.shape[:-1] + (1,), c,
                                     dtype=torch.int32, device=dev)], -1)
    nslots = torch.where(lane < num.unsqueeze(-1),
                         torch.minimum(next_off, n_occ.unsqueeze(-1))
                         - offsets, 0)
    return perm.to(torch.int32), ugroups, offsets, nslots, num, n_occ


def _key_sentinel(dtype: torch.dtype):
    return torch.iinfo(dtype).max if is_integer(dtype) else float("inf")


def _slot_sorted(spec: PaneStoreSpec, state: PaneStoreState):
    """Per-slot replay view of the ring buffers: closed panes are already
    key-sorted; open panes get their unfilled lanes pushed to the tail and
    are sorted here.  Returns ``(keys, seqs, filled)``, each ``[..., C,
    WA]``, every row an ascending run."""
    wa = spec.wa
    lanes = torch.arange(wa, dtype=torch.int32, device=state.keys.device)
    filled = lanes < state.count.unsqueeze(-1)
    sk = torch.where(filled, state.keys,
                     _key_sentinel(state.keys.dtype))
    order = torch.sort(sk, dim=-1, stable=True).indices
    is_sorted = (state.count == wa).unsqueeze(-1)
    return (torch.where(is_sorted, state.keys, torch.gather(sk, -1, order)),
            torch.where(is_sorted, state.seqs,
                        torch.gather(state.seqs, -1, order)),
            torch.where(is_sorted, filled, torch.gather(filled, -1, order)))


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [..., C, *rest]`` at slot indices ``idx [..., R, S]`` -> ``[...,
    R, S, *rest]`` (batched over the leading axes)."""
    lead = idx.shape[:-2]
    c = x.shape[len(lead)]
    rest = x.shape[len(lead) + 1:]
    flat = x.reshape((-1, c) + rest)
    b = flat.shape[0]
    fidx = (idx.reshape(b, -1).long()
            + torch.arange(b, device=x.device)[:, None] * c)
    out = flat.reshape((b * c,) + rest)[fidx.reshape(-1)]
    return out.reshape(idx.shape + rest)


def gather_runs(spec: PaneStoreSpec, state: PaneStoreState,
                eval_time=None) -> ReplayRuns:
    """The per-group pane index, applied: each live group's pane subset as
    ``spec.runs`` presorted runs with a liveness mask.  ``state`` may carry
    leading batch axes (one store per evaluation).  A padded run (slot
    index past the group's count) may gather another slot's keys; its lanes
    are dead, every run is still ascending, and the replayed window depends
    only on the live lanes.

    A time-mode store takes ``eval_time`` (one a store, or one for all): a
    lane is live iff its timestamp lies in ``[eval_time - time_range,
    eval_time)``."""
    c, wa, s = spec.capacity, spec.wa, spec.runs
    dev = state.owner.device
    if spec.is_time:
        if eval_time is None:
            raise ValueError("time-mode stores gather against a watermark: "
                             "pass eval_time=")
        et = torch.as_tensor(eval_time, dtype=torch.int32, device=dev)
        et = et.reshape(et.shape + (1, 1, 1))
    elif eval_time is not None:
        raise ValueError("eval_time only applies to time-mode stores")
    perm, ugroups, offsets, nslots, num, _n_occ = _slot_directory(
        state.owner, state.base)
    keys_v, seqs_v, filled_v = _slot_sorted(spec, state)

    j = torch.arange(s, dtype=torch.int32, device=dev)
    pos = torch.clamp(offsets.unsqueeze(-1) + j, 0, c - 1)     # [..., C, S]
    sidx = torch.gather(perm, -1, pos.reshape(pos.shape[:-2] + (c * s,))
                        .long()).reshape(pos.shape)
    slot_ok = j < nslots.unsqueeze(-1)                          # [..., C, S]
    rk = _take_rows(keys_v, sidx)                               # [..., C, S, WA]
    rs = _take_rows(seqs_v, sidx)
    filled = _take_rows(filled_v, sidx)

    shape = rk.shape[:-2] + (s * wa,)
    if spec.is_time:
        # the seqs hold timestamps: live iff inside the evaluation window
        lane_ok = (slot_ok.unsqueeze(-1) & filled
                   & (rs >= et - spec.time_range) & (rs < et))
        return ReplayRuns(ugroups, rk.reshape(shape), lane_ok.reshape(shape),
                          num)
    # the newest slot is the last occupied one (base-ascending order);
    # lanes older than the group's last WS_g tuples are dead
    rb = _take_rows(state.base.unsqueeze(-1), sidx)[..., 0]     # [..., C, S]
    rc = torch.where(slot_ok, _take_rows(state.count.unsqueeze(-1),
                                         sidx)[..., 0], 0)
    last = torch.clamp(nslots - 1, 0, s - 1).unsqueeze(-1).long()
    m_g = torch.where(nslots > 0, (torch.gather(rb, -1, last)
                                   + torch.gather(rc, -1, last))[..., 0], 0)
    lo = m_g - spec.ws_of(ugroups)
    lane_ok = (slot_ok.unsqueeze(-1) & filled
               & (rs >= lo.unsqueeze(-1).unsqueeze(-1)))
    return ReplayRuns(ugroups, rk.reshape(shape), lane_ok.reshape(shape),
                      num)


def merged_window(run_keys: torch.Tensor, run_valid: torch.Tensor, *,
                  run: int):
    """Merge each row's presorted runs of ``run`` lanes (liveness as
    payload) and compact the live lanes to the front:
    ``(keys_sorted_live_prefix, cnt)``; the tail holds the key sentinel.
    Float keys merge as the panes are sorted: NaN after every number (the
    JAX package's network compares NaN with nothing, so where NaN keys
    are live, min, max, median and distinct count may differ from it)."""
    if run_keys.dtype.is_floating_point:
        nan = torch.isnan(run_keys)
        _, _, mk, mv = sorter.merge_presorted(
            (nan.to(torch.int32), torch.where(nan, 0.0, run_keys), run_keys,
             run_valid.to(torch.int32)), run=run, num_keys=2)
    else:
        mk, mv = sorter.merge_presorted(
            (run_keys, run_valid.to(torch.int32)), run=run, num_keys=1)
    mv = mv == 1
    n = mk.shape[-1]
    rank = torch.cumsum(mv.to(torch.int32), -1, dtype=torch.int32) \
        - mv.to(torch.int32)
    idx = torch.where(mv, rank, n).to(torch.int64)
    out = _engine._scatter_drop(mk.shape, _key_sentinel(mk.dtype), mk.dtype,
                                idx, mk, n)
    return out, mv.to(torch.int32).sum(-1, dtype=torch.int32)


def _wrap_sum(x: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """Sum along the last axis in ``acc``; integer sums wrap in 32 bits."""
    if is_integer(acc):
        return x.sum(-1, dtype=torch.int64).to(acc)
    return x.to(acc).sum(-1)


def _direct_tails(keys_c: torch.Tensor, cnt: torch.Tensor, names, *,
                  interpolate: bool) -> dict:
    """Every DIRECT_OPS value from compacted, key-sorted live prefixes
    ``keys_c [..., n]`` with ``cnt [...]`` live lanes each."""
    n = keys_c.shape[-1]
    dt = keys_c.dtype
    lane = torch.arange(n, device=keys_c.device)
    live = lane < cnt.unsqueeze(-1)
    nonempty = cnt > 0
    acc = _acc_dtype(dt)

    def at(i):
        return torch.gather(keys_c, -1, torch.clamp(i, 0, n - 1)
                            .unsqueeze(-1).long())[..., 0]

    out = {}
    for name in names:
        if name == "count":
            out[name] = cnt
        elif name == "sum":
            out[name] = _wrap_sum(torch.where(live, keys_c, 0), acc)
        elif name == "min":
            out[name] = torch.where(nonempty, keys_c[..., 0], 0).to(dt)
        elif name == "max":
            out[name] = torch.where(nonempty, at(cnt - 1), 0).to(dt)
        elif name == "mean":
            s = _wrap_sum(torch.where(live, keys_c, 0), acc)
            out[name] = (s.to(torch.float32)
                         / torch.clamp(cnt, min=1).to(torch.float32))
        elif name == "median":
            lo = at(torch.clamp(cnt - 1, min=0) // 2)
            if interpolate:
                hi = at(cnt // 2)
                med = (lo.to(torch.float32) + hi.to(torch.float32)) / 2.0
            else:
                med = lo
            out[name] = torch.where(nonempty, med, 0).to(med.dtype)
        elif name == "distinct_count":
            prev = torch.cat([torch.full(keys_c.shape[:-1] + (1,),
                                         _key_sentinel(dt), dtype=dt,
                                         device=keys_c.device),
                              keys_c[..., :-1]], -1)
            out[name] = ((keys_c != prev) & live).to(torch.int32).sum(
                -1, dtype=torch.int32)
        else:
            raise ValueError(f"{name} is not a direct replay op")
    return out


def replay_rows(spec: PaneStoreSpec, run_keys: torch.Tensor,
                run_valid: torch.Tensor, ops, names, *, interpolate: bool):
    """Merge + tails over ``[R, S*WA]`` gathered replay rows.  Ops outside
    DIRECT_OPS fall back to an engine pass over the merged, compacted
    window.  Returns ``({name: values [R]}, cnt [R])``."""
    kc, cnt = merged_window(run_keys, run_valid, run=spec.wa)
    vals = _direct_tails(kc, cnt, [nm for nm in names if nm in DIRECT_OPS],
                         interpolate=interpolate)
    fallback = [(op, nm) for op, nm in zip(ops, names)
                if nm not in DIRECT_OPS]
    if fallback:
        lane = torch.arange(kc.shape[-1], device=kc.device)
        gc = torch.where(lane < cnt.unsqueeze(-1), 0, PAD_GROUP).to(
            torch.int32)
        for op, nm in fallback:
            vals[nm] = _engine._group_by_aggregate(gc, kc, op).values[..., 0]
    return vals, cnt


def _replay_partials(spec: PaneStoreSpec, state: PaneStoreState, names):
    """The per-pane partial fast path: every PANE_PARTIAL_OPS value from
    per-slot masked partials combined per group — no gather, no merge.
    Returns ``(ugroups [C], {name: values [C]}, valid [C], num)``."""
    wa = spec.wa
    c = state.owner.shape[0]
    dev = state.owner.device
    occ = state.owner != PAD_GROUP
    span = torch.where(occ, state.base + state.count, INT32_MIN)
    same = occ[:, None] & (state.owner[:, None] == state.owner[None, :])
    m = torch.where(same, span[None, :], INT32_MIN).amax(1)
    lo = m - spec.ws_of(state.owner)
    lanes = torch.arange(wa, device=dev)[None, :]
    live = (occ[:, None] & (lanes < state.count[:, None])
            & (state.seqs >= lo[:, None]))

    _perm, ugroups, _off, _ns, num, _n_occ = _slot_directory(state.owner,
                                                            state.base)
    rows = ((ugroups[:, None] == state.owner[None, :]) & occ[None, :]
            & (ugroups[:, None] != PAD_GROUP))
    out = _partials_per_row(state.keys, live, rows, names)
    valid = torch.arange(c, device=dev) < num
    return ugroups, out, valid, num


def _partials_per_row(keys, live, rows, names) -> dict:
    """Per-slot partials of the ``live`` lanes of ``keys [C, WA]``, combined
    per output row over the slots ``rows [R, C]`` marks."""
    dt = keys.dtype
    hi = _key_sentinel(dt)
    lo_s = torch.iinfo(dt).min if is_integer(dt) else float("-inf")
    pc = live.to(torch.int32).sum(1, dtype=torch.int32)
    cnt = torch.where(rows, pc[None, :], 0).sum(1, dtype=torch.int32)
    rsum = None
    if any(nm in ("sum", "mean") for nm in names):
        acc = _acc_dtype(dt)
        psum = _wrap_sum(torch.where(live, keys, 0), acc)
        rsum = _wrap_sum(torch.where(rows, psum[None, :], 0), acc)
    out = {}
    for name in names:
        if name == "count":
            out[name] = cnt
        elif name == "sum":
            out[name] = rsum
        elif name == "mean":
            out[name] = (rsum.to(torch.float32)
                         / torch.clamp(cnt, min=1).to(torch.float32))
        elif name == "min":
            pmin = torch.where(live, keys, hi).amin(1)
            v = torch.where(rows, pmin[None, :], hi).amin(1)
            out[name] = torch.where(cnt > 0, v, 0).to(dt)
        elif name == "max":
            pmax = torch.where(live, keys, lo_s).amax(1)
            v = torch.where(rows, pmax[None, :], lo_s).amax(1)
            out[name] = torch.where(cnt > 0, v, 0).to(dt)
        else:
            raise ValueError(f"{name} is not a partial-path op")
    return out


def drop_empty_rows(groups: torch.Tensor, values: dict, valid: torch.Tensor,
                    cnt: torch.Tensor):
    """Time-mode evaluation rows, compacted: a group may still own slots
    while none of its tuples lies in the window; its row (``cnt`` 0) goes,
    the rest keep their order (along the last axis; rows past the valid
    ones may hold anything).  Returns ``(groups, values, valid, num)``,
    PAD_GROUP and zeros past ``num``."""
    c = groups.shape[-1]
    keep = valid & (cnt > 0)
    k32 = keep.to(torch.int32)
    rank = torch.cumsum(k32, -1, dtype=torch.int32) - k32
    idx = torch.where(keep, rank, c).to(torch.int64)
    num = k32.sum(-1, dtype=torch.int32)
    valid = torch.arange(c, device=groups.device) < num.unsqueeze(-1)
    out = {nm: torch.where(valid, _engine._scatter_drop(
        v.shape, 0, v.dtype, idx, v, c), 0).to(v.dtype)
        for nm, v in values.items()}
    return (_engine._scatter_drop(groups.shape, PAD_GROUP, torch.int32, idx,
                                  groups, c), out, valid, num)


def replay(spec: PaneStoreSpec, state: PaneStoreState, ops, *,
           interpolate: bool = False, eval_time=None):
    """Evaluate every live group's window from the store (reference path).
    Returns ``(groups [C], {name: values [C]}, valid [C], num_groups)``.
    PANE_PARTIAL_OPS take the per-pane partial path; the other DIRECT_OPS
    come off the merged window; any other combiner falls back to an engine
    pass over the merged, compacted window.

    A time-mode store evaluates ``[eval_time - time_range, eval_time)``,
    always by merge-replay, and drops the rows of groups with no tuple in
    that window (:func:`drop_empty_rows`)."""
    names = [op.name if isinstance(op, Combiner) else op for op in ops]
    c = spec.capacity
    psel = ([False] * len(names) if spec.is_time
            else partial_path_names(names, state.keys.dtype))
    partial_names = [nm for nm, sel in zip(names, psel) if sel]
    merge_pairs = [(op, nm) for (op, nm), sel in zip(zip(ops, names), psel)
                   if not sel]

    values = {}
    if partial_names:
        ugroups, pvals, pvalid, pnum = _replay_partials(spec, state,
                                                        partial_names)
        values.update(pvals)
        if not merge_pairs:
            return ugroups, {nm: torch.where(pvalid, v, 0).to(v.dtype)
                             for nm, v in values.items()}, pvalid, pnum

    runs = gather_runs(spec, state, eval_time=eval_time)
    mvals, cnts = replay_rows(
        spec, runs.run_keys, runs.run_valid, [op for op, _ in merge_pairs],
        [nm for _, nm in merge_pairs], interpolate=interpolate)
    values.update(mvals)
    valid = torch.arange(c, device=state.owner.device) < runs.num_groups
    if spec.is_time:
        return drop_empty_rows(runs.groups, values, valid, cnts)
    return runs.groups, {nm: torch.where(valid, v, 0).to(v.dtype)
                         for nm, v in values.items()}, valid, \
        runs.num_groups
