"""The query-plan API of the port: one declarative ``Query``, a planner, and
the port's backend registry — the counterpart of ``repro.query`` for
grouped aggregation and count-window SWAG.

    >>> from repro_torch.query import Query, Window, execute
    >>> q = Query(ops=("sum", "min", "dc"), window=Window(ws=1024, wa=256))
    >>> result, _ = execute(q, groups, keys)          # on the card
    >>> result.values["sum"].shape                    # [num_windows, 1024]

Per-group windows (``Window(ws, wa, ws_per_group=..., capacity=...)``) run
on the shared pane store: the last ``WS_g`` tuples of each group, one
evaluation per ``wa`` tuples.

Time-range windows (``Window(range=R, slide=S)``) aggregate by event time
over a batch: ``execute(q, groups, keys, timestamps=ts)`` gives one window
``[e - R, e)`` per multiple ``e`` of ``S``, by the flip-batched two-stack
(ungrouped sum/count/min/max) or by replaying each framed window.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; with no card, asking for ``cuda`` raises.  Backends:
``reference`` | ``cuda`` | ``cuda-panes`` | ``cuda-panestore`` | ``auto``
(:mod:`repro_torch.kernels.registry`).

Contracts (as in the paper): non-windowed queries need the input sorted by
group id; ``distinct_count`` and ``median`` also need keys sorted within
groups.  Windowed queries sort internally.

Streaming queries (``Query(streaming=True)``) take one batch a call and
thread a state between calls (``execute(..., state=...)`` returns the
next), or run through :class:`repro_torch.core.StreamingAggregator`:
without a window the state is one rolling carry an op and each push emits
the groups it proves closed; with a count window it is the pane store and
each push emits every live group's window:

    >>> q = Query(ops=("sum", "dc"), streaming=True)
    >>> res, state = execute(q, g1, k1)                # first batch
    >>> res, state = execute(q, g2, k2, state=state)   # the next

With an event-time window (``Window(range=R, slide=S, max_lateness=L)``)
each push carries timestamps; the state is a bounded-lateness reorder
buffer and a time-mode pane store, and each push emits every group's
window ``[wm - R, wm)`` at the stream's watermark ``wm`` (the largest
timestamp seen less ``L``):

    >>> q = Query(ops="sum", window=Window(range=64, slide=16,
    ...                                    max_lateness=8), streaming=True)
    >>> res, state = execute(q, g1, k1, timestamps=t1)
    >>> res, state = execute(q, g2, k2, state=state, timestamps=t2)

``execute(..., collect_stats=True)`` surfaces the engine's counters as
``AggResult.stats`` (:mod:`repro_torch.obs`): a streaming state then
carries a counters dict beside the engine state, the placement, reorder
and time-placement kernels count into it on the card, and nothing is read
back until the caller reads ``stats``.

Sharded execution (``execute(..., num_shards=S)`` or ``mesh=[device,
...]``, one shard a device) runs the two-phase pipeline of
:mod:`repro_torch.distributed.query_exec`: per-shard partial tables, one
combine tree, one finalize, for batch queries with and without a count
window and for rolling streams without one.  On the card the shards'
local phases launch the same kernels as one device, once a shard.  A
sharded event-time stream keeps a reorder buffer a shard, released
against the min-merged watermark, and one shared time-mode pane store: on
the card a push is one reorder launch for every shard's buffer, one
time-mode placement of their merged emissions and one replay.
"""
from __future__ import annotations

import dataclasses
import functools
import time as _time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import engine as _engine
from repro_torch.core import eventtime as _eventtime
from repro_torch.core import panestore as _panestore
from repro_torch.core import segscan as _segscan
from repro_torch.core import streaming as _streaming
from repro_torch.core import twostack as _twostack
from repro_torch.core.combiners import Combiner, get_combiner, out_dtype
from repro_torch.core.sorter import next_pow2, sort_pairs_xla
from repro_torch.core.swag import (PARTIAL_OPS, _median_sorted_window, _swag,
                                   _swag_median, swag_multi, swag_per_group)
from repro_torch.kernels import common as _common
from repro_torch.kernels import registry as _registry
from repro_torch.kernels.eventtime import kernel as _et_kernel
from repro_torch.kernels.groupagg.ops import _groupagg_kernel_exec
from repro_torch.kernels.segscan.ops import segmented_scan_cuda
from repro_torch.kernels.swag import kernel as _swag_kernel
from repro_torch.kernels.swag.ops import (_engine_median_kernel_exec,
                                          _swag_kernel_exec,
                                          _swag_pergroup_kernel_exec,
                                          _timeframe_kernel_exec)
from repro_torch.obs import counters as _c
from repro_torch.obs import trace as _trace

#: spelling conveniences accepted anywhere an op name is
OP_ALIASES = {
    "dc": "distinct_count",
    "avg": "mean",
    "average": "mean",
    "med": "median",
}


def canonical_op(name: str) -> str:
    """Resolve an op-name alias (``"dc"`` -> ``"distinct_count"``, ...)."""
    return OP_ALIASES.get(name, name)


@dataclasses.dataclass(frozen=True)
class Window:
    """Sliding count window: aggregate the last ``ws`` tuples, advance by
    ``wa`` (``None`` means tumbling, ``wa = ws``; ``wa > ws`` samples).
    ``panes`` is the tri-state pane-path control of the reference backend.

    ``ws_per_group`` selects per-group windows on the shared, evicting
    pane store: a mapping ``{group id: ws}`` (other groups take ``ws``), a
    tuple of such pairs, or one int for every group.  ``wa`` is then the
    pane width (a power of two) and the evaluation stride; ``capacity``
    bounds the store in pane slots (``None``: room for every listed group
    plus four default ones).  When live groups need more, the globally
    oldest pane is evicted and its group's window shrinks.

    **Event-time clause** — ``Window(range=R, slide=S)``, without
    ``ws``/``ws_per_group``/``panes``: windows cover ``[e - R, e)`` for
    evaluation times ``e`` at multiples of ``S`` (``slide=None``: tumbling;
    ``S > R`` samples).  Tuples carry timestamps (``execute(...,
    timestamps=...)``).  ``strategy`` is ``"twostack"`` (replay-free;
    ungrouped PARTIAL_OPS only), ``"replay"`` (any op) or ``None`` (the
    two-stack when eligible).  Streamed (``Query(streaming=True)``), the
    clause runs on a time-mode pane store behind a reorder buffer: ``wa``
    is a pane slot's tuple capacity (default 8), ``capacity`` the store's
    slots, ``max_lateness`` the lateness contract (default 0) and
    ``reorder_capacity`` the buffer's slots (default 64)."""
    ws: int | None = None
    wa: int | None = None
    panes: bool | None = None
    ws_per_group: Any = None
    capacity: int | None = None
    range: int | None = None
    slide: int | None = None
    max_lateness: int | None = None
    reorder_capacity: int | None = None
    strategy: str | None = None

    def __post_init__(self):
        if self.capacity is not None and self.capacity <= 0:
            raise ValueError(f"capacity must be positive, got {self.capacity}")
        if self.range is not None:
            self._time_clause()
            return
        for val, nm in ((self.slide, "slide"),
                        (self.max_lateness, "max_lateness"),
                        (self.reorder_capacity, "reorder_capacity"),
                        (self.strategy, "strategy")):
            if val is not None:
                raise ValueError(f"{nm} is an event-time parameter — it "
                                 f"needs Window(range=...)")
        if self.ws is None:
            raise ValueError("Window needs ws (a tuple count) or "
                             "range (a time span)")
        if self.ws <= 0:
            raise ValueError(f"ws must be positive, got {self.ws}")
        wa = self.ws if self.wa is None else self.wa
        if wa <= 0:
            raise ValueError(f"wa must be positive, got {wa}")
        object.__setattr__(self, "wa", wa)
        wpg = self.ws_per_group
        if wpg is not None and not isinstance(wpg, int):
            if isinstance(wpg, tuple):
                pairs = wpg
            else:
                try:
                    pairs = tuple(wpg.items())
                except AttributeError:
                    raise TypeError(
                        "ws_per_group must be a mapping {group id: ws}, an "
                        "int (uniform per-group window), or None; got "
                        f"{wpg!r}") from None
            wpg = tuple(sorted((int(g), int(w)) for g, w in pairs))
            object.__setattr__(self, "ws_per_group", wpg)

    def _time_clause(self) -> None:
        if self.ws is not None or self.ws_per_group is not None:
            raise ValueError(
                "Window(range=...) is time-bounded — the tuple-count "
                "clauses ws / ws_per_group do not apply")
        if self.panes is not None:
            raise ValueError("panes is a count-window control; "
                             "time-range windows pick a strategy "
                             "(strategy='replay'|'twostack')")
        if self.range <= 0:
            raise ValueError(f"range must be positive, got {self.range}")
        slide = self.range if self.slide is None else self.slide
        if slide <= 0:
            raise ValueError(f"slide must be positive, got {slide}")
        object.__setattr__(self, "slide", slide)
        wa = 8 if self.wa is None else self.wa
        if wa <= 0 or wa & (wa - 1):
            raise ValueError(f"time-mode wa (pane-slot tuple capacity) "
                             f"must be a positive power of two, got {wa}")
        object.__setattr__(self, "wa", wa)
        lateness = 0 if self.max_lateness is None else self.max_lateness
        if lateness < 0:
            raise ValueError(f"max_lateness must be >= 0, got {lateness}")
        object.__setattr__(self, "max_lateness", lateness)
        rc = 64 if self.reorder_capacity is None else self.reorder_capacity
        if rc <= 0 or rc & (rc - 1):
            raise ValueError(f"reorder_capacity must be a positive "
                             f"power of two, got {rc}")
        object.__setattr__(self, "reorder_capacity", rc)
        if self.strategy not in (None, "replay", "twostack"):
            raise ValueError(f"strategy must be 'replay', 'twostack' or "
                             f"None, got {self.strategy!r}")

    @property
    def per_group(self) -> bool:
        return self.ws_per_group is not None

    @property
    def is_time(self) -> bool:
        return self.range is not None

    def store_spec(self) -> _panestore.PaneStoreSpec:
        """The pane-store configuration this window clause implies; a time
        clause gives a time-mode store (panes keyed by ``ts // slide``)."""
        if self.is_time:
            npanes = -(-self.range // self.slide) + 1
            cap = self.capacity
            if cap is None:
                cap = next_pow2(max(16, 4 * npanes))
            return _panestore.PaneStoreSpec(
                wa=self.wa, capacity=cap, default_ws=1, per_group=(),
                slide=self.slide, time_range=self.range)
        wpg = self.ws_per_group
        pairs = wpg if isinstance(wpg, tuple) else ()
        default = wpg if isinstance(wpg, int) else self.ws
        cap = self.capacity
        if cap is None:
            cap = _panestore.default_capacity(self.wa, default, pairs)
        return _panestore.PaneStoreSpec(wa=self.wa, capacity=cap,
                                        default_ws=default, per_group=pairs)

    def reorder_spec(self) -> _eventtime.ReorderSpec:
        """The bounded-lateness reorder buffer this (time) clause implies."""
        if not self.is_time:
            raise ValueError("reorder buffers serve Window(range=...) only")
        return _eventtime.ReorderSpec(capacity=self.reorder_capacity,
                                      max_lateness=self.max_lateness)


def _twostack_reason(query: "Query") -> str | None:
    """Why the two-stack strategy cannot serve ``query`` (None = it can)."""
    if query.group_by:
        return ("the flip-batched two-stack aggregates the whole stream "
                "(group_by=False); grouped time windows take the replay "
                "strategy")
    bad = sorted(set(query.op_names) - set(PARTIAL_OPS))
    if bad:
        return (f"two-stack scans need single-array monoid states "
                f"({sorted(PARTIAL_OPS)}); {bad} take the replay strategy")
    return None


def resolve_time_strategy(query: "Query") -> str:
    """A time-window query's strategy, validating an explicit
    ``Window(strategy=...)`` (never a silent fallback)."""
    w = query.window
    if w.strategy == "twostack":
        reason = _twostack_reason(query)
        if reason is not None:
            raise ValueError(f"Window(strategy='twostack') cannot run this "
                             f"query: {reason}")
        return "twostack"
    if w.strategy == "replay":
        return "replay"
    return "twostack" if _twostack_reason(query) is None else "replay"


@dataclasses.dataclass(frozen=True)
class Query:
    """Declarative aggregation query — the ``function_select`` spec.

    Fields: ``ops`` (one name / :class:`Combiner` or a tuple; ``"median"``
    allowed; aliases normalised), ``group_by`` (False: the whole stream is
    one group), ``window`` (:class:`Window`), ``interpolate`` (median only:
    the float midpoint), ``n_valid`` (static real-prefix length),
    ``streaming`` (one batch a call, a state threaded between calls; a
    plain ``Window(ws, wa)`` then runs on the pane store, ``ws`` being each
    group's window), ``presorted`` (windowed queries promise each window
    is already (group, key)-sorted; reference backend)."""
    ops: Any
    group_by: bool = True
    window: Window | None = None
    interpolate: bool = False
    n_valid: int | None = None
    streaming: bool = False
    presorted: bool = False

    def __post_init__(self):
        ops = self.ops
        if isinstance(ops, (str, Combiner)):
            ops = (ops,)
        ops = tuple(canonical_op(op) if isinstance(op, str) else op
                    for op in ops)
        if not ops:
            raise ValueError("Query needs at least one op")
        names = [op.name if isinstance(op, Combiner) else op for op in ops]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate ops in query: {names}")
        object.__setattr__(self, "ops", ops)

    @property
    def op_names(self) -> tuple[str, ...]:
        return tuple(op.name if isinstance(op, Combiner) else op
                     for op in self.ops)


class AggResult(NamedTuple):
    """The single result type every backend returns; the layout of
    ``repro.query.AggResult``.  ``values`` maps op name -> value column;
    all columns share ``groups`` / ``valid`` / ``num_groups``.  Windowed
    queries carry a leading ``[num_windows]`` axis on every array."""
    groups: torch.Tensor      # [N] int32 — compacted group ids (PAD tail)
    values: dict              # {op name: [N] aggregate column}
    valid: torch.Tensor       # [N] bool
    num_groups: torch.Tensor  # scalar int32 (per window when windowed)
    #: engine telemetry (``execute(..., collect_stats=True)``): a dict of
    #: :mod:`repro_torch.obs.counters` values — None when stats are off
    stats: Any = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """A Query lowered onto a concrete backend and stage pipeline.

    ``stages`` is the explicit execution pipeline: one device runs
    ``("local", "finalize")``; sharded plans (``num_shards > 1``) the
    two-phase ``("partition", "local", "merge", "finalize")`` of
    :mod:`repro_torch.distributed.query_exec`.  ``device`` is where the
    inputs and the result live (a mesh's first device)."""
    query: Query
    backend: str            # concrete registry name (never "auto")
    path: str               # "engine" | "window" | "stream"
    device: str
    note: str = ""
    num_shards: int = 1
    stages: tuple = ("local", "finalize")


def _validate_sharded(query: Query, backend: str) -> None:
    """Reject, at plan time and with the reason, a query whose states
    cannot merge across shards (never a silent wrong answer)."""
    w = query.window
    if w is not None and w.per_group:
        raise ValueError(
            "per-group windows (Window(ws_per_group=...)) replay one shared "
            "evicting pane store — a sequential structure with no "
            "cross-shard merge; run them single-device")
    if w is not None and query.streaming and not w.is_time:
        raise ValueError(
            "streaming windowed queries thread one shared pane store as "
            "their carry and cannot shard; stream the non-windowed query "
            "per shard instead")
    if w is not None and w.is_time and not query.streaming:
        raise ValueError(
            "batch time-range windows frame by concrete host-side "
            "timestamps and run single-device; shard the streaming path "
            "(Query(streaming=True)) instead — per-shard reorder buffers "
            "release against the min-merged watermark")
    if query.presorted:
        raise ValueError("presorted conflicts with sharded execution — the "
                         "local phase sorts per shard/pane")
    if w is not None and w.is_time:
        # sharded event-time streaming merges *emissions* (per-shard reorder
        # buffers feed one shared time-pane store), so any replay op works:
        # the mergeable-combiner constraint does not apply
        return
    for op, nm in zip(query.ops, query.op_names):
        if nm == "median":
            if query.streaming:
                raise ValueError("streaming median has no mergeable carry")
            continue
        comb = op if isinstance(op, Combiner) else get_combiner(nm)
        if not comb.mergeable:
            raise ValueError(
                f"op {nm!r} has no cross-shard partial-state merge (its "
                f"lifted positions are shard-local); run it single-device")
    if backend == "cuda" and w is None and not query.streaming:
        # median rides the sorted-run channel, never the group-by kernel; a
        # rolling push's local phase is the engine pass with the scan
        # kernel, whose states are partial states for every op it scans
        from repro_torch.distributed.query_exec import KERNEL_STATE_OPS
        bad = sorted(set(query.op_names) - set(KERNEL_STATE_OPS)
                     - {"median"})
        if bad:
            raise ValueError(
                f"the cuda group-by kernel emits finalized values; only "
                f"{sorted(KERNEL_STATE_OPS)} coincide with their partial "
                f"states, so {bad} cannot shard on this backend — use "
                f"reference")


def plan(query: Query, *, backend: str | None = None, device="cuda",
         num_shards: int = 1, devices=None) -> Plan:
    """Validate ``query``, choose a backend and lay out the stage pipeline.
    Precedence: ``backend``, else the ``REPRO_TORCH_BACKEND`` environment
    variable, else ``auto`` (``kernels.registry.resolve_backend``: an
    unknown name raises here).  Raises ``ValueError`` when an explicitly
    requested backend cannot run the query (never a silent fallback).

    ``num_shards > 1`` plans the two-phase pipeline (``partition -> local
    -> merge -> finalize``); ``devices`` (a mesh's devices) makes ``auto``
    answer for the devices the shards run on, ``device`` by default.  An
    ``auto`` kernel backend that cannot shard the query falls back to the
    reference (the note says so); an explicit one raises.

    Streaming windowed queries run on the per-group pane store: with a
    plain ``Window(ws)`` the window counts each group's *own* last ``ws``
    tuples (the paper's approximation — other numbers than the same window
    executed batch-at-a-time, which frames the raw stream); the plan's
    ``note`` records the reinterpretation."""
    if not isinstance(query, Query):
        raise TypeError(f"expected a Query, got {type(query).__name__}")
    device = _common.require_cuda(device)
    if query.window is not None and query.window.is_time:
        if query.presorted:
            raise ValueError("presorted does not apply to time-range "
                             "windows — they frame by timestamp")
        resolve_time_strategy(query)  # explicit strategy validated now
        query.window.store_spec()     # wa/capacity validated now
    elif query.window is not None and (query.window.per_group
                                       or query.streaming):
        # both the per-group batch path and every streaming windowed query
        # run on the shared pane store (streaming global windows are the
        # paper's approximation: ws becomes each group's default window)
        if query.presorted:
            raise ValueError("presorted is meaningless with the pane "
                             "store — it frames and sorts panes itself")
        if query.window.panes is False:
            raise ValueError("Window(panes=False) conflicts with "
                             "ws_per_group / streaming windows: the pane "
                             "store *is* the pane path")
        query.window.store_spec()  # validate wa/capacity/ws_per_group now
    names = query.op_names
    if query.interpolate and "median" not in names:
        raise ValueError("interpolate=True applies to the median op only")
    if query.n_valid is not None and query.window is not None \
            and not (query.streaming and query.window.is_time):
        # exception: event-time streaming pushes — the reorder buffer
        # ingests a masked prefix a push
        raise ValueError("n_valid applies to non-windowed queries (windows "
                         "frame a dense stream)")
    for op in query.ops:
        if isinstance(op, str) and op != "median":
            get_combiner(op)  # raises on unknown names
    if query.streaming and query.window is None and "median" in names:
        # the JAX package's words (its sharded path); its single-device
        # stream fails on the missing carry
        raise ValueError("streaming median has no mergeable carry")

    name = _registry.resolve_backend(backend)
    note = ""
    if name == "auto":
        name = _registry.choose_backend(
            query, device if devices is None else devices,
            num_shards=num_shards)
        note = "auto"
    reason = _registry.get_backend(name).supports(query)
    if reason is not None:
        raise _registry.unsupported_error(name, reason)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    stages = ("local", "finalize")
    if num_shards > 1:
        try:
            _validate_sharded(query, name)
        except ValueError:
            # an auto-chosen kernel backend must not turn a shardable query
            # into a plan failure: fall back to the reference (an explicit
            # backend still raises)
            if note != "auto" or name == "reference":
                raise
            name = "reference"
            _validate_sharded(query, name)
            note = "auto; kernel backend cannot shard this query"
        stages = ("partition", "local", "merge", "finalize")
    path = ("stream" if query.streaming
            else "window" if query.window is not None
            else "engine")
    if path == "stream" and query.window is not None \
            and query.window.is_time:
        note = (note + "; " if note else "") + \
            "event-time: panes close by watermark; evaluation at each " \
            "push's watermark"
    elif path == "stream" and query.window is not None \
            and not query.window.per_group:
        # NOT the batch semantics: a streamed global window runs on the
        # pane store, where ws becomes each group's default per-group
        # window (the paper's approximation) — flag it on the plan
        note = (note + "; " if note else "") + \
            "stream-window: ws serves as each group's per-group window"
    if path == "stream" and query.window is not None \
            and name == "reference" and device.type == "cuda":
        # no kernel places this push: the reference's loop runs on a host
        # copy of the store, off the card
        why = _registry.BACKENDS["cuda-panestore"].supports(query)
        note = (note + "; " if note else "") + \
            "reference: per-tuple placement on the host" + \
            (f" (cuda-panestore: {why})" if why else "")
    return Plan(query=query, backend=name, path=path, device=str(device),
                note=note, num_shards=num_shards, stages=stages)


def _combiners(query: Query) -> tuple:
    """Resolved combiners aligned with ``query.ops`` (a streaming query
    without a window has no median)."""
    return tuple(op if isinstance(op, Combiner) else get_combiner(op)
                 for op in query.ops)


def _init_stream_counters(p: Plan) -> dict:
    """The zeroed counters dict a stats-collecting stream starts from, on
    the plan's device: every key the step will touch, those of the JAX
    package's single-device streams."""
    dev = torch.device(p.device)
    w = p.query.window
    if w is not None and w.is_time:
        counters = _c.init(dev, reorder_depth_hwm=0, reorder_forced_pops=0,
                           pane_evictions=0, pane_occupancy_hwm=0,
                           late_dropped=0, watermark=_eventtime.TS_MIN)
        if p.num_shards > 1:
            counters.update(_c.init(dev, watermark_lag=0))
        return counters
    if p.num_shards > 1:
        # the combine tree's telemetry: seeded with the plan's round count
        # (log2 of the next power of two), so every push keeps its keys
        rounds = (p.num_shards - 1).bit_length()
        counters = _c.init(dev, stream_tuples=0, combine_rounds=rounds)
        for name, dtype in (("combine_round_width", torch.int32),
                            ("combine_round_groups", torch.int32),
                            ("combine_round_bytes", torch.float32)):
            counters[name] = torch.zeros((rounds,), dtype=dtype, device=dev)
        return counters
    if w is not None:
        return _c.init(dev, pane_evictions=0, pane_occupancy_hwm=0,
                       pergroup_partial_ops=0, pergroup_merge_ops=0)
    return _c.init(dev, stream_tuples=0, stream_emitted=0)


def init_stream_state(p: Plan, key_dtype=torch.int32,
                      collect_stats: bool = False):
    """Fresh state for a streaming plan, on its device: one
    :class:`repro_torch.core.segscan.Carry` an op, a pane store when the
    query is windowed, or the pair ``(reorder buffer, time-mode pane
    store)`` for an event-time window (a sharded plan stacks one reorder
    buffer a shard: each shard tracks its own watermark).

    ``collect_stats=True`` wraps the state as ``(state, counters)``, the
    shape ``stream_fn(..., collect_stats=True)`` threads; pass the same
    flag to both (``execute`` does)."""
    if p.path != "stream":
        raise ValueError("init_stream_state needs a streaming plan")
    dev = torch.device(p.device)
    w = p.query.window
    if w is not None and w.is_time:
        rspec = w.reorder_spec()
        rstate = (_eventtime.init_reorder(rspec, key_dtype, dev)
                  if p.num_shards == 1 else _eventtime.init_reorder_stacked(
                      rspec, p.num_shards, key_dtype, dev))
        state = (rstate, _panestore.init_store(w.store_spec(), key_dtype,
                                               device=dev))
    elif w is not None:
        state = _panestore.init_store(w.store_spec(), key_dtype, device=dev)
    else:
        state = tuple(_segscan.init_carry(c, key_dtype, dev)
                      for c in _combiners(p.query))
    if collect_stats:
        return state, _init_stream_counters(p)
    return state


def _store_push(p: Plan, state, groups, keys, n_valid, inplace: bool,
                counters=None):
    """Place a batch (its first ``n_valid`` tuples) into the pane store:
    on ``cuda-panestore`` one placement scan launch from the carried store
    (``inplace``: the store's own ring and directory are updated); on the
    reference the per-tuple loop on a host copy.  ``counters`` (or None)
    is updated where it lies."""
    spec = p.query.window.store_spec()
    if p.backend != "cuda-panestore":
        if counters is None:
            return _panestore.push(spec, state, groups, keys,
                                   n_valid=n_valid)
        state, new = _panestore.push(spec, state, groups, keys,
                                     n_valid=n_valid,
                                     counters=dict(counters))
        _c.store_into(counters, new)
        return state
    n = groups.shape[-1]
    if n_valid is not None:
        n = min(max(int(n_valid), 0), n)
    if n == 0:
        if counters is not None and groups.shape[-1] > 0:
            # dead tuples only: each step leaves the occupancy as it was
            _c.store_into(counters, _c.high_water(
                _c.ensure(counters, _swag_kernel.PANE_COUNTERS),
                "pane_occupancy_hwm",
                (state.owner != _engine.PAD_GROUP).sum(dtype=torch.int32)))
        return state
    keys = keys[:n].to(state.keys.dtype).contiguous()
    return _swag_kernel.pergroup_scan(
        spec, state, groups[:n].to(torch.int32).contiguous(), keys,
        push=True, inplace=inplace, counters=counters).final


def _time_place(p: Plan, pstate, groups, keys, ts, live, retire_below,
                inplace: bool, counters=None):
    """Place a reorder buffer's emission (its ``live`` lanes) into the
    time-mode pane store: on ``cuda-panestore`` one time-mode placement
    launch, else the plain per-tuple loop on a host copy.  ``counters``
    (or None) is updated where it lies."""
    spec = p.query.window.store_spec()
    if p.backend != "cuda-panestore":
        if counters is None:
            return _panestore.push_time(spec, pstate, groups, keys, ts,
                                        live=live, retire_below=retire_below)
        pstate, new = _panestore.push_time(
            spec, pstate, groups, keys, ts, live=live,
            retire_below=retire_below, counters=dict(counters))
        _c.store_into(counters, new)
        return pstate
    return _swag_kernel.pergroup_scan_time(
        spec, pstate, groups, keys, ts, live, retire_below, inplace=inplace,
        counters=counters)[0]


def _time_push(p: Plan, state, groups, keys, timestamps, n_valid,
               inplace: bool, counters=None):
    """An event-time push: the batch through the reorder buffer, what it
    releases into the time-mode store, panes wholly behind the horizon
    (the watermark less the range) retired.  Returns ``(state, wm)``, the
    watermark a 0-d device tensor (nothing is read back).  On
    ``cuda-panestore`` a reorder launch and a placement launch, which
    count into ``counters`` (or None) where it lies."""
    w = p.query.window
    rspec = w.reorder_spec()
    rstate, pstate = state
    if p.backend == "cuda-panestore":
        emit, rstate = _et_kernel.reorder_push(
            rspec, rstate, timestamps, groups, keys, n_valid=n_valid,
            inplace=inplace, counters=counters)
    elif counters is None:
        emit, rstate = _eventtime.reorder_push(rspec, rstate, timestamps,
                                               groups, keys, n_valid=n_valid)
    else:
        emit, rstate, new = _eventtime.reorder_push(
            rspec, rstate, timestamps, groups, keys, n_valid=n_valid,
            counters=dict(counters))
        _c.store_into(counters, new)
    wm = rstate.max_ts - w.max_lateness
    pstate = _time_place(p, pstate, emit.groups, emit.keys, emit.ts,
                         emit.live, wm - w.range, inplace, counters)
    if counters is not None:
        _c.store_into(counters, {"late_dropped": rstate.dropped,
                                 "watermark": wm})
    return (rstate, pstate), wm


def _time_flush(p: Plan, state, inplace: bool):
    """The end of an event-time stream: drain the reorder buffer (a
    sharded stream's every buffer, in one launch on ``cuda-panestore``,
    their emissions merged by timestamp), place every drained tuple (no
    retirement).  Returns ``(state, eval_time)``, the evaluation time one
    past the largest timestamp seen."""
    rstate, pstate = state
    rspec = p.query.window.reorder_spec()
    sharded = p.num_shards > 1
    if p.backend == "cuda-panestore":
        flush = (_et_kernel.reorder_flush_sharded if sharded
                 else _et_kernel.reorder_flush)
        emit, rstate = flush(rspec, rstate, inplace=inplace)
    else:
        flush = (_eventtime.reorder_flush_sharded if sharded
                 else _eventtime.reorder_flush)
        emit, rstate = flush(rspec, rstate)
    if sharded:
        from repro_torch.distributed.query_exec import merge_emissions
        cols = merge_emissions(emit)
        end = rstate.max_ts.max()
    else:
        cols = (emit.groups, emit.keys, emit.ts, emit.live)
        end = rstate.max_ts
    pstate = _time_place(p, pstate, *cols, None, inplace)
    return (rstate, pstate), end + 1


def _store_eval(p: Plan, state, eval_time=None):
    """One evaluation of every live group's window in the pane store:
    ``(groups [C], {name: values [C]}, valid [C], num)`` (a time-mode
    store at ``eval_time``).  On ``cuda-panestore`` one launch of the
    ring-form replay over the store as a one-snapshot ``[1, ...]``
    state."""
    q = p.query
    spec = q.window.store_spec()
    if p.backend != "cuda-panestore":
        return _panestore.replay(spec, state, q.ops,
                                 interpolate=q.interpolate,
                                 eval_time=eval_time)
    one = _panestore.PaneStoreState(*(x[None] for x in state))
    ovs, ugroups, num = _swag_kernel.pergroup_replay_ring(
        spec, one, q.op_names,
        eval_time=None if eval_time is None else eval_time.reshape(1))
    valid = torch.arange(spec.capacity, device=num.device) < num
    values = {nm: torch.where(valid, v[0], 0).to(v.dtype)
              for nm, v in ovs.items()}
    return (torch.where(valid, ugroups[0], _engine.PAD_GROUP), values,
            valid, num[0])


def stream_fn(p: Plan, *, p_ports: int = 4, mesh=None,
              collect_stats: bool = False, tile: int = 1024,
              inplace: bool = False):
    """The raw streaming step of a planned streaming query: ``(groups,
    keys, state, n_valid) -> ((groups, values, valid, num, rr), state)``
    (an event-time window's step takes ``timestamps`` last).

    Non-windowed streams thread one :class:`segscan.Carry` an op (on
    ``cuda`` each op's segmented scan is one kernel launch at ``tile``);
    windowed streams thread a
    :class:`repro_torch.core.panestore.PaneStoreState` (place the batch,
    then one per-group evaluation); event-time windows thread ``(reorder
    buffer, time-mode store)`` (reorder the batch, place what it releases,
    evaluate at the watermark).  The given state is left as it was,
    unless ``inplace``, which lets a ``cuda-panestore`` push update its
    buffers where they lie.

    Sharded plans (``num_shards > 1``) take the same whole batch, reduce
    each shard's slice to a partial table (over ``mesh``, a sequence of
    devices, when given; on ``cuda`` with the segmented-scan kernel, one
    launch an op a shard), merge them in the combine tree (which reads
    the tables' group counts back, once a push) and fold the carry in at
    emit time: the same slots as one device.  A sharded event-time plan
    keeps a reorder buffer a shard (stacked), releases against the
    min-merged watermark, merges the shards' emissions by timestamp into
    the one time-mode store and evaluates at that watermark
    (:func:`repro_torch.distributed.query_exec.stream_push_eventtime_sharded`;
    ``mesh`` is not used: every buffer runs on the state's device, as the
    JAX package's push runs its shards on one).

    ``collect_stats=True`` expects (and returns) the wrapped state
    ``(engine state, counters dict)`` of ``init_stream_state(...,
    collect_stats=True)``: the counters accumulate across pushes, on the
    device (:mod:`repro_torch.obs.counters`); with ``inplace`` they are
    updated where they lie, else the step counts into copies.  The default
    runs exactly the stats-off step."""
    if p.path != "stream":
        raise ValueError("stream_fn needs a streaming plan")
    if mesh is not None and len(mesh) != p.num_shards:
        raise ValueError(f"the plan shards {p.num_shards} ways but the mesh "
                         f"holds {len(mesh)} devices")
    q = p.query

    def unwrap(state):
        """The engine state and the counters the step counts into."""
        if not collect_stats:
            return state, None
        inner, counters = state
        return inner, counters if inplace else _c.copy(counters)

    def wrap(state, counters):
        return state if counters is None else (state, counters)

    if q.window is not None and q.window.is_time:
        c = q.window.store_spec().capacity
        if p.num_shards > 1:
            from repro_torch.distributed import query_exec as _qx

            def sharded_time_step(groups, keys, state, n_valid=None,
                                  timestamps=None):
                if timestamps is None:
                    raise ValueError("event-time streaming pushes need "
                                     "timestamps=")
                state, counters = unwrap(state)
                ts = _as_tensor(timestamps, groups.device)
                out = _qx.stream_push_eventtime_sharded(
                    q, groups, keys, ts, state, num_shards=p.num_shards,
                    mesh=mesh, n_valid=n_valid, p_ports=p_ports,
                    counters=counters, backend=p.backend, inplace=inplace)
                return out[0], wrap(out[1], counters)

            return sharded_time_step

        def time_step(groups, keys, state, n_valid=None, timestamps=None):
            if timestamps is None:
                raise ValueError("event-time streaming pushes need "
                                 "timestamps=")
            state, counters = unwrap(state)
            ts = _as_tensor(timestamps, groups.device)
            state, wm = _time_push(p, state, groups, keys, ts, n_valid,
                                   inplace, counters)
            g, values, valid, num = _store_eval(p, state[1], eval_time=wm)
            lane = torch.arange(c, dtype=torch.int32, device=valid.device)
            rr = torch.where(valid, lane % p_ports, -1).to(torch.int32)
            return (g, values, valid, num, rr), wrap(state, counters)

        return time_step

    if q.window is not None:
        c = q.window.store_spec().capacity

        def store_step(groups, keys, state, n_valid=None):
            state, counters = unwrap(state)
            state = _store_push(p, state, groups, keys, n_valid, inplace,
                                counters)
            if counters is not None:
                # which ops each evaluation serves on the per-pane partial
                # path and which by merge-replay (a gauge per plan)
                psel = _panestore.partial_path_names(q.op_names,
                                                     state.keys.dtype)
                _c.fill(counters, pergroup_partial_ops=sum(psel),
                        pergroup_merge_ops=len(psel) - sum(psel))
            g, values, valid, num = _store_eval(p, state)
            lane = torch.arange(c, dtype=torch.int32, device=valid.device)
            rr = torch.where(valid, lane % p_ports, -1).to(torch.int32)
            return (g, values, valid, num, rr), wrap(state, counters)

        return store_step

    combiners = _combiners(q)
    if p.num_shards > 1:
        from repro_torch.distributed import query_exec as _qx

        def sharded_step(groups, keys, carries, n_valid=None):
            carries, counters = unwrap(carries)
            out = _qx.stream_push_sharded(
                q, groups, keys, carries, combiners,
                num_shards=p.num_shards, mesh=mesh, n_valid=n_valid,
                p_ports=p_ports, counters=counters, backend=p.backend,
                tile=tile)
            if counters is not None:
                _c.store_into(counters, out[2])
            return out[0], wrap(out[1], counters)

        return sharded_step

    # step (c) on the segmented-scan kernel, one launch an op
    scan = functools.partial(segmented_scan_cuda, tile=tile) \
        if p.backend == "cuda" else _segscan.segmented_scan

    def step(groups, keys, carries, n_valid=None):
        carries, counters = unwrap(carries)
        out, carries = _streaming.stream_push(groups, keys, carries,
                                              combiners, n_valid=n_valid,
                                              p_ports=p_ports, scan=scan)
        if counters is not None:
            pushed = groups.shape[-1] if n_valid is None else n_valid
            if isinstance(pushed, torch.Tensor):
                pushed = pushed.to(groups.device, torch.int32)
            new = _c.bump(counters, "stream_tuples", pushed)
            _c.store_into(counters, _c.bump(new, "stream_emitted", out[3]))
        return out, wrap(carries, counters)

    return step


def _as_tensor(x, device) -> torch.Tensor:
    """A column on ``device``; 64-bit columns narrow to 32 bits, as the
    JAX package's arrays do with x64 off."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    if t.dtype == torch.int64:
        t = t.to(torch.int32)
    elif t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t.to(device)


def _prepare_inputs(query: Query, groups, keys, n_valid, device):
    if keys is None:
        raise ValueError("keys are required")
    keys = _as_tensor(keys, device)
    if query.group_by:
        if groups is None:
            raise ValueError("Query(group_by=True) needs a groups column")
        groups = _as_tensor(groups, device)
    else:
        # the whole stream is one group — SELECT f(k) FROM t
        groups = torch.zeros(keys.shape[-1:], dtype=torch.int32,
                             device=device)
    if n_valid is None:
        n_valid = query.n_valid
    return groups, keys, n_valid


def _execute_engine(p: Plan, groups, keys, n_valid, *, tile: int):
    q = p.query
    names = q.op_names
    if p.backend == "cuda":
        if "median" in names:
            # median needs whole groups in one row: the fused one-row swag
            # kernel over the pow2-padded stream (all ops ride along)
            og, ovs, valid, num = _engine_median_kernel_exec(
                groups, keys, names, n_valid=n_valid)
            return AggResult(og, ovs, valid, num)
        og, ovs, valid, num = _groupagg_kernel_exec(
            groups, keys, q.ops, n_valid=n_valid, tile=tile)
        return AggResult(og, ovs, valid, num)

    non_median = tuple(op for op, nm in zip(q.ops, names) if nm != "median")
    values = {}
    shared = None
    if non_median:
        (g, vals, valid, num), _ = _engine.multi_engine_step(
            groups, keys, non_median, n_valid=n_valid)
        values.update(vals)
        shared = (g, valid, num)
    if "median" in names:
        t = _median_sorted_window(groups, keys, interpolate=q.interpolate,
                                  n_valid=n_valid)
        values["median"] = t.medians
        shared = shared or (t.groups, t.valid, t.num_groups)
    return AggResult(shared[0], values, shared[1], shared[2])


def _execute_window(p: Plan, groups, keys, counters=None):
    q = p.query
    w = q.window
    if w.per_group:
        spec = w.store_spec()
        if p.backend == "cuda-panestore":
            og, ovs, valid, num = _swag_pergroup_kernel_exec(
                groups, keys, spec=spec, ops=q.op_names,
                regime=_registry.pergroup_kernel_path(q, keys.dtype))
            if counters is None:
                return AggResult(og, ovs, valid, num)
            # the JAX package's pallas-panestore gauges: evaluations,
            # replay rows and the ops of each regime
            names = q.op_names
            psel = _panestore.partial_path_names(names, keys.dtype)
            ne = groups.shape[-1] // spec.wa
            fused = bool(psel) and all(psel)
            return AggResult(og, ovs, valid, num, _c.init(
                keys.device, pergroup_evals_batched=ne,
                pergroup_replay_rows_per_launch=ne * spec.capacity,
                pergroup_partial_dispatch=len(names) if fused else 0,
                pergroup_merge_dispatch=0 if fused else len(names)))
        if counters is not None:
            (og, values, valid, num), _, counters = swag_per_group(
                groups, keys, spec=spec, ops=q.ops,
                interpolate=q.interpolate, counters=counters)
            return AggResult(og, values, valid, num, counters)
        (og, values, valid, num), _ = swag_per_group(
            groups, keys, spec=spec, ops=q.ops, interpolate=q.interpolate)
        return AggResult(og, values, valid, num)
    if p.backend in ("cuda", "cuda-panes"):
        og, ovs, valid, oc = _swag_kernel_exec(
            groups, keys, ws=w.ws, wa=w.wa, ops=q.op_names,
            panes=p.backend == "cuda-panes")
        return AggResult(og, ovs, valid, oc)

    if len(q.ops) > 1:
        g, values, valid, num = swag_multi(
            groups, keys, ws=w.ws, wa=w.wa, ops=q.ops,
            interpolate=q.interpolate, presorted=q.presorted, panes=w.panes)
        return AggResult(g, values, valid, num)
    (op,) = q.ops
    (name,) = q.op_names
    if name == "median":
        r = _swag_median(groups, keys, ws=w.ws, wa=w.wa,
                         interpolate=q.interpolate, panes=w.panes)
        return AggResult(r.groups, {name: r.medians}, r.valid, r.num_groups)
    r = _swag(groups, keys, ws=w.ws, wa=w.wa, op=op, presorted=q.presorted,
              panes=w.panes)
    return AggResult(r.groups, {name: r.values}, r.valid, r.num_groups)


def _execute_sharded(p: Plan, groups, keys, n_valid, *, mesh, tile: int,
                     counters=None):
    """A batch query through the two-phase pipeline of
    :mod:`repro_torch.distributed.query_exec`."""
    from repro_torch.distributed import query_exec as _qx
    q = p.query
    if p.path == "window":
        if n_valid is not None:
            raise ValueError("n_valid applies to non-windowed queries")
        # the per-window combine trees run batched (one tiny tree a
        # window): no shard-tree telemetry to record there
        g, values, valid, num = _qx._window_sharded(
            q, groups, keys, num_shards=p.num_shards, mesh=mesh,
            backend=p.backend)
    elif counters is not None:
        g, values, valid, num, counters = _qx._engine_sharded(
            q, groups, keys, n_valid, num_shards=p.num_shards, mesh=mesh,
            backend=p.backend, tile=tile, counters=counters)
    else:
        g, values, valid, num = _qx._engine_sharded(
            q, groups, keys, n_valid, num_shards=p.num_shards, mesh=mesh,
            backend=p.backend, tile=tile)
    return AggResult(g, values, valid, num, counters)


def _execute_time_window(p: Plan, groups, keys, timestamps):
    """A batch of ``Window(range=..., slide=...)``: sort by timestamp once
    (window count and width are shapes, read back from the device), then
    either the flip-batched **two-stack** (ungrouped PARTIAL_OPS; plain
    scans or the twostack_flip kernel) or a **replay** of each framed
    window (any op; engine rows or the swag kernel)."""
    q = p.query
    w = q.window
    ts = _eventtime.concrete_timestamps(timestamps, keys.device)
    if ts.shape[0] != keys.shape[-1]:
        raise ValueError(f"timestamps length {ts.shape[0]} != stream "
                         f"length {keys.shape[-1]}")
    layout = _eventtime.time_window_layout(ts, w.range, w.slide)
    gs = groups.to(torch.int32)[layout.order]
    ks = keys[layout.order]
    kernels = p.backend != "reference"
    dev = keys.device

    if resolve_time_strategy(q) == "twostack":
        epochs = _twostack.epoch_layout(layout.starts.cpu().numpy(),
                                        layout.ends.cpu().numpy())
        values, cnt = _twostack.twostack_time_windows(
            ks, layout, epochs, q.op_names, use_kernel=kernels)
        valid = (cnt > 0)[:, None]
        og = torch.where(valid, torch.zeros((), dtype=torch.int32,
                                            device=dev),
                         torch.tensor(_engine.PAD_GROUP, dtype=torch.int32,
                                      device=dev))
        return AggResult(og, {name: v[:, None] for name, v in values.items()},
                         valid, valid[:, 0].to(torch.int32))

    fg, fk, cnt = _eventtime.frame_time_windows(layout, gs, ks,
                                                _engine.PAD_GROUP)
    if kernels:
        return AggResult(*_timeframe_kernel_exec(fg, fk, ops=q.op_names))

    names = q.op_names
    if cnt.shape[0] == 0:
        shape = (0, layout.wcap)
        med = torch.float32 if q.interpolate else keys.dtype
        return AggResult(
            torch.zeros(shape, dtype=torch.int32, device=dev),
            {name: torch.zeros(shape, dtype=med if name == "median"
                               else out_dtype(name, keys.dtype), device=dev)
             for name in names},
            torch.zeros(shape, dtype=torch.bool, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev))
    # each row sorted by (group, key): PAD_GROUP sorts last, so the live
    # lanes form the prefix n_valid marks
    g2, k2 = sort_pairs_xla(fg, fk)
    non_median = tuple(op for op, nm in zip(q.ops, names) if nm != "median")
    values = {}
    shared = None
    if non_median:
        (og, vals, valid, num), _ = _engine.multi_engine_step(
            g2, k2, non_median, n_valid=cnt)
        values.update(vals)
        shared = (og, valid, num)
    if "median" in names:
        t = _median_sorted_window(g2, k2, interpolate=q.interpolate,
                                  n_valid=cnt)
        values["median"] = t.medians
        shared = shared or (t.groups, t.valid, t.num_groups)
    return AggResult(shared[0], values, shared[1], shared[2])


def execute(plan_or_query, groups, keys=None, *, state=None,
            backend: str | None = None, device="cuda", tile: int = 1024,
            n_valid=None, timestamps=None, mesh=None,
            num_shards: int | None = None, collect_stats: bool = False):
    """Run a :class:`Query` (planned on the fly) or a prebuilt :class:`Plan`.

    Args:
      groups: [N] group-id column (``None`` for ``Query(group_by=False)``);
        numpy or torch, moved to ``device``.
      keys: [N] value column.
      state: streaming queries only — the state the previous call
        returned (``None`` starts a fresh stream); it is not modified.
        An event-time stream's state is ``(reorder buffer, time-mode pane
        store)``.
      backend: override the plan's backend (re-plans when it differs).
      device: where to run — ``"cuda"`` (the default) or ``"cpu"``, where
        the kernel backends run their kernels' plain torch versions.
      tile: kernel tile length of the ``cuda`` group-by path and of a
        ``cuda`` streaming push's scans.
      n_valid: prefix-length override of ``query.n_valid``.
      timestamps: [N] integer event times of a ``Window(range=...)``
        query (numpy or torch; required by it, refused by the others;
        int32 in a stream).
      mesh: a sequence of devices (``torch.device`` or their names), one
        shard each: the two-phase pipeline with shard *s*'s local phase on
        ``mesh[s]`` and the combine tree on ``mesh[0]``, where the inputs
        and the result live (``device`` is then ``mesh[0]``).
      num_shards: the shard count without a mesh: the same pipeline on
        ``device`` (the kernels launched once a shard).  With ``mesh`` it
        must match the mesh's length (or be omitted).  The sharded result
        equals one device's on the valid lanes, for the exactly-mergeable
        ops on int32 keys.
      collect_stats: surface the engine's counters
        (:mod:`repro_torch.obs.counters`) as ``AggResult.stats``, and
        record the call's observed tuples/s in
        :data:`repro_torch.obs.registry.METRICS` under ``(backend, plan
        fingerprint)`` (waiting for the result on the device to time it).
        It never changes a result.  Streaming queries keep the flag
        constant across a stream (the counters live in the state): pass
        ``state=None`` to toggle it.

    Returns ``(AggResult, new_state)``; ``new_state`` is ``None`` unless
    the query streams.
    """
    t0 = _time.perf_counter()
    devices = None
    if mesh is not None:
        from repro_torch.distributed import query_exec as _qx
        mesh_shards = _qx.mesh_num_shards(mesh)
        if num_shards is not None and num_shards != mesh_shards:
            raise ValueError(
                f"num_shards={num_shards} contradicts the mesh's "
                f"{mesh_shards} devices; pass one or the other")
        num_shards = mesh_shards
        devices = [_common.require_cuda(d) for d in mesh]
        device = devices[0]
    device = _common.require_cuda(device)
    with _trace.span("plan"):
        if isinstance(plan_or_query, Plan):
            p = plan_or_query
            want = backend if backend is not None else p.backend
            shards = num_shards if num_shards is not None else p.num_shards
            if want != p.backend or torch.device(p.device) != device \
                    or shards != p.num_shards:
                p = plan(p.query, backend=want, device=device,
                         num_shards=shards, devices=devices)
        else:
            p = plan(plan_or_query, backend=backend, device=device,
                     num_shards=1 if num_shards is None else num_shards,
                     devices=devices)

    groups, keys, n_valid = _prepare_inputs(p.query, groups, keys, n_valid,
                                            device)
    n = groups.shape[-1]
    is_time = p.query.window is not None and p.query.window.is_time
    if is_time and timestamps is None:
        raise ValueError("Window(range=...) queries aggregate by event "
                         "time; pass timestamps=")
    if not is_time and timestamps is not None:
        raise ValueError("timestamps apply to time-range windows "
                         "(Window(range=...)) only")
    if p.path == "stream":
        if state is None:
            state = init_stream_state(p, keys.dtype,
                                      collect_stats=collect_stats)
        elif collect_stats != _state_collects_stats(state):
            raise ValueError(
                "collect_stats must stay constant across a stream — the "
                "counters live in the threaded state; pass state=None to "
                "start a new stream with the other setting")
        extra = (timestamps,) if is_time else ()
        step = stream_fn(p, tile=tile, mesh=mesh,
                         collect_stats=collect_stats)
        with _trace.span(f"dispatch:{p.backend}/stream") as sp:
            (g, values, valid, num, _rr), new_state = step(
                groups, keys, state, n_valid, *extra)
            sp.attach((values, new_state))
        stats = dict(new_state[1]) if collect_stats else None
        res = AggResult(g, values, valid, num, stats)
        if collect_stats:
            _observe_throughput(p, res, n, t0)
        return res, new_state
    if state is not None:
        raise ValueError("state= applies to streaming queries "
                         "(Query(streaming=True))")
    counters = {} if collect_stats else None
    if p.num_shards > 1:
        with _trace.span(f"dispatch:{p.backend}/{p.path}/sharded") as sp:
            res = _execute_sharded(p, groups, keys, n_valid, mesh=mesh,
                                   tile=tile, counters=counters)
            sp.attach(res)
    elif p.path == "window":
        if n_valid is not None:
            raise ValueError("n_valid applies to non-windowed queries")
        with _trace.span(f"dispatch:{p.backend}/window") as sp:
            if is_time:
                res = _execute_time_window(p, groups, keys, timestamps)
            else:
                res = _execute_window(p, groups, keys, counters)
            sp.attach(res)
    else:
        with _trace.span(f"dispatch:{p.backend}/engine") as sp:
            res = _execute_engine(p, groups, keys, n_valid, tile=tile)
            sp.attach(res)
    if collect_stats:
        stats = dict(res.stats) if res.stats else {}
        stats["tuples"] = n
        stats["num_shards"] = p.num_shards
        res = res._replace(stats=stats)
        _observe_throughput(p, res, n, t0)
    return res, None


def _state_collects_stats(state) -> bool:
    """Whether a streaming state is the ``(state, counters)`` wrapping of
    ``collect_stats=True`` (a dict second element — no engine state ever
    holds one)."""
    return (isinstance(state, tuple) and len(state) == 2
            and isinstance(state[1], dict))


def _observe_throughput(p: Plan, res: AggResult, tuples: int,
                        t0: float) -> None:
    """Record one observed-throughput sample in the process registry,
    once the result is ready on its device."""
    from repro_torch.obs.registry import METRICS, plan_fingerprint
    _trace.synchronize((res.groups, res.values))
    METRICS.observe(p.backend, plan_fingerprint(p), tuples=int(tuples),
                    seconds=_time.perf_counter() - t0)
