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

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; with no card, asking for ``cuda`` raises.  Backends:
``reference`` | ``cuda`` | ``cuda-panes`` | ``cuda-panestore`` | ``auto``
(:mod:`repro_torch.kernels.registry`).

Contracts (as in the paper): non-windowed queries need the input sorted by
group id; ``distinct_count`` and ``median`` also need keys sorted within
groups.  Windowed queries sort internally.

Streaming, event-time windows, execution statistics and sharded execution
belong to later slices of the port and raise ``NotImplementedError`` naming
the ROADMAP slice that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import engine as _engine
from repro_torch.core import panestore as _panestore
from repro_torch.core.combiners import Combiner, get_combiner
from repro_torch.core.swag import (_median_sorted_window, _swag,
                                   _swag_median, swag_multi, swag_per_group)
from repro_torch.kernels import common as _common
from repro_torch.kernels import registry as _registry
from repro_torch.kernels.groupagg.ops import _groupagg_kernel_exec
from repro_torch.kernels.swag.ops import (_engine_median_kernel_exec,
                                          _swag_kernel_exec,
                                          _swag_pergroup_kernel_exec)

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


def _later_slice(feature: str, slice_no: int, title: str):
    return NotImplementedError(
        f"{feature} is not ported yet; it comes with ROADMAP queue 1, "
        f"slice {slice_no} ({title}) — use repro.query meanwhile")


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

    The event-time fields of ``repro.query.Window`` are kept and raise
    until their slice is ported."""
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
            raise _later_slice("Window(range=...)", 5, "event time")
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

    @property
    def per_group(self) -> bool:
        return self.ws_per_group is not None

    def store_spec(self) -> _panestore.PaneStoreSpec:
        """The pane-store configuration this window clause implies."""
        wpg = self.ws_per_group
        pairs = wpg if isinstance(wpg, tuple) else ()
        default = wpg if isinstance(wpg, int) else self.ws
        cap = self.capacity
        if cap is None:
            cap = _panestore.default_capacity(self.wa, default, pairs)
        return _panestore.PaneStoreSpec(wa=self.wa, capacity=cap,
                                        default_ws=default, per_group=pairs)


@dataclasses.dataclass(frozen=True)
class Query:
    """Declarative aggregation query — the ``function_select`` spec.

    Fields: ``ops`` (one name / :class:`Combiner` or a tuple; ``"median"``
    allowed; aliases normalised), ``group_by`` (False: the whole stream is
    one group), ``window`` (:class:`Window`), ``interpolate`` (median only:
    the float midpoint), ``n_valid`` (static real-prefix length),
    ``streaming`` (a later slice), ``presorted`` (windowed queries promise
    each window is already (group, key)-sorted; reference backend)."""
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
    stats: Any = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """A Query lowered onto a concrete backend for one device."""
    query: Query
    backend: str            # concrete registry name (never "auto")
    path: str               # "engine" | "window"
    device: str
    note: str = ""


def plan(query: Query, *, backend: str | None = None,
         device="cuda") -> Plan:
    """Validate ``query`` and choose a backend (``None`` means ``auto``).
    Raises ``ValueError`` when an explicitly requested backend cannot run
    the query (never a silent fallback)."""
    if not isinstance(query, Query):
        raise TypeError(f"expected a Query, got {type(query).__name__}")
    if query.streaming:
        raise _later_slice("Query(streaming=True)", 3, "streaming")
    device = _common.require_cuda(device)
    if query.window is not None and query.window.per_group:
        if query.presorted:
            raise ValueError("presorted is meaningless with the pane "
                             "store — it frames and sorts panes itself")
        if query.window.panes is False:
            raise ValueError("Window(panes=False) conflicts with "
                             "ws_per_group: the pane store *is* the pane "
                             "path")
        query.window.store_spec()  # validate wa/capacity/ws_per_group now
    names = query.op_names
    if query.interpolate and "median" not in names:
        raise ValueError("interpolate=True applies to the median op only")
    if query.n_valid is not None and query.window is not None:
        raise ValueError("n_valid applies to non-windowed queries (windows "
                         "frame a dense stream)")
    for op in query.ops:
        if isinstance(op, str) and op != "median":
            get_combiner(op)  # raises on unknown names

    name = "auto" if backend is None else backend
    note = ""
    if name == "auto":
        name = _registry.choose_backend(query, device)
        note = "auto"
    reason = _registry.get_backend(name).supports(query)
    if reason is not None:
        raise _registry.unsupported_error(name, reason)
    path = "window" if query.window is not None else "engine"
    return Plan(query=query, backend=name, path=path, device=str(device),
                note=note)


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


def _execute_window(p: Plan, groups, keys):
    q = p.query
    w = q.window
    if w.per_group:
        spec = w.store_spec()
        if p.backend == "cuda-panestore":
            og, ovs, valid, num = _swag_pergroup_kernel_exec(
                groups, keys, spec=spec, ops=q.op_names,
                regime=_registry.pergroup_kernel_path(q, keys.dtype))
            return AggResult(og, ovs, valid, num)
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


def execute(plan_or_query, groups, keys=None, *, backend: str | None = None,
            device="cuda", tile: int = 1024, n_valid=None, mesh=None,
            num_shards: int | None = None, collect_stats: bool = False):
    """Run a :class:`Query` (planned on the fly) or a prebuilt :class:`Plan`.

    Args:
      groups: [N] group-id column (``None`` for ``Query(group_by=False)``);
        numpy or torch, moved to ``device``.
      keys: [N] value column.
      backend: override the plan's backend (re-plans when it differs).
      device: where to run — ``"cuda"`` (the default) or ``"cpu"``, where
        the kernel backends run their kernels' plain torch versions.
      tile: kernel tile length of the ``cuda`` group-by path.
      n_valid: prefix-length override of ``query.n_valid``.
      mesh, num_shards, collect_stats: later slices of the port.

    Returns ``(AggResult, None)``.
    """
    if mesh is not None or num_shards not in (None, 1):
        raise _later_slice("sharded execution (mesh=, num_shards=)", 7,
                           "multi-device")
    if collect_stats:
        raise _later_slice("execute(collect_stats=True)", 6,
                           "observability")
    device = _common.require_cuda(device)
    if isinstance(plan_or_query, Plan):
        p = plan_or_query
        want = backend if backend is not None else p.backend
        if want != p.backend or torch.device(p.device) != device:
            p = plan(p.query, backend=want, device=device)
    else:
        p = plan(plan_or_query, backend=backend, device=device)

    groups, keys, n_valid = _prepare_inputs(p.query, groups, keys, n_valid,
                                            device)
    if p.path == "window":
        if n_valid is not None:
            raise ValueError("n_valid applies to non-windowed queries")
        return _execute_window(p, groups, keys), None
    return _execute_engine(p, groups, keys, n_valid, tile=tile), None
