"""Streaming (multi-batch) execution — the paper's non-blocking pipeline, in
torch (the counterpart of ``repro.core.streaming``).

A batch is a column of ``N`` tuples; :func:`stream_push` is the multi-op
rolling step (one fused engine pass, per-op carries — the ``n'`` state —
threaded between calls).  It is the ``path == "stream"`` step of the
port's query API (``repro_torch.query``); :class:`StreamingAggregator` is
the stateful wrapper over a planned streaming ``Query``.  Semantics:

  * a group fully contained in past batches is emitted by the push() that
    first proves it closed (i.e. sees a different leading group id);
  * the final, possibly-open group of each batch is withheld (``open_tail``);
  * ``flush()`` closes the stream and emits the last group.

Outputs are padded to ``N + 1`` slots (the +1 holds a carried-over group
that closed at a batch boundary) with a ``valid`` mask; ``rr_port``
reproduces the round-robin port rotation across the whole stream.

With a count window the carry is a pane store
(:mod:`repro_torch.core.panestore`): each push places the batch and emits
one per-group-window evaluation.  With an event-time window
(``Window(range=...)``) every push carries timestamps and the carry is a
reorder buffer and a time-mode pane store: each push emits every group's
window at the stream's watermark, and ``flush()`` drains the buffer and
evaluates past the last tuple.  ``collect_stats=True`` threads a
:mod:`repro_torch.obs.counters` dict beside the carry.  A rolling stream
without a window shards (``num_shards=`` or ``mesh=``): each push reduces
its shards' slices to partial tables, merges them in the combine tree
(:func:`stream_push_table` folds the carry in), and emits the same slots
as one device.  An event-time stream shards too: a reorder buffer a shard
(stacked in the carry), released against the min-merged watermark, whose
emissions merge by timestamp into one time-mode pane store; its
``late_dropped`` is the sum over the shards, and the flush drains every
shard's buffer (one launch on the card) and evaluates past the largest
timestamp any shard saw.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import engine as _engine
from repro_torch.core import segscan
from repro_torch.core.combiners import Combiner, get_combiner, tree_map
from repro_torch.obs import counters as _c
from repro_torch.obs import trace as _trace


class StreamResult(NamedTuple):
    groups: torch.Tensor      # [N+1] (windowed: [C])
    values: torch.Tensor      # [N+1]
    valid: torch.Tensor       # [N+1] bool
    num_groups: torch.Tensor  # scalar int32
    rr_port: torch.Tensor     # [N+1] round-robin output port (-1 where invalid)
    #: engine telemetry: the cumulative counters dict with
    #: ``collect_stats=True``; else ``{"late_dropped": 0-d int32}`` for
    #: event-time windows (the stream's late tuples so far), or None
    stats: Any = None


def stream_push(groups: torch.Tensor, keys: torch.Tensor, carries,
                combiners, *, n_valid=None, p_ports: int = 4,
                scan=segscan.segmented_scan):
    """One rolling multi-op engine pass over a batch of sorted tuples.

    ``carries`` is a tuple of :class:`segscan.Carry`, aligned with
    ``combiners``; every carry shares the group / nonempty / emitted fields
    (the group structure is op-independent), so the first one drives the
    close-carry decision.  ``scan`` is the engine's step (c)
    (:func:`repro_torch.core.engine.multi_engine_step`).  Returns
    ``((groups, {name: values}, valid, num, rr_port), new_carries)`` with
    ``N + 1`` output slots; nothing is read back to the host.
    """
    combiners = tuple(c if isinstance(c, Combiner) else get_combiner(c)
                      for c in combiners)
    n = groups.shape[0]
    dev = groups.device
    lead = carries[0]
    emitted_before = lead.emitted

    closes_carry = lead.nonempty & (groups[0].to(torch.int32) != lead.group)
    if n_valid is not None:
        closes_carry = closes_carry & (torch.as_tensor(n_valid, device=dev)
                                       > 0)
    carried_group = lead.group
    carried_values = {c.name: c.finalize(cr.state)
                      for c, cr in zip(combiners, carries)}

    # neutralize the carries before the engine merges them if being closed
    minus_one = torch.tensor(-1, dtype=torch.int32, device=dev)
    live_carries = tuple(
        segscan.Carry(
            group=torch.where(closes_carry, minus_one, cr.group),
            state=cr.state,
            nonempty=cr.nonempty & ~closes_carry,
            emitted=cr.emitted + closes_carry.to(torch.int32),
        ) for cr in carries)

    (res_g, res_values, _res_valid, res_num), new_carries = \
        _engine.multi_engine_step(groups, keys, combiners,
                                  carries=live_carries, open_tail=True,
                                  n_valid=n_valid, scan=scan)

    # prepend the carried group's slot; rotate so valid entries stay dense
    # (if the carry slot is unused, shift engine results up by one)
    num = res_num + closes_carry.to(torch.int32)
    shift = (~closes_carry).to(torch.int64)
    idx = torch.arange(n + 1, device=dev)
    src = torch.clamp(idx + shift, 0, n)

    pad = torch.tensor(_engine.PAD_GROUP, dtype=torch.int32, device=dev)
    out_groups = torch.cat([
        torch.where(closes_carry, carried_group, pad)[None], res_g])[src]
    out_values = {}
    for c in combiners:
        cv = carried_values[c.name]
        col = torch.cat([
            torch.where(closes_carry, cv, torch.zeros((), dtype=cv.dtype,
                                                      device=dev))[None],
            res_values[c.name]])
        out_values[c.name] = col[src]
    out_valid = idx < num

    rr = torch.where(out_valid, (emitted_before + idx) % p_ports,
                     -1).to(torch.int32)
    return (out_groups, out_values, out_valid, num, rr), new_carries


def stream_push_table(table, carries, combiners, *, first_group, any_real,
                      p_ports: int = 4):
    """The emission half of a sharded rolling push: given the batch's
    merged per-group :class:`repro_torch.core.engine.PartialTable` (the
    cross-shard combine tree's, ``repro_torch.distributed.query_exec``),
    fold in the rolling carry, emit every group but the open tail, and roll
    the tail into the new carry.

    Mirrors :func:`stream_push` slot for slot (the closed-carry slot first,
    round-robin ports, the carry's bookkeeping), so a sharded stream equals
    the single-device one for exactly-mergeable ops.  ``first_group`` is
    the raw batch's leading group id (it decides whether the carry
    closes), ``any_real`` a 0-d bool tensor, False for an all-padding
    batch (``n_valid == 0``).  Nothing is read back."""
    combiners = tuple(c if isinstance(c, Combiner) else get_combiner(c)
                      for c in combiners)
    c_slots = table.groups.shape[-1]
    dev = table.groups.device
    lead = carries[0]
    emitted_before = lead.emitted

    closes_carry = (lead.nonempty & any_real
                    & (first_group.to(torch.int32) != lead.group))
    carried_group = lead.group
    carried_values = {c.name: c.finalize(cr.state)
                      for c, cr in zip(combiners, carries)}

    # the carry continues into the batch's first group: fold its state
    # into table row 0 (the earlier range on the left)
    applies = lead.nonempty & any_real & ~closes_carry
    num_t = table.num_groups
    idx = torch.arange(c_slots, device=dev)
    emit_row = table.valid & (idx < num_t - 1)   # withhold the open tail
    num = (torch.clamp(num_t - 1, min=0)
           + closes_carry.to(torch.int32)).to(torch.int32)
    tail_idx = torch.clamp(num_t - 1, min=0).to(torch.int64)

    out_values = {}
    new_carries = []
    for c, cr in zip(combiners, carries):
        st = table.states[c.name]
        merged0 = c.partial_merge(tree_map(lambda x: x[None], cr.state),
                                  tree_map(lambda x: x[:1], st))
        st = tree_map(lambda m, x: torch.cat([torch.where(applies, m, x[:1]),
                                              x[1:]]), merged0, st)
        vals = c.finalize(st)
        zero = torch.zeros((), dtype=vals.dtype, device=dev)
        cv = carried_values[c.name]
        out_values[c.name] = torch.cat([
            torch.where(closes_carry, cv, zero.to(cv.dtype))[None],
            torch.where(emit_row, vals, zero)])
        new_carries.append(segscan.Carry(
            group=torch.where(any_real, table.groups[tail_idx],
                              cr.group).to(torch.int32),
            state=tree_map(lambda x, old: torch.where(any_real, x[tail_idx],
                                                      old), st, cr.state),
            nonempty=cr.nonempty | any_real,
            emitted=(emitted_before + num).to(torch.int32),
        ))

    # prepend the carried group's slot; rotate so valid entries stay dense
    shift = (~closes_carry).to(torch.int64)
    out_idx = torch.arange(c_slots + 1, device=dev)
    src = torch.clamp(out_idx + shift, 0, c_slots)
    pad = torch.tensor(_engine.PAD_GROUP, dtype=torch.int32, device=dev)
    row_groups = torch.where(emit_row, table.groups, pad)
    out_groups = torch.cat([torch.where(closes_carry, carried_group,
                                        pad)[None], row_groups])[src]
    out_values = {name: col[src] for name, col in out_values.items()}
    out_valid = out_idx < num
    rr = torch.where(out_valid, (emitted_before + out_idx) % p_ports,
                     -1).to(torch.int32)
    return (out_groups, out_values, out_valid, num, rr), tuple(new_carries)


class StreamingAggregator:
    """Stateful wrapper over a planned streaming Query; one engine pass per
    ``push``.

    With ``window=repro_torch.query.Window(...)`` the carry threaded
    between pushes *is* a pane store (:mod:`repro_torch.core.panestore`):
    each ``push`` ingests the batch and emits one per-group-window
    evaluation — the paper's SWAG-with-groups approximation as a streaming
    surface (``ws_per_group`` per-group sizes, or ``ws`` as every group's
    default).

    ``op`` is one op, as in the JAX package (results carry its value
    column), or a tuple of ops a ``Query`` takes (``"median"`` with a
    window; results carry ``{name: column}``).  ``device`` and ``backend``
    are ``execute``'s: the plan is ``auto`` for the device (the kernels on
    the card, the reference on the CPU).  On ``cuda-panestore`` a push
    updates its pane store (and an event-time window's reorder buffer) in
    place, where the JAX package donates the carry.

    An event-time window (``Window(range=...)``) takes ``timestamps=`` on
    every push; its results carry ``stats={"late_dropped": ...}``.

    ``num_shards`` / ``mesh`` (a sequence of devices, one shard each; the
    carry lives on the first) run every push of a stream without a window
    through the two-phase pipeline of
    :mod:`repro_torch.distributed.query_exec`, and an event-time stream
    through a reorder buffer a shard under the min-merged watermark
    (``stream_push_eventtime_sharded``; its buffers all live on the first
    device); ``push`` also takes the batch pre-cut as ``[num_shards, L]``
    slices.

    ``collect_stats=True`` threads a :mod:`repro_torch.obs.counters` dict
    beside the carry and surfaces it (cumulative over the stream, copies
    on the device) as ``StreamResult.stats`` on every push and on the
    flush, with ``store_donated_buffers``: the state tensors the pushes
    so far updated in place (counters included), where the JAX package
    counts the carry buffers its pushes donate.  Nothing is read back.
    """

    def __init__(self, op="sum", *, window=None, key_dtype=torch.int32,
                 p_ports: int = 4, num_shards: int | None = None,
                 mesh=None, collect_stats: bool = False, device="cuda",
                 backend: str | None = None):
        from repro_torch import query as _q
        if mesh is not None:
            if num_shards is not None and num_shards != len(mesh):
                raise ValueError(
                    f"num_shards={num_shards} contradicts the mesh's "
                    f"{len(mesh)} devices")
            num_shards = len(mesh)
            device = mesh[0]
        self.num_shards = num_shards or 1
        self.mesh = mesh
        self._one = not isinstance(op, (tuple, list))
        if self._one:
            op = op if isinstance(op, Combiner) else get_combiner(op)
        query = _q.Query(ops=(op,) if self._one else tuple(op),
                         window=window, streaming=True)
        self.window = window
        self.key_dtype = key_dtype
        self.p_ports = p_ports
        self.collect_stats = bool(collect_stats)
        self.plan = _q.plan(query, backend=backend, device=device,
                            num_shards=self.num_shards, devices=mesh)
        self.carry = _q.init_stream_state(self.plan, key_dtype,
                                          collect_stats=self.collect_stats)
        self._step = _q.stream_fn(self.plan, p_ports=p_ports, mesh=mesh,
                                  inplace=True,
                                  collect_stats=self.collect_stats)
        self._donated_buffers = 0

    @property
    def _is_time(self) -> bool:
        return self.window is not None and self.window.is_time

    def _base_carry(self):
        """The engine state, unwrapped from the (state, counters) pair the
        stats-collecting carry threads."""
        return self.carry[0] if self.collect_stats else self.carry

    def _stats(self):
        """The stats to surface on a result (copies: the carry is updated
        in place): the cumulative counters when collecting; else an
        event-time window's late-drop count; None otherwise."""
        if self.collect_stats:
            stats = _c.copy(self.carry[1])  # one launch
            stats["store_donated_buffers"] = torch.full(
                (), self._donated_buffers, dtype=torch.int32,
                device=self.plan.device)
            return stats
        if self._is_time:
            # a copy (the buffers update in place), summed over the shards
            return {"late_dropped":
                    self.carry[0].dropped.sum(dtype=torch.int32)}
        return None

    def _result(self, g, values, valid, num, rr, stats=None) -> StreamResult:
        if self._one:
            (values,) = values.values()
        return StreamResult(g, values, valid, num, rr, stats)

    def push(self, groups, keys, n_valid=None,
             timestamps=None) -> StreamResult:
        from repro_torch import query as _q
        if self._is_time and timestamps is None:
            raise ValueError("event-time windows (Window(range=...)) need "
                             "timestamps= on every push")
        if not self._is_time and timestamps is not None:
            raise ValueError("timestamps apply to event-time windows "
                             "(Window(range=...)) only")
        dev = torch.device(self.plan.device)
        groups = _q._as_tensor(groups, dev).to(torch.int32)
        keys = _q._as_tensor(keys, dev)
        if timestamps is not None:
            timestamps = _q._as_tensor(timestamps, dev)
        if groups.dim() == 2:
            # per-shard pushes: [num_shards, L] slices of one batch
            if groups.shape[0] != self.num_shards:
                raise ValueError(
                    f"per-shard push has {groups.shape[0]} slices but the "
                    f"aggregator shards {self.num_shards} ways")
            groups = groups.reshape(-1)
            keys = keys.reshape(-1)
            if timestamps is not None:
                timestamps = timestamps.reshape(-1)
        extra = (timestamps,) if self._is_time else ()
        before = _trace.tensors(self.carry) if self.collect_stats else ()
        out, self.carry = self._step(groups, keys, self.carry, n_valid,
                                     *extra)
        if self.collect_stats:
            self._donated_buffers += sum(
                a is b for a, b in zip(before, _trace.tensors(self.carry)))
        return self._result(*out, self._stats())

    def flush(self) -> StreamResult:
        """Close the stream: emit the open group (windowed: re-emit every
        live group's current window; event-time: drain the reorder
        buffer(s) and evaluate past the last tuple), reset the carry."""
        from repro_torch import query as _q
        stats = self._stats()
        carry = self._base_carry()
        if self.window is not None:
            store, end = carry, None
            if self._is_time:
                (_, store), end = _q._time_flush(self.plan, carry,
                                                 inplace=True)
            g, values, valid, num = _q._store_eval(self.plan, store,
                                                   eval_time=end)
            c = valid.shape[-1]
            rr = torch.where(
                valid, torch.arange(c, dtype=torch.int32,
                                    device=valid.device) % self.p_ports,
                -1).to(torch.int32)
        else:
            lead = carry[0]
            dev = lead.group.device
            pad = torch.tensor(_engine.PAD_GROUP, dtype=torch.int32,
                               device=dev)
            g = torch.where(lead.nonempty, lead.group, pad)[None]
            values = {}
            for comb, cr in zip(_q._combiners(self.plan.query), carry):
                v = comb.finalize(cr.state)
                values[comb.name] = torch.where(
                    lead.nonempty, v,
                    torch.zeros((), dtype=v.dtype, device=dev))[None]
            valid = lead.nonempty[None]
            num = lead.nonempty.to(torch.int32)
            rr = torch.where(valid, lead.emitted % self.p_ports,
                             -1).to(torch.int32)
        self.carry = _q.init_stream_state(self.plan, self.key_dtype,
                                          collect_stats=self.collect_stats)
        return self._result(g, values, valid, num, rr, stats)
