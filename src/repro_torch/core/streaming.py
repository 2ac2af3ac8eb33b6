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
:mod:`repro_torch.obs.counters` dict beside the carry.  Sharded streams
come with a later slice of the port (slice 7) and raise
``NotImplementedError`` naming it.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import engine as _engine
from repro_torch.core import segscan
from repro_torch.core.combiners import Combiner, get_combiner
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
    """The emission half of a *sharded* rolling push: it consumes the
    merged per-group partial table of the cross-shard combine tree, which
    comes with the port's multi-device slice."""
    from repro_torch import query as _q
    raise _q._later_slice("stream_push_table", 7, "multi-device")


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
        if mesh is not None or num_shards not in (None, 1):
            raise _q._later_slice("StreamingAggregator(num_shards=, mesh=)",
                                  7, "multi-device")
        self._one = not isinstance(op, (tuple, list))
        if self._one:
            op = op if isinstance(op, Combiner) else get_combiner(op)
        query = _q.Query(ops=(op,) if self._one else tuple(op),
                         window=window, streaming=True)
        self.window = window
        self.key_dtype = key_dtype
        self.p_ports = p_ports
        self.collect_stats = bool(collect_stats)
        self.plan = _q.plan(query, backend=backend, device=device)
        self.carry = _q.init_stream_state(self.plan, key_dtype,
                                          collect_stats=self.collect_stats)
        self._step = _q.stream_fn(self.plan, p_ports=p_ports, inplace=True,
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
            return {"late_dropped": self.carry[0].dropped.clone()}
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
            if groups.shape[0] != 1:
                raise ValueError(
                    f"per-shard push has {groups.shape[0]} slices but the "
                    f"aggregator shards 1 ways")
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
        live group's current window; event-time: drain the reorder buffer
        and evaluate past the last tuple), reset the carry."""
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
