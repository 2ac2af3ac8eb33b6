"""Two-phase (mergeable-state) query execution across devices — the
counterpart of ``repro.distributed.query_exec``.  Every sharded ``Query``
runs as

    partition -> local (per shard) -> merge (combine tree) -> finalize

The local phase reduces each shard's range of the stream to a compact
:class:`repro_torch.core.engine.PartialTable` (or a sorted run, for the
non-incremental median), and only those are gathered.  The combine tree,
log2(S) rounds of pairwise
:func:`repro_torch.core.engine.combine_partial_tables`, is the device-level
analog of the paper's merge network.

Two merge channels, chosen per op:

  * **table channel**: mergeable combiners, per-group partial states folded
    with ``Combiner.partial_merge`` (dc's boundary rule merges adjacent
    ranges of the (group, key)-sorted stream exactly);
  * **run channel**: the median and, for windowed queries, every op the
    single-device pane path also serves from the merged window: sorted
    runs merged with the bitonic merge network
    (:func:`repro_torch.core.sorter.merge_presorted`), then the window
    tails.  A fully sorted multiset is unique, so this channel equals the
    single-device result by construction.

A **mesh** is a sequence of ``torch.device``s, one shard an entry: shard
*s*'s local phase runs on ``mesh[s]`` and its table is gathered onto
``mesh[0]`` for the combine tree.  Without a mesh, ``num_shards=S`` runs
the same pipeline on the input's device (logical shards: the reference's
local phase is one call over the ``[S, L]`` shard axis, as the port's core
functions work along the last axis).  Kernel backends launch their
kernels once a shard: on ``cuda`` the engine path's local phase is one
``groupagg`` launch for all of a query's ops (its values are the partial
states of :data:`KERNEL_STATE_OPS`), a rolling stream's the engine pass
with the segmented-scan kernel as its scan, and windows run ``swag`` (or
``sort_panes`` + ``swag_panes`` on ``cuda-panes``) over each shard's block
of whole windows.  The combine tree, the run merge and the per-window
trees are plain torch, as the JAX package computes them outside any
Pallas kernel.

A sharded event-time stream (:func:`stream_push_eventtime_sharded`)
merges emissions, not states: a reorder buffer a shard, released against
the min-merged watermark, then one shared time-mode pane store.  On
``cuda-panestore`` a push is one reorder launch for every shard's buffer,
one time-mode placement of the merged emissions and one replay; the merge
(:func:`merge_emissions`) is a stable sort by timestamp in torch, as the
JAX package sorts outside any kernel.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import engine as _engine
from repro_torch.core import eventtime as _eventtime
from repro_torch.core import sorter
from repro_torch.core import streaming as _streaming
from repro_torch.core.swag import (PARTIAL_OPS, _median_sorted_window,
                                   _pane_windows, frame_panes, num_windows,
                                   pane_compatible, pane_partials,
                                   pane_table_channel, swag_multi,
                                   window_tails)
from repro_torch.core.combiners import tree_map
from repro_torch.core.eventtime import merge_watermarks  # noqa: F401
from repro_torch.obs import counters as _c
from repro_torch.obs import trace as _trace

PAD_GROUP = _engine.PAD_GROUP
PartialTable = _engine.PartialTable

#: ops whose group-by kernel output *is* the partial state (single-array
#: state, identity finalize): the ``cuda`` engine path's local phase
KERNEL_STATE_OPS = PARTIAL_OPS


def mesh_num_shards(mesh) -> int:
    """The shard count of ``mesh``: one shard a device."""
    return len(mesh)


def _shard_devices(mesh, device, count: int) -> list:
    """The device of each of ``count`` shards: ``mesh``'s entries, else
    ``device`` for all."""
    if mesh is None:
        return [device] * count
    return [torch.device(d) for d in mesh][:count]


def partition_stream(groups: torch.Tensor, keys: torch.Tensor,
                     num_shards: int):
    """[N] -> [S, N/S] contiguous shard slices (adjacent ranges, which is
    what keeps the dc boundary rule exact on sorted streams)."""
    n = groups.shape[-1]
    if n % num_shards:
        raise ValueError(
            f"sharded execution needs num_shards to divide the stream "
            f"length, got n={n} num_shards={num_shards}")
    length = n // num_shards
    return (groups.reshape(num_shards, length),
            keys.reshape(num_shards, length))


def _tree(fn, *trees):
    """``fn`` over the tensors of same-structure trees (tensors, dicts,
    tuples and named tuples)."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: _tree(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple):
        items = [_tree(fn, *xs) for xs in zip(*trees)]
        return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
    return t


def _gather(outs: list, device):
    """Per-shard results concatenated along their leading axis on
    ``device``."""
    return _tree(lambda *xs: torch.cat([x.to(device) for x in xs]), *outs)


def _map_shards(fn, mesh, args):
    """Run ``fn`` (written along the last axis, so for a batch of shards)
    over the leading axis of every array in ``args``: one call without a
    mesh; with one, block *s* of that axis on ``mesh[s]``, the results
    gathered onto ``mesh[0]``."""
    if mesh is None:
        return fn(*args)
    devs = _shard_devices(mesh, None, len(mesh))
    total = args[0].shape[0]
    if total % len(devs):
        raise ValueError(f"{total} shard rows do not split over a mesh of "
                         f"{len(devs)} devices")
    per = total // len(devs)
    return _gather([fn(*(a[i * per:(i + 1) * per].to(d) for a in args))
                    for i, d in enumerate(devs)], devs[0])


def _table_map(table: PartialTable, rows, num) -> PartialTable:
    """``rows`` over the per-row fields (groups, states, valid), ``num``
    over ``num_groups``."""
    return PartialTable(rows(table.groups),
                        {name: tree_map(rows, st)
                         for name, st in table.states.items()},
                        rows(table.valid), num(table.num_groups))


def _row_bytes(table: PartialTable) -> int:
    """Bytes of one row of ``table``: its group, valid flag and states."""
    return sum(t.element_size()
               for t in _trace.tensors((table.groups, table.states,
                                        table.valid)))


def _pad_rows(table: PartialTable, width: int, ops, key_dtype
              ) -> PartialTable:
    """``table`` widened to ``width`` rows with empty rows (PAD_GROUP,
    the identity, not valid): what rows past the live groups hold."""
    live = table.groups.shape[-1]
    if live >= width:
        return table
    out = _engine.empty_partial_table(width, ops, key_dtype,
                                      table.groups.device,
                                      lead=tuple(table.groups.shape[:-1]))

    def put(dst, src):
        dst = dst.to(src.dtype)
        dst[..., :live] = src
        return dst

    return PartialTable(
        put(out.groups, table.groups),
        {name: tree_map(put, out.states[name], st)
         for name, st in table.states.items()},
        put(out.valid, table.valid), table.num_groups)


def _vector(values, dtype, device) -> torch.Tensor:
    """A short 1-D tensor of numbers, filled on ``device``."""
    if not values:
        return torch.zeros((0,), dtype=dtype, device=device)
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in values])


def combine_tree(tables: PartialTable, ops, *, key_dtype, counters=None):
    """Merge stacked tables (the shard axis next to the rows: ``[..., S,
    C]``, ``num_groups`` ``[..., S]``) down to one — log2(S) rounds of
    pairwise merges, widths doubling each round.  A shard count that is
    not a power of two is padded with
    :func:`repro_torch.core.engine.empty_partial_table` (the merge
    identity).

    Only the rows that can hold a group are merged: the tables are cut to
    the most live groups any of them holds (one read-back of the counts),
    and the merged table is widened back with empty rows, so the result is
    the full-width table the JAX package's static shapes give.  The rows
    past the live groups are padding, which every merge would sort to the
    end and drop.

    With ``counters`` returns ``(table, counters)``, recording per round
    the merged row width, the live groups summed over the round's nodes
    and the bytes of the tables the round produced: those of the
    full-width tables, as the JAX package records them."""
    s, width = tables.groups.shape[-2:]
    row_bytes = _row_bytes(tables)
    live = max(int(tables.num_groups.max()), 1)
    if live < width:
        tables = _table_map(tables, lambda x: x[..., :live], lambda x: x)
    s2 = sorter.next_pow2(s)
    if s2 != s:
        pad = _engine.empty_partial_table(
            tables.groups.shape[-1], ops, key_dtype, tables.groups.device,
            lead=tuple(tables.groups.shape[:-2]) + (s2 - s,))
        tables = PartialTable(
            torch.cat([tables.groups, pad.groups], dim=-2),
            {name: tree_map(lambda x, y: torch.cat([x, y], dim=-2), st,
                            pad.states[name])
             for name, st in tables.states.items()},
            torch.cat([tables.valid, pad.valid], dim=-2),
            torch.cat([tables.num_groups, pad.num_groups], dim=-1))
        s = s2
    round_width: list = []
    round_groups: list = []
    round_bytes: list = []
    while s > 1:
        a = _table_map(tables, lambda x: x[..., 0::2, :],
                       lambda x: x[..., 0::2])
        b = _table_map(tables, lambda x: x[..., 1::2, :],
                       lambda x: x[..., 1::2])
        tables = _engine.combine_partial_tables(a, b, ops,
                                                key_dtype=key_dtype)
        s //= 2
        if counters is not None:
            w = width * (s2 // s)
            nodes = tables.num_groups.numel()
            round_width.append(w)
            round_groups.append(tables.num_groups.sum(dtype=torch.int32))
            round_bytes.append(nodes * (w * row_bytes + 4))
    out = _table_map(tables, lambda x: x[..., 0, :], lambda x: x[..., 0])
    out = _pad_rows(out, width * s2, ops, key_dtype)
    if counters is None:
        return out
    dev = out.groups.device
    counters = _c.put(counters, "combine_rounds",
                      torch.full((), len(round_width), dtype=torch.int32,
                                 device=dev))
    counters = _c.put(counters, "combine_round_width",
                      _vector(round_width, torch.int32, dev))
    counters = _c.put(counters, "combine_round_groups",
                      torch.stack(round_groups) if round_groups
                      else _vector([], torch.int32, dev))
    counters = _c.put(counters, "combine_round_bytes",
                      _vector(round_bytes, torch.float32, dev))
    return out, counters


def _trim_table(table: PartialTable, width: int) -> PartialTable:
    """Cut a merged table back to ``width`` rows: safe whenever ``width``
    is at least the number of real groups (the stream length); the rows
    past it are the padding of :func:`combine_tree`'s power-of-two
    shards."""
    return _table_map(table, lambda x: x[..., :width], lambda x: x)


def merge_sorted_runs(run_groups: torch.Tensor, run_keys: torch.Tensor):
    """[S, L] per-shard (group, key)-sorted runs -> one sorted [S*L] run:
    the run channel's combine tree (:func:`sorter.merge_presorted` is the
    log2(S) rounds of pairwise bitonic merges).  S and L must be powers of
    two (padded by the callers)."""
    _, length = run_groups.shape
    return sorter.merge_presorted(
        (run_groups.reshape(-1), run_keys.reshape(-1)), run=length,
        num_keys=2)


def _pad_pow2_shards(gs: torch.Tensor, ks: torch.Tensor):
    """Pad [S, L] shard runs to power-of-two S and L with PAD_GROUP rows
    (they sort after every real group and stay masked downstream)."""
    s, length = gs.shape
    s2, l2 = sorter.next_pow2(s), sorter.next_pow2(length)
    if (s2, l2) != (s, length):
        pg = torch.full((s2, l2), PAD_GROUP, dtype=gs.dtype, device=gs.device)
        pk = torch.zeros((s2, l2), dtype=ks.dtype, device=ks.device)
        pg[:s, :length] = gs
        pk[:s, :length] = ks
        gs, ks = pg, pk
    return gs, ks


# --------------------------------------------------------------------------
# non-windowed (engine) path
# --------------------------------------------------------------------------

def _kernel_shard_tables(gs, ks, nvs, mesh, local) -> PartialTable:
    """A kernel local phase: ``local(g, k, nv) -> PartialTable`` once a
    shard, on the shard's device, the tables gathered onto the first."""
    devs = _shard_devices(mesh, gs.device, gs.shape[0])
    tables = [local(gs[s].to(d), ks[s].to(d),
                    None if nvs is None else nvs[s].to(d))
              for s, d in enumerate(devs)]
    return _gather([_tree(lambda x: x[None], t) for t in tables], devs[0])


def _local_engine_tables(gs, ks, nvs, combiner_ops, mesh, backend, *,
                         tile) -> PartialTable:
    """Per-shard local phase of the engine path.  On ``cuda``, one
    ``groupagg`` launch a shard for all of ``combiner_ops``, whose values
    are their partial states (:data:`KERNEL_STATE_OPS`; ``plan`` makes
    sure); on the reference, the engine pass stopped before finalize."""
    if backend == "cuda":
        from repro_torch.kernels.groupagg.ops import _groupagg_kernel_exec

        def local(g, k, nv):
            og, ovs, valid, num = _groupagg_kernel_exec(
                g, k, combiner_ops, n_valid=nv, tile=tile)
            return PartialTable(og, ovs, valid, num)

        return _kernel_shard_tables(gs, ks, nvs, mesh, local)

    def partials(g, k, nv=None):
        return _engine.multi_engine_partials(g, k, combiner_ops, n_valid=nv)

    return _map_shards(partials, mesh, (gs, ks) if nvs is None
                       else (gs, ks, nvs))


def _shard_valid(n_valid, num_shards: int, length: int, device):
    """Each shard's real prefix: ``n_valid`` less the shards before it,
    clipped to the shard."""
    if isinstance(n_valid, torch.Tensor):
        n_valid = n_valid.to(device)
    lane0 = torch.arange(num_shards, dtype=torch.int32, device=device) \
        * length
    return torch.clamp(n_valid - lane0, 0, length).to(torch.int32)


def _engine_sharded(q, groups, keys, n_valid, *, num_shards, mesh, backend,
                    tile, counters=None):
    names = q.op_names
    combiner_ops = tuple(op for op, nm in zip(q.ops, names) if nm != "median")
    n = groups.shape[-1]
    dev = groups.device
    groups = groups.to(torch.int32)
    with _trace.span("partition") as sp:
        if n_valid is not None:
            # mask the tail up front so every shard keeps the engine's
            # sorted-with-PAD-tail contract locally
            groups = torch.where(_engine._prefix_mask(n, n_valid, dev),
                                 groups, PAD_GROUP)
        gs, ks = partition_stream(groups, keys, num_shards)
        sp.attach((gs, ks))
    nvs = None if n_valid is None else _shard_valid(
        n_valid, num_shards, n // num_shards, dev)

    values: dict = {}
    shared = None
    if combiner_ops:
        with _trace.span("local") as sp:
            tables = _local_engine_tables(gs, ks, nvs, combiner_ops, mesh,
                                          backend, tile=tile)
            sp.attach(tables)
        with _trace.span("merge") as sp:
            if counters is None:
                table = combine_tree(tables, combiner_ops,
                                     key_dtype=keys.dtype)
            else:
                table, counters = combine_tree(tables, combiner_ops,
                                               key_dtype=keys.dtype,
                                               counters=counters)
            # power-of-two shard padding can leave the merged table wider
            # than the stream: trim to the single-device layout
            table = _trim_table(table, n)
            sp.attach(table)
        with _trace.span("finalize") as sp:
            g_out, vals, valid, num = _engine.finalize_partial_table(
                table, combiner_ops)
            sp.attach((g_out, vals))
        values.update(vals)
        shared = (g_out, valid, num)

    if "median" in names:
        # run channel: the shard slices are adjacent ranges of the
        # (group, key)-sorted stream, so their merge is the stream the
        # single-device rank pick reads
        with _trace.span("merge:runs") as sp:
            mg, mk = merge_sorted_runs(*_pad_pow2_shards(gs, ks))
            t = _median_sorted_window(mg[:n], mk[:n],
                                            interpolate=q.interpolate,
                                            n_valid=n_valid)
            sp.attach(t)
        values["median"] = torch.where(
            t.valid, t.medians, torch.zeros((), dtype=t.medians.dtype,
                                            device=dev))
        shared = shared or (t.groups, t.valid, t.num_groups)
    if counters is None:
        return shared[0], values, shared[1], shared[2]
    return shared[0], values, shared[1], shared[2], counters


# --------------------------------------------------------------------------
# windowed (SWAG) path
# --------------------------------------------------------------------------

def _window_sharded(q, groups, keys, *, num_shards, mesh, backend):
    w = q.window
    ws, wa = w.ws, w.wa
    n = groups.shape[-1]
    nw = num_windows(n, ws, wa)
    names = q.op_names

    if backend in ("cuda", "cuda-panes") or nw == 0 \
            or not (pane_compatible(ws, wa)
                    or (ws == wa and ws & (ws - 1) == 0)) \
            or w.panes is False:
        return _window_partitioned(q, groups, keys, num_shards=num_shards,
                                   mesh=mesh, backend=backend)

    p = ws // wa
    np_ = nw + p - 1
    pg = frame_panes(groups.to(torch.int32), wa, np_)
    pk = frame_panes(keys, wa, np_)
    # pad the pane axis so every shard owns the same number of panes
    npp = -(-np_ // num_shards) * num_shards
    if npp != np_:
        pg = torch.cat([pg, torch.full((npp - np_, wa), PAD_GROUP,
                                       dtype=pg.dtype, device=pg.device)])
        pk = torch.cat([pk, torch.zeros((npp - np_, wa), dtype=pk.dtype,
                                        device=pk.device)])

    # the single-device pane dispatch's predicate: both paths route every
    # op the same way, which the equality with single-device rests on
    table_sel = pane_table_channel(q.ops, keys.dtype, p)
    table_ops = tuple(op for op, sel in zip(q.ops, table_sel) if sel)
    run_pairs = tuple((op, name) for (op, name), sel
                      in zip(zip(q.ops, names), table_sel) if not sel)

    if table_ops:
        sg, sk, tables = _map_shards(
            functools.partial(pane_partials, ops=table_ops), mesh,
            (pg, pk))
        tables = _tree(lambda x: x[:np_], tables)
    else:
        # run-channel-only query: the local phase is the pane sort alone
        sg, sk = _map_shards(
            functools.partial(sorter.sort_pairs, full_width=True), mesh,
            (pg, pk))
    sg, sk = sg[:np_], sk[:np_]
    dev = sg.device
    widx = (torch.arange(nw, device=dev)[:, None]
            + torch.arange(p, device=dev)[None, :])

    values: dict = {}
    shared = None
    if table_ops:
        # per window, a combine tree over its P pane tables
        merged = combine_tree(_tree(lambda x: x[widx], tables), table_ops,
                              key_dtype=keys.dtype)
        tg, tvals, tvalid, tnum = _engine.finalize_partial_table(merged,
                                                                 table_ops)
        values.update(tvals)
        shared = (tg, tvalid, tnum)
    if run_pairs:
        wg = _pane_windows(sg, nw, p)
        wk = _pane_windows(sk, nw, p)
        if p > 1:
            wg, wk = sorter.merge_presorted((wg, wk), run=wa, num_keys=2)
        mg, mvalues, mvalid, mnum = window_tails(
            wg, wk, run_pairs, interpolate=q.interpolate)
        values.update(mvalues)
        shared = (mg, mvalid, mnum)
    return shared[0], values, shared[1], shared[2]


def _window_partitioned(q, groups, keys, *, num_shards, mesh, backend):
    """Windowed sharding by the window axis: each shard computes a
    contiguous block of whole windows from its slice of the stream, with
    the backend's kernels on ``cuda`` / ``cuda-panes`` (one call a shard,
    on the shard's device), and the merge is a concatenation along the
    window axis.  Serves the kernel backends and the window shapes the
    pane pipeline does not take."""
    w = q.window
    ws, wa = w.ws, w.wa
    n = groups.shape[-1]
    nw = num_windows(n, ws, wa)
    names = q.op_names
    dev = groups.device

    wps = -(-nw // num_shards) if nw else 0   # windows a shard
    if wps == 0:
        num_shards = 1
        wps = nw
    slice_len = (max(wps, 1) - 1) * wa + ws
    with _trace.span("partition") as sp:
        starts = torch.arange(num_shards, device=dev) * (wps * wa)
        idx = starts[:, None] + torch.arange(slice_len, device=dev)[None, :]
        in_range = idx < n
        idx = torch.clamp(idx, 0, max(n - 1, 0))
        gs = torch.where(in_range, groups[idx].to(torch.int32), PAD_GROUP)
        ks = torch.where(in_range, keys[idx],
                         torch.zeros((), dtype=keys.dtype, device=dev))
        sp.attach((gs, ks))

    devs = _shard_devices(mesh, dev, num_shards)
    with _trace.span("local") as sp:
        outs = []
        for s, d in enumerate(devs):
            g, k = gs[s].to(d), ks[s].to(d)
            if backend in ("cuda", "cuda-panes"):
                from repro_torch.kernels.swag.ops import _swag_kernel_exec
                out = _swag_kernel_exec(g, k, ws=ws, wa=wa, ops=names,
                                        panes=backend == "cuda-panes")
            else:
                out = swag_multi(g, k, ws=ws, wa=wa, ops=q.ops,
                                       interpolate=q.interpolate,
                                       panes=w.panes)
            outs.append(tuple(out))
        sp.attach(outs)
    with _trace.span("merge") as sp:
        # windows are independent: the merge is a concatenation
        out = sp.attach(_tree(lambda x: x[:nw], _gather(outs, devs[0])))
    return out


# --------------------------------------------------------------------------
# streaming path
# --------------------------------------------------------------------------

def stream_push_eventtime_sharded(q, groups, keys, timestamps, state, *,
                                  num_shards, mesh=None, n_valid=None,
                                  p_ports: int = 4, counters=None,
                                  backend: str = "reference",
                                  inplace: bool = False):
    """One sharded event-time push: per-shard bounded-lateness reorder
    buffers (stacked, each tracking its own watermark), released against
    the **min-merged** global watermark, then one shared time-mode pane
    store, as the JAX package's push.

    The release gate and the lateness floor of every shard's cycles are
    the previous push's merged watermark (a shard fed the tail slice of
    every batch sees an inflated local maximum; a tuple is unrecoverable
    only once an emitted evaluation has passed it); the drain gate is this
    push's merged watermark, computed up front.  The shards' emissions are
    merged into one timestamp-ordered batch (:func:`merge_emissions`),
    placed with the panes wholly behind ``watermark - range`` retired, and
    every group's window ``[wm - range, wm)`` is replayed at the merged
    watermark.  On ``cuda-panestore``: one reorder launch for every
    buffer, one time-mode placement, one ring replay; nothing read back
    (``inplace``: the state's buffers updated where they lie).  ``mesh``
    is not used: the buffers run where the state lies, as the JAX package
    runs its shards on one device.

    Returns ``((groups, values, valid, num, rr), state)``; with
    ``counters`` (updated where they lie) also the counters: the reorder
    depth mark (the largest shard's) and forced pops (summed over the
    shards), the store's evictions and occupancy, ``late_dropped`` summed
    over the shards, ``watermark`` the merged one and ``watermark_lag``
    how far the fastest shard runs ahead of it."""
    from repro_torch import query as _q
    from repro_torch.kernels.eventtime import kernel as _et_kernel

    w = q.window
    rspec = w.reorder_spec()
    rstates, pstate = state
    dev = pstate.keys.device
    n = groups.shape[-1]
    groups = groups.to(dev, torch.int32)
    keys = keys.to(dev, pstate.keys.dtype)
    ts = timestamps.to(dev, torch.int32)
    gs, ks = partition_stream(groups, keys, num_shards)
    length = n // num_shards
    tss = ts.reshape(num_shards, length)
    tss_live = tss
    if n_valid is not None:
        nvs = _shard_valid(n_valid, num_shards, length, dev)
        tss_live = torch.where(torch.arange(length, device=dev)[None, :]
                               < nvs[:, None], tss, _eventtime.TS_MIN)

    # the gates: the previous push's merged watermark, and this push's
    # (every shard's largest timestamp after the push, min-merged)
    lateness = w.max_lateness
    prev_wm = _eventtime.merge_watermarks(rstates.max_ts - lateness)
    new_max = rstates.max_ts
    if length:
        new_max = torch.maximum(new_max, tss_live.max(dim=-1).values)
    global_wm = _eventtime.merge_watermarks(new_max - lateness)

    gates = dict(n_valid=n_valid, release_wm=prev_wm, late_wm=prev_wm,
                 drain_wm=global_wm)
    if backend == "cuda-panestore":
        emit, rstates = _et_kernel.reorder_push_sharded(
            rspec, rstates, tss, gs, ks, inplace=inplace, counters=counters,
            **gates)
    elif counters is None:
        emit, rstates = _eventtime.reorder_push_sharded(rspec, rstates, tss,
                                                        gs, ks, **gates)
    else:
        emit, rstates, new = _eventtime.reorder_push_sharded(
            rspec, rstates, tss, gs, ks, counters=dict(counters), **gates)
        _c.store_into(counters, new)

    p = _q.Plan(query=q, backend=backend, path="stream", device=str(dev),
                num_shards=num_shards)
    pstate = _q._time_place(p, pstate, *merge_emissions(emit),
                            global_wm - w.range, inplace, counters)
    if counters is not None:
        _c.store_into(counters, {
            "late_dropped": rstates.dropped.sum(dtype=torch.int32),
            "watermark": global_wm,
            # how far the fastest shard runs ahead of the merged gate: the
            # skew the min-merge rule absorbs
            "watermark_lag": (new_max - lateness).max() - global_wm})
    g, values, valid, num = _q._store_eval(p, pstate, eval_time=global_wm)
    c = valid.shape[-1]
    rr = torch.where(valid, torch.arange(c, dtype=torch.int32, device=dev)
                     % p_ports, -1).to(torch.int32)
    if counters is None:
        return (g, values, valid, num, rr), (rstates, pstate)
    return (g, values, valid, num, rr), (rstates, pstate), counters


def merge_emissions(emits):
    """Flatten stacked per-shard reorder emissions (``[S, L + C]``) into one
    timestamp-ordered stream: a stable sort on the timestamp with dead
    lanes at INT32_MAX, so they sort to the tail and the flat lane index
    breaks ties (the JAX package's ``lax.sort`` on (ts, lane)).  Returns
    ``(groups, keys, ts, live)``, a dead lane's ts 0."""
    e_live = emits.live.reshape(-1)
    ts_key = torch.where(e_live, emits.ts.reshape(-1), _eventtime.INT32_MAX)
    sts, order = torch.sort(ts_key, stable=True)
    slive = e_live[order]
    return (emits.groups.reshape(-1)[order], emits.keys.reshape(-1)[order],
            torch.where(slive, sts, 0), slive)


def _local_stream_tables(gs, ks, combiners, mesh, backend, *,
                         tile) -> PartialTable:
    """Per-shard local phase of a rolling push: the engine pass stopped
    before finalize, on ``cuda`` with the segmented-scan kernel as its
    scan (one launch an op a shard)."""
    if backend == "cuda":
        from repro_torch.kernels.segscan.ops import segmented_scan_cuda
        scan = functools.partial(segmented_scan_cuda, tile=tile)

        def local(g, k, nv):
            return _engine.multi_engine_partials(g, k, combiners, scan=scan)

        return _kernel_shard_tables(gs, ks, None, mesh, local)
    return _map_shards(
        functools.partial(_engine.multi_engine_partials, ops=combiners),
        mesh, (gs, ks))


def stream_push_sharded(q, groups, keys, carries, combiners, *,
                        num_shards, mesh=None, n_valid=None,
                        p_ports: int = 4, counters=None,
                        backend: str = "reference", tile: int = 1024):
    """One sharded rolling push: per-shard partial tables, one combine
    tree, then the carry and emission bookkeeping of
    :func:`repro_torch.core.streaming.stream_push_table`.  Equal to the
    single-device :func:`repro_torch.core.streaming.stream_push` for
    exactly-mergeable ops.  With ``counters`` returns ``(ports, carries,
    counters)``, the combine tree's rounds and the pushed tuples
    counted."""
    n = groups.shape[-1]
    dev = groups.device
    groups = groups.to(torch.int32)
    first_group = groups[0]
    if n_valid is not None:
        groups = torch.where(_engine._prefix_mask(n, n_valid, dev), groups,
                             PAD_GROUP)
        any_real = torch.as_tensor(n_valid, device=dev) > 0
    else:
        any_real = torch.ones((), dtype=torch.bool, device=dev)
    gs, ks = partition_stream(groups, keys, num_shards)
    with _trace.span("local") as sp:
        tables = sp.attach(_local_stream_tables(gs, ks, combiners, mesh,
                                                backend, tile=tile))
    with _trace.span("merge") as sp:
        if counters is None:
            table = combine_tree(tables, combiners, key_dtype=keys.dtype)
        else:
            table, counters = combine_tree(tables, combiners,
                                           key_dtype=keys.dtype,
                                           counters=counters)
            pushed = n if n_valid is None else n_valid
            if isinstance(pushed, torch.Tensor):
                pushed = pushed.to(dev, torch.int32)
            counters = _c.bump(counters, "stream_tuples", pushed)
        table = sp.attach(_trim_table(table, n))   # N + 1 output slots
    with _trace.span("finalize") as sp:
        out, new_carries = sp.attach(_streaming.stream_push_table(
            table, carries, combiners, first_group=first_group,
            any_real=any_real, p_ports=p_ports))
    if counters is None:
        return out, new_carries
    return out, new_carries, counters
