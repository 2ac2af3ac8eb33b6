"""The port's side of the parity tests, run in a process of its own.

The test processes hold JAX; these functions, called through
``_torch_parity.port`` in a spawned child, hold torch and the port.  Keeping
the two runtimes in separate processes means no JAX test of the suite ever
shares a process with torch.  Every function takes numpy arrays and plain
values and returns numpy arrays, dicts and namespaces (nothing whose
unpickling would import torch).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from repro_torch import query as tq
from repro_torch.core import engine as core_engine
from repro_torch.core import sorter as core_sorter
from repro_torch.interop import result_to_numpy
from repro_torch.kernels.groupagg import kernel as gk
from repro_torch.kernels.groupagg.ops import _groupagg_kernel_exec
from repro_torch.kernels.swag import kernel as sk
from repro_torch.kernels.swag.ops import _engine_median_kernel_exec


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def cuda_available() -> bool:
    return torch.cuda.is_available()


# ---------------------------------------------------------------- groupagg

def groupagg(g, k, op, tile):
    return _np(gk.groupagg(_t(g), _t(k), op, tile=tile))


def groupagg_exec(g, k, op, tile, n_valid=None):
    og, ovs, valid, num = _np(_groupagg_kernel_exec(_t(g), _t(k), op,
                                                    n_valid=n_valid,
                                                    tile=tile))
    return SimpleNamespace(groups=og, values=ovs[op], valid=valid,
                           num_groups=num)


def groupagg_exec_multi(g, k, ops, tile, n_valid=None):
    """One multi-op ``_groupagg_kernel_exec`` call; per op, the layout of a
    single-op call."""
    og, ovs, valid, num = _np(_groupagg_kernel_exec(_t(g), _t(k), ops,
                                                    n_valid=n_valid,
                                                    tile=tile))
    return {name: SimpleNamespace(groups=og, values=v, valid=valid,
                                  num_groups=num) for name, v in ovs.items()}


def engine_two_chunks(g, k, ops, split, n_valid):
    """``multi_engine_step`` over ``[:split]`` with an open tail, then over
    the rest with the carries folded in and ``n_valid``; each chunk's
    result and the final carries (as tuples)."""
    r1, c1 = core_engine.multi_engine_step(_t(g[:split]), _t(k[:split]), ops,
                                           open_tail=True)
    r2, c2 = core_engine.multi_engine_step(_t(g[split:]), _t(k[split:]), ops,
                                           carries=c1, n_valid=n_valid)
    return _np((r1, r2, tuple(tuple(c) for c in c2)))


def sort_pairs(g, k, full_width):
    """The network sort and the library sort of (group, key) rows."""
    net = core_sorter.sort_pairs(_t(g), _t(k), full_width=full_width)
    lib = core_sorter.sort_pairs_xla(_t(g), _t(k), full_width=full_width)
    return _np(net), _np(lib)


# -------------------------------------------------------------------- swag

def swag(fg, fk, ops):
    return _np(sk.swag(_t(fg), _t(fk), ops))


def swag_unfolded(g, k, ws, wa, ops):
    """The swag kernel over windows given as a strided view of the stream."""
    return _np(sk.swag(_t(g).unfold(0, ws, wa), _t(k).unfold(0, ws, wa), ops))


def sort_panes(pg, pk):
    return _np(sk.sort_panes(_t(pg), _t(pk)))


def swag_panes(pg, pk, ops, p):
    return _np(sk.swag_panes(_t(pg), _t(pk), ops, p=p))


def engine_median(g, k, ops, n_valid):
    return _np(_engine_median_kernel_exec(_t(g), _t(k), ops, n_valid=n_valid))


# ------------------------------------------------------------------- query

def _query(ops, window, query):
    win = None if window is None else tq.Window(**window)
    return tq.Query(ops=ops, window=win, **(query or {}))


def execute(ops, g, k, *, backend, window=None, query=None, **kw):
    """``repro_torch.query.execute`` (on the CPU unless ``device`` says
    otherwise); the result in the numpy layout of ``repro.query``."""
    kw.setdefault("device", "cpu")
    res, _ = tq.execute(_query(ops, window, query), g, k, backend=backend,
                        **kw)
    r = result_to_numpy(res)
    return SimpleNamespace(groups=r.groups, values=r.values, valid=r.valid,
                           num_groups=r.num_groups)


def plan_backend(ops, *, backend=None, window=None, query=None):
    return tq.plan(_query(ops, window, query), backend=backend,
                   device="cpu").backend


def make_window(**window):
    tq.Window(**window)


# ------------------------------------------------------ per-group windows

def _spec(spec_kw):
    from repro_torch.core import panestore as ps

    return ps.PaneStoreSpec(**spec_kw)


def _state(state_arrays):
    from repro_torch.interop import pane_state_from_numpy

    return pane_state_from_numpy(state_arrays, "cpu")


def pane_push_gather_replay(spec_kw, g, k, ops):
    """``push`` from an empty store, then ``gather_runs`` and ``replay`` of
    the result, all in numpy."""
    from repro_torch.core import panestore as ps
    from repro_torch.interop import pane_state_to_numpy

    spec = _spec(spec_kw)
    st = ps.push(spec, ps.init_store(spec, _t(k).dtype), _t(g), _t(k))
    runs = ps.gather_runs(spec, st)
    return (pane_state_to_numpy(st), _np(tuple(runs)),
            _np(ps.replay(spec, st, list(ops))))


def chunk_states(spec_kw, g, k):
    """The store after every WA chunk, as the kernel path's placement scan
    records it (its plain version)."""
    from repro_torch.core import panestore as ps

    spec = _spec(spec_kw)
    trace = sk.pergroup_scan(spec, ps.init_store(spec, _t(k).dtype), _t(g),
                             _t(k))
    return _np(tuple(trace.states)), _np(tuple(trace.final))


def write_plan(spec_kw, g):
    from repro_torch.core.swag import pergroup_write_plan

    return _np(tuple(pergroup_write_plan(_spec(spec_kw), _t(g))))


def pergroup_fused(inputs, ops):
    return _np(sk.pergroup_fused(*(_t(x) for x in inputs), ops))


def pergroup_replay(rk, rv, ops, run):
    return _np(sk.pergroup_replay(_t(rk), _t(rv), ops, run=run))


def pergroup_replay_ring(spec_kw, g, k, ops):
    """The placement scan's stores after every chunk (the kernel path's
    scan), then the ring-form replay of them; with the scan's evictions
    and retirements and the count of partly filled open panes among the
    stores' live slots."""
    from repro_torch.core import panestore as ps

    spec = _spec(spec_kw)
    trace = sk.pergroup_scan(spec, ps.init_store(spec, _t(k).dtype), _t(g),
                             _t(k))
    values, ugroups, num = sk.pergroup_replay_ring(spec, trace.states, ops)
    st = trace.states
    open_panes = ((st.count > 0) & (st.count < spec.wa)
                  & (st.owner != ps.PAD_GROUP)).sum()
    return {"values": _np(values), "ugroups": _np(ugroups), "num": _np(num),
            "events": trace.events.tolist(), "open_panes": int(open_panes)}


def swag_per_group(spec_kw, g, k, ops, state_arrays=None):
    """``swag_per_group`` (optionally continuing ``state_arrays``); the
    result and the final state in numpy."""
    from repro_torch.core.swag import swag_per_group as run
    from repro_torch.interop import pane_state_to_numpy

    state = None if state_arrays is None else _state(state_arrays)
    out, final = run(_t(g), _t(k), spec=_spec(spec_kw), ops=list(ops),
                     state=state)
    return _np(out), pane_state_to_numpy(final)


def _check_group_panes(spec, st):
    """Within each group the live panes' bases are exactly WA apart (so
    distinct) and ordered like their stamps."""
    from repro_torch.core import panestore as ps

    live = st.owner != ps.PAD_GROUP
    for grp in torch.unique(st.owner[live]).tolist():
        mine = st.owner == grp
        by_base = torch.sort(st.base[mine]).indices
        bases, stamps = st.base[mine][by_base], st.stamp[mine][by_base]
        assert bool((bases.diff() == spec.wa).all()), (grp, bases)
        assert bool((stamps.diff() > 0).all()), (grp, bases, stamps)


def _check_scan_groups(spec, st, g):
    """The placement kernel wrapper's dense indices, pane chains and window
    table over the stream ``g`` and the store ``st``."""
    from repro_torch.core import panestore as ps

    gidx, ids, slots, gtab = sk._scan_groups(spec, st, g)
    own, nxt = slots[0], slots[4]
    assert torch.equal(ids[gidx], g)
    live = st.owner != ps.PAD_GROUP
    assert torch.equal(torch.where(live, ids[own], ps.PAD_GROUP), st.owner)
    assert bool((own[~live] == -1).all())
    assert torch.equal(gtab[2], spec.ws_of(ids))
    assert torch.equal(slots[1:4], torch.stack([st.count, st.base,
                                                st.stamp]))
    for d in range(ids.shape[0]):
        chain, s = [], int(gtab[1, d])
        while s >= 0:
            chain.append(s)
            s = int(nxt[s])
        mine = torch.nonzero(own == d).flatten()
        want = mine[torch.sort(st.base[mine]).indices].tolist()
        assert chain == want, (d, chain, want)
        assert int(gtab[0, d]) == (want[-1] if want else -1)
    return int((~torch.isin(st.owner[live], g)).sum())


def pane_invariants(spec_kw, first, second):
    """Step the plain placement (``_push_decide``) over ``first``, then over
    ``second`` from the store the first left, one tuple at a time, holding
    what the placement kernel's constant-time path assumes after every
    tuple: within each group the live panes' bases are exactly WA apart
    and ordered like their stamps; every pane that retires or is
    evicted is its group's oldest.  Between the two streams, the kernel
    wrapper's dense indices, pane chains and window table
    (``_scan_groups``) against the store and ``spec.ws_of``.  Returns what
    was checked."""
    from repro_torch.core import panestore as ps

    spec = _spec(spec_kw)
    st = ps.init_store(spec)
    true = torch.ones((), dtype=torch.bool)
    seen = {"tuples": 0, "retired": 0, "evicted": 0, "absent_owners": 0,
            "groups": 0}

    def oldest(owner, base, grp, k):
        """The ``k`` smallest-base slots of group ``grp``."""
        mine = torch.nonzero(owner == grp).flatten()
        return set(mine[torch.sort(base[mine]).indices][:k].tolist())

    for part, stream in enumerate((first, second)):
        g = _t(stream).to(torch.int32)
        if part:
            seen["absent_owners"] = _check_scan_groups(spec, st, g)
            seen["groups"] = int(torch.unique(torch.cat([
                g, st.owner[st.owner != ps.PAD_GROUP]])).numel())
        for x in g:
            owner, base = st.owner.clone(), st.base.clone()
            slot, _lane, _m, _alloc, _closes, evicted, _ret = \
                ps._push_decide(spec, st.owner, st.count, st.base,
                                st.stamp, st.clock, x, true)
            if bool(evicted):
                victim = int(owner[slot])
                assert int(slot) in oldest(owner, base, victim, 1), \
                    ("evicted a pane that is not its group's oldest", victim)
                seen["evicted"] += 1
            gone = (owner != ps.PAD_GROUP) & (st.owner == ps.PAD_GROUP)
            retired = set(torch.nonzero(gone).flatten().tolist())
            assert retired == oldest(owner, base, int(x), len(retired)), \
                ("retired panes that are not the group's oldest", retired)
            seen["retired"] += len(retired)
            seen["tuples"] += 1
            _check_group_panes(spec, st)
    return seen


def pergroup_kernel_path(ops, window, float_keys=False):
    from repro_torch.kernels import registry

    return registry.pergroup_kernel_path(
        _query(ops, window, None),
        torch.float32 if float_keys else None)


def backend_reason(name, ops, window=None, query=None):
    from repro_torch.kernels import registry

    return registry.get_backend(name).supports(_query(ops, window, query))


def swag_per_group_counters():
    """``swag_per_group(counters=...)`` of one group's 8 tuples: the
    counters, read back."""
    from repro_torch.core.swag import swag_per_group as run

    g = torch.zeros(8, dtype=torch.int32)
    _, _, counters = run(g, g, spec=_spec(dict(wa=4, capacity=8,
                                               default_ws=8)),
                         ops=["sum"], counters={})
    return {name: int(v) for name, v in sorted(counters.items())}


def execute_stats(ops, g, k, **kw):
    """The stats of ``execute(..., collect_stats=True)`` on the CPU (numpy
    in place of tensors)."""
    from repro_torch.interop import stats_to_numpy

    res, _ = tq.execute(_query(ops, None, None), g, k, device="cpu",
                        collect_stats=True, **kw)
    return stats_to_numpy(res.stats)


# --------------------------------------------------------------- streaming

def _stream_plan(ops, window, query, backend, num_shards=1):
    return tq.plan(_query(ops, window, dict(query or {}, streaming=True)),
                   backend=backend, device="cpu", num_shards=num_shards)


def _stream_state(p, state, key_dtype):
    """A stream's state from numpy (carries or a pane store), or a fresh
    one."""
    from repro_torch.interop import carries_from_numpy, pane_state_from_numpy

    if state is None:
        return tq.init_stream_state(p, key_dtype)
    if p.query.window is not None and not p.query.window.is_time:
        return pane_state_from_numpy(state, "cpu")
    return carries_from_numpy(state, "cpu")


def _state_np(state):
    from repro_torch.core.panestore import PaneStoreState
    from repro_torch.interop import carries_to_numpy, pane_state_to_numpy

    if isinstance(state, PaneStoreState):
        return pane_state_to_numpy(state)
    return carries_to_numpy(state)


def stream_steps(ops, batches, *, backend, window=None, query=None,
                 state=None, n_valids=None, num_shards=1, mesh=None,
                 collect_stats=False):
    """Push ``batches`` ([(groups, keys)], or [(groups, keys, timestamps)]
    for an event-time window) through the streaming step of the plan
    (``stream_fn``, sharded ``num_shards`` ways or over ``mesh``), from
    ``state`` (numpy) or a fresh one; per push, its full outputs (with
    ``rr_port``) and the state it left (and with ``collect_stats`` the
    counters), in numpy."""
    from repro_torch.interop import stats_to_numpy

    p = _stream_plan(ops, window, query, backend, num_shards)
    st = _stream_state(p, state, _t(batches[0][1]).dtype)
    if collect_stats:
        st = (st, tq._init_stream_counters(p))
    step = tq.stream_fn(p, mesh=mesh, collect_stats=collect_stats)
    n_valids = n_valids or [None] * len(batches)
    out = []
    for (g, k, *ts), nv in zip(batches, n_valids):
        (og, ov, valid, num, rr), st = step(_t(g), _t(k), st, nv,
                                            *(_t(t) for t in ts))
        inner, stats = st if collect_stats else (st, None)
        out.append({"groups": og.numpy(), "values": _np(ov),
                    "valid": valid.numpy(), "num": num.numpy(),
                    "rr": rr.numpy(), "state": _state_np(inner),
                    "stats": stats_to_numpy(stats)})
    return out


def aggregator_stream(op, batches, *, backend, window=None,
                      float_keys=False, n_valids=None, num_shards=None):
    """``StreamingAggregator``'s pushes and flush on the CPU: per push its
    result (``stats`` included) and carry, then the flush's result, in
    numpy.  An event-time window's batches carry timestamps third; a
    sharded aggregator's batches may come as ``[num_shards, L]``
    slices."""
    from repro_torch.core import StreamingAggregator

    agg = StreamingAggregator(
        op, window=None if window is None else tq.Window(**window),
        key_dtype=torch.float32 if float_keys else torch.int32,
        device="cpu", backend=backend, num_shards=num_shards)
    n_valids = n_valids or [None] * len(batches)
    out = []
    for (g, k, *ts), nv in zip(batches, n_valids):
        r = agg.push(g, k, n_valid=nv,
                     timestamps=ts[0] if ts else None)
        out.append({**_np(r._asdict()), "state": _state_np(agg.carry)})
    return out, _np(agg.flush()._asdict())


def execute_twice(ops, g, k, *, backend, window=None, state=None,
                  timestamps=None):
    """``execute(state=...)`` twice on one state: both results, and the
    state before and after (numpy)."""
    p = _stream_plan(ops, window, None, backend)
    st = _stream_state(p, state, _t(k).dtype)
    before = _state_np(st)
    r1, s1 = tq.execute(p, g, k, state=st, device="cpu",
                        timestamps=timestamps)
    r2, s2 = tq.execute(p, g, k, state=st, device="cpu",
                        timestamps=timestamps)
    return (_np(tuple(result_to_numpy(r1)[:4])),
            _np(tuple(result_to_numpy(r2)[:4])), _state_np(s1),
            _state_np(s2), before, _state_np(st))


def rr_ports(groups, valid, emitted_before, p):
    """``repro_torch.core.rr_ports`` of a result's groups and valid mask."""
    from repro_torch.core import rr_ports as run

    res = core_engine.GroupAggResult(_t(groups), _t(groups), _t(valid),
                                     _t(valid).sum())
    return run(res, torch.tensor(emitted_before, dtype=torch.int32),
               p).numpy()


def stream_evictions(window, batches) -> int:
    """The evictions of the plain placement over a windowed stream's
    pushes."""
    from repro_torch.core import panestore as ps

    spec = tq.Window(**window).store_spec()
    st = ps.init_store(spec)
    total = 0
    for g, _ in batches:
        trace = ps.scan(spec, st, _t(g), push=True)
        total += int(trace.events[0])
        st = trace.final
    return total


def aggregator_later_slice(what):
    """The pieces of streaming that came with, or wait for, later slices:
    what a sharded aggregator or the table push return, or the raise."""
    from repro_torch.core import StreamingAggregator
    from repro_torch.core.engine import multi_engine_partials
    from repro_torch.core.segscan import init_carry
    from repro_torch.core.combiners import get_combiner
    from repro_torch.core.streaming import stream_push_table

    g = np.repeat(np.arange(4, dtype=np.int32), 2)
    if what == "shards":
        agg = StreamingAggregator("sum", num_shards=2, device="cpu")
        return _np(agg.push(g, g).values)
    elif what == "mesh":
        agg = StreamingAggregator("sum", mesh=["cpu", "cpu"])
        return _np(agg.push(g.reshape(2, 4), g.reshape(2, 4)).values)
    elif what == "time window shards":
        agg = StreamingAggregator("sum", window=tq.Window(range=10),
                                  num_shards=2, device="cpu")
        return agg.plan.backend, list(agg.carry[0].ts.shape)
    elif what == "stats":
        return StreamingAggregator("sum", collect_stats=True,
                                   device="cpu").collect_stats
    elif what == "timestamps":
        agg = StreamingAggregator("sum", device="cpu")
        agg.push(np.zeros(4, np.int32), np.zeros(4, np.int32),
                 timestamps=np.zeros(4, np.int32))
    elif what == "time window stats":
        agg = StreamingAggregator("sum", window=tq.Window(range=10),
                                  collect_stats=True, device="cpu")
        g = np.zeros(4, np.int32)
        return sorted(agg.push(g, g, timestamps=np.arange(4)).stats)
    elif what == "table":
        t = multi_engine_partials(_t(g), _t(g), ("sum",))
        (og, ov, _, num, _), _ = stream_push_table(
            t, (init_carry(get_combiner("sum"), torch.int32),), ("sum",),
            first_group=_t(g)[0], any_real=torch.tensor(True))
        return _np((og, ov["sum"], num))


# ------------------------------------------------------ time-range windows

def time_layout(ts, time_range, slide):
    """``time_window_layout`` and ``epoch_layout`` of the port, in numpy."""
    from repro_torch.core import eventtime as et
    from repro_torch.core import twostack as t2

    lay = et.time_window_layout(et.concrete_timestamps(ts), time_range,
                                slide)
    ep = t2.epoch_layout(lay.starts.numpy(), lay.ends.numpy())
    return _np(tuple(lay)), tuple(ep)


def frame_time(ts, g, k, time_range, slide, pad_group):
    from repro_torch.core import eventtime as et

    lay = et.time_window_layout(et.concrete_timestamps(ts), time_range,
                                slide)
    return _np(et.frame_time_windows(lay, _t(g)[lay.order], _t(k)[lay.order],
                                     pad_group))


def flip_scans(kf, vf, kb, vb, names):
    """The two-stack flip through its wrapper (the plain version on the
    CPU)."""
    return _np(sk.twostack_flip(_t(kf), _t(vf), _t(kb), _t(vb), names))


def window_info(window):
    """A time clause's normalised fields and its store spec."""
    w = tq.Window(**window)
    spec = w.store_spec()
    return (w.slide, w.wa, w.max_lateness, w.reorder_capacity, w.is_time,
            spec.is_time, spec.min_capacity, spec.capacity)


def init_time_store(spec_kw):
    """A fresh time-mode store, in numpy."""
    from repro_torch.core import panestore as ps
    from repro_torch.interop import pane_state_to_numpy

    return pane_state_to_numpy(ps.init_store(_spec(spec_kw)))


def reorder_spec(window):
    """A time clause's reorder buffer: (capacity, max_lateness)."""
    rs = tq.Window(**window).reorder_spec()
    return rs.capacity, rs.max_lateness


def plan_note(ops, *, backend=None, window=None, query=None):
    return tq.plan(_query(ops, window, query), backend=backend,
                   device="cpu").note


# --------------------------------------------------- event-time streaming

def _rspec(capacity, lateness):
    from repro_torch.core.eventtime import ReorderSpec

    return ReorderSpec(capacity, lateness)


def reorder_pushes(capacity, lateness, pushes, float_keys=False,
                   state=None):
    """Pushes ``[(ts, groups, keys, n_valid, drain_wm)]`` through the plain
    reorder buffer (``kernels.eventtime.kernel.reorder_push`` on CPU
    tensors), from ``state`` (numpy) or an empty buffer, then a flush; per
    push and for the flush the emission and the buffer, in numpy."""
    from repro_torch.core import eventtime as et
    from repro_torch.interop import (reorder_state_from_numpy,
                                     reorder_state_to_numpy)
    from repro_torch.kernels.eventtime import kernel as ek

    spec = _rspec(capacity, lateness)
    st = (et.init_reorder(spec, torch.float32 if float_keys
                          else torch.int32) if state is None
          else reorder_state_from_numpy(state, "cpu"))
    out = []
    for ts, g, k, nv, dw in pushes:
        emit, st = ek.reorder_push(spec, st, _t(ts), _t(g), _t(k),
                                   n_valid=nv, drain_wm=dw)
        out.append((_np(tuple(emit)), reorder_state_to_numpy(st)))
    emit, st = ek.reorder_flush(spec, st)
    out.append((_np(tuple(emit)), reorder_state_to_numpy(st)))
    return out


def watermarks(batches, lateness, shard_wms):
    """The watermark tracker over ``batches`` of (ts, live): max_ts after
    each, the watermark, and the merge of ``shard_wms``."""
    from repro_torch.core import eventtime as et

    tr = et.init_tracker()
    seen = []
    for ts, live in batches:
        tr = et.observe(tr, _t(ts), None if live is None else _t(live))
        seen.append(int(tr.max_ts))
    return (seen, int(et.watermark(tr, lateness)),
            int(et.merge_watermarks(shard_wms)),
            int(et.merge_watermarks(_t(np.asarray(shard_wms, np.int32)))))


def push_time_steps(spec_kw, pushes, state=None, float_keys=False):
    """Pushes ``[(groups, keys, ts, live, retire_below)]`` through the
    plain time-mode placement (``kernels.swag.kernel.pergroup_scan_time``
    on CPU tensors), from ``state`` (numpy) or an empty store: per push the
    store and its events, in numpy."""
    from repro_torch.core import panestore as ps
    from repro_torch.interop import pane_state_to_numpy

    spec = _spec(spec_kw)
    st = (ps.init_store(spec, torch.float32 if float_keys else torch.int32)
          if state is None else _state(state))
    out = []
    for g, k, ts, live, rb in pushes:
        st, events = sk.pergroup_scan_time(
            spec, st, _t(g), _t(k), _t(ts), _t(live),
            None if rb is None else torch.tensor(rb, dtype=torch.int32))
        out.append((pane_state_to_numpy(st), events.numpy()))
    return out


def time_replay(spec_kw, state_arrays, ops, eval_time):
    """``gather_runs`` and ``replay`` of a time-mode store at
    ``eval_time``, and the ring replay's plain version over it as a
    one-snapshot state."""
    from repro_torch.core import panestore as ps

    spec = _spec(spec_kw)
    st = _state(state_arrays)
    et = torch.tensor(eval_time, dtype=torch.int32)
    runs = ps.gather_runs(spec, st, eval_time=et)
    g, vals, valid, num = ps.replay(spec, st, ops, eval_time=et)
    one = ps.PaneStoreState(*(x[None] for x in st))
    ring = sk.pergroup_replay_ring(spec, one, ops, eval_time=et.reshape(1))
    return (_np(tuple(runs)), _np((g, vals, valid, num)), _np(ring))


# ------------------------------------------- standalone sort and scan

def bitonic_sort_cuda(operands, num_keys):
    from repro_torch.kernels.bitonic.ops import bitonic_sort_cuda as run

    return _np(run(tuple(_t(o) for o in operands), num_keys))


def sort_pairs_cuda(g, k, full_width):
    from repro_torch.kernels.bitonic.ops import sort_pairs_cuda as run

    return _np(run(_t(g), _t(k), full_width=full_width))


def segmented_scan_cuda(flags, leaves, op, tile):
    """``segmented_scan_cuda`` over the state's leaves; the scanned leaves
    and the launches counted (none on the CPU)."""
    from repro_torch.kernels.segscan import kernel as ssk
    from repro_torch.kernels.segscan.ops import segmented_scan_cuda as run

    state = tuple(_t(x) for x in leaves)
    out = run(_t(flags), state if len(state) > 1 else state[0], op,
              tile=tile)
    return _np(out if isinstance(out, tuple) else (out,)), ssk.segscan.launches


# ---------------------------------------------------------- observability

def execute_on_off(ops, g, k, *, backend, window=None, query=None, **kw):
    """``execute`` with stats off, then on (on the CPU): both results in
    numpy, their stats included."""
    q = _query(ops, window, query)
    out = []
    for on in (False, True):
        res, _ = tq.execute(q, g, k, backend=backend, device="cpu",
                            collect_stats=on, **kw)
        r = result_to_numpy(res)
        out.append(SimpleNamespace(groups=r.groups, values=r.values,
                                   valid=r.valid, num_groups=r.num_groups,
                                   stats=r.stats))
    return out


def stream_on_off(ops, batches, *, backend, window=None, n_valids=None):
    """A stream through ``execute(state=)`` twice, with stats off and on
    (``batches`` as :func:`stream_steps`'s): per push both results and
    states, and the stats, in numpy."""
    from repro_torch.interop import stats_to_numpy

    p = _stream_plan(ops, window, None, backend)
    st_off = st_on = None
    n_valids = n_valids or [None] * len(batches)
    out = []
    for (g, k, *ts), nv in zip(batches, n_valids):
        kw = {"timestamps": ts[0]} if ts else {}
        off, st_off = tq.execute(p, g, k, state=st_off, n_valid=nv,
                                 device="cpu", **kw)
        on, st_on = tq.execute(p, g, k, state=st_on, n_valid=nv,
                               device="cpu", collect_stats=True, **kw)
        out.append({"off": _np(tuple(result_to_numpy(off)[:4])),
                    "on": _np(tuple(result_to_numpy(on)[:4])),
                    "state_off": _state_np(st_off),
                    "state_on": _state_np(st_on[0]),
                    "stats": stats_to_numpy(on.stats),
                    "carried": stats_to_numpy(st_on[1])})
    return out


def aggregator_stats(op, batches, *, backend, window=None):
    """A ``StreamingAggregator(collect_stats=True)`` on the CPU: the stats
    of every push, of the flush and of one more push after it, and the
    count of tensors in its carry."""
    from repro_torch.core import StreamingAggregator
    from repro_torch.interop import stats_to_numpy
    from repro_torch.obs import trace

    agg = StreamingAggregator(
        op, window=None if window is None else tq.Window(**window),
        collect_stats=True, device="cpu", backend=backend)
    leaves = len(trace.tensors(agg.carry))
    stats = [stats_to_numpy(agg.push(g, k, timestamps=ts[0] if ts else None)
                            .stats) for g, k, *ts in batches]
    stats.append(stats_to_numpy(agg.flush().stats))
    g, k, *ts = batches[0]
    stats.append(stats_to_numpy(
        agg.push(g, k, timestamps=ts[0] if ts else None).stats))
    return stats, leaves


def stats_off_paths(g, k, ts):
    """Every stats-off path of the port with the counter helpers of
    :mod:`repro_torch.obs.counters` made to raise: the results' stats (all
    must be None, but an event-time aggregator's late-drop count)."""
    from repro_torch.core import StreamingAggregator
    from repro_torch.obs import counters

    def boom(*a, **kw):
        raise AssertionError("a counter helper ran with stats off")

    names = ("init", "ensure", "bump", "high_water", "put", "copy",
             "store_into")
    saved = {n: getattr(counters, n) for n in names}
    for n in names:
        setattr(counters, n, boom)
    time_w = tq.Window(range=32, slide=8, max_lateness=4,
                       reorder_capacity=8)
    count_w = tq.Window(ws=16, wa=8, capacity=8)
    seen = {}
    try:
        for backend in ("reference", "cuda", "cuda-panes"):
            if backend != "cuda-panes":
                res, _ = tq.execute(tq.Query(ops=("sum", "min")),
                                    np.sort(g), k, backend=backend,
                                    device="cpu")
                seen[f"engine/{backend}"] = res.stats
            res, _ = tq.execute(tq.Query(ops=("sum", "min"),
                                         window=tq.Window(ws=32, wa=8)),
                                g, k, backend=backend, device="cpu")
            seen[f"window/{backend}"] = res.stats
        for backend in ("reference", "cuda-panestore"):
            res, _ = tq.execute(
                tq.Query(ops=("sum", "median"), window=tq.Window(
                    ws=32, wa=8, ws_per_group={0: 16})),
                g, k, backend=backend, device="cpu")
            seen[f"pergroup/{backend}"] = res.stats
        res, _ = tq.execute(tq.Query(ops="min", group_by=False,
                                     window=tq.Window(range=32, slide=8)),
                            None, k, timestamps=ts, backend="cuda",
                            device="cpu")
        seen["time window/cuda"] = res.stats
        for backend, window in (("reference", None), ("cuda", None),
                                ("reference", count_w),
                                ("cuda-panestore", count_w),
                                ("reference", time_w),
                                ("cuda-panestore", time_w)):
            agg = StreamingAggregator(("sum",), window=window, device="cpu",
                                      backend=backend)
            kind = ("plain" if window is None
                    else "time" if window is time_w else "store")
            r = agg.push(np.sort(g) if window is None else g, k,
                         timestamps=ts if window is time_w else None)
            seen[f"stream {kind}/{backend}"] = r.stats
            seen[f"flush {kind}/{backend}"] = agg.flush().stats
    finally:
        for n, f in saved.items():
            setattr(counters, n, f)
    return {name: None if s is None else sorted(s)
            for name, s in seen.items()}


def fingerprints(cases):
    """``query_fingerprint`` of each ``(ops, window, query, num_shards)``,
    and the ``plan_fingerprint`` of its reference plan (one shard)."""
    from repro_torch.obs.registry import plan_fingerprint, query_fingerprint

    out = []
    for ops, window, query, shards in cases:
        q = _query(ops, window, query)
        pfp = (plan_fingerprint(tq.plan(q, backend="reference",
                                        device="cpu"))
               if shards == 1 else None)
        out.append((query_fingerprint(q, num_shards=shards), pfp))
    return out


def prometheus_text(cells, stats):
    """The port's Prometheus text of a registry fed ``cells`` ([(backend,
    fingerprint, tuples, seconds)]) and of ``stats`` (numpy values become
    tensors)."""
    from repro_torch.obs import export
    from repro_torch.obs.registry import MetricsRegistry

    reg = MetricsRegistry()
    for backend, fp, tuples, seconds in cells:
        reg.observe(backend, fp, tuples=tuples, seconds=seconds)
    return export.prometheus_metrics(
        registry=reg,
        stats={k: torch.as_tensor(np.asarray(v)) for k, v in stats.items()})


def backend_routing(ops, window):
    """``choose_backend`` (on the CPU) and the ``auto`` plan as the
    process registry is fed, step by step as the JAX package's test
    feeds its own."""
    from repro_torch.kernels.registry import choose_backend
    from repro_torch.obs.registry import METRICS, query_fingerprint

    q = _query(ops, window, None)
    fp = query_fingerprint(q)
    cpu = torch.device("cpu")
    seen = []
    METRICS.reset()
    try:
        seen.append(choose_backend(q, cpu))
        METRICS.observe("reference", fp, tuples=1_000, seconds=1.0)
        seen.append(choose_backend(q, cpu))
        METRICS.observe("cuda-panestore", fp, tuples=50_000, seconds=1.0)
        seen.append(choose_backend(q, cpu))
        seen.append(tq.plan(q, device="cpu").backend)
        # a stale cell of a backend that cannot run this query never wins
        METRICS.observe("cuda", fp, tuples=10_000_000, seconds=1.0)
        seen.append(choose_backend(q, cpu))
        METRICS.observe("reference", fp, tuples=10, seconds=1.0)
        seen.append(choose_backend(q, cpu))
    finally:
        METRICS.reset()
    seen.append(choose_backend(q, cpu))
    return seen


def obs_substrate(g, k, jsonl_path):
    """The host-side pieces on the port: a capture's spans around
    ``execute``, the shared no-op span, the process registry fed by
    ``execute(collect_stats=True)``, the counter helpers and a JSONL round
    trip of a result's stats."""
    from repro_torch.obs import counters, export, trace
    from repro_torch.obs.registry import (METRICS, MetricsRegistry,
                                          plan_fingerprint)

    out = {}
    with trace.capture() as tr:
        tq.execute(tq.Query(ops=("sum",)), g, k, device="cpu")
    out["spans"] = [(s.name, s.depth, s.duration_s) for s in tr.spans]
    out["report"] = tr.report()
    out["null_shared"] = trace.span("x") is trace.span("y")

    reg = MetricsRegistry()
    reg.observe("reference", "fp", tuples=1000, seconds=1.0)
    reg.observe("reference", "fp", tuples=1000, seconds=1.0)
    reg.observe("cuda", "fp", tuples=4000, seconds=1.0)
    out["registry"] = (reg.tuples_per_s("reference", "fp"),
                       reg.snapshot()[("reference", "fp")],
                       reg.best_backend("fp"), reg.best_backend("other"))
    reg.observe("x", "fp", tuples=1, seconds=0.0)  # ignored, not a div0
    reg.reset()
    out["reset"] = reg.snapshot()

    p = tq.plan(tq.Query(ops=("sum",)), backend="reference", device="cpu")
    fp = plan_fingerprint(p)
    before = METRICS.snapshot().get(("reference", fp), {"calls": 0})["calls"]
    tq.execute(p, g, k, device="cpu", collect_stats=True)
    cell = METRICS.snapshot()[("reference", fp)]
    out["observed"] = (cell["calls"] - before, cell["tuples_per_s"])

    c = counters.ensure(counters.init(), ("a", "b"))
    c2 = counters.bump(c, "a", torch.tensor(3, dtype=torch.int32))
    c3 = counters.high_water(c2, "b", torch.tensor(7, dtype=torch.int32))
    c3 = counters.high_water(c3, "b", 4)
    out["helpers"] = {
        "none": [counters.bump(None, "x", 1), counters.high_water(None, "x", 1),
                 counters.put(None, "x", 1), counters.ensure(None, ("x",))],
        "keys": sorted(c), "a": (int(c2["a"]), int(c["a"])),
        "b": int(c3["b"]), "dtype": str(c["a"].dtype)}

    res, _ = tq.execute(tq.Query(ops=("sum",), window=tq.Window(
        ws=16, wa=8, ws_per_group={0: 8})), g, k, device="cpu",
        collect_stats=True)
    export.write_jsonl([{"name": "t", "engine_stats": res.stats}], jsonl_path)
    out["jsonl"] = export.read_jsonl(jsonl_path)
    return out


def execute_stats_toggled():
    """The errors of a stream whose ``collect_stats`` flips: on then off,
    and off then on."""
    q = tq.Query(ops=("sum",), streaming=True)
    g = np.zeros(8, np.int32)
    errors = []
    for first in (True, False):
        _, state = tq.execute(q, g, g, device="cpu", collect_stats=first)
        try:
            tq.execute(q, g, g, state=state, device="cpu",
                       collect_stats=not first)
        except ValueError as e:
            errors.append(str(e))
    return errors


# ------------------------------------------------- sharded execution (7a)

def _table_np(t):
    from repro_torch.interop import partial_table_to_numpy

    return partial_table_to_numpy(t)


def partials_algebra(g, k, ops, cut):
    """The partial tables of the whole stream, of its first ``cut`` tuples
    and of the rest (each a masked prefix of a full-width stream), their
    merge, and the finalized whole and merge (numpy)."""
    from repro_torch.core import engine as E

    g, k = _t(g), _t(k)
    n = g.shape[0]
    full = E.multi_engine_partials(g, k, ops)
    pa = E.multi_engine_partials(g, k, ops, n_valid=cut)
    pb = E.multi_engine_partials(torch.roll(g, -cut), torch.roll(k, -cut),
                                 ops, n_valid=n - cut)
    merged = E.combine_partial_tables(pa, pb, ops, key_dtype=k.dtype)
    return ([_table_np(t) for t in (full, pa, pb, merged)],
            [_np(E.finalize_partial_table(t, ops)) for t in (full, merged)])


def combine_tables(tables, ops, key_dtype="int32"):
    """Stacked partial tables (numpy, through ``interop``) merged by the
    combine tree, then finalized, and the tree's counters."""
    from repro_torch.core import engine as E
    from repro_torch.distributed import query_exec as qx
    from repro_torch.interop import partial_table_from_numpy

    merged, c = qx.combine_tree(partial_table_from_numpy(tables, "cpu"), ops,
                                key_dtype=getattr(torch, key_dtype),
                                counters={})
    return (_table_np(merged), _np(E.finalize_partial_table(merged, ops)),
            _np(c))


def empty_identity(g, k, ops, width):
    """The empty table of ``width`` rows (numpy), and the finalized
    partials of the stream, alone and merged after the empty table."""
    from repro_torch.core import engine as E

    empty = E.empty_partial_table(width, ops, _t(k).dtype)
    pb = E.multi_engine_partials(_t(g), _t(k), ops)
    merged = E.combine_partial_tables(empty, pb, ops, key_dtype=_t(k).dtype)
    return (_table_np(empty),
            [_np(E.finalize_partial_table(t, ops)) for t in (pb, merged)])


def local_tables(ops, g, k, num_shards, *, backend, tile=1024,
                 n_valid=None):
    """The per-shard partial tables of the engine path's local phase
    (``partition_stream`` and the backend's local phase; ``cuda`` runs the
    groupagg kernel's plain version), in numpy."""
    from repro_torch.distributed import query_exec as qx

    g, k = _t(g), _t(k)
    n = g.shape[0]
    if n_valid is not None:
        g = torch.where(torch.arange(n) < n_valid, g, qx.PAD_GROUP)
    gs, ks = qx.partition_stream(g, k, num_shards)
    nvs = None if n_valid is None else qx._shard_valid(
        n_valid, num_shards, n // num_shards, g.device)
    q = tq.Query(ops=ops)
    return _table_np(qx._local_engine_tables(gs, ks, nvs, q.ops, None,
                                             backend, tile=tile))


def plan_sharded(ops, *, backend=None, window=None, query=None,
                 num_shards=1, devices=None):
    """A plan's backend, note and stages (``devices`` by name)."""
    p = tq.plan(_query(ops, window, query), backend=backend, device="cpu",
                num_shards=num_shards,
                devices=None if devices is None
                else [torch.device(d) for d in devices])
    return p.backend, p.note, p.stages, p.num_shards


def choose_backend_on(ops, window, devices):
    from repro_torch.kernels.registry import choose_backend

    return choose_backend(_query(ops, window, None),
                          [torch.device(d) for d in devices])


def sharded_stats(ops, g, k, num_shards):
    """``execute(plan(num_shards=S), collect_stats=True)`` on the
    reference and the same call with stats off (numpy)."""
    p = tq.plan(tq.Query(ops=ops), backend="reference", device="cpu",
                num_shards=num_shards)
    on, _ = tq.execute(p, g, k, device="cpu", collect_stats=True)
    off, _ = tq.execute(p, g, k, device="cpu")
    return result_to_numpy(on), result_to_numpy(off)


# ----------------------------------- sharded event-time streams (7b)

def reorder_sharded(capacity, lateness, pushes, float_keys=False,
                    state=None):
    """Pushes ``[(ts, groups, keys [S, L], n_valid, release, late,
    drain)]`` through stacked reorder buffers
    (``kernels.eventtime.kernel.reorder_push_sharded``, its plain version
    on CPU tensors; counters from zero each push), from ``state`` (numpy)
    or fresh buffers, then ``reorder_flush_sharded``: per push and for the
    flush the emission, the stacked buffers and the counters, in numpy."""
    from repro_torch.core import eventtime as et
    from repro_torch.interop import (reorder_state_from_numpy,
                                     reorder_state_to_numpy)
    from repro_torch.kernels.eventtime import kernel as ek

    spec = _rspec(capacity, lateness)
    shards = pushes[0][0].shape[0]
    st = (et.init_reorder_stacked(spec, shards, torch.float32 if float_keys
                                  else torch.int32) if state is None
          else reorder_state_from_numpy(state, "cpu"))
    out = []
    for ts, g, k, nv, rel, late, drain in pushes:
        counters = {}
        emit, st = ek.reorder_push_sharded(
            spec, st, _t(ts), _t(g), _t(k), n_valid=nv, release_wm=rel,
            late_wm=late, drain_wm=drain, counters=counters)
        out.append((_np(tuple(emit)), reorder_state_to_numpy(st),
                    _np(counters)))
    emit, st = ek.reorder_flush_sharded(spec, st)
    out.append((_np(tuple(emit)), reorder_state_to_numpy(st), {}))
    return out


def merge_emissions(emit):
    """``query_exec.merge_emissions`` of a stacked emission (numpy)."""
    from repro_torch.core.eventtime import ReorderEmit
    from repro_torch.distributed import query_exec as qx

    return _np(qx.merge_emissions(ReorderEmit(*(_t(x) for x in emit))))


def time_aggregator(op, batches, *, window, num_shards=None, mesh=None,
                    backend=None):
    """A sharded event-time ``StreamingAggregator`` on the CPU (``mesh`` by
    device name): per push its groups, values, valid and late-drop count,
    then the flush's, in numpy."""
    from repro_torch.core import StreamingAggregator

    agg = StreamingAggregator(op, window=tq.Window(**window),
                              num_shards=num_shards, mesh=mesh,
                              device="cpu", backend=backend)
    out = []
    for g, k, ts in batches:
        r = agg.push(g, k, timestamps=ts)
        out.append(_np((r.groups, r.values, r.valid,
                        r.stats["late_dropped"])))
    r = agg.flush()
    out.append(_np((r.groups, r.values, r.valid, r.stats["late_dropped"])))
    return out


# ------------------------------------------- slice 8: shims and helpers

#: the port's deprecated shims, by the name of their JAX counterpart
_SHIMS = {
    "group_by_aggregate": ("repro_torch.core", "group_by_aggregate"),
    "multi_aggregate": ("repro_torch.core", "multi_aggregate"),
    "swag": ("repro_torch.core.swag", "swag"),
    "swag_median": ("repro_torch.core.swag", "swag_median"),
    "group_by_aggregate_tpu": ("repro_torch.kernels.groupagg.ops",
                               "group_by_aggregate_cuda"),
    "swag_tpu": ("repro_torch.kernels.swag.ops", "swag_cuda"),
}


def shim(name, g, k, *args, **kwargs):
    """The port's counterpart of the JAX shim ``name`` on CPU tensors:
    the DeprecationWarnings naming ``repro_torch.query`` it emitted, the
    type name of its result, and the result in numpy."""
    import importlib
    import warnings

    module, attr = _SHIMS[name]
    fn = getattr(importlib.import_module(module), attr)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(_t(g), _t(k), *args, **kwargs)
    dep = [str(w.message) for w in caught
           if issubclass(w.category, DeprecationWarning)
           and "repro_torch.query" in str(w.message)]
    kind = type(out).__name__
    if isinstance(out, dict):
        return dep, kind, {n: _np(tuple(r)) for n, r in out.items()}
    return dep, kind, _np(tuple(out))


def complexity_table(ps):
    """The port's entity counts and ratio at each P of ``ps``."""
    from repro_torch.core import complexity as cx

    return [(cx.prra_entities(p), cx.engine_entities(p),
             cx.modular_entities(p), cx.reduction_ratio(p)) for p in ps]


def complexity_raises(p):
    from repro_torch.core import complexity as cx

    try:
        cx.engine_entities(p)
    except ValueError as e:
        return str(e)
    return None


def domain_stats(domains, values, ops):
    """``repro_torch.data.domain_stats`` on the CPU (numpy)."""
    from repro_torch.data import domain_stats as run

    return _np(run(domains, values, ops, device="cpu"))


# ------------------------------------------- slice 9a: the LLM serving path

def _port_in(x):
    """numpy arrays (in dicts, tuples and lists too) as CPU tensors."""
    if isinstance(x, np.ndarray):
        from repro_torch.interop import _tensor
        return _tensor(x, "cpu")
    if isinstance(x, dict):
        return {k: _port_in(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_port_in(v) for v in x)
    return x


def _port_out(x):
    """Tensors (bfloat16 as float32) as numpy; named tuples as dicts, so
    nothing of the port's types crosses back."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if isinstance(x, tuple) and hasattr(x, "_asdict"):
        return {k: _port_out(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: _port_out(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_port_out(v) for v in x)
    return x


def call(module, name, *args, **kwargs):
    """``module.name(*args, **kwargs)`` of the port on CPU tensors, in and
    out as numpy."""
    import importlib

    fn = getattr(importlib.import_module(module), name)
    return _port_out(fn(*_port_in(args), **_port_in(kwargs)))


def _llm(arch, overrides, tree):
    from repro_torch.configs import get_config
    from repro_torch.interop import model_params_from_numpy

    cfg = get_config(arch).reduced(**overrides)
    return cfg, model_params_from_numpy(cfg, tree, "cpu")


def _memory(cfg, model, memory, encoder_embeds):
    from repro_torch.models import model as MDL

    if encoder_embeds is not None:
        return MDL.encode(model, cfg, _port_in(encoder_embeds))
    return None if memory is None else _port_in(memory)


def llm_forward(arch, overrides, tree, tokens, *, memory=None,
                encoder_embeds=None):
    """The port's forward, loss and prefill step of a reduced ``arch``
    holding the JAX parameters ``tree``."""
    from repro_torch.distributed.steps import make_prefill_step
    from repro_torch.models import model as MDL

    cfg, m = _llm(arch, overrides, tree)
    mem = _memory(cfg, m, memory, encoder_embeds)
    toks = _port_in(tokens)
    logits, aux = MDL.forward(m, cfg, toks, memory=mem)
    batch = {"tokens": toks, "labels": toks}
    if encoder_embeds is not None:
        batch["encoder_embeds"] = _port_in(encoder_embeds)
    elif memory is not None:
        batch["memory"] = mem
    loss, parts = MDL.loss_fn(m, cfg, batch, ce_chunk=4)
    prefill, _ = make_prefill_step(cfg)
    return _port_out({"logits": logits, "aux": aux, "loss": loss,
                      "parts": parts, "prefill": prefill(m, batch)})


def llm_decode(arch, overrides, tree, tokens, *, max_len, memory=None,
               encoder_embeds=None, state=None):
    """Each step's logits [B, S, V] of the port's decode steps over
    ``tokens`` [B, S], from a fresh state or from the JAX decode state
    ``state``; and the step count the state ends at."""
    from repro_torch.interop import decode_state_from_numpy
    from repro_torch.models import model as MDL

    cfg, m = _llm(arch, overrides, tree)
    if state is not None:
        st = decode_state_from_numpy(cfg, state, "cpu")
    else:
        mem = _memory(cfg, m, memory, encoder_embeds)
        st = MDL.init_decode_state(m, cfg, tokens.shape[0], max_len,
                                   memory=mem)
        if mem is not None:
            st = MDL.precompute_cross_kv(m, cfg, st, mem)
    out = []
    for t in range(tokens.shape[1]):
        lg, st = MDL.decode_step(m, cfg, _port_in(tokens[:, t]), st)
        out.append(lg)
    return _port_out(torch.stack(out, dim=1)), int(st["pos"])


def llm_serve(arch, overrides, tree, prompts, gen, forced=None):
    """The port's ``generate`` (greedy) of a reduced ``arch`` holding the
    JAX parameters: its tokens and every step's logits."""
    from repro_torch.launch.serve import generate

    cfg, m = _llm(arch, overrides, tree)
    res = generate(cfg, m, prompts, gen, forced=forced)
    return _port_out(res.tokens), _port_out(res.logits)


def llm_init_tree(arch):
    """The port's own initialisation of reduced ``arch``: {parameter name:
    shape} and the parameter count."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as MDL
    from repro_torch.models.params import count_params, param_bytes

    cfg = get_config(arch).reduced()
    m = MDL.init_model(cfg, seed=0, device="cpu")
    return ({k: tuple(v.shape) for k, v in m.named_parameters()},
            count_params(m), param_bytes(m))


def rwkv_steps(p, x, chunk):
    """RWKV time mix over the sequence and token by token."""
    from repro_torch.models import rwkv as R

    p, x = _port_in(p), _port_in(x)
    seq, _ = R.rwkv_time_mix(p, x, chunk=chunk)
    st = R.init_rwkv_state(x.shape[0], x.shape[2], x.dtype, "cpu")
    st = {"shift_t": st["shift_t"], "S": st["S"]}
    outs = []
    for t in range(x.shape[1]):
        y, st = R.rwkv_time_mix_step(p, x[:, t], st)
        outs.append(y)
    return _port_out((seq, torch.stack(outs, dim=1)))


def mamba_steps(p, x, ssm_state, chunk):
    """Mamba2 mixing over the sequence and token by token."""
    from repro_torch.models import mamba as M

    p, x = _port_in(p), _port_in(x)
    seq, _ = M.mamba_mix(p, x, ssm_state=ssm_state, chunk=chunk)
    st = M.init_mamba_state(x.shape[0], x.shape[2], ssm_state, x.dtype, "cpu")
    outs = []
    for t in range(x.shape[1]):
        y, st = M.mamba_mix_step(p, x[:, t], st, ssm_state=ssm_state)
        outs.append(y)
    return _port_out((seq, torch.stack(outs, dim=1)))


def cache_decode(q, k, v, ring, size, first=0):
    """decode_attend over a cache appended one step at a time, after a
    prefill of the ``first`` steps."""
    from repro_torch.models import attention as A

    q, k, v = _port_in((q, k, v))
    cache = A.init_cache(q.shape[0], size, k.shape[2], k.shape[3],
                         k.dtype, "cpu")
    if first:
        cache = A.cache_prefill(cache, k[:, :first], v[:, :first])
    outs = []
    for i in range(first, q.shape[1]):
        cache = A.cache_append(cache, k[:, i:i + 1], v[:, i:i + 1],
                               ring=ring)
        outs.append(A.decode_attend(q[:, i:i + 1], cache))
    return _port_out(torch.cat(outs, dim=1))


def moe_parts(p, x, num_experts, k, capacity_factor, mlp_kind):
    """``moe_sorted`` and ``moe_onehot`` of the port, and the sorted
    dispatch's integers: experts, sorted ids, ranks, kept, slots."""
    from repro_torch.models import moe as MOE

    p, x = _port_in(p), _port_in(x)
    kw = dict(num_experts=num_experts, num_experts_per_tok=k,
              capacity_factor=capacity_factor, mlp_kind=mlp_kind)
    experts, _, _ = MOE.route(p, x, k)
    cap = MOE._capacity(x.shape[0], num_experts, k, capacity_factor)
    return _port_out({"sorted": MOE.moe_sorted(p, x, **kw),
                      "onehot": MOE.moe_onehot(p, x, **kw),
                      "experts": experts,
                      "dispatch": MOE.dispatch(experts, num_experts, cap)})


def query_steps(ops, batches, *, backend, window=None, streaming=False,
                mesh=None, shard=False):
    """``make_query_step`` on the CPU: each batch's result (numpy) through
    the step, the state threaded, and the plan's backend."""
    from repro_torch.distributed.steps import make_query_step

    q = tq.Query(ops=ops, streaming=streaming,
                 window=None if window is None else tq.Window(**window))
    step, p = make_query_step(q, backend=backend, device="cpu", mesh=mesh,
                              shard=shard)
    state = tq.init_stream_state(p) if streaming else None
    out = []
    for g, k in batches:
        if streaming:
            res, state = step(g, k, state)
        else:
            res = step(g, k)
        r = result_to_numpy(res)
        out.append(SimpleNamespace(groups=r.groups, values=r.values,
                                   valid=r.valid, num_groups=r.num_groups))
    return p.backend, out


def serve_main(argv):
    """``python -m repro_torch.launch.serve`` in the child: its exit code
    and what it printed."""
    import contextlib
    import io

    from repro_torch.launch.serve import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def configs_table():
    """Every registered config of the port, full and reduced, as dicts;
    the shape grid; the applicability matrix; the engine configs."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.configs import paper_engine

    archs = C.list_archs()
    return {
        "archs": archs,
        "full": {a: dataclasses.asdict(C.get_config(a)) for a in archs},
        "reduced": {a: dataclasses.asdict(C.get_config(a).reduced())
                    for a in archs},
        "shapes": {n: dataclasses.asdict(s) for n, s in C.SHAPES.items()},
        "applicable": {(a, n): C.base.shape_applicable(C.get_config(a), s)[0]
                       for a in archs for n, s in C.SHAPES.items()},
        "engine": [dataclasses.asdict(paper_engine.config()),
                   dataclasses.asdict(paper_engine.config_dc()),
                   paper_engine.config_dc().op_list],
    }


# ------------------------------------------ public names and the backend

def _sumsq():
    """A user's monoid: the sum of squared keys (int32 wraps as JAX's)."""
    from repro_torch.core.combiners import Combiner

    return Combiner(
        name="sumsq", lift=lambda k: k * k, op=lambda a, b: a + b,
        finalize=lambda s: s,
        identity=lambda shape, dtype, device="cpu": torch.zeros(
            tuple(shape), dtype=dtype, device=device))


def registered_combiner(g, k, window):
    """``register_combiner("sumsq", ...)`` in the port: the reference's
    engine and window results of a query naming it (numpy), and each
    kernel backend's refusal."""
    from repro_torch.core import register_combiner
    from repro_torch.kernels import registry

    register_combiner("sumsq", _sumsq)
    ops = ("sumsq", "sum")
    out = {"engine": execute(ops, g, k, backend="reference"),
           "window": execute(ops, g, k, backend="reference",
                             window=window)}
    for name in ("cuda", "cuda-panes", "cuda-panestore"):
        for w in (None, window, dict(window, ws_per_group=window["ws"])):
            q = _query(ops, w, None)
            out[name, w is None, bool(w and "ws_per_group" in w)] = \
                registry.BACKENDS[name].supports(q)
    return out


def _outcome(fn):
    """``fn()``'s value, or the type and message of what it raised."""
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


def backend_env_cases():
    """The port's backend precedence under ``REPRO_TORCH_BACKEND`` (the
    cases of ``tests/test_obs.py::test_env_backend_validated_eagerly``),
    with the JAX package's ``REPRO_BACKEND`` set beside it; the process's
    environment is restored afterwards."""
    import os

    from repro_torch.kernels import registry

    q = tq.Query(ops=("sum",))
    saved = {v: os.environ.get(v) for v in (registry.BACKEND_ENV,
                                            "REPRO_BACKEND")}

    def plan():
        return tq.plan(q, device="cpu").backend

    out = {"name": registry.BACKEND_ENV}
    try:
        os.environ["REPRO_BACKEND"] = "pallas"  # the JAX package's: unread
        os.environ[registry.BACKEND_ENV] = "no-such-engine"
        out["bad"] = (_outcome(registry.resolve_backend), _outcome(plan))
        os.environ[registry.BACKEND_ENV] = "cuda"
        out["cuda"] = (registry.resolve_backend(), plan(),
                       registry.resolve_backend("reference"),
                       tq.plan(q, backend="reference", device="cpu").backend)
        del os.environ[registry.BACKEND_ENV]
        out["unset"] = (registry.resolve_backend(), plan())
        out["bogus"] = _outcome(lambda: registry.resolve_backend("bogus"))
        probe = registry.Backend("probe-only", lambda query: None)
        registry.register_backend(probe)
        try:
            out["registered"] = (registry.resolve_backend("probe-only"),
                                 "probe-only" in
                                 registry.available_backends())
        finally:
            del registry.BACKENDS["probe-only"]
    finally:
        for var, value in saved.items():
            if value is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = value
    return out


def core_names(names):
    """Each name of ``repro_torch.core``: the module that defines it and
    its kind (function, class, module or value)."""
    import inspect

    import repro_torch.core as core

    out = {}
    for name in names:
        obj = getattr(core, name, None)
        if obj is None:
            out[name] = None
        elif inspect.ismodule(obj):
            out[name] = (obj.__name__, "module")
        elif inspect.isclass(obj) or inspect.isfunction(obj):
            out[name] = (obj.__module__, type(obj).__name__)
        else:
            out[name] = ("", repr(obj))
    from repro_torch.core.swag import frame_panes  # the module's names
    out["_swag_module"] = frame_panes.__module__
    return out
