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
    """``swag_per_group(counters=...)``: raises until observability is
    ported."""
    from repro_torch.core.swag import swag_per_group as run

    g = torch.zeros(8, dtype=torch.int32)
    run(g, g, spec=_spec(dict(wa=4, capacity=8, default_ws=8)), ops=["sum"],
        counters={})


# --------------------------------------------------------------- streaming

def _stream_plan(ops, window, query, backend):
    return tq.plan(_query(ops, window, dict(query or {}, streaming=True)),
                   backend=backend, device="cpu")


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
                 state=None, n_valids=None):
    """Push ``batches`` ([(groups, keys)], or [(groups, keys, timestamps)]
    for an event-time window) through the streaming step of the plan
    (``stream_fn``), from ``state`` (numpy) or a fresh one; per push, its
    full outputs (with ``rr_port``) and the state it left, in numpy."""
    p = _stream_plan(ops, window, query, backend)
    st = _stream_state(p, state, _t(batches[0][1]).dtype)
    step = tq.stream_fn(p)
    n_valids = n_valids or [None] * len(batches)
    out = []
    for (g, k, *ts), nv in zip(batches, n_valids):
        (og, ov, valid, num, rr), st = step(_t(g), _t(k), st, nv,
                                            *(_t(t) for t in ts))
        out.append({"groups": og.numpy(), "values": _np(ov),
                    "valid": valid.numpy(), "num": num.numpy(),
                    "rr": rr.numpy(), "state": _state_np(st)})
    return out


def aggregator_stream(op, batches, *, backend, window=None,
                      float_keys=False, n_valids=None):
    """``StreamingAggregator``'s pushes and flush on the CPU: per push its
    result (``stats`` included) and carry, then the flush's result, in
    numpy.  An event-time window's batches carry timestamps third."""
    from repro_torch.core import StreamingAggregator

    agg = StreamingAggregator(
        op, window=None if window is None else tq.Window(**window),
        key_dtype=torch.float32 if float_keys else torch.int32,
        device="cpu", backend=backend)
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
    """The pieces of streaming that wait for later slices."""
    from repro_torch.core import StreamingAggregator
    from repro_torch.core.streaming import stream_push_table

    if what == "shards":
        StreamingAggregator("sum", num_shards=2, device="cpu")
    elif what == "mesh":
        StreamingAggregator("sum", mesh=object(), device="cpu")
    elif what == "stats":
        StreamingAggregator("sum", collect_stats=True, device="cpu")
    elif what == "timestamps":
        agg = StreamingAggregator("sum", device="cpu")
        agg.push(np.zeros(4, np.int32), np.zeros(4, np.int32),
                 timestamps=np.zeros(4, np.int32))
    elif what == "time window stats":
        StreamingAggregator("sum", window=tq.Window(range=10),
                            collect_stats=True, device="cpu")
    elif what == "table":
        stream_push_table(None, (), ("sum",), first_group=0, any_real=True)


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
