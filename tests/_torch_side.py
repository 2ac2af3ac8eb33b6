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


def swag_per_group(spec_kw, g, k, ops, state_arrays=None):
    """``swag_per_group`` (optionally continuing ``state_arrays``); the
    result and the final state in numpy."""
    from repro_torch.core.swag import swag_per_group as run
    from repro_torch.interop import pane_state_to_numpy

    state = None if state_arrays is None else _state(state_arrays)
    out, final = run(_t(g), _t(k), spec=_spec(spec_kw), ops=list(ops),
                     state=state)
    return _np(out), pane_state_to_numpy(final)


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
