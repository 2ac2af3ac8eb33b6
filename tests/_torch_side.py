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
