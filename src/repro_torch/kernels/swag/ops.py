"""Execution layer of the fused SWAG kernels.

:func:`_swag_kernel_exec` runs one or many ops over count windows: with
``panes`` the WA-panes are sorted once and each window merges its P = WS/WA
presorted panes; otherwise each window is re-sorted.  A fully (group,
key)-sorted window is unique, so both give identical results.

:func:`_timeframe_kernel_exec` runs the replay strategy of time-range
windows: each framed window row through the swag kernel.

:func:`_swag_pergroup_kernel_exec` runs per-group windows on the pane
store: the placement scan kernel, then either the fused push + partials
kernel or the replay kernel over the scan's ring snapshots.

:func:`swag_cuda` is the deprecated single-op entry point, the
counterpart of the JAX package's ``swag_tpu``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import panestore as _ps
from repro_torch.core.combiners import out_dtype
from repro_torch.core.engine import (PAD_GROUP, _deprecated, _device_of,
                                     _prefix_mask)
from repro_torch.core.sorter import next_pow2
from repro_torch.core.swag import (_empty_pergroup, frame_panes,
                                   frame_windows, num_windows, resolve_panes,
                                   write_plan)
from repro_torch.kernels.swag import kernel as _k


class SwagResult(NamedTuple):
    groups: torch.Tensor      # [NW, WS]
    values: torch.Tensor      # [NW, WS]
    valid: torch.Tensor       # [NW, WS]
    num_groups: torch.Tensor  # [NW]


def _names(ops) -> tuple:
    return (ops,) if isinstance(ops, str) else tuple(ops)


def _swag_kernel_exec(groups: torch.Tensor, keys: torch.Tensor, *, ws: int,
                      wa: int, ops, panes: bool | None = None):
    """Fused SWAG over one or many ops (``"median"`` allowed).  WS must be a
    power of two.  Returns ``(og [NW, WS], {name: ov}, valid [NW, WS],
    oc [NW])``."""
    if ws & (ws - 1):
        raise ValueError(f"WS must be a power of two, got {ws}")
    names = _names(ops)
    n = groups.shape[-1]
    dev = groups.device
    nw = num_windows(n, ws, wa)
    if nw == 0:
        # stream shorter than one window: an empty [0, WS] result, as the
        # reference backend gives
        return (torch.full((0, ws), PAD_GROUP, dtype=torch.int32, device=dev),
                {name: torch.zeros((0, ws), dtype=out_dtype(name, keys.dtype),
                                   device=dev) for name in names},
                torch.zeros((0, ws), dtype=torch.bool, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    groups = groups.to(torch.int32)
    if resolve_panes(ws, wa, n, panes) and wa < ws:
        p = ws // wa
        np_ = nw + p - 1
        pg, pk = _k.sort_panes(frame_panes(groups, wa, np_),
                               frame_panes(keys, wa, np_))
        og, ovs, oc = _k.swag_panes(pg, pk, names, p=p)
    else:
        og, ovs, oc = _k.swag(frame_windows(groups, ws, wa),
                              frame_windows(keys, ws, wa), names)
    valid = _prefix_mask(ws, oc, dev)
    return torch.where(valid, og, PAD_GROUP), ovs, valid, oc


def _engine_median_kernel_exec(groups: torch.Tensor, keys: torch.Tensor,
                               ops, *, n_valid=None):
    """Grouped median (plus any riding ops) without a window: the stream is
    one power-of-two-padded row of the fused SWAG kernel — median needs
    whole groups in one row, which the tiled groupagg kernel cannot give.
    On the card that row must fit one block (:data:`kernel.MAX_ROW`)."""
    names = _names(ops)
    n = groups.shape[-1]
    dev = groups.device
    groups = groups.to(torch.int32)
    if n_valid is not None:
        groups = torch.where(_prefix_mask(n, n_valid, dev), groups, PAD_GROUP)
    m = next_pow2(n)
    if dev.type == "cuda" and m > _k.MAX_ROW:
        raise ValueError(
            f"grouped median without a window runs the stream as one row of "
            f"the swag kernel; {n} tuples pad to {m} lanes, above the "
            f"{_k.MAX_ROW} lanes one block's shared memory holds")
    if m != n:
        groups = torch.cat([groups, torch.full((m - n,), PAD_GROUP,
                                               dtype=torch.int32, device=dev)])
        keys = torch.cat([keys, torch.zeros((m - n,), dtype=keys.dtype,
                                            device=dev)])
    og, ovs, oc = _k.swag(groups[None, :], keys[None, :], names)
    num = oc[0]
    valid = _prefix_mask(n, num, dev)
    og = torch.where(valid, og[0, :n], PAD_GROUP)
    return og, {name: v[0, :n] for name, v in ovs.items()}, valid, num


def _timeframe_kernel_exec(frames_g: torch.Tensor, frames_k: torch.Tensor,
                           *, ops):
    """The replay strategy of time-range windows on the swag kernel: the
    event-time layer has framed the ts-sorted stream into ``[NW, wcap]``
    rows (``repro_torch.core.eventtime.frame_time_windows``: variable tuple
    counts, dead lanes at PAD_GROUP), and each row is sorted and reduced as
    a count window's is.  Returns ``(og, {name: ov}, valid, oc)``."""
    names = _names(ops)
    nw, wcap = frames_g.shape
    dev = frames_g.device
    if wcap & (wcap - 1):
        raise ValueError(f"time frames must be power-of-two wide, "
                         f"got {wcap}")
    if nw == 0:
        return (torch.full((0, wcap), PAD_GROUP, dtype=torch.int32,
                           device=dev),
                {name: torch.zeros((0, wcap),
                                   dtype=out_dtype(name, frames_k.dtype),
                                   device=dev) for name in names},
                torch.zeros((0, wcap), dtype=torch.bool, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    if dev.type == "cuda" and wcap > _k.MAX_ROW:
        raise ValueError(
            f"a time window holds up to {wcap} tuples (padded); the cuda "
            f"replay sorts each window in one block's shared memory, at "
            f"most {_k.MAX_ROW} lanes — use a shorter range or the "
            f"reference backend")
    og, ovs, oc = _k.swag(frames_g.to(torch.int32), frames_k, names)
    valid = _prefix_mask(wcap, oc, dev)
    return torch.where(valid, og, PAD_GROUP), ovs, valid, oc


def _swag_pergroup_kernel_exec(groups: torch.Tensor, keys: torch.Tensor, *,
                               spec, ops, regime: str):
    """Per-group-window SWAG on the kernels; ``spec`` is a
    :class:`repro_torch.core.panestore.PaneStoreSpec`, ``ops`` DIRECT_OPS
    names, ``regime`` what
    :func:`repro_torch.kernels.registry.pergroup_kernel_path` chose:

    * partial-fused (every op on the partial path): one placement scan
      launch gives the write plan, one fused launch writes the ring and
      evaluates every chunk;
    * merge-replay: the scan also keeps the ring and copies it after every
      chunk, and one replay launch reads each evaluation's live groups
      straight from those snapshots through the slot directory.

    Returns ``(og [NE, C], {name: ov}, valid [NE, C], num_groups [NE])``.
    """
    names = _names(ops)
    groups = groups.to(torch.int32).contiguous()
    dev = groups.device
    ne = groups.shape[-1] // spec.wa
    c = spec.capacity
    if ne == 0:
        return _empty_pergroup(spec, names, keys.dtype, dev)

    if regime == "partial-fused":
        trace = _k.pergroup_scan(spec, _ps.init_store(spec, device=dev),
                                 groups)
        slots, lanes, seqs, own_s, cnt_s, lo_s, sortmask, ugroups, num = \
            write_plan(spec, trace)
        ovs = _k.pergroup_fused(frame_panes(keys, spec.wa, ne), slots, lanes,
                                seqs, own_s, cnt_s, lo_s, sortmask, ugroups,
                                names)
    else:
        trace = _k.pergroup_scan(
            spec, _ps.init_store(spec, keys.dtype, device=dev), groups,
            keys.contiguous())
        ovs, ugroups, num = _k.pergroup_replay_ring(spec, trace.states,
                                                     names)
        del trace
    valid = torch.arange(c, device=dev)[None, :] < num[:, None]
    values = {nm: torch.where(valid, v, 0).to(v.dtype)
              for nm, v in ovs.items()}
    return torch.where(valid, ugroups, PAD_GROUP), values, valid, num


def swag_cuda(groups, keys, *, ws: int, wa: int, op="sum",
              panes: bool | None = None) -> SwagResult:
    """Deprecated: use ``repro_torch.query.Query(ops=(op,),
    window=Window(ws, wa))`` + ``execute`` (``backend="cuda"``,
    ``"cuda-panes"`` or ``"auto"``).  The pane kernels where the window
    allows them (as ``panes`` resolves), else the swag kernel; on CPU
    tensors their plain versions."""
    _deprecated("repro_torch.kernels.swag.ops.swag_cuda",
                "Query(ops=(op,), window=Window(ws, wa))")
    from repro_torch import query as _q
    name = _q.canonical_op(op)
    n = groups.shape[-1]
    backend = ("cuda-panes" if resolve_panes(ws, wa, n, panes) and wa < ws
               else "cuda")
    q = _q.Query(ops=(op,), window=_q.Window(ws=ws, wa=wa, panes=panes))
    res, _ = _q.execute(q, groups, keys, backend=backend,
                        device=_device_of(keys))
    return SwagResult(res.groups, res.values[name], res.valid,
                      res.num_groups)
