"""Execution layer of the fused SWAG kernels.

:func:`_swag_kernel_exec` runs one or many ops over count windows: with
``panes`` the WA-panes are sorted once and each window merges its P = WS/WA
presorted panes; otherwise each window is re-sorted.  A fully (group,
key)-sorted window is unique, so both give identical results.
"""
from __future__ import annotations

import torch

from repro_torch.core.combiners import out_dtype
from repro_torch.core.engine import PAD_GROUP, _prefix_mask
from repro_torch.core.sorter import next_pow2
from repro_torch.core.swag import (frame_panes, frame_windows, num_windows,
                                   resolve_panes)
from repro_torch.kernels.swag import kernel as _k


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
