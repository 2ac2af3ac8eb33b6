"""Batch time-window framing — the batch half of ``repro.core.eventtime``.

A query with ``Window(range=R, slide=S)`` aggregates by *event time*: one
window ``[e - R, e)`` for every evaluation time ``e`` at a multiple of
``S``.  A batch is sorted by timestamp once and each window becomes a range
of tuple positions of the sorted stream (:func:`time_window_layout`);
:func:`frame_time_windows` gathers those ranges into static-width rows for
the replay strategy, and :mod:`repro_torch.core.twostack` reads them
without replay.

The window count and the row width are shapes, so they are read back from
the device (a few scalars); the sort and the boundary searches run where
the timestamps are.  Window ends use floor division (``ts // slide``), so
negative timestamps frame as they do in numpy.

Watermarks and the bounded-lateness reorder buffer serve event-time
streaming, which comes with a later slice (ROADMAP slice 5b).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sorter

#: hard ceiling on the number of time windows one batch may frame (a sparse
#: stream with a tiny slide would otherwise explode the window axis)
MAX_TIME_WINDOWS = 65536


def concrete_timestamps(timestamps, device=None) -> torch.Tensor:
    """Timestamps as an int64 column on ``device`` (default: where they
    are; numpy arrays start on the CPU)."""
    if isinstance(timestamps, torch.Tensor):
        ts = timestamps
    else:
        ts = torch.from_numpy(np.ascontiguousarray(np.asarray(timestamps)))
    if ts.dim() != 1:
        raise ValueError(f"timestamps must be a rank-1 column, "
                         f"got shape {tuple(ts.shape)}")
    return ts.to(device=ts.device if device is None else device,
                 dtype=torch.int64)


class TimeLayout(NamedTuple):
    """Layout of one batch's time windows over the ts-sorted stream:
    window ``j`` covers tuple positions ``[starts[j], ends[j])`` and the
    time range ``[end_times[j] - range, end_times[j])``.  Tensors live on
    the timestamps' device."""
    order: torch.Tensor      # [N] int64 ts-ascending stable permutation
    starts: torch.Tensor     # [NW] int64 first tuple index of each window
    ends: torch.Tensor       # [NW] int64 one past the last tuple index
    end_times: torch.Tensor  # [NW] int64 window ends (multiples of slide)
    wcap: int                # power-of-two max tuples per window (>= 1)


def _floor_div(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def time_window_layout(ts: torch.Tensor, time_range: int,
                       slide: int) -> TimeLayout:
    """Window boundaries over the ts-sorted stream: one window per ``slide``
    units, ending at multiples of ``slide``, from the first multiple after
    the earliest tuple through the first multiple after the latest.
    ``ts`` is an int64 column (:func:`concrete_timestamps`)."""
    dev = ts.device
    tss, order = torch.sort(ts, stable=True)
    n = tss.shape[0]
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return TimeLayout(order, empty, empty, empty, 1)
    first, last = _floor_div(tss[[0, -1]], slide).tolist()
    nw = last - first + 1
    if nw > MAX_TIME_WINDOWS:
        raise ValueError(
            f"slide={slide} frames {nw} windows over this batch's "
            f"timestamp span (> {MAX_TIME_WINDOWS}); use a larger slide "
            f"or the streaming path")
    end_times = (torch.arange(nw, dtype=torch.int64, device=dev)
                 + first + 1) * slide
    starts = torch.searchsorted(tss, end_times - time_range, side="left")
    ends = torch.searchsorted(tss, end_times, side="left")
    wcap = sorter.next_pow2(max(1, int((ends - starts).max())))
    return TimeLayout(order, starts, ends, end_times, wcap)


def frame_time_windows(layout: TimeLayout, groups_sorted: torch.Tensor,
                       keys_sorted: torch.Tensor, pad_group: int):
    """Gather the ts-sorted stream into ``[NW, wcap]`` window rows (dead
    lanes carry ``pad_group`` / zero keys).  Returns ``(frame_groups,
    frame_keys, counts)``, counts int32."""
    n = groups_sorted.shape[-1]
    dev = keys_sorted.device
    cnt = (layout.ends - layout.starts).to(torch.int32)
    lane = torch.arange(layout.wcap, device=dev)
    idx = torch.clamp(layout.starts[:, None] + lane[None, :], 0,
                      max(n - 1, 0))
    live = lane[None, :] < cnt[:, None]
    fg = torch.where(live, groups_sorted[idx],
                     torch.tensor(pad_group, dtype=groups_sorted.dtype,
                                  device=dev))
    fk = torch.where(live, keys_sorted[idx],
                     torch.zeros((), dtype=keys_sorted.dtype, device=dev))
    return fg, fk, cnt
