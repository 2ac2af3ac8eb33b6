"""Engine counters on the stream's device (the counterpart of
``repro.obs.counters``).

A counters value is a plain ``dict[str, torch.Tensor]`` of 0-d (or small
1-D) tensors on the device of the stream they describe.  Every helper
below is ``None``-transparent: counter sites take ``counters=None`` by
default and do nothing else then, so the stats-off path allocates nothing
and runs exactly the ops of code that never heard of counters.  No helper
reads a value back to the host: a counter stays on the card until the
caller reads ``stats``.

Conventions
-----------
- values are 0-d ``int32`` tensors (or small 1-D ones);
- the helpers are functional: they return a new dict and never modify
  the tensors they were given (:func:`store_into` and :func:`fill` are
  the exceptions, the in-place updates of a carried dict);
- the kernels' wrappers (``kernels.swag.kernel.pergroup_scan`` and
  ``pergroup_scan_time``, ``kernels.eventtime.kernel.reorder_push``)
  update the counters they are given where they lie, and add the keys
  they count when missing;
- ``int32`` sums wrap, as the JAX package's do.

Counter names used by the engine:

=========================  ====================================================
``pane_evictions``         occupied pane slots displaced by capacity pressure
``pane_occupancy_hwm``     high-water mark of occupied slots in the pane store
``reorder_depth_hwm``      high-water mark of buffered tuples in the reorder ring
``reorder_forced_pops``    pops forced by a full ring rather than the watermark
``late_dropped``           tuples dropped for violating the lateness contract
``watermark``              the event-time watermark after the last push
``stream_tuples``          tuples pushed through a streaming carry
``stream_emitted``         groups emitted (retired) by streaming pushes
=========================  ====================================================
"""
from __future__ import annotations

from typing import Optional

import torch

Counters = dict  # dict[str, torch.Tensor]


def _tensor(value, device=None, dtype=None) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value if dtype is None else value.to(dtype)
    if dtype is None:
        dtype = torch.float32 if isinstance(value, float) else torch.int32
    # a fill on the device, not a copy from the host (no sync)
    return torch.full((), value, dtype=dtype, device=device)


def _device(counters: Counters, device):
    if device is not None:
        return device
    for v in counters.values():
        return v.device
    return None


def init(device=None, **values) -> Counters:
    """A fresh counters dict; plain numbers become 0-d tensors on
    ``device`` (int32 for integers)."""
    return {name: _tensor(v, device) for name, v in values.items()}


def ensure(counters: Optional[Counters], names: tuple, dtype=torch.int32,
           device=None) -> Optional[Counters]:
    """Zero-init any missing ``names`` (on ``device``, else the device of
    the counters already there) so a stream's carry keeps its keys."""
    if counters is None:
        return None
    out = dict(counters)
    dev = _device(out, device)
    for name in names:
        if name not in out:
            out[name] = torch.zeros((), dtype=dtype, device=dev)
    return out


def bump(counters: Optional[Counters], name: str,
         amount) -> Optional[Counters]:
    """Add ``amount`` to ``counters[name]`` (zero-init if absent)."""
    if counters is None:
        return None
    out = dict(counters)
    prev = out.get(name)
    amount = _tensor(amount, _device(out, None) if prev is None
                     else prev.device)
    out[name] = amount if prev is None else prev + amount.to(prev.dtype)
    return out


def high_water(counters: Optional[Counters], name: str,
               value) -> Optional[Counters]:
    """Raise ``counters[name]`` to ``value`` if larger."""
    if counters is None:
        return None
    out = dict(counters)
    prev = out.get(name)
    value = _tensor(value, _device(out, None) if prev is None
                    else prev.device)
    out[name] = value if prev is None else torch.maximum(
        prev, value.to(prev.dtype))
    return out


def put(counters: Optional[Counters], name: str,
        value) -> Optional[Counters]:
    """Overwrite ``counters[name]`` with ``value`` (gauge semantics)."""
    if counters is None:
        return None
    out = dict(counters)
    prev = out.get(name)
    out[name] = _tensor(value, _device(out, None) if prev is None
                        else prev.device)
    return out


def copy(counters: Optional[Counters]) -> Optional[Counters]:
    """A dict of copies (on the device), for a caller whose counters must
    stay as they are while a push updates its own: one stacked copy when
    every value is a 0-d tensor of one dtype and device (a single launch),
    else a copy of each."""
    if counters is None:
        return None
    vals = list(counters.values())
    if vals and all(v.dim() == 0 and v.dtype == vals[0].dtype
                    and v.device == vals[0].device for v in vals):
        return dict(zip(counters, torch.stack(vals).unbind()))
    return {name: v.clone() for name, v in counters.items()}


def fill(dst: Counters, **values) -> Counters:
    """Set gauges of ``dst`` to plain numbers where they lie (one fill a
    gauge; a new key gets a 0-d tensor on the device of the others);
    returns ``dst``."""
    for name, v in values.items():
        old = dst.get(name)
        if old is None:
            dst[name] = _tensor(v, _device(dst, None))
        else:
            old.fill_(v)
    return dst


def store_into(dst: Counters, src: Counters) -> Counters:
    """Write ``src``'s values into ``dst``'s tensors where they lie (keys
    new to ``dst`` get a copy); returns ``dst``."""
    for name, v in src.items():
        old = dst.get(name)
        if old is None:
            dst[name] = v.clone()
        elif old is not v:
            old.copy_(v)
    return dst
