"""The bounded-lateness reorder buffer of an event-time stream, as one
CUDA kernel (``csrc/reorder.cu``).

No TPU kernel stands behind it: the JAX package runs the buffer as a
``lax.scan`` of its one-in, at-most-one-out cycle
(``src/repro/core/eventtime.py``, ``_reorder_cycle`` and
``_reorder_drain``).  The cycle is sequential (each release depends on
the buffer the cycles before left), so one warp runs the whole push: the
slots in shared memory, the held entries in their release order (ts,
seq, slot) in registers (up to 32 ranks a lane), so the least is a
broadcast and a cycle moves the ranks between a release and an insert by
one; the scalars (watermark, emission floor, arrival clock, drop count)
in registers, each 32 cycles' emissions stored at once, the drain a
prefix of the order.  Nothing is read back to the host.

* :func:`reorder_push` — one push: a cycle a tuple, then the drain of
  everything the gate has passed; emissions ``[N + capacity]``.
* :func:`reorder_flush` — the same launch with no input, every held tuple
  drained.

On CPU tensors each runs its plain version
(:func:`repro_torch.core.eventtime.reorder_push` / ``reorder_flush``).
"""
from __future__ import annotations

import torch

from repro_torch.core import eventtime as _eventtime
from repro_torch.kernels import _build
from repro_torch.kernels import common
from repro_torch.kernels.swag.kernel import _store_into
from repro_torch.obs import counters as _counters

#: the most slots the kernel's warp holds (32 ranks a lane, in registers)
MAX_REORDER_CAPACITY = 1024
#: the counters the reorder kernel counts: forced pops, depth mark
REORDER_COUNTERS = ("reorder_forced_pops", "reorder_depth_hwm")


def reorder_push_plain(spec, state, ts, groups, keys, *, n_valid=None,
                       drain_wm=None, inplace=False, counters=None):
    """Plain torch version of :func:`reorder_push`."""
    if counters is None:
        emit, new = _eventtime.reorder_push(
            spec, state, ts, groups, keys, n_valid=n_valid,
            drain_wm=drain_wm)
    else:
        emit, new, counted = _eventtime.reorder_push(
            spec, state, ts, groups, keys, n_valid=n_valid,
            drain_wm=drain_wm, counters=dict(counters))
        _counters.store_into(counters, counted)
    if inplace:
        _store_into(state, new)
        new = state
    return emit, new


def reorder_flush_plain(spec, state, *, inplace=False, counters=None):
    """Plain torch version of :func:`reorder_flush` (a flush has no cycle
    to count: ``counters`` only gains its missing keys)."""
    if counters is not None:
        common.counter_slots(counters, REORDER_COUNTERS, state.ts.device)
    emit, new = _eventtime.reorder_flush(spec, state)
    if inplace:
        _store_into(state, new)
        new = state
    return emit, new


def _check_state(spec, state) -> None:
    c = spec.capacity
    if c > MAX_REORDER_CAPACITY:
        raise ValueError(f"reorder kernel: capacity {c} exceeds the "
                         f"{MAX_REORDER_CAPACITY} slots one warp holds")
    for name in ("ts", "grp", "seq", "max_ts", "last_emit", "seq_clock",
                 "dropped"):
        t = getattr(state, name)
        if t.device.type != "cuda" or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"reorder kernel: state.{name} must be a "
                             f"contiguous int32 tensor on the card, got "
                             f"{t.dtype} on {t.device}")
    if state.val.dtype not in common.KEY_TYPES \
            or state.occ.dtype != torch.bool \
            or any(t.shape != (c,) for t in state[:5]) \
            or not (state.val.is_contiguous() and state.occ.is_contiguous()):
        raise ValueError(f"reorder kernel: [capacity] slots of int32 or "
                         f"float32 keys and a bool occupancy, got "
                         f"{state.val.dtype} / {state.occ.dtype} "
                         f"{tuple(state.val.shape)}")


def _empty_state(state, c: int):
    """A new buffer shaped as ``state``, from two allocations (the kernel
    writes every field)."""
    dev = state.ts.device
    words = torch.empty((4 * c + 4,), dtype=torch.int32, device=dev)
    ts, grp, val, seq, *scalars = words.split([c] * 4 + [1] * 4)
    return _eventtime.ReorderState(
        ts=ts, grp=grp, val=val.view(state.val.dtype), seq=seq,
        occ=torch.empty((c,), dtype=torch.bool, device=dev),
        **{name: x.view(()) for name, x in zip(
            ("max_ts", "last_emit", "seq_clock", "dropped"), scalars)})


def _launch(spec, state, ts, groups, keys, nvalid, drain_wm,
            drain_all: bool, inplace: bool, counters=None):
    c = spec.capacity
    dev = state.ts.device
    n = 0 if ts is None else ts.shape[0]
    new = state if inplace else _empty_state(state, c)
    words = torch.empty((3 * (n + c),), dtype=torch.int32, device=dev)
    flags = torch.empty((2 * (n + c),), dtype=torch.bool, device=dev)
    o_ts, o_g, o_k = words.split(n + c)
    out = _eventtime.ReorderEmit(o_ts, o_g, o_k.view(state.val.dtype),
                                 *flags.split(n + c))
    nv_host, nv_dev = n, None
    if isinstance(nvalid, torch.Tensor):
        nv_dev = nvalid.to(dev, torch.int32).reshape(())
    elif nvalid is not None:
        nv_host = min(max(int(nvalid), 0), n)
    drain = None if drain_wm is None else torch.as_tensor(
        drain_wm, dtype=torch.int32).to(dev).reshape(())
    c_forced = c_depth = None
    if counters is not None:
        c_forced, c_depth = common.counter_slots(counters, REORDER_COUNTERS,
                                                 dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_reorder(
            ptr(ts), ptr(groups), ptr(keys), n, nv_host, ptr(nv_dev),
            ptr(drain), int(drain_all), *(t.data_ptr() for t in state),
            *(t.data_ptr() for t in new), c, spec.max_lateness,
            *(t.data_ptr() for t in out), ptr(c_forced), ptr(c_depth),
            _build.stream_handle(dev))
    _build.check(err, "reorder")
    reorder_push.launches += 1
    return out, new


def reorder_push(spec, state, ts, groups, keys, *, n_valid=None,
                 drain_wm=None, inplace=False, counters=None):
    """One push of ``N`` tuples (``ts``, ``groups``, ``keys``; the first
    ``n_valid`` live) through the reorder buffer ``state`` (a
    :class:`repro_torch.core.eventtime.ReorderState`): a cycle a tuple,
    then the drain of every slot the gate has passed (``drain_wm``, else
    the watermark after the push).  Returns ``(ReorderEmit [N +
    capacity], state)``: ``state`` itself, updated where it lies, when
    ``inplace``, else an updated copy.  One launch; ``n_valid`` and
    ``drain_wm`` may be 0-d tensors on the card.

    ``counters`` (a :mod:`repro_torch.obs.counters` dict of 0-d int32
    tensors on the card): the kernel adds the pops a full buffer forced
    past the release gate to ``reorder_forced_pops`` and raises
    ``reorder_depth_hwm`` to the held entries after any cycle, where they
    lie (missing keys are added); nothing is read back.  ``None``: stats
    off, the launch counts nothing."""
    if ts.device.type == "cpu":
        return reorder_push_plain(spec, state, ts, groups, keys,
                                  n_valid=n_valid, drain_wm=drain_wm,
                                  inplace=inplace, counters=counters)
    _check_state(spec, state)
    n = ts.shape[-1]
    ts, groups = (torch.as_tensor(x).to(ts.device, torch.int32).contiguous()
                  for x in (ts, groups))
    keys = keys.to(state.val.dtype).contiguous()
    if ts.dim() != 1 or groups.shape != (n,) or keys.shape != (n,) \
            or keys.device != ts.device or ts.device != state.ts.device:
        raise ValueError(f"reorder_push takes three [N] columns on the "
                         f"buffer's card, got {tuple(ts.shape)}, "
                         f"{tuple(groups.shape)}, {tuple(keys.shape)}")
    return _launch(spec, state, ts, groups, keys, n_valid, drain_wm, False,
                   inplace, counters)


def reorder_flush(spec, state, *, inplace=False, counters=None):
    """Drain the buffer: every held tuple, sorted by (ts, seq), as one
    ``[capacity]`` emission batch, the buffer left empty — the launch of
    :func:`reorder_push` with no input and every slot released (so no
    cycle: ``counters`` only gains its missing keys)."""
    if state.ts.device.type == "cpu":
        return reorder_flush_plain(spec, state, inplace=inplace,
                                   counters=counters)
    _check_state(spec, state)
    return _launch(spec, state, None, None, None, None, None, True, inplace,
                   counters)


#: kernel launches since the count was last set to 0 (pushes and flushes)
reorder_push.launches = 0
