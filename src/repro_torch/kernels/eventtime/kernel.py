"""The bounded-lateness reorder buffer of an event-time stream, as one
CUDA kernel (``csrc/reorder.cu``).

No TPU kernel stands behind it: the JAX package runs the buffer as a
``lax.scan`` of its one-in, at-most-one-out cycle
(``src/repro/core/eventtime.py``, ``_reorder_cycle`` and
``_reorder_drain``).  The cycle is sequential (each release depends on
the buffer the cycles before left), so one warp runs the whole push: the
buffer's slots in shared memory, the scalars (watermark, emission floor,
arrival clock, drop count) in registers, the drain a bitonic sort of the
released slots.  Nothing is read back to the host.

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

#: the most slots the kernel's warp holds (32 a lane)
MAX_REORDER_CAPACITY = 1024


def reorder_push_plain(spec, state, ts, groups, keys, *, n_valid=None,
                       drain_wm=None, inplace=False):
    """Plain torch version of :func:`reorder_push`."""
    emit, new = _eventtime.reorder_push(
        spec, state, ts, groups, keys, n_valid=n_valid, drain_wm=drain_wm)
    if inplace:
        _store_into(state, new)
        new = state
    return emit, new


def reorder_flush_plain(spec, state, *, inplace=False):
    """Plain torch version of :func:`reorder_flush`."""
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


def _launch(spec, state, ts, groups, keys, nvalid, drain_wm,
            drain_all: bool, inplace: bool):
    c = spec.capacity
    dev = state.ts.device
    n = 0 if ts is None else ts.shape[0]
    if not inplace:
        state = _eventtime.ReorderState(*(x.clone() for x in state))
    out = _eventtime.ReorderEmit(
        ts=torch.empty((n + c,), dtype=torch.int32, device=dev),
        groups=torch.empty((n + c,), dtype=torch.int32, device=dev),
        keys=torch.empty((n + c,), dtype=state.val.dtype, device=dev),
        live=torch.empty((n + c,), dtype=torch.bool, device=dev),
        late=torch.empty((n + c,), dtype=torch.bool, device=dev))
    nv_host, nv_dev = n, None
    if isinstance(nvalid, torch.Tensor):
        nv_dev = nvalid.to(dev, torch.int32).reshape(())
    elif nvalid is not None:
        nv_host = min(max(int(nvalid), 0), n)
    drain = None if drain_wm is None else torch.as_tensor(
        drain_wm, dtype=torch.int32).to(dev).reshape(())

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_reorder(
            ptr(ts), ptr(groups), ptr(keys), n, nv_host, ptr(nv_dev),
            ptr(drain), int(drain_all),
            *(t.data_ptr() for t in state), c, spec.max_lateness,
            *(t.data_ptr() for t in out), _build.stream_handle(dev))
    _build.check(err, "reorder")
    reorder_push.launches += 1
    return out, state


def reorder_push(spec, state, ts, groups, keys, *, n_valid=None,
                 drain_wm=None, inplace=False):
    """One push of ``N`` tuples (``ts``, ``groups``, ``keys``; the first
    ``n_valid`` live) through the reorder buffer ``state`` (a
    :class:`repro_torch.core.eventtime.ReorderState`): a cycle a tuple,
    then the drain of every slot the gate has passed (``drain_wm``, else
    the watermark after the push).  Returns ``(ReorderEmit [N +
    capacity], state)``: ``state`` itself, updated where it lies, when
    ``inplace``, else an updated copy.  One launch; ``n_valid`` and
    ``drain_wm`` may be 0-d tensors on the card."""
    if ts.device.type == "cpu":
        return reorder_push_plain(spec, state, ts, groups, keys,
                                  n_valid=n_valid, drain_wm=drain_wm,
                                  inplace=inplace)
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
                   inplace)


def reorder_flush(spec, state, *, inplace=False):
    """Drain the buffer: every held tuple, sorted by (ts, seq), as one
    ``[capacity]`` emission batch, the buffer left empty — the launch of
    :func:`reorder_push` with no input and every slot released."""
    if state.ts.device.type == "cpu":
        return reorder_flush_plain(spec, state, inplace=inplace)
    _check_state(spec, state)
    return _launch(spec, state, None, None, None, None, None, True, inplace)


#: kernel launches since the count was last set to 0 (pushes and flushes)
reorder_push.launches = 0
