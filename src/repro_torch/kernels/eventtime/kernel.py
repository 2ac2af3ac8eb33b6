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
* :func:`reorder_push_sharded` / :func:`reorder_flush_sharded` — a
  sharded event-time stream's ``S`` stacked buffers (``[S, C]`` slots),
  all in one launch of ``S`` one-warp blocks, each on its row of the
  ``[S, L]`` tuples, under the merged watermark's gates; the counters
  summed (forced pops) and maxed (depth mark) over the blocks.

On CPU tensors each runs its plain version
(:func:`repro_torch.core.eventtime.reorder_push`, ``reorder_flush``,
``reorder_push_sharded``, ``reorder_flush_sharded``).
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


def _plain(fn, spec, state, *args, inplace=False, counters=None, **kw):
    """A plain version: ``fn`` (a push or a flush of
    :mod:`repro_torch.core.eventtime`) on ``state``, ``counters`` updated
    where they lie, ``state`` itself updated when ``inplace``."""
    if counters is None:
        emit, new = fn(spec, state, *args, **kw)
    else:
        emit, new, counted = fn(spec, state, *args, counters=dict(counters),
                                **kw)
        _counters.store_into(counters, counted)
    if inplace:
        _store_into(state, new)
        new = state
    return emit, new


def reorder_push_plain(spec, state, ts, groups, keys, *, n_valid=None,
                       release_wm=None, late_wm=None, drain_wm=None,
                       inplace=False, counters=None):
    """Plain torch version of :func:`reorder_push`."""
    return _plain(_eventtime.reorder_push, spec, state, ts, groups, keys,
                  n_valid=n_valid, release_wm=release_wm, late_wm=late_wm,
                  drain_wm=drain_wm, inplace=inplace, counters=counters)


def reorder_push_sharded_plain(spec, states, ts, groups, keys, *,
                               n_valid=None, release_wm=None, late_wm=None,
                               drain_wm=None, inplace=False, counters=None):
    """Plain torch version of :func:`reorder_push_sharded`: the plain push
    looped over the shards on a host copy."""
    return _plain(_eventtime.reorder_push_sharded, spec, states, ts, groups,
                  keys, n_valid=n_valid, release_wm=release_wm,
                  late_wm=late_wm, drain_wm=drain_wm, inplace=inplace,
                  counters=counters)


def _flush_plain(fn, spec, state, inplace, counters):
    """A plain flush: no cycle to count, so ``counters`` only gains its
    missing keys."""
    if counters is not None:
        common.counter_slots(counters, REORDER_COUNTERS, state.ts.device)
    return _plain(fn, spec, state, inplace=inplace)


def reorder_flush_plain(spec, state, *, inplace=False, counters=None):
    """Plain torch version of :func:`reorder_flush`."""
    return _flush_plain(_eventtime.reorder_flush, spec, state, inplace,
                        counters)


def reorder_flush_sharded_plain(spec, states, *, inplace=False,
                                counters=None):
    """Plain torch version of :func:`reorder_flush_sharded`."""
    return _flush_plain(_eventtime.reorder_flush_sharded, spec, states,
                        inplace, counters)


def _check_state(spec, state, shards=None) -> None:
    """``state``: one buffer (``shards`` None) or ``shards`` stacked."""
    c = spec.capacity
    lead = () if shards is None else (shards,)
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
            or any(t.shape != lead + (c,) for t in state[:5]) \
            or any(t.shape != lead for t in state[5:]) \
            or not (state.val.is_contiguous() and state.occ.is_contiguous()):
        raise ValueError(f"reorder kernel: {list(lead)} x [capacity] slots "
                         f"of int32 or float32 keys and a bool occupancy, "
                         f"got {state.val.dtype} / {state.occ.dtype} "
                         f"{tuple(state.val.shape)}")


def _empty_state(state, c: int):
    """New buffers shaped as ``state`` (one, or stacked), from two
    allocations (the kernel writes every field)."""
    dev = state.ts.device
    lead = tuple(state.ts.shape[:-1])
    m = 1 if not lead else lead[0]
    words = torch.empty((m * (4 * c + 4),), dtype=torch.int32, device=dev)
    ts, grp, val, seq, *scalars = words.split([m * c] * 4 + [m] * 4)
    return _eventtime.ReorderState(
        ts=ts.view(lead + (c,)), grp=grp.view(lead + (c,)),
        val=val.view(state.val.dtype).view(lead + (c,)),
        seq=seq.view(lead + (c,)),
        occ=torch.empty(lead + (c,), dtype=torch.bool, device=dev),
        **{name: x.view(lead) for name, x in zip(
            ("max_ts", "last_emit", "seq_clock", "dropped"), scalars)})


def _gate(x, dev):
    """A gate as a 0-d int32 tensor on ``dev`` (None stays None)."""
    return None if x is None else torch.as_tensor(
        x, dtype=torch.int32).to(dev).reshape(())


def _launch(spec, state, ts, groups, keys, nvalid, gates, drain_all: bool,
            inplace: bool, counters=None, shards=None):
    """One launch over one buffer (``shards`` None; [N] columns) or
    ``shards`` stacked ones ([S, L] columns, [S, L + C] emissions).
    ``gates``: (drain, release, late), each None or a value."""
    c = spec.capacity
    dev = state.ts.device
    m = 1 if shards is None else shards
    n = 0 if ts is None else ts.shape[-1]
    new = state if inplace else _empty_state(state, c)
    lead = () if shards is None else (shards,)
    width = m * (n + c)
    words = torch.empty((3 * width,), dtype=torch.int32, device=dev)
    flags = torch.empty((2 * width,), dtype=torch.bool, device=dev)
    o_ts, o_g, o_k = (x.view(lead + (n + c,)) for x in words.split(width))
    out = _eventtime.ReorderEmit(
        o_ts, o_g, o_k.view(state.val.dtype),
        *(x.view(lead + (n + c,)) for x in flags.split(width)))
    nv_host, nv_dev = m * n, None
    if isinstance(nvalid, torch.Tensor):
        nv_dev = nvalid.to(dev, torch.int32).reshape(())
    elif nvalid is not None:
        nv_host = min(max(int(nvalid), 0), m * n)
    drain, release, late = (_gate(x, dev) for x in gates)
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
            ptr(drain), ptr(release), ptr(late), int(drain_all), m,
            *(t.data_ptr() for t in state), *(t.data_ptr() for t in new), c,
            spec.max_lateness, *(t.data_ptr() for t in out), ptr(c_forced),
            ptr(c_depth), _build.stream_handle(dev))
    _build.check(err, "reorder")
    reorder_push.launches += 1
    return out, new


def _columns(state, ts, groups, keys, shape, what):
    """The push's three columns, int32 (keys in the buffer's dtype),
    contiguous on the buffer's card, of ``shape``."""
    dev = state.ts.device
    ts, groups = (torch.as_tensor(x).to(dev, torch.int32).contiguous()
                  for x in (ts, groups))
    keys = torch.as_tensor(keys).to(dev, state.val.dtype).contiguous()
    if ts.shape != shape or groups.shape != shape or keys.shape != shape:
        raise ValueError(f"{what} takes three {list(shape)} columns on the "
                         f"buffer's card, got {tuple(ts.shape)}, "
                         f"{tuple(groups.shape)}, {tuple(keys.shape)}")
    return ts, groups, keys


def reorder_push(spec, state, ts, groups, keys, *, n_valid=None,
                 release_wm=None, late_wm=None, drain_wm=None, inplace=False,
                 counters=None):
    """One push of ``N`` tuples (``ts``, ``groups``, ``keys``; the first
    ``n_valid`` live) through the reorder buffer ``state`` (a
    :class:`repro_torch.core.eventtime.ReorderState`): a cycle a tuple,
    then the drain of every slot the gate has passed (``drain_wm``, else
    ``release_wm``, else the watermark after the push).  ``release_wm``
    and ``late_wm`` replace the cycles' release gate and lateness floor
    (each None: the buffer's watermark), as
    :func:`repro_torch.core.eventtime.reorder_push` takes them.  Returns
    ``(ReorderEmit [N + capacity], state)``: ``state`` itself, updated
    where it lies, when ``inplace``, else an updated copy.  One launch;
    ``n_valid`` and the gates may be 0-d tensors on the card.

    ``counters`` (a :mod:`repro_torch.obs.counters` dict of 0-d int32
    tensors on the card): the kernel adds the pops a full buffer forced
    past the release gate to ``reorder_forced_pops`` and raises
    ``reorder_depth_hwm`` to the held entries after any cycle, where they
    lie (missing keys are added); nothing is read back.  ``None``: stats
    off, the launch counts nothing."""
    if ts.device.type == "cpu":
        return reorder_push_plain(spec, state, ts, groups, keys,
                                  n_valid=n_valid, release_wm=release_wm,
                                  late_wm=late_wm, drain_wm=drain_wm,
                                  inplace=inplace, counters=counters)
    _check_state(spec, state)
    if ts.dim() != 1:
        raise ValueError(f"reorder_push takes [N] columns, got "
                         f"{tuple(ts.shape)}")
    ts, groups, keys = _columns(state, ts, groups, keys, tuple(ts.shape),
                                "reorder_push")
    drain = drain_wm if drain_wm is not None else release_wm
    return _launch(spec, state, ts, groups, keys, n_valid,
                   (drain, release_wm, late_wm), False, inplace, counters)


def reorder_flush(spec, state, *, inplace=False, counters=None):
    """Drain the buffer: every held tuple, sorted by (ts, seq), as one
    ``[capacity]`` emission batch, the buffer left empty — the launch of
    :func:`reorder_push` with no input and every slot released (so no
    cycle: ``counters`` only gains its missing keys)."""
    if state.ts.device.type == "cpu":
        return reorder_flush_plain(spec, state, inplace=inplace,
                                   counters=counters)
    _check_state(spec, state)
    return _launch(spec, state, None, None, None, None, (None,) * 3, True,
                   inplace, counters)


def reorder_push_sharded(spec, states, ts, groups, keys, *, n_valid=None,
                         release_wm=None, late_wm=None, drain_wm=None,
                         inplace=False, counters=None):
    """One push of a sharded event-time stream through its ``S`` stacked
    buffers (``states``: every field with a leading ``[S]`` axis): row
    ``s`` of the ``[S, L]`` columns through buffer ``s``, live its first
    ``clip(n_valid - s L, 0, L)`` tuples (``n_valid`` counts the whole
    ``[S L]`` batch; the JAX package's split), every buffer under the
    same gates (:func:`reorder_push`'s).  Returns ``(ReorderEmit [S, L +
    capacity], states)``.  One launch of S one-warp blocks; the
    ``counters`` gain every shard's forced pops and the largest depth
    mark; nothing is read back."""
    if ts.device.type == "cpu":
        return reorder_push_sharded_plain(
            spec, states, ts, groups, keys, n_valid=n_valid,
            release_wm=release_wm, late_wm=late_wm, drain_wm=drain_wm,
            inplace=inplace, counters=counters)
    if ts.dim() != 2:
        raise ValueError(f"reorder_push_sharded takes [S, L] columns, got "
                         f"{tuple(ts.shape)}")
    shards = ts.shape[0]
    _check_state(spec, states, shards)
    ts, groups, keys = _columns(states, ts, groups, keys, tuple(ts.shape),
                                "reorder_push_sharded")
    drain = drain_wm if drain_wm is not None else release_wm
    return _launch(spec, states, ts, groups, keys, n_valid,
                   (drain, release_wm, late_wm), False, inplace, counters,
                   shards=shards)


def reorder_flush_sharded(spec, states, *, inplace=False, counters=None):
    """Drain every shard's buffer in one launch: ``(ReorderEmit [S,
    capacity], states)``, the buffers left empty (``counters`` only gains
    its missing keys)."""
    if states.ts.device.type == "cpu":
        return reorder_flush_sharded_plain(spec, states, inplace=inplace,
                                           counters=counters)
    shards = states.ts.shape[0]
    _check_state(spec, states, shards)
    return _launch(spec, states, None, None, None, None, (None,) * 3, True,
                   inplace, counters, shards=shards)


#: kernel launches since the count was last set to 0 (pushes and flushes)
reorder_push.launches = 0
