"""The fused sliding-window kernels: counterparts of the JAX package's
``swag_pallas``, ``sort_panes_pallas``, ``swag_pallas_panes``,
``pergroup_fused_pallas``, ``pergroup_replay_pallas`` and
``twostack_flip_pallas`` (``src/repro/kernels/swag/kernel.py``), plus the
per-group placement scan, which the JAX package leaves to an XLA
``lax.scan``.

* :func:`swag` — one row per window: sort by (group, key), then every
  requested op's tail (one shared compaction; the lower median rides along).
* :func:`sort_panes` — sort each WA-lane pane once.
* :func:`swag_panes` — window ``i`` merges the presorted panes
  ``i .. i+P-1`` instead of re-sorting, then the same tails.
* :func:`pergroup_scan` — the per-tuple pane-store placement over a
  stream's WA chunks (optionally keeping the ring buffers; for a
  streaming push, every tuple and only the store it leaves).
* :func:`pergroup_scan_time` — the same for a time-mode store: a reorder
  buffer's emission placed by time pane, panes retired by watermark.
* :func:`pergroup_fused` — per chunk: the per-group partial aggregates of
  the ring as the chunk's writes leave it (the chunks in parallel).
* :func:`pergroup_replay_ring` — per evaluation and live group: the
  DIRECT_OPS of the group's window, read straight from the placement
  scan's ring snapshots (a time-mode store's at an evaluation time).
* :func:`pergroup_replay` — per gathered replay row: the live lanes'
  DIRECT_OPS.
* :func:`twostack_flip` — per epoch row of a two-stack time-window batch:
  the front region's suffix scan and the back region's prefix scan.

Each wrapper launches ``csrc/swag.cu``, ``csrc/pergroup.cu`` or
``csrc/twostack.cu`` on CUDA
tensors and runs the plain torch version beside it (``*_plain``) on CPU
tensors.  The window kernels' outputs follow the TPU kernels: ``og [NW,
WS]`` (PAD_GROUP tail), ``{op: ov [NW, WS]}`` (zero tail), ``oc [NW]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import panestore as _panestore
from repro_torch.core.combiners import get_combiner, out_dtype
from repro_torch.core.engine import PAD_GROUP
from repro_torch.kernels import _build
from repro_torch.kernels import common

INT32_MIN = torch.iinfo(torch.int32).min
#: the longest row the CUDA kernels take: a row of (int32 group, 4-byte
#: key) pairs must fit one block's shared memory (csrc/tile.cuh, MAX_ROW)
MAX_ROW = 16384
#: dynamic shared memory a block may use (csrc/pergroup.cu, SMEM_BUDGET)
SMEM_BUDGET = 227 * 1024 - 256


def _resolve_ops(ops) -> dict:
    """op name(s) -> {name: Combiner | None}; ``None`` marks median."""
    if isinstance(ops, str):
        ops = (ops,)
    return {op: (None if op == "median" else get_combiner(op)) for op in ops}


def _median_in_tile(g, k):
    """Lower median per group over closed, (group, key)-sorted rows."""
    starts = g != common._shift_right(g, 1, INT32_MIN)
    ends = g != common._shift_left(g, 1, INT32_MIN)
    count = get_combiner("count")
    ranks = common.tile_segmented_scan(starts, count.lift(k), count)
    card_at_end = torch.where(ends, ranks, 0)
    # broadcast each run's cardinality backwards: reversed max-scan
    g_rev = torch.flip(g, dims=(-1,))
    starts_rev = g_rev != common._shift_right(g_rev, 1, INT32_MIN)
    card = torch.flip(common.tile_segmented_scan(
        starts_rev, torch.flip(card_at_end, dims=(-1,)), get_combiner("max")),
        dims=(-1,))
    emit = ((ranks - 1) == (card - 1) // 2) & (g != PAD_GROUP)
    (cg, cv), cnt = common.butterfly_compact(emit, (g, k), (PAD_GROUP, 0))
    return cg, cv, cnt


def _multi_tails_in_tile(g, k, combiners: dict):
    """All requested tails over closed, sorted rows: one segment structure,
    one compaction shared by every non-median op.  The median's own
    compaction supplies the layout only when no other op is present.
    Returns ``(cg, {name: cv}, cnt [..., 1])``."""
    starts = g != common._shift_right(g, 1, INT32_MIN)
    ends = g != common._shift_left(g, 1, INT32_MIN)
    vals, names = [], []
    for name, comb in combiners.items():
        if comb is None:
            continue
        scanned = common.tile_segmented_scan(starts, comb.lift(k), comb)
        vals.append(comb.finalize(scanned))
        names.append(name)
    out = {}
    cg = cnt = None
    if names:
        emit = ends & (g != PAD_GROUP)
        compacted, cnt = common.butterfly_compact(
            emit, (g, *vals), (PAD_GROUP,) + (0,) * len(vals))
        cg = compacted[0]
        out.update(zip(names, compacted[1:]))
    if None in combiners.values():
        mg, mv, mcnt = _median_in_tile(g, k)
        out[next(n for n, c in combiners.items() if c is None)] = mv
        if cg is None:
            cg, cnt = mg, mcnt
    return cg, out, cnt


def _tails(g, k, ops):
    combiners = _resolve_ops(ops)
    cg, vals, cnt = _multi_tails_in_tile(g, k, combiners)
    return cg, {name: vals[name] for name in combiners}, cnt[..., 0]


def swag_plain(frames_g, frames_k, ops):
    """Plain torch version of :func:`swag`."""
    g, k = common.bitonic_sort_tile((frames_g, frames_k), num_keys=2)
    return _tails(g, k, ops)


def sort_panes_plain(panes_g, panes_k):
    """Plain torch version of :func:`sort_panes`."""
    return common.bitonic_sort_tile((panes_g, panes_k), num_keys=2)


def _pane_rows(panes, p: int):
    """[NP, WA] -> [NW, P*WA]: row i = panes i .. i+P-1 back to back."""
    np_, wa = panes.shape
    return panes.reshape(-1).unfold(0, p * wa, wa)[:np_ - p + 1]


def swag_panes_plain(panes_g, panes_k, ops, *, p: int):
    """Plain torch version of :func:`swag_panes`."""
    wa = panes_g.shape[-1]
    g, k = common.bitonic_merge_tile(
        (_pane_rows(panes_g, p), _pane_rows(panes_k, p)), num_keys=2, run=wa)
    return _tails(g, k, ops)


def _check_rows(name: str, g: torch.Tensor, k: torch.Tensor) -> None:
    if g.dim() != 2:
        raise ValueError(f"{name} takes [rows, lanes] tensors, got "
                         f"{tuple(g.shape)}")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {g.device}")
    if not common.is_pow2(g.shape[1]):
        raise ValueError(f"{name} needs power-of-two rows, got "
                         f"{g.shape[1]} lanes")
    if g.device.type == "cuda":
        common.check_kernel_inputs(name, g, k)
        if g.shape[1] > MAX_ROW:
            raise ValueError(
                f"{name}: a row of {g.shape[1]} lanes does not fit one "
                f"block's shared memory; the CUDA kernel takes rows of at "
                f"most {MAX_ROW} (int32 group, key) pairs")
        if g.stride(0) != k.stride(0):
            raise ValueError(f"{name}: groups and keys rows differ in stride")


def _launch_rows(name, g, k, ops, *, nrows: int, width: int, run: int):
    """Run rt_swag_rows over ``nrows`` rows of ``width`` lanes starting at
    ``g``/``k`` with their row stride."""
    dev = g.device
    names = tuple(_resolve_ops(ops))
    og = torch.empty((nrows, width), dtype=torch.int32, device=dev)
    oc = torch.empty((nrows,), dtype=torch.int32, device=dev)
    ovs = {n: torch.empty((nrows, width), dtype=out_dtype(n, k.dtype),
                          device=dev) for n in names}
    codes = (ctypes.c_int * len(names))(*(common.OP_CODES[n] for n in names))
    outs = (ctypes.c_void_p * len(names))(*(v.data_ptr()
                                            for v in ovs.values()))
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_swag_rows(
            g.data_ptr(), k.data_ptr(), common.KEY_TYPES[k.dtype],
            g.stride(0), nrows, width, run, codes, outs, len(names),
            og.data_ptr(), oc.data_ptr(), _build.stream_handle(dev))
    _build.check(err, name)
    return og, ovs, oc


def swag_geometry(width: int) -> dict:
    """The launch shape of :func:`swag` and :func:`swag_panes` for rows of
    ``width`` lanes, as the CUDA library chooses it: lanes a thread,
    threads a block and dynamic shared memory a block (bytes)."""
    lanes, threads, smem = ctypes.c_int(), ctypes.c_int(), \
        ctypes.c_longlong()
    _build.check(_build.library().rt_swag_geometry(
        width, ctypes.byref(lanes), ctypes.byref(threads),
        ctypes.byref(smem)), "swag_geometry")
    return {"lanes_per_thread": lanes.value, "threads": threads.value,
            "smem_bytes": smem.value}


def swag(frames_g: torch.Tensor, frames_k: torch.Tensor, ops):
    """``frames_*``: ``[NW, WS]`` window rows, WS a power of two; rows may
    be a strided view of the stream (``unfold``) as long as each row is
    contiguous.  Returns ``(og, {name: ov}, oc)``."""
    _check_rows("swag", frames_g, frames_k)
    if frames_g.device.type == "cpu":
        return swag_plain(frames_g, frames_k, ops)
    nw, ws = frames_g.shape
    if nw == 0:
        raise ValueError("swag: no window rows to launch over")
    out = _launch_rows("swag", frames_g, frames_k, ops, nrows=nw, width=ws,
                       run=1)
    swag.launches += 1
    return out


def sort_panes(panes_g: torch.Tensor, panes_k: torch.Tensor):
    """Sort each ``[NP, WA]`` pane row once by (group, key)."""
    _check_rows("sort_panes", panes_g, panes_k)
    if panes_g.device.type == "cpu":
        return sort_panes_plain(panes_g, panes_k)
    if not (panes_g.is_contiguous() and panes_k.is_contiguous()):
        raise ValueError("sort_panes takes contiguous [NP, WA] panes")
    np_, wa = panes_g.shape
    if np_ == 0:
        raise ValueError("sort_panes: no pane rows to launch over")
    dev = panes_g.device
    og = torch.empty_like(panes_g)
    ok = torch.empty_like(panes_k)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_sort_rows(
            panes_g.data_ptr(), panes_k.data_ptr(),
            common.KEY_TYPES[panes_k.dtype], np_, wa, og.data_ptr(),
            ok.data_ptr(), _build.stream_handle(dev))
    _build.check(err, "sort_panes")
    sort_panes.launches += 1
    return og, ok


def swag_panes(panes_g: torch.Tensor, panes_k: torch.Tensor, ops, *,
               p: int):
    """Window pass over presorted ``[NP, WA]`` panes: window ``i`` merges
    pane rows ``i .. i+p-1``.  Returns ``(og [NW, p*WA], {name: ov}, oc)``
    with ``NW = NP - p + 1``."""
    _check_rows("swag_panes", panes_g, panes_k)
    np_, wa = panes_g.shape
    if p < 1 or not common.is_pow2(p) or np_ < p:
        raise ValueError(f"swag_panes needs a power-of-two P <= NP, got "
                         f"P={p} NP={np_}")
    if panes_g.device.type == "cpu":
        return swag_panes_plain(panes_g, panes_k, ops, p=p)
    if not (panes_g.is_contiguous() and panes_k.is_contiguous()):
        raise ValueError("swag_panes takes contiguous [NP, WA] panes")
    if p * wa > MAX_ROW:
        raise ValueError(f"swag_panes: a window of {p * wa} lanes exceeds "
                         f"the kernel's {MAX_ROW}-lane row")
    # window i starts at pane i: rows of P*WA lanes at a stride of WA
    rows_g = panes_g.reshape(-1).as_strided((np_ - p + 1, p * wa), (wa, 1))
    rows_k = panes_k.reshape(-1).as_strided((np_ - p + 1, p * wa), (wa, 1))
    out = _launch_rows("swag_panes", rows_g, rows_k, ops,
                       nrows=np_ - p + 1, width=p * wa, run=wa)
    swag_panes.launches += 1
    return out


# ------------------------------------------------- two-stack time windows

#: the widest epoch row the two-stack kernel takes: its front and back
#: exchange rows, double-buffered in shared memory, and the row's staged
#: keys and masks take 26 bytes a lane (csrc/twostack.cu, MAX_WCAP)
MAX_WCAP = 8192
#: the ops the two-stack flip scans (single-tensor monoid states)
TWOSTACK_OPS = ("sum", "count", "min", "max")


def twostack_geometry(wcap: int) -> dict:
    """The launch shape of :func:`twostack_flip` for epoch rows of ``wcap``
    lanes, as the CUDA library chooses it: lanes a thread, threads a block
    and dynamic shared memory a block (bytes)."""
    lanes, threads, smem = ctypes.c_int(), ctypes.c_int(), \
        ctypes.c_longlong()
    _build.check(_build.library().rt_twostack_geometry(
        wcap, ctypes.byref(lanes), ctypes.byref(threads),
        ctypes.byref(smem)), "twostack_geometry")
    return {"lanes_per_thread": lanes.value, "threads": threads.value,
            "smem_bytes": smem.value}


def twostack_flip_plain(kf, vf, kb, vb, names):
    """Plain torch version of :func:`twostack_flip`."""
    from repro_torch.core.twostack import flip_scans

    return flip_scans(kf, vf, kb, vb, tuple(names), kf.dtype)


def twostack_flip(kf: torch.Tensor, vf: torch.Tensor, kb: torch.Tensor,
                  vb: torch.Tensor, names):
    """The flip of the two-stack over ``[NE, wcap]`` epoch regions: per op,
    the inclusive suffix scan of the front keys ``kf`` and the inclusive
    prefix scan of the back keys ``kb``, lanes where the bool masks
    ``vf``/``vb`` are False pinned to the op's identity.  Returns ``{name:
    (front_suffix, back_prefix)}`` in each op's state dtype (``count`` is
    int32 for any key)."""
    names = (names,) if isinstance(names, str) else tuple(names)
    if kf.device.type == "cpu":
        return twostack_flip_plain(kf, vf, kb, vb, names)
    bad = [nm for nm in names if nm not in TWOSTACK_OPS]
    if bad:
        raise ValueError(f"twostack_flip scans {list(TWOSTACK_OPS)}, not "
                         f"{bad}")
    if kf.dim() != 2 or any(t.shape != kf.shape for t in (vf, kb, vb)):
        raise ValueError(f"twostack_flip takes four [NE, wcap] tensors, got "
                         f"{[tuple(t.shape) for t in (kf, vf, kb, vb)]}")
    ne, wcap = kf.shape
    if ne == 0 or not common.is_pow2(wcap):
        raise ValueError(f"twostack_flip needs at least one epoch row of "
                         f"power-of-two width, got {tuple(kf.shape)}")
    if wcap > MAX_WCAP:
        raise ValueError(
            f"twostack_flip: an epoch row of {wcap} lanes does not fit one "
            f"block's shared memory; the CUDA kernel takes rows of at most "
            f"{MAX_WCAP} lanes")
    if kf.dtype not in common.KEY_TYPES or kb.dtype != kf.dtype \
            or vf.dtype != torch.bool or vb.dtype != torch.bool:
        raise TypeError(f"twostack_flip: int32 or float32 keys and bool "
                        f"masks, got {kf.dtype}/{kb.dtype} and "
                        f"{vf.dtype}/{vb.dtype}")
    kf, vf, kb, vb = (t.contiguous() for t in (kf, vf, kb, vb))
    dev = kf.device
    outs = {nm: tuple(torch.empty((ne, wcap), dtype=out_dtype(nm, kf.dtype),
                                  device=dev) for _ in range(2))
            for nm in names}
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_twostack_flip(
            kf.data_ptr(), vf.data_ptr(), kb.data_ptr(), vb.data_ptr(),
            common.KEY_TYPES[kf.dtype], ne, wcap, _codes(names),
            _ptrs([t for pair in outs.values() for t in pair]), len(names),
            _build.stream_handle(dev))
    _build.check(err, "twostack_flip")
    twostack_flip.launches += 1
    return outs


# ------------------------------------------------------ per-group windows

def _codes(names):
    return (ctypes.c_int * len(names))(*(common.OP_CODES[n] for n in names))


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _cuda_int32(name: str, **tensors) -> None:
    for what, t in tensors.items():
        if t.device.type != "cuda" or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous int32 "
                             f"tensor on the card, got {t.dtype} on "
                             f"{t.device}")


def _store_into(state, new) -> None:
    """Copy the store ``new`` into the tensors of ``state``."""
    for dst, src in zip(state, new):
        if dst is not src:
            dst.copy_(src)


def pergroup_scan_plain(spec, state, groups, keys=None, *, push=False,
                        inplace=False):
    """Plain torch version of :func:`pergroup_scan`: the per-tuple loop."""
    trace = _panestore.scan(spec, state, groups, keys, push=push)
    if inplace:
        _store_into(state, trace.final)
        trace = trace._replace(final=state)
    return trace


#: the scan keeps its group tables in shared memory up to this many groups,
#: in device memory beyond (csrc/pergroup.cu, GROUP_SMEM_MAX)
SCAN_GROUP_SMEM_MAX = 4096


def _scan_groups(spec, state, groups: torch.Tensor):
    """The placement scan kernel's view of a stream and a store: a dense
    index over the ids of the stream and of the store's live owners, and
    each group's panes as a chain in base order.  Returns ``(gidx [N], ids
    [G], slots [5, C], gtab [3, G])``, all int32: each tuple's index; the
    id of each index (ascending); per slot its owner's index (-1: free),
    count, base, stamp and the next pane of its group (-1: none); per group
    its newest and oldest pane (-1: none) and its window.  Reads one pair
    of numbers back to the host (the count of ids and the largest)."""
    n, c = groups.shape[0], state.owner.shape[0]
    dev = groups.device
    free = state.owner == PAD_GROUP
    every = torch.cat([groups, torch.where(free, groups[:1], state.owner)])
    srt, order = torch.sort(every)
    new = torch.ones_like(srt, dtype=torch.bool)
    new[1:] = srt[1:] != srt[:-1]
    rank = torch.cumsum(new, 0, dtype=torch.int32) - 1
    ng, top = torch.stack([rank[-1] + 1, srt[-1]]).tolist()
    if top == PAD_GROUP:
        raise ValueError(f"pergroup_scan: group id {PAD_GROUP} marks a free "
                         f"slot and cannot be a tuple's group")
    inv = torch.empty_like(rank).scatter_(0, order, rank)
    # equal ids scatter to one index with one value
    ids = torch.empty_like(srt).scatter_(0, rank.long(), srt)[:ng]
    own = torch.where(free, -1, inv[n:])
    by_base = torch.sort(state.base, stable=True).indices
    order = by_base[torch.sort(own[by_base], stable=True).indices]
    od = own[order]
    step = od[1:] != od[:-1]
    true = torch.ones((1,), dtype=torch.bool, device=dev)
    first = (od >= 0) & torch.cat([true, step])
    last = (od >= 0) & torch.cat([step, true])
    order32 = order.to(torch.int32)
    nxt = torch.full((c,), -1, dtype=torch.int32, device=dev)
    nxt[order[:-1]] = torch.where(last[:-1] | (od[:-1] < 0), -1,
                                  order32[1:])
    # free slots scatter into a dropped column
    gtab = torch.full((3, ng + 1), -1, dtype=torch.int32, device=dev)
    gtab[0].scatter_(0, torch.where(last, od, ng).long(), order32)
    gtab[1].scatter_(0, torch.where(first, od, ng).long(), order32)
    gtab[2, :ng] = spec.ws_of(ids)
    slots = torch.stack([own, state.count, state.base, state.stamp, nxt])
    return (inv[:n].contiguous(), ids, slots.to(torch.int32).contiguous(),
            gtab[:, :ng].contiguous())


def pergroup_scan(spec, state, groups: torch.Tensor,
                  keys: torch.Tensor | None = None, *, push: bool = False,
                  inplace: bool = False):
    """Place the ``N // WA`` full chunks of ``groups`` into the pane
    store ``state`` (a :class:`repro_torch.core.panestore.PaneStoreState`
    the scan or a push made, or an empty one), in one warp, 32 tuples at a
    time where no pane is allocated or retired.  With ``keys`` the ring
    buffers are kept too.  Returns a
    :class:`repro_torch.core.panestore.ScanTrace` (without arrival ranks).
    A streaming ``push`` places every tuple (the last chunk may be short)
    and records only the store after the last (no plan, no store after
    every chunk).  ``state`` is not modified, unless ``inplace``: then the
    kernel updates its ring and clock where they lie, its directory is
    copied in, and the trace's ``final`` is ``state``.  One host sync (:func:`_scan_groups`).  The
    kernel's batches, and how many of them placed all their tuples at
    once, are left in ``pergroup_scan.batch_stats`` ([2] int32 on the
    card)."""
    if groups.device.type == "cpu":
        return pergroup_scan_plain(spec, state, groups, keys, push=push,
                                   inplace=inplace)
    wa, c = spec.wa, spec.capacity
    n = groups.shape[-1] if push else groups.shape[-1] // wa * wa
    ne = -(-n // wa)
    _cuda_int32("pergroup_scan", groups=groups, owner=state.owner,
                count=state.count, base=state.base, stamp=state.stamp,
                clock=state.clock)
    if groups.dim() != 1 or n == 0:
        raise ValueError(f"pergroup_scan takes a [N] stream of at least "
                         f"{1 if push else wa} tuples, got "
                         f"{tuple(groups.shape)}")
    if keys is not None and (keys.dtype != state.keys.dtype
                             or keys.dtype not in common.KEY_TYPES
                             or keys.device != groups.device
                             or keys.shape != groups.shape
                             or not keys.is_contiguous()):
        raise ValueError(f"pergroup_scan: keys must be contiguous int32 or "
                         f"float32 of the store's dtype on the card, one a "
                         f"tuple, got {keys.dtype} {tuple(keys.shape)} "
                         f"(store {state.keys.dtype})")
    ring = keys is not None
    if inplace and ring:
        _cuda_int32("pergroup_scan", seqs=state.seqs)
        if not state.keys.is_contiguous():
            raise ValueError("pergroup_scan: an in-place ring must be "
                             "contiguous")
    dev = groups.device
    kt = state.keys.dtype
    gidx, ids, slots0, gtab = _scan_groups(spec, state, groups[:n])
    direc = torch.empty((4, c), dtype=torch.int32, device=dev)
    clock = state.clock.reshape(1)
    if not inplace:
        clock = clock.clone()
    ring_k = ring_s = None
    if ring:
        ring_k = state.keys if inplace else state.keys.contiguous().clone()
        ring_s = state.seqs if inplace else \
            state.seqs.to(torch.int32).contiguous().clone()
    plan = snaps = clock_s = rk_s = rs_s = None
    if not push:
        plan = torch.empty((3, ne, wa), dtype=torch.int32, device=dev)
        snaps = torch.empty((4, ne, c), dtype=torch.int32, device=dev)
        clock_s = torch.empty((ne,), dtype=torch.int32, device=dev)
        if ring:
            rk_s = torch.empty((ne, c, wa), dtype=kt, device=dev)
            rs_s = torch.empty((ne, c, wa), dtype=torch.int32, device=dev)
    events = torch.empty((2,), dtype=torch.int32, device=dev)
    stats = torch.empty((2,), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_pergroup_scan(
            gidx.data_ptr(), ptr(keys), common.KEY_TYPES[kt] if ring else 0,
            n, wa, c, ids.shape[0], ids.data_ptr(), slots0.data_ptr(),
            gtab.data_ptr(), direc.data_ptr(), clock.data_ptr(), ptr(ring_k),
            ptr(ring_s), ptr(plan), ptr(snaps), ptr(clock_s), ptr(rk_s),
            ptr(rs_s), events.data_ptr(), stats.data_ptr(),
            _build.stream_handle(dev))
    _build.check(err, "pergroup_scan")
    pergroup_scan.launches += 1
    pergroup_scan.batch_stats = stats
    final = _panestore.PaneStoreState(
        owner=direc[0], keys=ring_k if ring else state.keys,
        seqs=ring_s if ring else state.seqs, count=direc[1], base=direc[2],
        stamp=direc[3], clock=clock[0])
    if inplace:
        _store_into(state, final)
        final = state
    if push:
        return _panestore.ScanTrace(None, None, None, None, None, final,
                                    None, events)
    states = _panestore.PaneStoreState(
        owner=snaps[0], keys=rk_s, seqs=rs_s, count=snaps[1], base=snaps[2],
        stamp=snaps[3], clock=clock_s)
    return _panestore.ScanTrace(plan[0], plan[1], plan[2], states, None,
                                final, None, events)


def time_scan_smem(c: int, wa: int) -> int:
    """Shared memory that :func:`pergroup_scan_time`'s block needs (bytes):
    the ``[C]`` owner, count, base and stamp columns, and for ``wa`` > 32
    one close-sort buffer of ``wa`` (key, timestamp, lane) triples
    (csrc/pergroup.cu, ``time_scan_smem``).  Its index and bitmaps
    (:func:`time_aux_bytes`) join them when they fit, else lie in device
    memory."""
    return 16 * c + (12 * wa if wa > 32 else 0)


def time_aux_bytes(c: int) -> int:
    """Bytes of :func:`pergroup_scan_time`'s pane index (16 an entry, at
    least ``2 C`` entries), its free and closed-pane bitmaps, its list of
    the panes to sort and a word a slot for a batch's lanes of each pane
    (csrc/pergroup.cu, ``time_aux_bytes``)."""
    h = 1
    while h < 2 * c:
        h <<= 1
    return 16 * h + 4 * (2 * ((c + 31) // 32) + 2 * c)


def pergroup_scan_time_plain(spec, state, groups, keys, ts, live,
                             retire_below=None, *, inplace=False):
    """Plain torch version of :func:`pergroup_scan_time`: the per-tuple
    loop of :func:`repro_torch.core.panestore.push_time`."""
    final, events = _panestore.push_time_events(spec, state, groups, keys,
                                                ts, live, retire_below)
    if inplace:
        _store_into(state, final)
        final = state
    return final, events


def pergroup_scan_time(spec, state, groups: torch.Tensor,
                       keys: torch.Tensor, ts: torch.Tensor,
                       live: torch.Tensor, retire_below=None, *,
                       inplace: bool = False):
    """Place ``N`` timestamped tuples (a reorder buffer's emission: the
    lanes ``live`` marks, in order) into the time-mode pane store
    ``state``: each into its (group, ``ts // slide``) slot with room, else
    the first free slot, else the globally oldest (evicted); a pane sorted
    once when it fills; then every pane wholly below ``retire_below`` (a
    0-d int32 tensor, or None: no retirement) retired, on every lane as
    the JAX package's scan does.  Returns ``(state, events [2])`` (the
    evictions and retirements): ``state`` itself, updated where it lies,
    when ``inplace``, else an updated copy.  One launch (one warp places,
    seven more build its pane index and sort the panes that close);
    nothing read back."""
    if groups.device.type == "cpu":
        return pergroup_scan_time_plain(spec, state, groups, keys, ts, live,
                                        retire_below, inplace=inplace)
    if not spec.is_time:
        raise ValueError("pergroup_scan_time places time-mode panes; a "
                         "count-mode store takes pergroup_scan")
    wa, c = spec.wa, spec.capacity
    n = groups.shape[-1]
    dev = groups.device
    _cuda_int32("pergroup_scan_time", groups=groups, ts=ts,
                owner=state.owner, count=state.count, base=state.base,
                stamp=state.stamp, clock=state.clock, seqs=state.seqs)
    if groups.dim() != 1 or ts.shape != (n,) or keys.shape != (n,) \
            or live.shape != (n,) or live.dtype != torch.bool \
            or keys.dtype != state.keys.dtype \
            or keys.dtype not in common.KEY_TYPES \
            or not (keys.is_contiguous() and live.is_contiguous()
                    and state.keys.is_contiguous()) \
            or state.keys.shape != (c, wa):
        raise ValueError(f"pergroup_scan_time takes [N] contiguous groups, "
                         f"keys of the store's dtype, int32 timestamps and "
                         f"a bool live mask, got {tuple(groups.shape)} "
                         f"{keys.dtype} {tuple(keys.shape)} "
                         f"{tuple(ts.shape)} {live.dtype}")
    if time_scan_smem(c, wa) > SMEM_BUDGET:
        raise ValueError(f"pergroup_scan_time: the directory of {c} slots "
                         f"and a {wa}-lane sort buffer do not fit one "
                         f"block's shared memory")
    if not inplace:
        state = _panestore.PaneStoreState(*(x.clone() for x in state))
    rb = None
    if retire_below is not None:
        rb = torch.as_tensor(retire_below, dtype=torch.int32).to(
            dev).reshape(())
    aux = None
    if time_scan_smem(c, wa) + time_aux_bytes(c) > SMEM_BUDGET:
        aux = torch.empty((time_aux_bytes(c),), dtype=torch.uint8,
                          device=dev)
    return state, time_scan_launch(spec, state, groups, keys, ts, live, rb,
                                   aux=aux)


def time_scan_launch(spec, state, groups, keys, ts, live, rb, *, aux=None):
    """The launch of :func:`pergroup_scan_time` alone, on ``state`` where
    it lies, ``rb`` a 0-d int32 device tensor or None: the events ``[2]``.
    ``aux``: device memory of :func:`time_aux_bytes` bytes for the pane
    index and bitmaps, or None: they join the directory in shared memory
    (the wrapper passes device memory only where they do not fit)."""
    dev = groups.device
    events = torch.empty((2,), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_pergroup_scan_time(
            groups.data_ptr(), keys.data_ptr(), ts.data_ptr(),
            live.data_ptr(), groups.shape[-1],
            None if rb is None else rb.data_ptr(),
            common.KEY_TYPES[keys.dtype], spec.wa, spec.capacity,
            spec.slide, state.owner.data_ptr(), state.count.data_ptr(),
            state.base.data_ptr(), state.stamp.data_ptr(),
            state.clock.data_ptr(), state.keys.data_ptr(),
            state.seqs.data_ptr(), events.data_ptr(),
            None if aux is None else aux.data_ptr(),
            _build.stream_handle(dev))
    _build.check(err, "pergroup_scan_time")
    pergroup_scan_time.launches += 1
    return events


def _last_writes(slots: torch.Tensor, lanes: torch.Tensor, wa: int):
    """``[NE, WA]``: True where no later tuple of the chunk writes the same
    (slot, lane) — the writes that survive the chunk's in-order loop."""
    code = slots.to(torch.int64) * wa + lanes
    later = torch.triu(torch.ones((wa, wa), dtype=torch.bool,
                                  device=slots.device), diagonal=1)
    return ~((code[:, :, None] == code[:, None, :]) & later).any(-1)


def pergroup_fused_plain(chunk_keys, slots, lanes, seqs, own_s, cnt_s, lo_s,
                         sortmask, ugroups, ops):
    """Plain torch version of :func:`pergroup_fused`, chunk by chunk."""
    ne, wa = chunk_keys.shape
    c = own_s.shape[1]
    dev = chunk_keys.device
    names = tuple(ops)
    kk = torch.zeros((c * wa + 1,), dtype=chunk_keys.dtype, device=dev)
    ss = torch.zeros((c * wa + 1,), dtype=torch.int32, device=dev)
    keep = _last_writes(slots, lanes, wa)
    dest = torch.where(keep, slots.to(torch.int64) * wa + lanes, c * wa)
    lane_ids = torch.arange(wa, device=dev)[None, :]
    outs = {nm: torch.empty((ne, c), dtype=out_dtype(
        nm, chunk_keys.dtype), device=dev) for nm in names}
    for e in range(ne):
        kk.scatter_(0, dest[e], chunk_keys[e])
        ss.scatter_(0, dest[e], seqs[e].to(torch.int32))
        k2, s2 = kk[:-1].view(c, wa), ss[:-1].view(c, wa)
        # the closing rows, sorted by (key, seq)
        o1 = torch.sort(s2, dim=-1, stable=True).indices
        k1, s1 = torch.gather(k2, -1, o1), torch.gather(s2, -1, o1)
        o2 = torch.sort(k1, dim=-1, stable=True).indices
        closing = (sortmask[e] != 0)[:, None]
        k2.copy_(torch.where(closing, torch.gather(k1, -1, o2), k2))
        s2.copy_(torch.where(closing, torch.gather(s1, -1, o2), s2))
        owner = own_s[e]
        occ = owner != PAD_GROUP
        live = (occ[:, None] & (lane_ids < cnt_s[e][:, None])
                & (s2 >= lo_s[e][:, None]))
        ug = ugroups[e]
        rows = ((ug[:, None] == owner[None, :]) & occ[None, :]
                & (ug[:, None] != PAD_GROUP))
        for nm, v in _panestore._partials_per_row(k2, live, rows,
                                                  names).items():
            outs[nm][e] = v
    return outs


def _writes_by_slot(chunk_keys, slots, seqs, c: int):
    """The fused kernel's view of a write plan: the keys and seqs of the
    ``[NE, WA]`` writes grouped by slot (stable, so stream order within a
    slot), where each slot's writes begin ``[C]``, and for every (chunk,
    slot) one past the slot's last write at or before the chunk ``[NE,
    C]`` (binary searches of (slot, stream index) in the grouped order)."""
    ne, wa = slots.shape
    n = ne * wa
    dev = slots.device
    by_slot, order = torch.sort(slots.reshape(-1), stable=True)
    key = by_slot.to(torch.int64) * n + order  # ascending
    first = torch.arange(c, device=dev, dtype=torch.int64) * n
    ends = first[None, :] + wa * torch.arange(
        1, ne + 1, device=dev, dtype=torch.int64)[:, None]
    return (chunk_keys.reshape(-1)[order], seqs.reshape(-1)[order],
            torch.searchsorted(key, first).to(torch.int32),
            torch.searchsorted(key, ends).to(torch.int32))


def pergroup_fused(chunk_keys, slots, lanes, seqs, own_s, cnt_s, lo_s,
                   sortmask, ugroups, ops):
    """Per-group partial evaluation of ``[NE, WA]`` chunks (the inputs of
    :func:`repro_torch.core.swag.write_plan`): every chunk's per-group
    partial aggregates over the live lanes of the ``[C, WA]`` ring as the
    chunk's writes leave it.  ``ops`` are partial-path names; their values
    do not depend on the order of a pane's lanes, so the kernel skips the
    close sort (``sortmask``).  The plan must be a placement scan's (a
    pane fills lanes 0, 1, ... and a reallocated slot starts again at lane
    0): the kernel reads each slot's live lanes as its last writes.
    Returns ``{name: [NE, C]}`` (mask with the plan's ``num`` outside)."""
    names = (ops,) if isinstance(ops, str) else tuple(ops)
    if chunk_keys.device.type == "cpu":
        return pergroup_fused_plain(chunk_keys, slots, lanes, seqs, own_s,
                                    cnt_s, lo_s, sortmask, ugroups, names)
    bad = [nm for nm in names if nm not in _panestore.PANE_PARTIAL_OPS]
    if bad:
        raise ValueError(f"pergroup_fused computes "
                         f"{sorted(_panestore.PANE_PARTIAL_OPS)}, not {bad}")
    ne, wa = chunk_keys.shape
    c = own_s.shape[1]
    if ne == 0:
        raise ValueError("pergroup_fused: no chunk to launch over")
    if chunk_keys.dtype not in common.KEY_TYPES \
            or not chunk_keys.is_contiguous():
        raise ValueError(f"pergroup_fused: contiguous int32 or float32 "
                         f"keys, got {chunk_keys.dtype}")
    dirs = [t.to(torch.int32).contiguous()
            for t in (own_s, cnt_s, lo_s, sortmask, ugroups)]
    plan = [t.to(torch.int32).contiguous() for t in (slots, lanes, seqs)]
    _cuda_int32("pergroup_fused", **dict(zip(
        ("slots", "lanes", "seqs", "own_s", "cnt_s", "lo_s", "sortmask",
         "ugroups"), plan + dirs)))
    if any(t.shape != (ne, wa) for t in plan) \
            or any(t.shape != (ne, c) for t in dirs):
        raise ValueError("pergroup_fused: plan inputs must be [NE, WA], "
                         "directory inputs [NE, C]")
    dev = chunk_keys.device
    own, cnt, lo, _, ug = dirs
    wk, wq, start, endp = _writes_by_slot(chunk_keys, plan[0], plan[2], c)
    perm = torch.sort(own, dim=1, stable=True).indices.to(torch.int32)
    outs = {nm: torch.empty((ne, c), dtype=out_dtype(
        nm, chunk_keys.dtype), device=dev) for nm in names}
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_pergroup_fused(
            wk.data_ptr(), wq.data_ptr(), start.data_ptr(), endp.data_ptr(),
            *(t.data_ptr() for t in (own, cnt, lo, ug, perm)),
            common.KEY_TYPES[chunk_keys.dtype], ne, wa, c, _codes(names),
            _ptrs(list(outs.values())), len(names),
            _build.stream_handle(dev))
    _build.check(err, "pergroup_fused")
    pergroup_fused.launches += 1
    return outs


def pergroup_replay_plain(run_keys, run_valid, ops, *, run: int):
    """Plain torch version of :func:`pergroup_replay`: the merge of the
    presorted runs (liveness as payload), compaction, tails."""
    kc, cnt = _panestore.merged_window(run_keys, run_valid != 0, run=run)
    return _panestore._direct_tails(kc, cnt, tuple(ops), interpolate=False)


def pergroup_replay(run_keys: torch.Tensor, run_valid: torch.Tensor, ops, *,
                    run: int):
    """Replay over gathered per-group pane subsets: ``run_keys`` /
    ``run_valid`` (int32) ``[R, S*WA]``, each row S runs of ``run`` lanes
    whose live lanes are key-sorted, with a liveness mask.  ``ops`` are
    DIRECT_OPS names.  Returns ``{name: [R]}``."""
    names = (ops,) if isinstance(ops, str) else tuple(ops)
    if run_keys.device.type == "cpu":
        return pergroup_replay_plain(run_keys, run_valid, names, run=run)
    bad = [nm for nm in names if nm not in _panestore.DIRECT_OPS]
    if bad:
        raise ValueError(f"pergroup_replay computes "
                         f"{sorted(_panestore.DIRECT_OPS)}, not {bad}")
    _cuda_int32("pergroup_replay", run_valid=run_valid)
    r, length = run_keys.shape
    if run_valid.shape != run_keys.shape or r == 0 \
            or not common.is_pow2(length) or length % run \
            or length > MAX_ROW or length < 2:
        raise ValueError(f"pergroup_replay takes [R >= 1, L] keys and "
                         f"validity, L a power of two in [2, {MAX_ROW}] "
                         f"holding runs of {run}, got {tuple(run_keys.shape)}"
                         f" and {tuple(run_valid.shape)}")
    if run_keys.dtype not in common.KEY_TYPES \
            or not run_keys.is_contiguous():
        raise ValueError(f"pergroup_replay: contiguous int32 or float32 "
                         f"keys, got {run_keys.dtype}")
    dev = run_keys.device
    outs = {nm: torch.empty((r,), dtype=out_dtype(
        nm, run_keys.dtype), device=dev) for nm in names}
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_pergroup_replay(
            run_keys.data_ptr(), run_valid.data_ptr(),
            common.KEY_TYPES[run_keys.dtype], r, length, run, _codes(names),
            _ptrs(list(outs.values())), len(names),
            _build.stream_handle(dev))
    _build.check(err, "pergroup_replay")
    pergroup_replay.launches += 1
    return outs


def _time_rows(ovs, ugroups, num, cnt):
    """A time-mode evaluation's rows without the groups whose window holds
    no tuple (:func:`repro_torch.core.panestore.drop_empty_rows`)."""
    c = ugroups.shape[-1]
    valid = torch.arange(c, device=num.device) < num.unsqueeze(-1)
    ug, ovs, _, num = _panestore.drop_empty_rows(ugroups, ovs, valid, cnt)
    return ovs, ug, num


def pergroup_replay_ring_plain(spec, states, ops, eval_time=None):
    """Plain torch version of :func:`pergroup_replay_ring`: the gathered
    replay rows (:func:`repro_torch.core.panestore.gather_runs`) through
    :func:`pergroup_replay_plain`."""
    names = (ops,) if isinstance(ops, str) else tuple(ops)
    runs = _panestore.gather_runs(spec, states, eval_time=eval_time)
    ne, c = runs.groups.shape
    length = runs.run_keys.shape[-1]
    ovs = pergroup_replay_plain(
        runs.run_keys.reshape(ne * c, length),
        runs.run_valid.reshape(ne * c, length).to(torch.int32), names,
        run=spec.wa)
    ovs = {nm: v.reshape(ne, c) for nm, v in ovs.items()}
    if spec.is_time:
        return _time_rows(ovs, runs.groups, runs.num_groups,
                          runs.run_valid.sum(-1, dtype=torch.int32))
    return ovs, runs.groups, runs.num_groups


def ring_directory(spec, states, eval_time=None) -> dict:
    """The ring-form replay kernel's view of the stores after every chunk
    (torch): the ring's seqs, each slot's count and base, the slot
    directory (:func:`repro_torch.core.panestore._slot_directory`: perm,
    live group ids, offsets, slot counts, num) and each live group's
    window, all contiguous int32.  A time-mode store's window is its
    evaluation's ``[eval_time - range, eval_time)``, ``ws`` ``[NE, 2]``."""
    perm, ugroups, offsets, nslots, num, _ = _panestore._slot_directory(
        states.owner, states.base)
    if spec.is_time:
        et = torch.as_tensor(eval_time, dtype=torch.int32,
                             device=num.device).expand(num.shape)
        ws = torch.stack([et - spec.time_range, et], -1)
    else:
        ws = spec.ws_of(ugroups)
    return {nm: t.contiguous() for nm, t in dict(
        seqs=states.seqs, count=states.count, base=states.base, perm=perm,
        offsets=offsets, nslots=nslots, num=num, ws=ws,
        ugroups=ugroups).items()}


def pergroup_replay_ring(spec, states, ops, eval_time=None):
    """Replay every evaluation's live groups straight from the placement
    scan's ring snapshots: ``states`` is the ``[NE, ...]``
    :class:`repro_torch.core.panestore.PaneStoreState` of the store after
    every chunk that :func:`pergroup_scan` (with keys) returns.  ``ops``
    are DIRECT_OPS names.  Returns ``({name: [NE, C]}, ugroups [NE, C],
    num [NE])``: what :func:`repro_torch.core.panestore.gather_runs`
    followed by :func:`pergroup_replay` gives on the rows below ``num``;
    on the card the rows at or past ``num[e]`` are left unwritten.

    A time-mode store takes ``eval_time`` (``[NE]`` or one for all, int32,
    may lie on the card): a lane is live iff its timestamp lies in
    ``[eval_time - range, eval_time)``, the kernel counts each row's live
    lanes, and the rows of groups with none are dropped (stable), the
    rows past ``num`` then PAD_GROUP and zeros."""
    names = (ops,) if isinstance(ops, str) else tuple(ops)
    if spec.is_time and eval_time is None:
        raise ValueError("time-mode stores replay at an evaluation time: "
                         "pass eval_time=")
    if states.owner.device.type == "cpu":
        return pergroup_replay_ring_plain(spec, states, names, eval_time)
    bad = [nm for nm in names if nm not in _panestore.DIRECT_OPS]
    if bad:
        raise ValueError(f"pergroup_replay_ring computes "
                         f"{sorted(_panestore.DIRECT_OPS)}, not {bad}")
    if states.keys is None or states.owner.dim() != 2:
        raise ValueError("pergroup_replay_ring takes the [NE, ...] stores "
                         "of a placement scan that kept the ring")
    ne, c = states.owner.shape
    wa, runs = spec.wa, spec.runs
    keys = states.keys
    if keys.dtype not in common.KEY_TYPES or not keys.is_contiguous() \
            or keys.shape != (ne, c, wa):
        raise ValueError(f"pergroup_replay_ring: contiguous [NE, C, WA] "
                         f"int32 or float32 keys, got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if ne == 0 or runs * wa > MAX_ROW:
        raise ValueError(f"pergroup_replay_ring takes at least one "
                         f"evaluation of rows up to {MAX_ROW} lanes, got "
                         f"{ne} of {runs} x {wa}")
    dirs = ring_directory(spec, states, eval_time)
    _cuda_int32("pergroup_replay_ring", **dirs)
    if not spec.is_time:
        return replay_ring_launch(spec, keys, dirs, names), \
            dirs["ugroups"], dirs["num"]
    cnt = torch.empty((ne, c), dtype=torch.int32, device=keys.device)
    ovs = replay_ring_launch(spec, keys, dirs, names, live_out=cnt)
    return _time_rows(ovs, dirs["ugroups"], dirs["num"], cnt)


def replay_ring_launch(spec, keys, dirs: dict, names: tuple,
                       live_out=None) -> dict:
    """The launch of :func:`pergroup_replay_ring` alone, over the
    ``[NE, C, WA]`` ring keys and the :func:`ring_directory` of their
    stores: ``{name: [NE, C]}``, the rows at or past ``num`` unwritten.
    A time-mode store's launch writes each row's live lanes into
    ``live_out`` ``[NE, C]``."""
    ne, c, wa = keys.shape
    dev = keys.device
    outs = {nm: torch.empty((ne, c), dtype=out_dtype(nm, keys.dtype),
                            device=dev) for nm in names}
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_pergroup_replay_ring(
            keys.data_ptr(), *(dirs[nm].data_ptr() for nm in (
                "seqs", "count", "base", "perm", "offsets", "nslots", "num",
                "ws")), None if live_out is None else live_out.data_ptr(),
            common.KEY_TYPES[keys.dtype], ne, c, wa, spec.runs,
            int(spec.is_time), _codes(names), _ptrs(list(outs.values())),
            len(names), _build.stream_handle(dev))
    _build.check(err, "pergroup_replay_ring")
    pergroup_replay_ring.launches += 1
    return outs


#: kernel launches since each count was last set to 0
swag.launches = 0
sort_panes.launches = 0
swag_panes.launches = 0
pergroup_scan.launches = 0
pergroup_scan.batch_stats = None
pergroup_scan_time.launches = 0
pergroup_fused.launches = 0
pergroup_replay.launches = 0
pergroup_replay_ring.launches = 0
twostack_flip.launches = 0
