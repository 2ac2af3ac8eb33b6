"""The fused sliding-window kernels: counterparts of the JAX package's
``swag_pallas``, ``sort_panes_pallas``, ``swag_pallas_panes``,
``pergroup_fused_pallas`` and ``pergroup_replay_pallas``
(``src/repro/kernels/swag/kernel.py``), plus the per-group placement scan,
which the JAX package leaves to an XLA ``lax.scan``.

* :func:`swag` — one row per window: sort by (group, key), then every
  requested op's tail (one shared compaction; the lower median rides along).
* :func:`sort_panes` — sort each WA-lane pane once.
* :func:`swag_panes` — window ``i`` merges the presorted panes
  ``i .. i+P-1`` instead of re-sorting, then the same tails.
* :func:`pergroup_scan` — the per-tuple pane-store placement over a
  stream's WA chunks (optionally keeping the ring buffers).
* :func:`pergroup_fused` — per chunk, in order: the writes into the
  resident ring, the close sort, the per-group partial aggregates.
* :func:`pergroup_replay` — per replay row: the live lanes' DIRECT_OPS.

Each wrapper launches ``csrc/swag.cu`` or ``csrc/pergroup.cu`` on CUDA
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


def pergroup_scan_plain(spec, state, groups, keys=None):
    """Plain torch version of :func:`pergroup_scan`: the per-tuple loop."""
    return _panestore.scan(spec, state, groups, keys)


def pergroup_scan(spec, state, groups: torch.Tensor,
                  keys: torch.Tensor | None = None):
    """Place the ``N // WA`` full chunks of ``groups`` into the pane store
    ``state`` (a :class:`repro_torch.core.panestore.PaneStoreState`), one
    tuple at a time in one warp.  With ``keys`` the ring buffers are kept
    too.  Returns a :class:`repro_torch.core.panestore.ScanTrace` (without
    arrival ranks); ``state`` is not modified."""
    if groups.device.type == "cpu":
        return pergroup_scan_plain(spec, state, groups, keys)
    wa, c = spec.wa, spec.capacity
    ne = groups.shape[-1] // wa
    _cuda_int32("pergroup_scan", groups=groups, owner=state.owner,
                count=state.count, base=state.base, stamp=state.stamp)
    if groups.dim() != 1 or ne == 0:
        raise ValueError(f"pergroup_scan takes a [N] stream of at least one "
                         f"chunk of {wa}, got {tuple(groups.shape)}")
    if keys is not None and (keys.dtype != state.keys.dtype
                             or keys.dtype not in common.KEY_TYPES
                             or keys.device != groups.device
                             or not keys.is_contiguous()):
        raise ValueError(f"pergroup_scan: keys must be contiguous int32 or "
                         f"float32 of the store's dtype on the card, got "
                         f"{keys.dtype} (store {state.keys.dtype})")
    dev = groups.device
    kt = state.keys.dtype
    direc = torch.stack([state.owner, state.count, state.base, state.stamp])
    clock = state.clock.reshape(1).to(torch.int32).clone()
    ring = keys is not None
    ring_k = state.keys.contiguous().clone() if ring else None
    ring_s = state.seqs.to(torch.int32).contiguous().clone() if ring \
        else None
    plan = torch.empty((3, ne, wa), dtype=torch.int32, device=dev)
    snaps = torch.empty((4, ne, c), dtype=torch.int32, device=dev)
    clock_s = torch.empty((ne,), dtype=torch.int32, device=dev)
    rk_s = torch.empty((ne, c, wa), dtype=kt, device=dev) if ring else None
    rs_s = torch.empty((ne, c, wa), dtype=torch.int32, device=dev) \
        if ring else None
    pg = torch.tensor(spec.per_group or [(0, 0)], dtype=torch.int32,
                      device=dev)
    events = torch.empty((2,), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_pergroup_scan(
            groups.data_ptr(), ptr(keys), common.KEY_TYPES[kt] if ring else 0,
            ne, wa, c, pg.data_ptr(), len(spec.per_group), spec.default_ws,
            direc.data_ptr(), clock.data_ptr(), ptr(ring_k), ptr(ring_s),
            plan.data_ptr(), snaps.data_ptr(), clock_s.data_ptr(),
            ptr(rk_s), ptr(rs_s), events.data_ptr(),
            _build.stream_handle(dev))
    _build.check(err, "pergroup_scan")
    pergroup_scan.launches += 1
    states = _panestore.PaneStoreState(
        owner=snaps[0], keys=rk_s, seqs=rs_s, count=snaps[1], base=snaps[2],
        stamp=snaps[3], clock=clock_s)
    final = _panestore.PaneStoreState(
        owner=direc[0], keys=ring_k if ring else state.keys,
        seqs=ring_s if ring else state.seqs, count=direc[1], base=direc[2],
        stamp=direc[3], clock=clock[0])
    return _panestore.ScanTrace(plan[0], plan[1], plan[2], states, None,
                                final, None, events)


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


def pergroup_fused(chunk_keys, slots, lanes, seqs, own_s, cnt_s, lo_s,
                   sortmask, ugroups, ops):
    """Fused push + partial evaluation over ``[NE, WA]`` chunks (the
    inputs of :func:`repro_torch.core.swag.write_plan`): per chunk, in
    order, the writes into the ``[C, WA]`` ring, the sort of the closing
    rows and every row's per-group partial aggregates.  ``ops`` are
    partial-path names.  Returns ``{name: [NE, C]}`` (mask with the plan's
    ``num`` outside)."""
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
    outs = {nm: torch.empty((ne, c), dtype=out_dtype(
        nm, chunk_keys.dtype), device=dev) for nm in names}
    ring_k = torch.zeros((c, wa), dtype=chunk_keys.dtype, device=dev)
    ring_s = torch.zeros((c, wa), dtype=torch.int32, device=dev)
    tag = torch.full((c, wa), -1, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_pergroup_fused(
            chunk_keys.data_ptr(), *(t.data_ptr() for t in plan + dirs),
            common.KEY_TYPES[chunk_keys.dtype], ne, wa, c, _codes(names),
            _ptrs(list(outs.values())), len(names), ring_k.data_ptr(),
            ring_s.data_ptr(), tag.data_ptr(), _build.stream_handle(dev))
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
    ``run_valid`` (int32) ``[R, S*WA]``, each row S key-sorted runs of
    ``run`` lanes with a liveness mask.  ``ops`` are DIRECT_OPS names.
    Returns ``{name: [R]}``."""
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
            common.KEY_TYPES[run_keys.dtype], r, length, _codes(names),
            _ptrs(list(outs.values())), len(names),
            _build.stream_handle(dev))
    _build.check(err, "pergroup_replay")
    pergroup_replay.launches += 1
    return outs


#: kernel launches since each count was last set to 0
swag.launches = 0
sort_panes.launches = 0
swag_panes.launches = 0
pergroup_scan.launches = 0
pergroup_fused.launches = 0
pergroup_replay.launches = 0
