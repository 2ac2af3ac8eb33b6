"""The fused sliding-window kernels: counterparts of the JAX package's
``swag_pallas``, ``sort_panes_pallas`` and ``swag_pallas_panes``
(``src/repro/kernels/swag/kernel.py``).

* :func:`swag` — one row per window: sort by (group, key), then every
  requested op's tail (one shared compaction; the lower median rides along).
* :func:`sort_panes` — sort each WA-lane pane once.
* :func:`swag_panes` — window ``i`` merges the presorted panes
  ``i .. i+P-1`` instead of re-sorting, then the same tails.

Each wrapper launches ``csrc/swag.cu`` on CUDA tensors and runs the plain
torch version beside it (``*_plain``) on CPU tensors.  Outputs follow the
TPU kernels: ``og [NW, WS]`` (PAD_GROUP tail), ``{op: ov [NW, WS]}`` (zero
tail), ``oc [NW]``.
"""
from __future__ import annotations

import ctypes

import torch

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


#: kernel launches since each count was last set to 0
swag.launches = 0
sort_panes.launches = 0
swag_panes.launches = 0
