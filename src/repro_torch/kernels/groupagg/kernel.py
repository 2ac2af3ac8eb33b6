"""The fused group-by-aggregate kernel: the counterpart of the JAX package's
``groupagg_pallas`` (``src/repro/kernels/groupagg/kernel.py``).

Per tile of T lanes: run boundaries, the segmented scan of one op, the merge
with the run pending from the previous tile, finalize at run ends, and a
dense compaction.  The trailing run of a tile is withheld (it may continue
into the next tile); a tile that does not continue the pending run emits it
at lane 0.  Outputs are per tile: ``og``/``ov`` ``[NT, T]``, ``oc [NT]``.

:func:`groupagg` launches ``csrc/groupagg.cu`` on CUDA tensors and runs
:func:`groupagg_plain`, the plain torch version, on CPU tensors.  Both
replace the TPU kernel's ordered-grid carry by the same reduce-then-scan
over tiles (tile summaries, a segmented scan of them, then the per-tile
emit), which gives the TPU kernel's per-tile outputs exactly.
"""
from __future__ import annotations

import torch

from repro_torch.core import segscan
from repro_torch.core.combiners import (Combiner, get_combiner, out_dtype,
                                        tree_map)
from repro_torch.core.engine import PAD_GROUP
from repro_torch.kernels import _build
from repro_torch.kernels import common

INT32_MIN = torch.iinfo(torch.int32).min
#: the largest tile the CUDA kernel takes (1024 threads of 4 lanes)
MAX_TILE = 4096
#: scratch bytes per tile: three int32 columns and two states of <= 16 B
_SCRATCH_PER_TILE = 48


def _resolve(op) -> Combiner:
    combiner = op if isinstance(op, Combiner) else get_combiner(op)
    if combiner.name in ("argmin", "argmax"):
        raise NotImplementedError(
            "position-carrying operators lift a global iota; the tiled "
            "kernel lifts per tile — use the reference backend")
    return combiner


def groupagg_plain(groups: torch.Tensor, keys: torch.Tensor, op, *,
                   tile: int):
    """Plain torch version of the kernel, on any device."""
    combiner = _resolve(op)
    nt = groups.shape[-1] // tile
    g = groups.reshape(nt, tile)
    k = keys.reshape(nt, tile)
    lane = torch.arange(tile, device=g.device)

    # (b) run boundaries from shifted compares; the trailing lane is withheld
    starts = g != common._shift_right(g, 1, INT32_MIN)
    ends = (g != common._shift_left(g, 1, INT32_MIN)) & (lane != tile - 1)
    # (c) in-tile segmented scan
    scanned = common.tile_segmented_scan(starts, combiner.lift(k), combiner)

    # the run pending after each tile: a tile that is one run continuing
    # the pending group extends it, any other tile restarts it with its
    # last run's state
    last = tree_map(lambda x: x[:, -1], scanned)
    single = ~starts[:, 1:].any(-1)
    prev_g = common._shift_right(g[:, -1], 1, PAD_GROUP)
    pvalid = prev_g != PAD_GROUP
    continues = pvalid & (prev_g == g[:, 0])
    pend = segscan.segmented_scan(~(single & continues), last, combiner)
    pstate = tree_map(lambda x: torch.roll(x, 1, dims=-1), pend)

    # merge the incoming pending run into the first run
    first_run = torch.cumsum(starts.to(torch.int32), dim=-1) == 1
    merge_mask = first_run & continues[:, None]
    merged_all = combiner.op(tree_map(lambda x: x[:, None], pstate), scanned)
    merged = tree_map(lambda m, s: torch.where(merge_mask, m, s),
                      merged_all, scanned)

    # (d) finalize at run ends, (e) compaction
    values = combiner.finalize(merged)
    emit = ends & (g != PAD_GROUP)
    (cg, cv), cnt = common.butterfly_compact(emit, (g, values),
                                             (PAD_GROUP, 0))
    # emit the pending run at lane 0 when this tile does not continue it
    emit_pending = pvalid & (prev_g != g[:, 0])
    pend_val = combiner.finalize(pstate).to(cv.dtype)
    cg_shift = torch.cat([prev_g[:, None], cg[:, :-1]], dim=-1)
    cv_shift = torch.cat([pend_val[:, None], cv[:, :-1]], dim=-1)
    og = torch.where(emit_pending[:, None], cg_shift, cg)
    ov = torch.where(emit_pending[:, None], cv_shift, cv)
    oc = cnt[:, 0] + emit_pending.to(torch.int32)
    return og, ov, oc


def groupagg(groups: torch.Tensor, keys: torch.Tensor, op, *, tile: int):
    """``groups``/``keys``: ``[N]`` with ``N % tile == 0``, closed by a
    PAD_GROUP tile.  Returns ``(og [NT, T], ov [NT, T], oc [NT])``.

    CPU tensors run :func:`groupagg_plain`; CUDA tensors launch the kernel
    (or raise on what it does not take)."""
    combiner = _resolve(op)
    if groups.dim() != 1 or groups.shape != keys.shape:
        raise ValueError(f"groupagg takes two [N] columns, got "
                         f"{tuple(groups.shape)} and {tuple(keys.shape)}")
    n = groups.shape[0]
    if not common.is_pow2(tile) or n == 0 or n % tile:
        raise ValueError(f"groupagg needs a power-of-two tile dividing a "
                         f"non-empty N, got N={n} tile={tile}")
    if groups.device.type == "cpu":
        return groupagg_plain(groups, keys, combiner, tile=tile)
    if groups.device.type != "cuda":
        raise ValueError(f"groupagg runs on cpu or cuda, not {groups.device}")
    common.check_kernel_inputs("groupagg", groups, keys)
    if tile > MAX_TILE:
        raise ValueError(f"the groupagg kernel takes tiles up to {MAX_TILE} "
                         f"lanes, got {tile}")
    if combiner.name not in common.OP_CODES:
        raise ValueError(f"the groupagg kernel has no code for op "
                         f"{combiner.name!r}")
    nt = n // tile
    dev = groups.device
    og = torch.empty((nt, tile), dtype=torch.int32, device=dev)
    ov = torch.empty((nt, tile), dtype=out_dtype(combiner.name, keys.dtype),
                     device=dev)
    oc = torch.empty((nt,), dtype=torch.int32, device=dev)
    scratch = torch.empty((nt * _SCRATCH_PER_TILE,), dtype=torch.uint8,
                          device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_groupagg(
            groups.data_ptr(), keys.data_ptr(), common.KEY_TYPES[keys.dtype],
            common.OP_CODES[combiner.name], nt, tile, scratch.data_ptr(),
            og.data_ptr(), ov.data_ptr(), oc.data_ptr(),
            _build.stream_handle(dev))
    _build.check(err, "groupagg")
    groupagg.launches += 1
    return og, ov, oc


#: kernel launches since the count was last set to 0
groupagg.launches = 0
