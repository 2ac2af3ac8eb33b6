"""The fused group-by-aggregate kernel: the counterpart of the JAX package's
``groupagg_pallas`` (``src/repro/kernels/groupagg/kernel.py``), and of the
stitch of its per-tile outputs (``src/repro/kernels/groupagg/ops.py``).

Per tile of T lanes: run boundaries, the segmented scan of each op, the
merge with the run pending from the previous tile, finalize at run ends,
and a dense compaction.  The trailing run of a tile is withheld (it may
continue into the next tile); a tile that does not continue the pending run
emits it at lane 0.  ``csrc/groupagg.cu`` writes one of two layouts:

* :func:`groupagg`, the TPU kernel's per-tile layout for one op: ``og``/
  ``ov`` ``[NT, T]``, ``oc [NT]``;
* :func:`groupagg_flat`, every op of a query in one launch, each group at
  its flat position: ``groups [N]``, ``{name: values [N]}``, ``valid [N]``
  and ``num``, the layout ``_groupagg_kernel_exec`` returns.

Each launches the kernel on CUDA tensors and runs its plain torch version,
:func:`groupagg_plain` or :func:`groupagg_flat_plain`, on CPU tensors.  The
plain version carries the pending run across tiles by a reduce-then-scan
over tile summaries; the kernel by a chained tile prefix in one pass.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import segscan
from repro_torch.core.combiners import (Combiner, get_combiner, out_dtype,
                                        tree_map)
from repro_torch.core.engine import PAD_GROUP, _prefix_mask
from repro_torch.kernels import _build
from repro_torch.kernels import common

INT32_MIN = torch.iinfo(torch.int32).min
#: the largest tile the CUDA kernel takes (1024 threads of 4 lanes)
MAX_TILE = 4096


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


def _check_tile(n: int, tile: int) -> None:
    if tile > MAX_TILE:
        raise ValueError(f"the groupagg kernel takes tiles up to {MAX_TILE} "
                         f"lanes, got {tile}")
    if n >= 2**31:
        raise ValueError(f"the groupagg kernel takes streams under 2^31 "
                         f"lanes, got {n}")


def _launch(groups, keys, combiners, tile: int, *, flat: bool, lim: int,
            nvalid, og, outs, valid, oc, num) -> None:
    """One launch of ``csrc/groupagg.cu`` (raises on what it does not
    take); the ticket and the chain's status words zeroed for this launch
    alone."""
    for c in combiners:
        if c.name not in common.OP_CODES:
            raise ValueError(f"the groupagg kernel has no code for op "
                             f"{c.name!r}")
    n = groups.shape[0]
    nt = n // tile + 1 if flat else n // tile
    # one zeroed buffer: the chain's payload slots (16-byte aligned), then
    # the ticket and the status words
    pay = (32 * len(combiners) + 12) * nt
    scratch = torch.zeros((pay + 4 * (4 + nt),), dtype=torch.uint8,
                          device=groups.device)
    dev = groups.device
    ptr = lambda t: None if t is None else t.data_ptr()
    codes = (ctypes.c_int * len(combiners))(
        *(common.OP_CODES[c.name] for c in combiners))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(t.data_ptr() for t in outs))
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_groupagg(
            groups.data_ptr(), keys.data_ptr(), common.KEY_TYPES[keys.dtype],
            n, lim, ptr(nvalid), tile, int(flat), codes, out_ptrs,
            len(combiners), scratch.data_ptr() + pay, scratch.data_ptr(),
            og.data_ptr(), ptr(valid), ptr(oc), ptr(num),
            _build.stream_handle(dev))
    _build.check(err, "groupagg")
    groupagg.launches += 1


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
    _check_tile(n, tile)
    nt = n // tile
    dev = groups.device
    og = torch.empty((nt, tile), dtype=torch.int32, device=dev)
    ov = torch.empty((nt, tile), dtype=out_dtype(combiner.name, keys.dtype),
                     device=dev)
    oc = torch.empty((nt,), dtype=torch.int32, device=dev)
    _launch(groups, keys, [combiner], tile, flat=False, lim=n, nvalid=None,
            og=og, outs=[ov], valid=None, oc=oc, num=None)
    return og, ov, oc


#: kernel launches since the count was last set to 0 (both layouts)
groupagg.launches = 0


def _resolve_all(ops) -> list:
    """The distinct combiners of ``ops`` (one name or many), in order."""
    combiners = [_resolve(op) for op in
                 ((ops,) if isinstance(ops, (str, Combiner)) else ops)]
    return list({c.name: c for c in combiners}.values())


def groupagg_flat_plain(groups: torch.Tensor, keys: torch.Tensor, ops, *,
                        tile: int, n_valid=None):
    """Plain torch version of :func:`groupagg_flat`: the stream masked past
    ``n_valid``, padded to whole tiles plus one PAD_GROUP tile (which closes
    the last real run), :func:`groupagg_plain` once per op, and the per-tile
    outputs stitched to their flat positions, as the JAX package stitches
    them in XLA outside its kernel.  The compacted layout does not depend on
    the op, so the first op's ``og``/``oc`` give the groups and the stitch
    index for all."""
    combiners = _resolve_all(ops)
    n = groups.shape[-1]
    dev = groups.device
    groups = groups.to(torch.int32)
    if n_valid is not None:
        groups = torch.where(_prefix_mask(n, n_valid, dev), groups, PAD_GROUP)
    pad = (-n) % tile + tile
    g_p = torch.cat([groups, torch.full((pad,), PAD_GROUP, dtype=torch.int32,
                                        device=dev)])
    k_p = torch.cat([keys, torch.zeros((pad,), dtype=keys.dtype, device=dev)])

    values = {}
    dest = flat_g = num = None
    for combiner in combiners:
        og, ov, oc = groupagg_plain(g_p, k_p, combiner, tile=tile)
        if dest is None:
            # stitch: flat destination = tile offset + lane, for lane <
            # count[tile]; lanes past the count go to the dropped slot n
            offsets = torch.cumsum(oc, dim=0, dtype=torch.int64) - oc
            lanes = torch.arange(tile, device=dev)[None, :]
            dest = torch.where(lanes < oc[:, None], offsets[:, None] + lanes,
                               n).reshape(-1)
            flat_g = torch.full((n + 1,), PAD_GROUP, dtype=torch.int32,
                                device=dev).scatter_(0, dest, og.reshape(-1))
            num = oc.sum(dtype=torch.int32)
        values[combiner.name] = torch.zeros(
            (n + 1,), dtype=ov.dtype, device=dev).scatter_(
            0, dest, ov.reshape(-1))[:n]
    return flat_g[:n], values, _prefix_mask(n, num, dev), num


def groupagg_flat(groups: torch.Tensor, keys: torch.Tensor, ops, *,
                  tile: int, n_valid=None):
    """Group-by-aggregate of one or many ops over the ``[N]`` columns, lanes
    at or past ``n_valid`` (an int or a tensor, read on the device) masked.
    Returns ``(groups [N], {name: values [N]}, valid [N], num)``, ``num``
    the count of groups as a 0-d int32 tensor.

    CPU tensors run :func:`groupagg_flat_plain`; CUDA tensors launch the
    kernel once for all ops (and its tail fill), with no copy of the
    stream, or raise on what it does not take."""
    combiners = _resolve_all(ops)
    if groups.dim() != 1 or groups.shape != keys.shape:
        raise ValueError(f"groupagg takes two [N] columns, got "
                         f"{tuple(groups.shape)} and {tuple(keys.shape)}")
    if not common.is_pow2(tile):
        raise ValueError(f"groupagg needs a power-of-two tile, got {tile}")
    if groups.device.type == "cpu":
        return groupagg_flat_plain(groups, keys, combiners, tile=tile,
                                   n_valid=n_valid)
    if groups.device.type != "cuda":
        raise ValueError(f"groupagg runs on cpu or cuda, not {groups.device}")
    groups = groups.to(torch.int32).contiguous()
    keys = keys.contiguous()
    common.check_kernel_inputs("groupagg", groups, keys)
    n = groups.shape[0]
    _check_tile(n, tile)
    dev = groups.device
    lim, nvalid = n, None
    if isinstance(n_valid, torch.Tensor):
        nvalid = torch.clamp(n_valid.to(dev).reshape(()), 0, n).to(
            torch.int32)
    elif n_valid is not None:
        lim = min(max(int(n_valid), 0), n)
    # the outputs as views of one buffer, each 16-byte aligned: groups,
    # each op's values (4 bytes a lane), valid, num
    step = -(-4 * n // 16) * 16
    vstep = -(-n // 16) * 16
    buf = torch.empty((step * (1 + len(combiners)) + vstep + 16,),
                      dtype=torch.uint8, device=dev)
    at = lambda i: buf[i * step:i * step + 4 * n]
    og = at(0).view(torch.int32)
    outs = [at(1 + i).view(out_dtype(c.name, keys.dtype))
            for i, c in enumerate(combiners)]
    end = step * (1 + len(combiners))
    valid = buf[end:end + n].view(torch.bool)
    num = buf[end + vstep:end + vstep + 4].view(torch.int32).reshape(())
    _launch(groups, keys, combiners, tile, flat=True, lim=lim, nvalid=nvalid,
            og=og, outs=outs, valid=valid, oc=None, num=num)
    return og, {c.name: v for c, v in zip(combiners, outs)}, valid, num
