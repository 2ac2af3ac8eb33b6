"""Execution layer of the fused group-by-aggregate kernel."""
from __future__ import annotations

import torch

from repro_torch.core.engine import PAD_GROUP, _prefix_mask
from repro_torch.kernels.groupagg import kernel as _k


def _groupagg_kernel_exec(groups: torch.Tensor, keys: torch.Tensor, ops="sum",
                          *, n_valid=None, tile: int = 1024):
    """Kernel-backed single-shot group-by-aggregate of one or many ops.

    Contract (as in the paper): ``groups`` sorted ascending, group ids in
    ``(INT32_MIN, INT32_MAX)``; for ``distinct_count`` keys sorted within
    groups.  The stream is padded once to a tile multiple plus one PAD_GROUP
    tile (which closes the last real run); the kernel runs once per op (it
    is single-op, as the TPU kernel is), and the per-tile compacted outputs
    are stitched in plain torch, as the JAX package stitches them in XLA
    outside its kernel.  The compacted layout does not depend on the op, so
    the first op's ``og``/``oc`` give the groups and the stitch index for
    all.  Returns ``(groups [N], {name: values [N]}, valid [N], num)``.
    """
    combiners = [_k._resolve(op) for op in
                 ((ops,) if isinstance(ops, str) else ops)]
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
        og, ov, oc = _k.groupagg(g_p, k_p, combiner, tile=tile)
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
