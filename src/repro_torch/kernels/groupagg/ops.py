"""Execution layer of the fused group-by-aggregate kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.groupagg import kernel as _k


def _groupagg_kernel_exec(groups: torch.Tensor, keys: torch.Tensor, ops="sum",
                          *, n_valid=None, tile: int = 1024):
    """Kernel-backed single-shot group-by-aggregate of one or many ops.

    Contract (as in the paper): ``groups`` sorted ascending, group ids in
    ``(INT32_MIN, INT32_MAX)``; for ``distinct_count`` keys sorted within
    groups.  On the card one launch of the kernel takes every op and writes
    each group straight to its flat position, lanes past ``n_valid`` read
    as padding inside the kernel (:func:`~repro_torch.kernels.groupagg.
    kernel.groupagg_flat`); on the CPU its plain version pads the stream,
    runs the per-tile kernel's plain version once per op and stitches the
    per-tile outputs, as the JAX package stitches them in XLA outside its
    kernel.  Returns ``(groups [N], {name: values [N]}, valid [N], num)``.
    """
    return _k.groupagg_flat(groups, keys, ops, tile=tile, n_valid=n_valid)
