"""Execution layer of the fused group-by-aggregate kernel, and the
deprecated entry point ``group_by_aggregate_cuda`` (the counterpart of the
JAX package's ``group_by_aggregate_tpu``)."""
from __future__ import annotations

import torch

from repro_torch.core.combiners import Combiner
from repro_torch.core.engine import GroupAggResult, _deprecated, _device_of
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


def group_by_aggregate_cuda(groups, keys, op="sum", *, n_valid=None,
                            tile: int = 1024) -> GroupAggResult:
    """Deprecated: use ``repro_torch.query.Query(ops=(op,))`` + ``execute``
    (``backend="cuda"``).  On card tensors the groupagg kernel runs, on
    CPU tensors its plain version."""
    _deprecated("repro_torch.kernels.groupagg.ops.group_by_aggregate_cuda",
                "Query(ops=(op,))")
    from repro_torch import query as _q
    name = op.name if isinstance(op, Combiner) else _q.canonical_op(op)
    res, _ = _q.execute(_q.Query(ops=(op,)), groups, keys, n_valid=n_valid,
                        backend="cuda", tile=tile, device=_device_of(keys))
    return GroupAggResult(res.groups, res.values[name], res.valid,
                          res.num_groups)
