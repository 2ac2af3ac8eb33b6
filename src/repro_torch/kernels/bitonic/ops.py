"""Public wrappers of the bitonic sort kernel: the counterparts of the JAX
package's ``bitonic_sort_tpu`` and ``sort_pairs_tpu``
(``src/repro/kernels/bitonic/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.core import sorter as _sorter
from repro_torch.kernels.bitonic import kernel as _k


def bitonic_sort_cuda(operands, num_keys: int = 1) -> tuple:
    """Sort parallel ``[R, T]`` (or ``[T]``) tensors by the leading
    ``num_keys`` operands, each row on its own; T must be a power of two.
    On the card the kernel runs; on CPU tensors its plain version."""
    operands = tuple(operands)
    squeeze = operands[0].dim() == 1
    if squeeze:
        operands = tuple(o[None, :] for o in operands)
    out = _k.bitonic_sort(operands, num_keys)
    if squeeze:
        out = tuple(o[0] for o in out)
    return out


def sort_pairs_cuda(groups: torch.Tensor, keys: torch.Tensor, *,
                    full_width: bool = True):
    """(group, key) tuple sort, padded to a power of two with INT32_MAX
    groups and zero keys: by (group, key) with ``full_width``, else by
    group with the keys carried along."""
    n = groups.shape[-1]
    m = _sorter.next_pow2(n)
    if m != n:
        lead = groups.shape[:-1]
        groups = torch.cat([groups, torch.full(
            lead + (m - n,), _sorter.INT32_MAX, dtype=groups.dtype,
            device=groups.device)], -1)
        keys = torch.cat([keys, torch.zeros(lead + (m - n,), dtype=keys.dtype,
                                            device=keys.device)], -1)
    g, k = bitonic_sort_cuda((groups, keys),
                             num_keys=2 if full_width else 1)
    return g[..., :n], k[..., :n]
