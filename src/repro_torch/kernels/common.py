"""Device probe and the plain-torch in-tile primitives of the kernels.

These are the plain versions the CUDA kernels are held against (the
counterparts of the JAX package's ``kernels/common.py``); the device
functions themselves live in ``csrc/tile.cuh``.  Every primitive works along
the last axis of a batch of tiles.
"""
from __future__ import annotations

import torch

from repro_torch.core import segscan, sorter
from repro_torch.core.combiners import Combiner


def require_cuda(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present — the port never runs on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain torch versions")
    return device


def is_pow2(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


def _shift_right(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x[i] <- x[i-d] along the last axis, front-filled."""
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :-d]], dim=-1)


def _shift_left(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x[i] <- x[i+d] along the last axis, back-filled."""
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x[..., d:], pad], dim=-1)


def tile_segmented_scan(flags: torch.Tensor, state, combiner: Combiner):
    """Inclusive segmented scan across the last axis of every state leaf
    (Hillis–Steele); a tile's lane 0 always starts a segment."""
    t = flags.shape[-1]
    if not is_pow2(t):
        raise ValueError(f"tile length must be a power of two, got {t}")
    return segscan.segmented_scan(flags, state, combiner)


def butterfly_compact(valid: torch.Tensor, arrays, fills):
    """Dense left-compaction of the ``valid`` lanes along the last axis.

    The function of the JAX package's reverse butterfly (each valid lane
    moves to its rank, the exclusive prefix sum of ``valid``), written as a
    scatter.  Returns (compacted arrays with the tail filled, count of
    valid lanes as ``[..., 1]`` int32)."""
    t = valid.shape[-1]
    rank = segscan.exclusive_prefix_sum(valid)
    dest = torch.where(valid, rank, t).to(torch.int64)
    out = []
    for a, fill in zip(arrays, fills):
        buf = torch.full(a.shape[:-1] + (t + 1,), fill, dtype=a.dtype,
                         device=a.device)
        out.append(buf.scatter_(-1, dest, a)[..., :t])
    count = valid.to(torch.int32).sum(-1, keepdim=True, dtype=torch.int32)
    return tuple(out), count


def bitonic_sort_tile(operands, num_keys: int) -> tuple:
    """Bitonic sort along the last axis (the network of
    :func:`repro_torch.core.sorter.bitonic_sort`)."""
    if not is_pow2(operands[0].shape[-1]):
        raise ValueError("tile length must be a power of two")
    return sorter.bitonic_sort(operands, num_keys=num_keys)


def bitonic_merge_tile(operands, num_keys: int, run: int) -> tuple:
    """Multiway merge of T/run presorted ascending runs along the last axis
    (:func:`repro_torch.core.sorter.merge_presorted`)."""
    t = operands[0].shape[-1]
    if not (is_pow2(t) and is_pow2(run) and t % run == 0):
        raise ValueError(f"need power-of-two tile/run, got T={t} run={run}")
    return sorter.merge_presorted(operands, run=run, num_keys=num_keys)


#: kernel key types (the C side's KeyType)
KEY_TYPES = {torch.int32: 0, torch.float32: 1}
#: C-side op codes (csrc/tile.cuh, OpCode)
OP_CODES = {name: i for i, name in enumerate(
    ("sum", "min", "max", "count", "mean", "distinct_count", "first",
     "last", "variance", "argmin", "argmax", "median"))}


def check_kernel_inputs(name: str, groups: torch.Tensor,
                        keys: torch.Tensor) -> None:
    """What every CUDA kernel of the port takes: groups and keys on one
    card, int32 groups, int32 or float32 keys, unit stride on the last
    axis."""
    if groups.device != keys.device:
        raise ValueError(f"{name}: groups on {groups.device}, keys on "
                         f"{keys.device}")
    if groups.dtype != torch.int32:
        raise TypeError(f"{name}: groups must be int32, got {groups.dtype}")
    if keys.dtype not in KEY_TYPES:
        raise TypeError(f"{name}: the CUDA kernel takes int32 or float32 "
                        f"keys, got {keys.dtype}")
    if groups.shape != keys.shape:
        raise ValueError(f"{name}: groups {tuple(groups.shape)} and keys "
                         f"{tuple(keys.shape)} differ in shape")
    if groups.stride(-1) != 1 or keys.stride(-1) != 1:
        raise ValueError(f"{name}: the last axis must have unit stride")


def counter_slots(counters: dict, names, device: torch.device) -> list:
    """The 0-d int32 tensors of ``counters`` named ``names`` (made 0 on
    ``device`` where missing; the dict is updated): what a kernel's
    wrapper hands its launch, which counts into them where they lie."""
    out = []
    for name in names:
        t = counters.get(name)
        if t is None:
            t = counters[name] = torch.zeros((), dtype=torch.int32,
                                             device=device)
        if t.dtype != torch.int32 or t.device != device or t.numel() != 1:
            raise ValueError(f"counter {name!r} must be one int32 on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        out.append(t)
    return out
