"""The tiled segmented scan: the counterpart of the JAX package's
``segscan_pallas`` (``src/repro/kernels/segscan/kernel.py``).

:func:`segscan` scans a combiner state, given as its leaves, within the
segments that ``flags`` starts, over a stream of whole tiles.  On CUDA
tensors it launches ``csrc/segscan.cu`` (one pass, a chained tile prefix
in place of the TPU kernel's ordered-grid carry; a ragged last tile is
masked in the kernel); on CPU tensors it runs the plain version,
:func:`segscan_plain`, the port's
:func:`repro_torch.core.segscan.segmented_scan`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import segscan as _segscan
from repro_torch.core.combiners import Combiner, get_combiner
from repro_torch.kernels import _build
from repro_torch.kernels import common

#: the ops the CUDA kernel scans
SEGSCAN_OPS = ("sum", "min", "max", "count", "mean", "distinct_count")
#: the widest tile the CUDA kernel takes
MAX_TILE = 4096


def segscan_plain(flags: torch.Tensor, leaves: tuple, combiner: Combiner):
    """Plain torch version of :func:`segscan`: the whole stream's segmented
    scan (the tiles change nothing but the order of float additions)."""
    state = leaves[0] if len(leaves) == 1 else tuple(leaves)
    out = _segscan.segmented_scan(flags, state, combiner)
    return out if isinstance(out, tuple) else (out,)


def _key_dtype(name: str, leaves: tuple) -> torch.dtype:
    """The key type of a state, checking its leaves' types and count."""
    n = len(leaves)
    i32 = torch.int32
    if name in ("sum", "min", "max") and n == 1:
        return leaves[0].dtype
    if name == "count" and n == 1 and leaves[0].dtype == i32:
        return i32
    if name == "mean" and n == 2 and leaves[1].dtype == i32:
        return leaves[0].dtype
    if name == "distinct_count" and n == 3 and leaves[0].dtype == i32 \
            and leaves[1].dtype == leaves[2].dtype:
        return leaves[1].dtype
    raise TypeError(f"segscan: {name}'s state leaves do not match its "
                    f"combiner: {[t.dtype for t in leaves]}")


def segscan(flags: torch.Tensor, leaves, op, *, tile: int) -> tuple:
    """Segmented inclusive scan of the state ``leaves`` ([N] each, the
    combiner's state in its tuple order) over segments starting where the
    bool ``flags`` [N] are set, in tiles of ``tile`` lanes (the last one
    may be ragged).  Returns the scanned leaves."""
    combiner = op if isinstance(op, Combiner) else get_combiner(op)
    leaves = tuple(leaves)
    n = flags.shape[-1]
    if flags.dim() != 1 or any(t.shape != flags.shape for t in leaves):
        raise ValueError(f"segscan takes [N] flags and leaves, got "
                         f"{tuple(flags.shape)} and "
                         f"{[tuple(t.shape) for t in leaves]}")
    if tile < 1:
        raise ValueError(f"segscan: tiles of at least one lane, got {tile}")
    if flags.device.type == "cpu":
        return segscan_plain(flags, leaves, combiner)
    if combiner.name not in SEGSCAN_OPS:
        raise ValueError(f"segscan: the CUDA kernel scans {list(SEGSCAN_OPS)}"
                         f", not {combiner.name!r}")
    if not common.is_pow2(tile) or tile > MAX_TILE:
        raise ValueError(f"segscan: the CUDA kernel takes power-of-two tiles "
                         f"of at most {MAX_TILE} lanes, got {tile}")
    key_dtype = _key_dtype(combiner.name, leaves)
    if key_dtype not in common.KEY_TYPES or flags.dtype != torch.bool:
        raise TypeError(f"segscan: bool flags and int32 or float32 keys, got "
                        f"{flags.dtype} and {key_dtype}")
    dev = flags.device
    if n == 0:
        raise ValueError("segscan: no tile to launch over")
    if any(t.device != dev for t in leaves):
        raise ValueError("segscan: flags and leaves on different devices")
    ins = [t.contiguous() for t in leaves]
    outs = [torch.empty_like(t) for t in ins]
    nt = -(-n // tile)
    # one buffer zeroed for this launch alone: the chain's payload slots
    # (16-byte aligned), then the ticket and the status words
    scratch = torch.zeros((32 * nt + 4 * (4 + nt),), dtype=torch.uint8,
                          device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_segscan(
            flags.contiguous().data_ptr(),
            (ctypes.c_void_p * 3)(*(t.data_ptr() for t in ins)),
            (ctypes.c_void_p * 3)(*(t.data_ptr() for t in outs)), len(ins),
            common.KEY_TYPES[key_dtype], common.OP_CODES[combiner.name], n,
            tile, scratch.data_ptr() + 32 * nt, scratch.data_ptr(),
            _build.stream_handle(dev))
    _build.check(err, "segscan")
    segscan.launches += 1
    return tuple(outs)


#: kernel launches since the count was last set to 0
segscan.launches = 0
