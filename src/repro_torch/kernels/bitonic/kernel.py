"""The row-wise bitonic sort: the counterpart of the JAX package's
``bitonic_pallas`` (``src/repro/kernels/bitonic/kernel.py``).

:func:`bitonic_sort` sorts each row of ``[R, T]`` operands (T a power of
two) by the leading ``num_keys`` operands, lexicographically, and carries
every other operand along.  On CUDA tensors it launches
``csrc/bitonic.cu`` (one block a row; the key words and lane indices in
registers, strides within a warp by shuffles, shared memory only past a
warp's span; the payloads gathered through the final permutation); on CPU
tensors it runs the plain version, :func:`bitonic_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import sorter
from repro_torch.kernels import _build
from repro_torch.kernels import common
from repro_torch.kernels.swag.kernel import MAX_ROW

#: key operands the CUDA kernel compares (the JAX wrapper has no limit)
MAX_KEYS = 4
#: payload operands one launch carries
MAX_PAYLOADS = 16
#: shared memory one block may use (H100: 227 KiB)
_SMEM_BYTES = 232448


def max_lanes(num_keys: int) -> int:
    """The longest row the kernel sorts by ``num_keys`` keys: the key words
    and a lane index, 4 bytes each, must fit one block's shared memory."""
    t = MAX_ROW
    while (num_keys + 1) * 4 * t > _SMEM_BYTES:
        t //= 2
    return t


def bitonic_geometry(num_keys: int, width: int,
                     max_payload_bytes: int = 0) -> dict:
    """The launch shape of :func:`bitonic_sort` for rows of ``width`` lanes
    by ``num_keys`` keys with payloads of at most ``max_payload_bytes`` an
    element, as the CUDA library chooses it: lanes a thread, threads a
    block and dynamic shared memory a block (bytes)."""
    lanes, threads, smem = ctypes.c_int(), ctypes.c_int(), \
        ctypes.c_longlong()
    _build.check(_build.library().rt_bitonic_geometry(
        num_keys, width, max_payload_bytes, ctypes.byref(lanes),
        ctypes.byref(threads), ctypes.byref(smem)), "bitonic_geometry")
    return {"lanes_per_thread": lanes.value, "threads": threads.value,
            "smem_bytes": smem.value}


def bitonic_plain(operands, num_keys: int) -> tuple:
    """Plain torch version of :func:`bitonic_sort`: the network of
    :func:`repro_torch.core.sorter.bitonic_sort`, each row on its own."""
    return sorter.bitonic_sort(tuple(operands), num_keys=num_keys)


def bitonic_sort(operands, num_keys: int) -> tuple:
    """Sort each row of the ``[R, T]`` operands by the leading
    ``num_keys`` (int32 or float32 keys on the card; ties never swap).
    Returns the sorted operands."""
    operands = tuple(operands)
    if not operands or operands[0].dim() != 2:
        raise ValueError("bitonic_sort takes [R, T] operands")
    shape = operands[0].shape
    if any(o.shape != shape for o in operands):
        raise ValueError(f"bitonic_sort: operands differ in shape: "
                         f"{[tuple(o.shape) for o in operands]}")
    if not 1 <= num_keys <= len(operands):
        raise ValueError(f"num_keys must be in [1, {len(operands)}], got "
                         f"{num_keys}")
    if not common.is_pow2(shape[1]):
        raise ValueError(f"bitonic_sort needs power-of-two rows, got "
                         f"{shape[1]} lanes")
    if operands[0].device.type == "cpu":
        return bitonic_plain(operands, num_keys)
    r, t = shape
    dev = operands[0].device
    if num_keys > MAX_KEYS:
        raise ValueError(f"bitonic_sort: the CUDA kernel compares at most "
                         f"{MAX_KEYS} keys, got {num_keys}")
    if len(operands) - num_keys > MAX_PAYLOADS:
        raise ValueError(f"bitonic_sort: the CUDA kernel carries at most "
                         f"{MAX_PAYLOADS} payloads, got "
                         f"{len(operands) - num_keys}")
    if t > max_lanes(num_keys):
        raise ValueError(
            f"bitonic_sort: a row of {t} lanes does not fit one block's "
            f"shared memory; with {num_keys} keys the CUDA kernel takes "
            f"rows of at most {max_lanes(num_keys)} lanes")
    if r == 0:
        raise ValueError("bitonic_sort: no rows to launch over")
    keys, pays = operands[:num_keys], operands[num_keys:]
    if any(o.device != dev for o in operands):
        raise ValueError("bitonic_sort: operands on different devices")
    if any(k.dtype not in common.KEY_TYPES for k in keys):
        raise TypeError(f"bitonic_sort: the CUDA kernel compares int32 or "
                        f"float32 keys, got {[k.dtype for k in keys]}")
    sizes = [p.element_size() for p in pays]
    if any(s not in (1, 2, 4, 8) for s in sizes):
        raise TypeError(f"bitonic_sort: payloads of 1, 2, 4 or 8 bytes an "
                        f"element, got {[p.dtype for p in pays]}")
    ins = [o.contiguous() for o in operands]
    outs = [torch.empty_like(o) for o in ins]
    float_keys = sum(1 << j for j, k in enumerate(keys)
                     if k.dtype == torch.float32)

    def ptrs(ts):
        return (ctypes.c_void_p * max(len(ts), 1))(*(x.data_ptr() for x in ts))

    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rt_bitonic_sort(
            ptrs(ins[:num_keys]), ptrs(outs[:num_keys]), num_keys,
            float_keys, ptrs(ins[num_keys:]), ptrs(outs[num_keys:]),
            (ctypes.c_int * max(len(sizes), 1))(*sizes), len(pays), r, t,
            _build.stream_handle(dev))
    _build.check(err, "bitonic_sort")
    bitonic_sort.launches += 1
    return tuple(outs)


#: kernel launches since the count was last set to 0
bitonic_sort.launches = 0
