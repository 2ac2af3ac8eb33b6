"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own ``nvcc``
process, all at once, and linked into one shared library with a plain C
interface, loaded with ``ctypes``.  The library lives under
``build/repro_torch/`` at the repository root, named by a hash of the
sources and flags, and is built at first use.  No ``--use_fast_math``:
the ``mean`` divide must stay IEEE to match the JAX package bit for bit.

Each C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # g, k, key_type, n, lim, nvalid, tile, flat, codes, outs, nops, status,
    # payload, og, valid, oc, num, stream
    "rt_groupagg": [_P, _P, _I, ctypes.c_longlong, ctypes.c_longlong, _P, _I,
                    _I, ctypes.POINTER(_I), ctypes.POINTER(_P), _I, _P, _P,
                    _P, _P, _P, _P, _P],
    # g, k, key_type, stride, nrows, T, run, codes, outs, nops, og, oc, stream
    "rt_swag_rows": [_P, _P, _I, ctypes.c_longlong, _I, _I, _I,
                     ctypes.POINTER(_I), ctypes.POINTER(_P), _I, _P, _P, _P],
    # T, lanes a thread, threads a block, dynamic shared memory bytes
    "rt_swag_geometry": [_I, ctypes.POINTER(_I), ctypes.POINTER(_I),
                         ctypes.POINTER(ctypes.c_longlong)],
    # g, k, key_type, nrows, T, og, ok, stream
    "rt_sort_rows": [_P, _P, _I, _I, _I, _P, _P, _P],
    # g, k, key_type, n, wa, c, ng, gid, slots0, gtab, dir, clock, ring_k,
    # ring_s, plan, snaps, clock_s, rk_s, rs_s, events, stats, c_evict,
    # c_hwm, stream
    "rt_pergroup_scan": [_P, _P, _I, _I, _I, _I, _I] + [_P] * 17,
    # wk, wq, start, endp, own, cnt, lo, ug, perm, key_type, ne, wa, c,
    # codes, outs, nops, stream
    "rt_pergroup_fused": [_P] * 9 + [_I, _I, _I, _I, ctypes.POINTER(_I),
                                     ctypes.POINTER(_P), _I, _P],
    # rk, rv, key_type, nrows, T, run, codes, outs, nops, stream
    "rt_pergroup_replay": [_P, _P, _I, _I, _I, _I, ctypes.POINTER(_I),
                           ctypes.POINTER(_P), _I, _P],
    # keys, seqs, count, base, perm, offsets, nslots, num, ws, live_out,
    # key_type, ne, c, wa, runs, time_win, codes, outs, nops, stream
    "rt_pergroup_replay_ring": [_P] * 10 + [_I] * 6 + [
        ctypes.POINTER(_I), ctypes.POINTER(_P), _I, _P],
    # g, k, ts, live, n, retire_below, key_type, wa, c, slide, owner, count,
    # base, stamp, clock, ring_k, ring_s, events, aux, c_evict, c_hwm, stream
    "rt_pergroup_scan_time": [_P] * 4 + [_I, _P, _I, _I, _I, _I] + [_P] * 12,
    # ts, g, k, n, nvalid, nvalid_dev, drain, release, late, drain_all,
    # shards, the buffers read (ts, grp, val, seq, occ, max_ts, last_emit,
    # seq_clock, dropped) and written (the same nine), capacity,
    # max_lateness, out ts, groups, keys, live, late, c_forced, c_depth,
    # stream
    "rt_reorder": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I] + [_P] * 18
    + [_I, _I] + [_P] * 8,
    # keys, okeys, nk, float_keys, pays, opays, psize, np, R, T, stream
    "rt_bitonic_sort": [ctypes.POINTER(_P), ctypes.POINTER(_P), _I, _I,
                        ctypes.POINTER(_P), ctypes.POINTER(_P),
                        ctypes.POINTER(_I), _I, _I, _I, _P],
    # nk, T, max payload bytes, lanes a thread, threads a block, shared bytes
    "rt_bitonic_geometry": [_I, _I, _I, ctypes.POINTER(_I),
                            ctypes.POINTER(_I),
                            ctypes.POINTER(ctypes.c_longlong)],
    # flags, ins, outs, nleaves, key_type, op, n, tile, status, payload,
    # stream
    "rt_segscan": [_P, ctypes.POINTER(_P), ctypes.POINTER(_P), _I, _I, _I,
                   ctypes.c_longlong, _I, _P, _P, _P],
    # kf, vf, kb, vb, key_type, ne, W, codes, outs, nops, stream
    "rt_twostack_flip": [_P, _P, _P, _P, _I, _I, _I, ctypes.POINTER(_I),
                         ctypes.POINTER(_P), _I, _P],
    # W, lanes a thread, threads a block, dynamic shared memory bytes
    "rt_twostack_geometry": [_I, ctypes.POINTER(_I), ctypes.POINTER(_I),
                             ctypes.POINTER(ctypes.c_longlong)],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: wall seconds the last build took (0.0 when the library was cached)
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> None:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *map(str, objs), "-o", str(lib)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(lib, target)  # atomic: a concurrent build sees all or none


def library() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"librepro_torch_{_digest()}.so"
            if not target.exists():
                target.parent.mkdir(parents=True, exist_ok=True)
                t0 = time.perf_counter()
                _compile(target)
                build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device``, as an int for ``ctypes``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
