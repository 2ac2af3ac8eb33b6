#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

What it does, in order (any failure exits non-zero, no phase swallows one):

1. identity: the card's name and power limit (``nvidia-smi``);
2. build: the hand-written kernels from ``src/repro_torch/csrc`` (timed);
3. the main path through ``repro_torch.query.execute`` on the card, with
   every kernel's launch count set to 0 just before each run and read just
   after; each run must launch the kernel it is meant to use:
     (a) grouped aggregation, ``cuda``: 2^24 (group, key) tuples, 4096
         uniform groups, sorted by (group, key), the paper's dc operator
         set (min, max, sum, count, distinct count);
     (b) count-window SWAG, ``cuda-panes``: a fresh unsorted 2^24-tuple
         stream over 64 groups, Window(ws=4096, wa=1024), ops (a) + median;
     (c) the same stream on ``cuda``, Window(ws=1024, wa=256);
     (d) SWAG without groups (group_by=False) on ``cuda-panes``,
         Window(ws=4096, wa=1024);
     (e) grouped median without a window on ``cuda`` (plus the (a) ops),
         at the largest stream the swag kernel takes in one row;
   each result is checked against the ``reference`` backend on the card
   over the full stream: groups, valid and counts equal, values equal on
   the valid lanes (int32 keys); each run is then timed over 7 calls
   (median, fastest and slowest);
4. each kernel against its plain torch version on the same card tensors at
   the shapes the main path gives it (int32 keys: exact, padded tails
   included; the swag kernel at both its row widths), timed with CUDA
   events beside the plain version, a library call where one computes the
   same function, and the least time the card could take (H100 SXM data
   sheet: 3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores);
5. prints a ``phases`` line, a ``kernels`` line, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Needs the repository beside it (``src/repro_torch``) and a CUDA card; it
exits non-zero without either.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
N = 1 << 24
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS = ("min", "max", "sum", "count", "dc")
REPLACES = {
    "groupagg": "src/repro/kernels/groupagg/kernel.py:109",
    "swag": "src/repro/kernels/swag/kernel.py:453",
    "sort_panes": "src/repro/kernels/swag/kernel.py:138",
    "swag_panes": "src/repro/kernels/swag/kernel.py:176",
}
SOURCES = {
    "groupagg": "src/repro_torch/csrc/groupagg.cu",
    "swag": "src/repro_torch/csrc/swag.cu",
    "sort_panes": "src/repro_torch/csrc/swag.cu",
    "swag_panes": "src/repro_torch/csrc/swag.cu",
}


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_all(torch, fn, reps: int):
    """(result, sorted ms of each call): one warm-up call, then ``reps``
    calls, each between CUDA events."""
    fn()
    times = []
    out = None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return out, sorted(times)


def timed(torch, fn, reps: int = 1):
    """(result, median ms of ``reps`` calls after a warm-up call)."""
    out, times = timed_all(torch, fn, reps)
    return out, times[len(times) // 2]


def max_abs_err(torch, got, want) -> float:
    """Largest |got - want| over matching tensors (dtypes must agree)."""
    err = 0.0
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"dtype/shape differ: {a.dtype}{tuple(a.shape)}"
                                 f" vs {b.dtype}{tuple(b.shape)}")
        if a.numel():
            err = max(err, (a.double() - b.double()).abs().max().item())
    return err


def flat(out):
    """(og, {name: ov}, oc) or a tuple of tensors -> list of tensors."""
    if len(out) == 3 and isinstance(out[1], dict):
        return [out[0], *out[1].values(), out[2]]
    return list(out)


def check_against_reference(torch, got, want, tag: str) -> None:
    for field in ("groups", "valid", "num_groups"):
        if not torch.equal(getattr(got, field), getattr(want, field)):
            raise AssertionError(f"{tag}: {field} differs from reference")
    # past num_groups the reference's median column holds the key its
    # clipped rank pick read, the kernels' a zero: compare the valid lanes
    for name, v in want.values.items():
        a = torch.where(want.valid, got.values[name], 0)
        b = torch.where(want.valid, v, 0)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{tag}: {name} differs from reference")


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def network_exchanges(rows: int, width: int, run: int = 1) -> float:
    """Compare-exchanges of the bitonic sort (run=1) or of the merge of
    width/run presorted runs, over ``rows`` rows."""
    lg = width.bit_length() - 1
    lr = run.bit_length() - 1
    sweeps = sum(r for r in range(lr + 1, lg + 1))
    return rows * (width / 2) * sweeps


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no port package under {src}; run it from the "
              f"repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))

    from repro_torch.interop import from_numpy, make_stream
    from repro_torch.kernels import _build
    from repro_torch.kernels.groupagg import kernel as gk
    from repro_torch.kernels.swag import kernel as sk
    from repro_torch.query import Query, Window, execute

    identity = card_identity()
    print(identity, flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)

    wrappers = {"groupagg": gk.groupagg, "swag": sk.swag,
                "sort_panes": sk.sort_panes, "swag_panes": sk.swag_panes}
    run_launches = {}

    t0 = time.perf_counter()
    data = {
        "sorted": from_numpy(*make_stream(SEED, N, 4096, 1000,
                                          sorted_by="group_key"), dev),
        "stream": from_numpy(*make_stream(SEED, N, 64, 1000), dev),
        "median": from_numpy(*make_stream(SEED, sk.MAX_ROW, 64, 1000,
                                          sorted_by="group_key"), dev),
    }
    print(f"data: {time.perf_counter() - t0:.1f} s", flush=True)

    runs = [
        ("a", "cuda", Query(ops=OPS), "sorted", ("groupagg",)),
        ("b", "cuda-panes", Query(ops=OPS + ("median",),
                                  window=Window(ws=4096, wa=1024)),
         "stream", ("sort_panes", "swag_panes")),
        ("c", "cuda", Query(ops=OPS + ("median",),
                            window=Window(ws=1024, wa=256)),
         "stream", ("swag",)),
        ("d", "cuda-panes", Query(ops=OPS + ("median",), group_by=False,
                                  window=Window(ws=4096, wa=1024)),
         "stream", ("sort_panes", "swag_panes")),
        ("e", "cuda", Query(ops=OPS + ("median",)), "median", ("swag",)),
    ]
    phases = []
    for tag, backend, q, which, expect in runs:
        g, k = data[which]
        g_in = g if q.group_by else None
        execute(q, g_in, k, backend=backend)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        res, _ = execute(q, g_in, k, backend=backend)
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        for name in expect:
            if counts[name] == 0:
                raise AssertionError(f"run ({tag}) did not launch {name}")
        run_launches[tag] = counts
        t1 = time.perf_counter()
        want, _ = execute(q, g_in, k, backend="reference")
        check_against_reference(torch, res, want, f"run ({tag})")
        check_s = time.perf_counter() - t1
        del want, res
        # [1]: the last timed result is dropped here, not held into the
        # next run's peak memory
        times = timed_all(torch, lambda: execute(q, g_in, k,
                                                 backend=backend), 7)[1]
        ms = times[len(times) // 2]
        n = k.shape[0]
        row = {"run": tag, "backend": backend, "tuples": n,
               "ops": list(q.op_names),
               "window": None if q.window is None else [q.window.ws,
                                                        q.window.wa],
               "group_by": q.group_by, "ms": ms, "ms_min": times[0],
               "ms_max": times[-1], "calls": len(times),
               "tuples_per_s": n / (ms / 1e3), "peak_bytes": peak,
               "launches": counts, "reference_check_s": check_s,
               "equal_to_reference": True}
        phases.append(row)
        print(f"run ({tag}) {backend}: {n} tuples in {ms:.3f} ms (median "
              f"of {len(times)}, {times[0]:.3f}-{times[-1]:.3f}) = "
              f"{row['tuples_per_s']:.4g} tuples/s, peak {peak / 2**30:.2f} "
              f"GiB, launches {counts}, equal to reference "
              f"({check_s:.1f} s) [{identity}]", flush=True)

    kernels = []

    # groupagg at run (a)'s shape: the padded stream, every op of (a)
    g, k = data["sorted"]
    pad = torch.full((1024,), 2**31 - 1, dtype=torch.int32, device=dev)
    gp = torch.cat([g, pad])
    kp = torch.cat([k, torch.zeros_like(pad)])
    err = 0.0
    for op in ("min", "max", "sum", "count", "distinct_count"):
        err = max(err, max_abs_err(torch, gk.groupagg(gp, kp, op, tile=1024),
                                   gk.groupagg_plain(gp, kp, op, tile=1024)))
    _, ms = timed(torch, lambda: gk.groupagg(gp, kp, "sum", tile=1024), 5)
    _, plain_ms = timed(torch, lambda: gk.groupagg_plain(gp, kp, "sum",
                                                         tile=1024))
    g64 = g.long()
    _, lib_ms = timed(torch, lambda: torch.zeros(
        4096, dtype=torch.int32, device=dev).scatter_reduce_(
        0, g64, k, "sum"), 5)
    npad = gp.numel()
    b, by = bound_ms(npad * 8 + npad * 8 + (npad // 1024) * 4, npad * 4)
    kernels.append({"name": "groupagg", "op": "sum", "ms": ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "library": "scatter_reduce_(sum) into 4096 groups",
                    "max_abs_err": err, "bound_ms": b, "bound_by": by,
                    "shape": [npad // 1024, 1024], "runs": ["a"]})
    del gp, kp, g64

    # swag (re-sort rows) at run (c)'s shape
    g, k = data["stream"]
    ops = OPS[:4] + ("distinct_count", "median")
    fg, fk = g.unfold(0, 1024, 256), k.unfold(0, 1024, 256)
    out, ms = timed(torch, lambda: sk.swag(fg, fk, ops), 3)
    want, plain_ms = timed(torch, lambda: sk.swag_plain(fg, fk, ops))
    err = max_abs_err(torch, flat(out), flat(want))
    del out, want
    nw = fg.shape[0]
    b, by = bound_ms(N * 8 + nw * 1024 * 4 * (1 + len(ops)) + nw * 4,
                     network_exchanges(nw, 1024) * 4
                     + nw * 1024 * 2 * len(ops))
    kernels.append({"name": "swag", "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None, "max_abs_err": err, "bound_ms": b,
                    "bound_by": by, "shape": [nw, 1024], "runs": ["c"]})

    # swag as run (e) launches it: the whole stream as one 16384-lane row
    # (the 16-lanes-a-thread variant of the kernel)
    mg, mk = (x[None, :] for x in data["median"])
    width = mg.shape[1]
    out, ms = timed(torch, lambda: sk.swag(mg, mk, ops), 5)
    want, plain_ms = timed(torch, lambda: sk.swag_plain(mg, mk, ops))
    err = max_abs_err(torch, flat(out), flat(want))
    del out, want
    b, by = bound_ms(width * 8 + width * 4 * (1 + len(ops)) + 4,
                     network_exchanges(1, width) * 4 + width * 2 * len(ops))
    kernels.append({"name": "swag", "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None, "max_abs_err": err, "bound_ms": b,
                    "bound_by": by, "shape": [1, width], "runs": ["e"]})

    # sort_panes and swag_panes at run (b)'s shape
    p, wa = 4, 1024
    np_ = (N - 4096) // wa + p
    pg, pk = g[:np_ * wa].reshape(np_, wa), k[:np_ * wa].reshape(np_, wa)
    sorted_k, ms = timed(torch, lambda: sk.sort_panes(pg, pk), 5)
    sorted_p, plain_ms = timed(torch, lambda: sk.sort_panes_plain(pg, pk))
    err = max_abs_err(torch, sorted_k, sorted_p)

    def library_sort():
        by_key = torch.sort(pk, dim=-1, stable=True).indices
        g1 = torch.gather(pg, -1, by_key)
        by_group = torch.sort(g1, dim=-1, stable=True).indices
        return (torch.gather(g1, -1, by_group),
                torch.gather(torch.gather(pk, -1, by_key), -1, by_group))

    lib_out, lib_ms = timed(torch, library_sort, 5)
    if max_abs_err(torch, lib_out, sorted_k) != 0.0:
        raise AssertionError("library sort disagrees with sort_panes")
    b, by = bound_ms(np_ * wa * 16, network_exchanges(np_, wa) * 4)
    kernels.append({"name": "sort_panes", "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms,
                    "library": "two stable torch.sort passes + gathers",
                    "max_abs_err": err, "bound_ms": b, "bound_by": by,
                    "shape": [np_, wa], "runs": ["b", "d"]})
    del lib_out, sorted_p

    sg, skk = sorted_k
    out, ms = timed(torch, lambda: sk.swag_panes(sg, skk, ops, p=p), 3)
    want, plain_ms = timed(torch, lambda: sk.swag_panes_plain(sg, skk, ops,
                                                              p=p))
    err = max_abs_err(torch, flat(out), flat(want))
    del out, want
    nw = np_ - p + 1
    b, by = bound_ms(np_ * wa * 8 + nw * 4096 * 4 * (1 + len(ops)) + nw * 4,
                     network_exchanges(nw, 4096, wa) * 4
                     + nw * 4096 * 2 * len(ops))
    kernels.append({"name": "swag_panes", "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None, "max_abs_err": err, "bound_ms": b,
                    "bound_by": by, "shape": [nw, 4096],
                    "runs": ["b", "d"]})

    for row in kernels:
        if row["max_abs_err"] != 0.0:
            raise AssertionError(f"{row['name']}: kernel and plain version "
                                 f"differ by {row['max_abs_err']} (int32 "
                                 f"keys must match exactly)")
        # launches: the main-path runs that give the kernel this shape
        row.update(route="cuda", source=SOURCES[row["name"]],
                   replaces=REPLACES[row["name"]],
                   launches=sum(run_launches[tag][row["name"]]
                                for tag in row["runs"]), card=identity)
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the main "
                                 f"path at {row['shape']}")

    print(json.dumps({"phases": phases}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_identity(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
