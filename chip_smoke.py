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
         set (min, max, sum, count, distinct count), in exactly one
         groupagg launch for all five ops;
     (b) count-window SWAG, ``cuda-panes``: a fresh unsorted 2^24-tuple
         stream over 64 groups, Window(ws=4096, wa=1024), ops (a) + median;
     (c) the same stream on ``cuda``, Window(ws=1024, wa=256);
     (d) SWAG without groups (group_by=False) on ``cuda-panes``,
         Window(ws=4096, wa=1024);
     (e) grouped median without a window on ``cuda`` (plus the (a) ops),
         at the largest stream the swag kernel takes in one row;
     (f) per-group windows on ``cuda-panestore``, partial-fused regime, at
         the repo's per-group configuration (``benchmarks/swag_bench.py``):
         Window(ws=1024, wa=128, ws_per_group=1024, capacity=292), 32
         uniform groups, 2^20 tuples, ops sum/count/min/max/mean;
     (g) the same window over 64 groups (the 292 slots hold about half of
         their windows, so the oldest panes are evicted), 2^16 tuples, ops
         (f) + median + dc: the merge-replay regime, whose replay kernel
         reads the placement scan's ring snapshots;
     (h) batch event-time windows on ``cuda``, Window(range=4096,
         slide=1024), ungrouped sum/count/min/max: the two-stack; 2^24
         tuples with int32 keys uniform in [0, 2^20), tuple i stamped
         floor(i * 8 / 7) + U[0, 64) (0.875 tuples a time unit, out of
         order within 64): about 18,725 windows of about 3,584 tuples
         (wcap 4096) in about 4,681 epochs;
     (i) the same stream and window over 64 groups, ops (a) + median: the
         replay strategy, the swag kernel over the framed windows;
     (j) the standalone sort, ``bitonic_sort_cuda``, on 16384 rows of 1024
         (int32 group, int32 key) pairs of (b)'s stream, with a float32
         payload;
     (k) the standalone scan, ``segmented_scan_cuda``, of (a)'s sorted
         stream (2^24 lanes, 4096 groups, tile 1024), ops sum and mean;
     (l) the row-form replay, ``pergroup_replay`` (the signature of the
         JAX package's ``pergroup_replay_pallas``), over (g)'s 149,504
         gathered replay rows of 2048 lanes, (g)'s ops;
     (m) a stream without a window through ``execute(state=)`` on
         ``cuda``: (a)'s stream in 16 pushes of 2^20 tuples, (a)'s ops,
         one segmented_scan launch an op a push;
     (n) a windowed stream through ``StreamingAggregator`` on
         ``cuda-panestore``: (g)'s window and stream in 8 pushes of 8000
         tuples and one of 1536 (each leaves a ragged chunk), (g)'s ops,
         then a flush; one placement scan (the final store only, updated
         in place) and one ring-form replay a push, one replay the flush;
     (o) an event-time stream through ``StreamingAggregator`` on
         ``cuda-panestore`` (``auto``): (h)'s generator (2^16 tuples, 64
         groups) and window, Window(range=4096, slide=1024, wa=16,
         capacity=1024, max_lateness=64, reorder_capacity=128), in 64
         pushes of 1024 tuples, (g)'s ops, then a flush; one reorder, one
         time-mode placement and one time-form ring replay a push and for
         the flush, the buffers updated in place;
   each result is checked against the ``reference`` backend on the card
   (groups, valid and counts equal, values equal on the valid lanes, int32
   keys): (a)-(e), (h) and (i) over the full stream, (f) and (g) over their
   first 2^16 tuples, whose evaluations are the leading ones of the full run
   (the reference places tuples one at a time in plain torch); (h) also
   against the replay strategy on the card; (j) against two stable
   ``torch.sort`` passes (keys) and the plain network (payload), (k)
   against the plain scan, (l) against (g)'s ring-form replay, (m) push by
   push against the reference backend's stream on the card and, with the
   open group of its final carries, against (a)'s one-shot result, (n)
   push by push (outputs with rr_port, and the store) against the plain
   placement on a host copy and the plain replay, through the first push
   that evicts, and its flush against the plain replay, (o) push by push
   (outputs with rr_port and late_dropped, which must stay 0, and the
   carried reorder buffer and store) against the plain reorder, placement
   and replay chained on the host, through the first push whose placement
   retires a pane, and its flush against the plain flush of a host copy of
   the carry before it; the
   per-group runs print the evictions and retirements of that prefix, and
   (f) fails without a retirement, (g) without an eviction; (h) and (i)
   print the share of their time spent in
   the window layout (its sort and searches, read back to the host) and,
   for (h), the host's walk of the epoch schedule; each run is then timed
   over 7 calls (median, fastest and slowest; (m), (n) and (o) over 7
   whole streams);
4. each kernel against its plain torch version on the same card tensors at
   the shapes the main path gives it (int32 keys: exact, padded tails
   included; the swag kernel at both its row widths, and on float32
   keys swag at (c)'s and swag_panes at (b)'s widths over 4096 rows, every
   window op, sums, means and variances within rtol = atol = 1e-5; the
   window kernels', the sort's and the flip's launch shapes and ptxas's
   registers and spills (one more ``nvcc -Xptxas -v`` of ``csrc/swag.cu``,
   ``csrc/pergroup.cu``, ``csrc/bitonic.cu``, ``csrc/twostack.cu``,
   ``csrc/groupagg.cu``, ``csrc/segscan.cu`` and ``csrc/reorder.cu``; a
   spill in the window, pane-sort, replay, sort, flip, group-by, scan,
   reorder or time-mode placement kernels fails the script) printed,
   swag at (c)'s and swag_panes at (b)'s shape timed with op count alone, and the sort, the flip, both groupagg layouts
   (the flat launch of all (a)'s ops and the per-tile op sum) and the scan
   also timed 20 calls back to back; the per-group placement scan, with
   its eviction and retirement counts, on the first 2^16 tuples and at
   (n)'s push, its plain version being one torch loop step a tuple; the
   scan at (m)'s push, every op; the ring replay at (n)'s one evaluation;
   at (o)'s push the reorder kernel and the time-mode placement, each also
   on float32 keys with -0.0 and NaN and on an edge push, timed too —
   forced pops and late tuples (a 32-slot buffer), chaining, evictions and
   negative timestamps (32 slots, four groups) —, the reorder also on a
   1024-slot buffer that holds about 900 tuples (timed), each printed
   with its ns a tuple beside the first design's (PERF.md §6), and the
   time-form replay of (o)'s last store, on float32 keys too),
   timed with CUDA events beside the plain
   version, a library call where one computes the same function, and the
   least time the card could take (H100 SXM data sheet: 3.35 TB/s, 67
   TFLOP/s float32 outside the tensor cores);
5. prints a ``phases`` line, a ``kernels`` line, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Needs the repository beside it (``src/repro_torch``) and a CUDA card; it
exits non-zero without either.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
N = 1 << 24
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS = ("min", "max", "sum", "count", "dc")
#: tuples of runs (f) and (g) held against the reference: past (f)'s first
#: retirement (about 37k) and (g)'s first eviction (about 33k)
PREFIX = 1 << 16
PARTIAL = ("sum", "count", "min", "max", "mean")
#: the per-group window of runs (f) and (g) (benchmarks/swag_bench.py)
PERGROUP = dict(ws=1024, wa=128, ws_per_group=1024, capacity=292)
#: the time window of runs (h) and (i), and its stream: 0.875 tuples a time
#: unit, out of order within 64 units, keys uniform in [0, 2^20)
TIME_WINDOW = dict(range=4096, slide=1024)
TIME_STREAM = dict(key_max=1 << 20, density=0.875, jitter=64)
TWOSTACK = ("sum", "count", "min", "max")
#: run (j): 16384 rows of 1024 lanes
SORT_ROWS = (16384, 1024)
#: run (m): (a)'s stream pushed in 16 batches of 2^20 tuples
STREAM_BATCHES = 16
#: run (n): (g)'s stream pushed as 8 x 8000 tuples and 1536, each push
#: leaving a ragged chunk of WA = 128
WINDOW_PUSHES = (8000,) * 8 + (1536,)
#: run (o): (h)'s stream generator and window, streamed: 2^16 tuples over 64
#: groups in 64 pushes of 1024, a time-mode store of 1024 slots of 16 (a
#: replay row of 1024 x 16 = 16384 lanes), a reorder buffer of 128 slots
#: (jitter 64 < lateness 64 + 1: nothing late)
EVENT_WINDOW = dict(range=4096, slide=1024, wa=16, capacity=1024,
                    max_lateness=64, reorder_capacity=128)
EVENT_STREAM = dict(n=1 << 16, n_groups=64, key_max=1 << 20, density=0.875,
                    jitter=64)
EVENT_PUSH = 1024
#: ns a tuple of the event-time kernels' first design at run (o)'s push
#: (PERF.md §6, rows 11 and 12), printed beside this run's
PARENT_NS = {"reorder": 1101.0, "pergroup_scan_time": 2597.0}
REPLACES = {
    "groupagg": "src/repro/kernels/groupagg/kernel.py:109",
    "swag": "src/repro/kernels/swag/kernel.py:453",
    "sort_panes": "src/repro/kernels/swag/kernel.py:138",
    "swag_panes": "src/repro/kernels/swag/kernel.py:176",
    "pergroup_replay": "src/repro/kernels/swag/kernel.py:245",
    "pergroup_replay_ring": "src/repro/kernels/swag/kernel.py:245",
    "pergroup_fused": "src/repro/kernels/swag/kernel.py:365",
    # no TPU kernel: the XLA lax.scan of _push_decide
    "pergroup_scan": "src/repro/core/panestore.py:238",
    # no TPU kernel: the lax.scans of _reorder_cycle (and _reorder_drain)
    # and of _push_one_time
    "reorder": "src/repro/core/eventtime.py:168",
    "pergroup_scan_time": "src/repro/core/panestore.py:379",
    "twostack_flip": "src/repro/kernels/swag/kernel.py:428",
    "bitonic_sort": "src/repro/kernels/bitonic/kernel.py:36",
    "segmented_scan": "src/repro/kernels/segscan/kernel.py:76",
}
SOURCES = {
    "groupagg": "src/repro_torch/csrc/groupagg.cu",
    "swag": "src/repro_torch/csrc/swag.cu",
    "sort_panes": "src/repro_torch/csrc/swag.cu",
    "swag_panes": "src/repro_torch/csrc/swag.cu",
    "pergroup_scan": "src/repro_torch/csrc/pergroup.cu",
    "pergroup_scan_time": "src/repro_torch/csrc/pergroup.cu",
    "reorder": "src/repro_torch/csrc/reorder.cu",
    "pergroup_fused": "src/repro_torch/csrc/pergroup.cu",
    "pergroup_replay": "src/repro_torch/csrc/pergroup.cu",
    "pergroup_replay_ring": "src/repro_torch/csrc/pergroup.cu",
    "twostack_flip": "src/repro_torch/csrc/twostack.cu",
    "bitonic_sort": "src/repro_torch/csrc/bitonic.cu",
    "segmented_scan": "src/repro_torch/csrc/segscan.cu",
}


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_all(torch, fn, reps: int, warmup: bool = True):
    """(result, sorted ms of each call): one warm-up call (unless
    ``warmup`` is False), then ``reps`` calls, each between CUDA events."""
    if warmup:
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


def timed(torch, fn, reps: int = 1, warmup: bool = True):
    """(result, median ms of ``reps`` calls after a warm-up call)."""
    out, times = timed_all(torch, fn, reps, warmup)
    return out, times[len(times) // 2]


def back_to_back_ms(torch, fn, reps: int = 20) -> float:
    """ms a call of ``reps`` calls in a row between one pair of CUDA events
    (after a warm-up call): each call's host work overlaps the device work
    of the calls before it, so a kernel that outlasts its wrapper's host
    work shows its device time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def counted_call(torch, fn, wrappers):
    """(result, launches, peak bytes) of ``fn()`` after a warm-up call,
    every launch count set to 0 just before it and read just after."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return (out, {nm: w.launches for nm, w in wrappers.items()},
            torch.cuda.max_memory_allocated())


def plain_once(torch, fn):
    """(result, ms) of one call of a plain per-tuple or per-chunk loop (a
    warm-up call would double the slowest part of the script)."""
    return timed(torch, fn, 1, warmup=False)


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


def leading(res, n_evals: int):
    """The first ``n_evals`` evaluations of a windowed result."""
    return type(res)(res.groups[:n_evals],
                     {k: v[:n_evals] for k, v in res.values.items()},
                     res.valid[:n_evals], res.num_groups[:n_evals])


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


#: the ops of run (g) and of the row-form replay, run (l)
REPLAY_OPS = PARTIAL + ("median", "distinct_count")


def replay_inputs(torch, sk, ps, data, dev):
    """(spec, the stores after every chunk of (g)'s scan with the ring,
    and the gathered replay rows of them: keys [R, L], int32 liveness)."""
    from repro_torch.query import Window

    spec = Window(**PERGROUP).store_spec()
    g, k = data["pergroup64"]
    states = sk.pergroup_scan(spec, ps.init_store(spec, torch.int32,
                                                  device=dev), g, k).states
    runs = ps.gather_runs(spec, states)
    length = runs.run_keys.shape[-1]
    return (spec, states, runs.run_keys.reshape(-1, length),
            runs.run_valid.reshape(-1, length).to(torch.int32))


def ring_replay_err(torch, got, want, c: int) -> float:
    """Hold a ring-form replay's (values, ugroups, num) to another: groups
    and counts equal, values compared on the rows below num (the kernel
    leaves the rest unwritten); the largest |difference|."""
    (gv, gg, gn), (wv, wg, wn) = got, want
    if not (torch.equal(gg, wg) and torch.equal(gn, wn)):
        raise AssertionError("pergroup_replay_ring: groups or num differ")
    valid = torch.arange(c, device=gn.device)[None, :] < wn[:, None]
    return max_abs_err(
        torch, [torch.where(valid, gv[nm], 0).to(gv[nm].dtype) for nm in wv],
        [torch.where(valid, v, 0).to(v.dtype) for v in wv.values()])


def ring_replay_bound(torch, spec, dirs, counts, n_ops: int) -> dict:
    """The least time of a ring-form replay over the stores whose
    :func:`ring_directory` is ``dirs``, with ``counts`` [NE, C] each live
    row's live lanes: bytes only, the seq of every filled lane of a slot
    read, the key of every live lane, each slot read's place in perm and
    count, each live row's offset, slot count, window and newest base,
    num, and one 4-byte output a live row and op (the rows past num are
    not written)."""
    c = spec.capacity
    num, offsets = dirs["num"], dirs["offsets"].long()
    ne = num.shape[0]
    valid = torch.arange(c, device=num.device)[None, :] < num[:, None]
    live_rows = int(num.sum())
    # the slots each live group reads (its first min(nslots, runs) in
    # perm), and the lanes filled in them
    j = torch.arange(spec.runs, device=num.device)
    reads = valid[..., None] & (j < dirs["nslots"][..., None])
    at = torch.clamp(offsets[..., None] + j, max=c - 1).reshape(ne, -1)
    slot = torch.gather(dirs["perm"].long(), 1, at)
    filled = torch.gather(dirs["count"], 1, slot).reshape(reads.shape)
    slots_read = int(reads.sum())
    filled_lanes = int(torch.where(reads, filled, 0).sum())
    live_lanes = int(torch.where(valid, counts, 0).sum())
    b, by = bound_ms(4.0 * filled_lanes + 4.0 * live_lanes + 8.0 * slots_read
                     + 16.0 * live_rows + 4.0 * ne
                     + 4.0 * live_rows * n_ops, 0.0)
    return {"bound_ms": b, "bound_by": by, "live_rows": live_rows,
            "slots_read": slots_read, "filled_lanes": filled_lanes,
            "live_lanes": live_lanes}


def pergroup_kernels(torch, sk, data, dev) -> list:
    """The per-group kernels at the shapes runs (f) and (g) give them, each
    against its plain version (the scan on the first PREFIX tuples)."""
    from repro_torch.core import panestore as ps
    from repro_torch.core.swag import frame_panes, write_plan
    from repro_torch.query import Window

    spec = Window(**PERGROUP).store_spec()
    c, wa = spec.capacity, spec.wa
    rows = []

    def scan_row(tag, g, k):
        ring = k is not None
        st = ps.init_store(spec, torch.int32, device=dev)
        n = g.shape[0]
        trace, ms = timed(torch, lambda: sk.pergroup_scan(spec, st, g, k), 3)
        batches, clean = sk.pergroup_scan.batch_stats.tolist()
        # the same placement as a streaming push (WA divides N here, so
        # it places the same tuples), which records no store after every
        # chunk: what the snapshots cost
        _, push_ms = timed(torch, lambda: sk.pergroup_scan(
            spec, st, g, k, push=True), 3)
        print(f"run ({tag}) placement scan: {clean} of {batches} batches of "
              f"up to 32 tuples placed at once ({clean / batches:.1%}), the "
              f"rest up to an allocation or a second retirement of a group; "
              f"{ms:.3f} ms, {push_ms:.3f} ms as a push keeping only the "
              f"final store", flush=True)
        pk = None if k is None else k[:PREFIX]
        got = sk.pergroup_scan(spec, st, g[:PREFIX], pk)
        want, plain_ms = plain_once(torch, lambda: sk.pergroup_scan_plain(
            spec, st, g[:PREFIX], pk))
        fields = lambda t: [t.slots, t.lanes, t.seqs, t.events, *(
            x for x in (*t.states, *t.final) if x is not None)]
        err = max_abs_err(torch, fields(got), fields(want))
        evictions, retirements = got.events.tolist()
        ne = n // wa
        nbytes = (4 * n * (2 if ring else 1) + 12 * n + 16 * ne * c + 4 * ne
                  + 32 * c + (8 * ne * c * wa if ring else 0))
        # per tuple: a few compares and adds on its group's newest and
        # oldest pane (the placement needs no pass over the C slots)
        b, by = bound_ms(nbytes, 8.0 * n)
        rows.append({"name": "pergroup_scan", "ms": ms, "plain_ms": plain_ms,
                     "push_ms": push_ms,
                     "plain_tuples": PREFIX, "evictions": evictions,
                     "retirements": retirements, "batches": batches,
                     "batches_at_once": clean, "library_ms": None,
                     "max_abs_err": err, "bound_ms": b, "bound_by": by,
                     "shape": [ne, wa, c], "ring": ring, "runs": [tag]})
        return trace

    g32, k32 = data["pergroup32"]
    trace = scan_row("f", g32, None)
    plan = write_plan(spec, trace)
    ne = plan[0].shape[0]
    ck = frame_panes(k32, wa, ne).contiguous()
    out, ms = timed(torch, lambda: sk.pergroup_fused(ck, *plan[:8], PARTIAL),
                    3)
    want, plain_ms = plain_once(torch, lambda: sk.pergroup_fused_plain(
        ck, *plan[:8], PARTIAL))
    err = max_abs_err(torch, list(out.values()), list(want.values()))
    del out, want
    # per chunk: the live lanes of every slot into per-slot partials, which
    # combine into their group's row in O(C)
    b, by = bound_ms(16 * ne * wa + 20 * ne * c + 4 * len(PARTIAL) * ne * c,
                     ne * 4.0 * c * wa)
    rows.append({"name": "pergroup_fused", "ms": ms, "plain_ms": plain_ms,
                 "library_ms": None, "max_abs_err": err, "bound_ms": b,
                 "bound_by": by, "shape": [ne, wa, c], "runs": ["f"]})
    del trace, plan, ck

    g64, k64 = data["pergroup64"]
    scan_row("g", g64, k64)
    _, states, rk, rv = data["replay"]
    ops = REPLAY_OPS

    # the ring form, as run (g) calls it, against the gather of every
    # evaluation's replay rows and the plain replay
    out, ms = timed(torch, lambda: sk.pergroup_replay_ring(spec, states, ops),
                    5)
    want, plain_ms = plain_once(torch, lambda: sk.pergroup_replay_ring_plain(
        spec, states, ops))
    err = ring_replay_err(torch, out, want, c)
    # the wrapper's torch glue alone (the slot directory), and the launch
    # alone over a directory built once
    dirs, glue_ms = timed(torch, lambda: sk.ring_directory(spec, states), 5)
    _, launch_ms = timed(torch, lambda: sk.replay_ring_launch(
        spec, states.keys, dirs, ops), 5)
    ne = states.owner.shape[0]
    bound = ring_replay_bound(torch, spec, dirs, want[0]["count"], len(ops))
    del out, want, dirs
    rows.append({"name": "pergroup_replay_ring", "ms": ms,
                 "launch_ms": launch_ms, "glue_ms": glue_ms,
                 "plain_ms": plain_ms, "library_ms": None,
                 "max_abs_err": err, **bound,
                 "shape": [ne, c, spec.runs, wa], "runs": ["g"]})

    # the row form at the same evaluations' gathered rows
    out, ms = timed(torch, lambda: sk.pergroup_replay(rk, rv, ops, run=wa),
                    5)
    want, plain_ms = timed(torch, lambda: sk.pergroup_replay_plain(
        rk, rv, ops, run=wa))
    err = max_abs_err(torch, list(out.values()), list(want.values()))
    del out, want
    r, length = rk.shape
    live_rows = int((rv != 0).any(-1).sum().item())
    live_lanes = int((rv != 0).sum().item())
    # bytes only: every lane's liveness, the key of every live lane (a
    # dead lane's key need not be read), one output a row and op
    b, by = bound_ms(4.0 * r * length + 4.0 * live_lanes
                     + 4.0 * r * len(ops), 0.0)
    rows.append({"name": "pergroup_replay", "ms": ms, "plain_ms": plain_ms,
                 "library_ms": None, "max_abs_err": err, "bound_ms": b,
                 "bound_by": by, "shape": [r, length],
                 "live_rows": live_rows, "live_lanes": live_lanes,
                 "runs": ["l"]})
    return rows


def window_desc(w):
    if w is None:
        return None
    if w.is_time:
        return {"range": w.range, "slide": w.slide}
    return [w.ws, w.wa]


def host_layout_ms(torch, q, ts):
    """(ms of the window layout, ms of the host's epoch walk or None): the
    median of 3 timings each, host clock, synchronised."""
    from repro_torch.core import eventtime as et
    from repro_torch.core import twostack as t2
    from repro_torch.query import resolve_time_strategy

    w = q.window
    lay_ms, walk_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lay = et.time_window_layout(et.concrete_timestamps(ts), w.range,
                                    w.slide)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lay_ms.append((t1 - t0) * 1e3)
        if resolve_time_strategy(q) == "twostack":
            t2.epoch_layout(lay.starts.cpu().numpy(), lay.ends.cpu().numpy())
            walk_ms.append((time.perf_counter() - t1) * 1e3)
    med = lambda xs: sorted(xs)[len(xs) // 2] if xs else None
    return med(lay_ms), med(walk_ms)


def check_time_strategies(torch, q, k, ts, twostack_res) -> None:
    """Run (h) against the replay strategy on the card: the same windows
    re-aggregated from their framed tuples by the swag kernel."""
    import dataclasses

    from repro_torch.query import Query, execute

    qr = Query(ops=q.ops, group_by=False, window=dataclasses.replace(
        q.window, strategy="replay"))
    rp, _ = execute(qr, None, k, backend="cuda", timestamps=ts)
    a, b = twostack_res, rp
    if not (torch.equal(a.valid[:, 0], b.valid[:, 0])
            and torch.equal(a.groups[:, 0], b.groups[:, 0])):
        raise AssertionError("run (h): two-stack and replay windows differ")
    for name in q.op_names:
        x = torch.where(a.valid[:, 0], a.values[name][:, 0], 0)
        y = torch.where(a.valid[:, 0], b.values[name][:, 0], 0)
        if not torch.equal(x, y):
            raise AssertionError(f"run (h): {name} differs between the "
                                 f"two-stack and replay")


def standalone_runs(torch, data, dev, wrappers, run_launches, identity):
    """Runs (j), (k) and (l): the standalone sort and scan entry points and
    the row-form replay, each with every launch count set to 0 just before
    and read just after."""
    import numpy as np

    from repro_torch.core import sorter
    from repro_torch.core.combiners import get_combiner
    from repro_torch.core.segscan import segmented_scan
    from repro_torch.kernels.bitonic.kernel import bitonic_plain
    from repro_torch.kernels.bitonic.ops import bitonic_sort_cuda
    from repro_torch.kernels.segscan.ops import segmented_scan_cuda
    from repro_torch.kernels.swag import kernel as sk

    g, k = data["stream"]
    r, t = SORT_ROWS
    pay = torch.from_numpy(np.random.default_rng(SEED).random(
        r * t, dtype=np.float32)).to(dev).reshape(r, t)
    ops = (g[:r * t].reshape(r, t), k[:r * t].reshape(r, t), pay)
    sg, skk = data["sorted"]
    flags = torch.ones_like(sg, dtype=torch.bool)
    flags[1:] = sg[1:] != sg[:-1]
    states = {"sum": get_combiner("sum").lift(skk),
              "mean": get_combiner("mean").lift(skk)}

    def sort_run():
        return bitonic_sort_cuda(ops, num_keys=2)

    def scan_run():
        return {op: segmented_scan_cuda(flags, st, op, tile=1024)
                for op, st in states.items()}

    def check_sort(out):
        lib = sorter.sort_pairs_xla(ops[0], ops[1])
        plain = bitonic_plain(ops, 2)
        if not (torch.equal(out[0], lib[0]) and torch.equal(out[1], lib[1])
                and torch.equal(out[2], plain[2])):
            raise AssertionError("run (j): the sort differs from the "
                                 "library sort or the plain network")

    def check_scan(out):
        for op, st in states.items():
            want = segmented_scan(flags, st, get_combiner(op))
            got = out[op]
            if not all(torch.equal(a, b) for a, b in zip(
                    got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,))):
                raise AssertionError(f"run (k): {op} differs from the plain "
                                     f"scan")

    spec, rstates, rk, rv = data["replay"]

    def replay_run():
        return sk.pergroup_replay(rk, rv, REPLAY_OPS, run=spec.wa)

    def check_replay(out):
        """Every row of every evaluation, against the ring form: equal on
        the rows below num, the rest are dead rows (count 0)."""
        ring = sk.pergroup_replay_ring(spec, rstates, REPLAY_OPS)
        ne, c = ring[1].shape
        got = ({nm: v.reshape(ne, c) for nm, v in out.items()}, ring[1],
               ring[2])
        if ring_replay_err(torch, got, ring, c) != 0.0:
            raise AssertionError("run (l): the row-form replay differs from "
                                 "the ring form")
        valid = torch.arange(c, device=dev)[None, :] < ring[2][:, None]
        if bool((got[0]["count"][~valid] != 0).any()):
            raise AssertionError("run (l): a dead replay row has live lanes")

    phases = []
    # run (l) counts the live lanes it replays (a tuple once for each
    # window that holds it), not the padded lanes of its rows
    for tag, name, fn, check, n, unit, expect in (
            ("j", "bitonic_sort_cuda", sort_run, check_sort, r * t,
             "tuples", "bitonic_sort"),
            ("k", "segmented_scan_cuda", scan_run, check_scan, sg.numel(),
             "tuples", "segmented_scan"),
            ("l", "pergroup_replay", replay_run, check_replay,
             int((rv != 0).sum()), "live replay lanes", "pergroup_replay")):
        out, counts, _ = counted_call(torch, fn, wrappers)
        if counts[expect] == 0:
            raise AssertionError(f"run ({tag}) did not launch {expect}")
        run_launches[tag] = counts
        t1 = time.perf_counter()
        check(out)
        check_s = time.perf_counter() - t1
        del out
        times = timed_all(torch, fn, 7)[1]
        ms = times[len(times) // 2]
        phases.append({"run": tag, "entry": name, "tuples": n,
                       "tuples_are": unit, "ms": ms,
                       "ms_min": times[0], "ms_max": times[-1],
                       "calls": len(times), "tuples_per_s": n / (ms / 1e3),
                       "launches": counts, "reference_check_s": check_s,
                       "equal_to_reference": True})
        print(f"run ({tag}) {name}: {n} {unit} in {ms:.3f} ms (median of "
              f"{len(times)}, {times[0]:.3f}-{times[-1]:.3f}) = "
              f"{n / (ms / 1e3):.4g} {unit}/s, launches {counts}, checked "
              f"({check_s:.1f} s) [{identity}]", flush=True)
    return phases


def device_busy(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time (host
    clock, synchronised; the profiler's own cost included), the device
    time of the kernels and copies it ran on the card (summed; one
    stream, so nothing overlaps; the host-side ops that launched them are
    not counted again), their ratio, and the five largest device times by
    name.  ``device_ms`` is None when the profiler records no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [(e.key[:60], e.self_device_time_total / 1e3)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    dev_ms = sum(t for _, t in events) or None
    top = sorted(events, key=lambda x: -x[1])[:5]
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "busy_share": None if dev_ms is None else dev_ms / wall_ms,
            "top_device_ms": [[k, t] for k, t in top]}


def _stream_phase(torch, tag, entry, backend, fn, n, pushes, counts, peak,
                  check_s, identity, **extra) -> dict:
    """Time 7 whole streams of ``fn`` (after a warm-up), profile one, and
    print the run."""
    times = timed_all(torch, fn, 7)[1]
    ms = times[len(times) // 2]
    busy = device_busy(torch, fn)
    row = {"run": tag, "entry": entry, "backend": backend, "tuples": n,
           "pushes": pushes, "ms": ms, "ms_min": times[0],
           "ms_max": times[-1], "calls": len(times),
           "tuples_per_s": n / (ms / 1e3), "peak_bytes": peak,
           "launches": counts, "reference_check_s": check_s,
           "equal_to_reference": True, "profiled": busy, **extra}
    launched = {nm: c for nm, c in counts.items() if c}
    print(f"run ({tag}) {entry} on {backend}: {n} tuples in {pushes} pushes "
          f"in {ms:.3f} ms a stream (median of {len(times)}, "
          f"{times[0]:.3f}-{times[-1]:.3f}) = {n / (ms / 1e3):.4g} tuples/s, "
          f"peak {peak / 2**30:.3f} GiB, launches {launched}, checked "
          f"({check_s:.1f} s) [{identity}]", flush=True)
    shown = ", ".join(f"{k} {t:.3f}" for k, t in busy["top_device_ms"])
    print(f"run ({tag}) profiled stream: {busy['wall_ms']:.3f} ms wall, "
          + ("no device time recorded" if busy["device_ms"] is None else
             f"{busy['device_ms']:.3f} ms on the device "
             f"({busy['busy_share']:.1%} busy); largest: {shown}"),
          flush=True)
    return row


def stream_runs(torch, data, dev, wrappers, run_launches, identity):
    """Runs (m) and (n): (a)'s stream pushed through ``execute(state=)`` on
    ``cuda``, and (g)'s window and stream through a ``StreamingAggregator``
    on ``cuda-panestore``.  Returns (phases, kernel rows at their
    shapes)."""
    import numpy as np

    from repro_torch.core import StreamingAggregator
    from repro_torch.core import panestore as ps
    from repro_torch.core.combiners import get_combiner
    from repro_torch.core.engine import PAD_GROUP
    from repro_torch.core.segscan import segment_starts
    from repro_torch.kernels.segscan import kernel as ssk
    from repro_torch.kernels.swag import kernel as sk
    from repro_torch.query import Query, Window, execute

    phases, rows = [], []

    # run (m): 16 pushes of 2^20 sorted tuples, (a)'s five ops
    g, k = data["sorted"]
    q = Query(ops=OPS, streaming=True)
    names = q.op_names
    b = N // STREAM_BATCHES
    batches = [(g[i * b:(i + 1) * b], k[i * b:(i + 1) * b])
               for i in range(STREAM_BATCHES)]

    def stream_m(backend="cuda"):
        state, outs = None, []
        for bg, bk in batches:
            res, state = execute(q, bg, bk, state=state, backend=backend)
            outs.append(res)
        return outs, state

    (outs, state), counts, peak = counted_call(torch, stream_m, wrappers)
    want = len(names) * STREAM_BATCHES
    if counts["segmented_scan"] != want or sum(counts.values()) != want:
        raise AssertionError(f"run (m) launched {counts}, not one "
                             f"segmented_scan an op a push ({want})")
    run_launches["m"] = counts
    t1 = time.perf_counter()
    ref_outs, ref_state = stream_m("reference")
    for i, (a, r) in enumerate(zip(outs, ref_outs)):
        same = all(torch.equal(getattr(a, f), getattr(r, f))
                   for f in ("groups", "valid", "num_groups"))
        if not (same and all(torch.equal(a.values[nm], r.values[nm])
                             for nm in names)):
            raise AssertionError(f"run (m) push {i} differs from the "
                                 f"reference stream")

    def leaves(carry):
        st = carry.state if isinstance(carry.state, tuple) else (carry.state,)
        return (carry.group, carry.nonempty, carry.emitted, *st)

    for a, r in zip(state, ref_state):
        if not all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(r))):
            raise AssertionError("run (m): the carries differ from the "
                                 "reference stream's")
    # the pushes' emissions and the open group of the final carries are
    # run (a)'s one-shot result
    one, _ = execute(Query(ops=OPS), g, k, backend="cuda")
    streamed = torch.cat([r.groups[r.valid] for r in outs]
                         + [state[0].group[None]])
    if not torch.equal(streamed, one.groups[one.valid]):
        raise AssertionError("run (m): the streamed groups differ from run "
                             "(a)'s one-shot result")
    for nm, carry in zip(names, state):
        streamed = torch.cat([r.values[nm][r.valid] for r in outs]
                             + [get_combiner(nm).finalize(carry.state)[None]])
        if not torch.equal(streamed, one.values[nm][one.valid]):
            raise AssertionError(f"run (m): streamed {nm} differs from run "
                                 f"(a)'s one-shot result")
    check_s = time.perf_counter() - t1
    del outs, state, ref_outs, ref_state, one, streamed
    phases.append(_stream_phase(
        torch, "m", "execute(state=)", "cuda", stream_m, N, STREAM_BATCHES,
        counts, peak, check_s, identity, ops=list(names),
        equal_to_one_shot=True))

    # segmented_scan at (m)'s shape: one push's scans, every op
    bg, bk = batches[0]
    flags = segment_starts(bg)
    lifted = {}
    for nm in names:
        st = get_combiner(nm).lift(bk)
        lifted[nm] = st if isinstance(st, tuple) else (st,)

    def push_scans():
        return [x for nm in names
                for x in ssk.segscan(flags, lifted[nm], nm, tile=1024)]

    out, ms = timed(torch, push_scans, 5)
    b2b_ms = back_to_back_ms(torch, push_scans)
    ref, plain_ms = timed(torch, lambda: [
        x for nm in names
        for x in ssk.segscan_plain(flags, lifted[nm], get_combiner(nm))])
    err = max_abs_err(torch, out, ref)
    del out, ref
    nbytes = sum(b * (1 + 2 * sum(x.element_size() for x in lv))
                 for lv in lifted.values())
    nops = sum(b * 2.0 * len(lv) for lv in lifted.values())
    bnd, by = bound_ms(nbytes, nops)
    rows.append({"name": "segmented_scan", "ops": list(names), "ms": ms,
                 "ms_back_to_back": b2b_ms, "plain_ms": plain_ms,
                 "library_ms": None, "max_abs_err": err, "bound_ms": bnd,
                 "bound_by": by, "shape": [b // 1024, 1024], "runs": ["m"]})
    del lifted, flags

    # run (n): (g)'s window and stream, 8 pushes of 8000 tuples and one of
    # 1536 (each leaves a ragged chunk), (g)'s seven ops, then a flush
    w = Window(**PERGROUP)
    spec = w.store_spec()
    c, wa = spec.capacity, spec.wa
    g, k = data["pergroup64"]
    edges = np.cumsum((0,) + WINDOW_PUSHES)
    pushes = [(g[a:b], k[a:b]) for a, b in zip(edges[:-1], edges[1:])]

    def stream_n(keep=False):
        agg = StreamingAggregator(REPLAY_OPS, window=w)
        outs, stores = [], []
        for pg, pk in pushes:
            outs.append(agg.push(pg, pk))
            if keep:
                stores.append(ps.PaneStoreState(*(x.clone()
                                                   for x in agg.carry)))
        outs.append(agg.flush())
        return outs, stores

    (outs, stores), counts, peak = counted_call(
        torch, lambda: stream_n(keep=True), wrappers)
    npush = len(pushes)
    if (counts["pergroup_scan"], counts["pergroup_replay_ring"]) \
            != (npush, npush + 1) or sum(counts.values()) != 2 * npush + 1:
        raise AssertionError(f"run (n) launched {counts}, not one "
                             f"pergroup_scan a push and one "
                             f"pergroup_replay_ring a push and flush")
    run_launches["n"] = counts
    t1 = time.perf_counter()
    lane = torch.arange(c, dtype=torch.int32)

    def plain_eval(store):
        """One evaluation of ``store`` by the plain replay, as a push's
        outputs: groups, valid, num, rr_port, values."""
        ov, ug, num = sk.pergroup_replay_ring_plain(
            spec, ps.PaneStoreState(*(x[None] for x in store)), REPLAY_OPS)
        ln = lane.to(num.device)
        valid = ln < num[0]
        return (torch.where(valid, ug[0], PAD_GROUP), valid, num[0],
                torch.where(valid, ln % 4, -1).to(torch.int32),
                {nm: torch.where(valid, v[0], 0).to(v.dtype)
                 for nm, v in ov.items()})

    def check_eval(res, want, what):
        got = (res.groups, res.valid, res.num_groups, res.rr_port)
        if not all(torch.equal(a.cpu(), b.cpu())
                   for a, b in zip(got, want[:4])) or not all(
                torch.equal(res.values[nm].cpu(), v.cpu())
                for nm, v in want[4].items()):
            raise AssertionError(f"run (n) {what} differs from the plain "
                                 f"versions")

    # every push through the first that evicts: the plain placement on a
    # host copy of the store, the plain replay of what it leaves; the
    # kernel's scan of the same push for its evictions
    host = ps.init_store(spec, torch.int32)
    before = ps.init_store(spec, torch.int32, device=dev)
    evictions = kernel_evictions = checked = 0
    scan_row = None
    for i, ((pg, pk), res, store) in enumerate(zip(pushes, outs, stores)):
        trace, p_ms = plain_once(torch, lambda: sk.pergroup_scan_plain(
            spec, host, pg.cpu(), pk.cpu(), push=True))
        host = trace.final
        kernel = sk.pergroup_scan(spec, before, pg, pk, push=True)
        if not torch.equal(kernel.events.cpu(), trace.events):
            raise AssertionError(f"run (n) push {i}: the scan's evictions "
                                 f"and retirements differ from the plain "
                                 f"placement's")
        if not all(torch.equal(a.cpu(), b) for a, b in zip(store, host)):
            raise AssertionError(f"run (n): the store after push {i} "
                                 f"differs from the plain placement's")
        check_eval(res, plain_eval(host), f"push {i}")
        evictions += int(trace.events[0])
        kernel_evictions += int(kernel.events[0])
        if i == 1:  # the kernel row: a push onto a store already filled
            scan_row = (before, pg, pk, trace, p_ms)
        before = store
        checked += 1
        if evictions and i >= 1:
            break
    if not evictions:
        raise AssertionError(f"run (n): no eviction in the {checked} pushes "
                             f"checked")
    check_eval(outs[-1], plain_eval(stores[-1]), "flush")
    check_s = time.perf_counter() - t1
    print(f"run (n) placement scan: {kernel_evictions} evictions in the "
          f"{checked} pushes checked (plain placement: {evictions})",
          flush=True)
    final = stores[-1]
    del outs, stores
    phases.append(_stream_phase(
        torch, "n", "StreamingAggregator push/flush", "cuda-panestore",
        stream_n, int(edges[-1]), npush, counts, peak, check_s, identity,
        ops=list(REPLAY_OPS), window=window_desc(w), checked_pushes=checked,
        evictions_checked=kernel_evictions))

    # pergroup_scan at a push's shape: push 1 onto push 0's store, the
    # final store only, the ring kept
    before, pg, pk, want, p_ms = scan_row
    got, ms = timed(torch, lambda: sk.pergroup_scan(
        spec, before, pg, pk, push=True), 5)
    # the wrapper's torch glue alone (the group index, one read-back)
    _, glue_ms = timed(torch, lambda: sk._scan_groups(spec, before, pg), 5)
    err = max_abs_err(torch, [*got.final, got.events],
                      [*(x.to(dev) for x in want.final),
                       want.events.to(dev)])
    n = pg.shape[0]
    # the panes that close in the push, each read and written once by its
    # sort: a slot full after the push that was not the same full pane
    # before (a pane that closes and leaves within the push is not seen,
    # which can only lower the bound)
    fin = want.final
    same = ((before.count == wa) & (before.owner == fin.owner.to(dev))
            & (before.base == fin.base.to(dev))).cpu()
    closes = int(((fin.count == wa) & ~same).sum())
    ng = int(torch.unique(torch.cat(
        [pg, before.owner[before.owner != PAD_GROUP]])).numel())
    # read: each tuple's group index and key, the directory and group
    # table; written: each tuple's lane (key and seq) and the directory
    # and clock; a closing pane's keys and seqs read and written once; the
    # rest of the ring is not touched (no snapshot, no plan)
    nbytes = (8 * n + 8 * n + 16 * wa * closes + 20 * c + 12 * ng + 16 * c
              + 8)
    bnd, by = bound_ms(nbytes, 8.0 * n)
    rows.append({"name": "pergroup_scan", "ms": ms, "glue_ms": glue_ms,
                 "plain_ms": p_ms,
                 "plain_tuples": n, "library_ms": None, "max_abs_err": err,
                 "bound_ms": bnd, "bound_by": by, "closes": closes,
                 "shape": [n, wa, c], "ring": True, "push": True,
                 "runs": ["n"]})

    # pergroup_replay_ring at a push's shape: one evaluation of the final
    # store
    one = ps.PaneStoreState(*(x[None] for x in final))
    out, ms = timed(torch, lambda: sk.pergroup_replay_ring(
        spec, one, REPLAY_OPS), 5)
    want, plain_ms = timed(torch, lambda: sk.pergroup_replay_ring_plain(
        spec, one, REPLAY_OPS))
    err = ring_replay_err(torch, out, want, c)
    dirs, glue_ms = timed(torch, lambda: sk.ring_directory(spec, one), 5)
    _, launch_ms = timed(torch, lambda: sk.replay_ring_launch(
        spec, one.keys, dirs, REPLAY_OPS), 5)
    bound = ring_replay_bound(torch, spec, dirs, want[0]["count"],
                              len(REPLAY_OPS))
    rows.append({"name": "pergroup_replay_ring", "ms": ms,
                 "launch_ms": launch_ms, "glue_ms": glue_ms,
                 "plain_ms": plain_ms, "library_ms": None,
                 "max_abs_err": err, **bound,
                 "shape": [1, c, spec.runs, wa], "runs": ["n"]})
    return phases, rows


def _bits(torch, t):
    """A tensor's bits: float32 viewed as int32 (NaN payloads, signed
    zeros); anything else as int64 (bool included), for max_abs_err."""
    return (t.view(torch.int32) if t.dtype == torch.float32 else t).long()


def _emit_err(torch, got, want, n_in: int) -> float:
    """Hold reorder emissions to the plain version's: live and late flags
    on every lane, ts, group and key bits on the live lanes (a dead
    lane's fields are whatever its cycle read), ts 0 on the dead drain
    lanes past the ``n_in`` cycle lanes.  The largest |difference|."""
    dev = got.ts.device
    lv = want.live.to(dev)
    pick = [torch.where(lv, _bits(torch, getattr(x, f).to(dev)), 0)
            for x in (got, want) for f in ("ts", "groups", "keys")]
    flags = [_bits(torch, getattr(x, f).to(dev))
             for x in (got, want) for f in ("live", "late")]
    if not bool((got.ts[n_in:][~got.live[n_in:]] == 0).all()):
        raise AssertionError("reorder: a dead drain lane's ts is not 0")
    return max_abs_err(torch, pick[:3] + flags[:2], pick[3:] + flags[2:])


def _state_err(torch, got, want) -> float:
    """|difference| of two stores or buffers, bit for bit."""
    dev = got[0].device
    return max_abs_err(torch, [_bits(torch, x) for x in got],
                       [_bits(torch, x.to(dev)) for x in want])


def _specials(torch, keys):
    """``keys`` as float32 with -0.0 at every 5th lane and NaN at every
    11th from lane 3."""
    k = keys.to(torch.float32).clone()
    k[::5] = -0.0
    k[3::11] = float("nan")
    return k


def event_time_run(torch, dev, wrappers, run_launches, identity):
    """Run (o): an event-time stream through ``StreamingAggregator`` on
    ``cuda-panestore`` — (h)'s generator and window streamed as 64 pushes
    of 1024 tuples, (g)'s seven ops, then a flush; each push one reorder,
    one time-mode placement and one ring replay launch — checked push by
    push against the plain versions on a host copy through the first push
    whose placement retires a pane, and its flush against the plain flush;
    then the three kernels at its shapes.  Returns (phases, kernel
    rows)."""
    import numpy as np

    from repro_torch.core import StreamingAggregator
    from repro_torch.core import eventtime as et
    from repro_torch.core import panestore as ps
    from repro_torch.core.engine import PAD_GROUP
    from repro_torch.interop import make_time_stream
    from repro_torch.kernels.eventtime import kernel as ek
    from repro_torch.kernels.swag import kernel as sk
    from repro_torch.query import Window

    w = Window(**EVENT_WINDOW)
    spec, rspec = w.store_spec(), w.reorder_spec()
    c, wa, lat = spec.capacity, spec.wa, w.max_lateness
    es = EVENT_STREAM
    n = es["n"]
    g, k, ts = (torch.from_numpy(x).to(dev) for x in make_time_stream(
        SEED, n, es["n_groups"], es["key_max"], es["density"],
        es["jitter"]))
    pushes = [(g[i:i + EVENT_PUSH], k[i:i + EVENT_PUSH],
               ts[i:i + EVENT_PUSH]) for i in range(0, n, EVENT_PUSH)]
    npush = len(pushes)

    def copy(carry):
        return (et.ReorderState(*(x.clone() for x in carry[0])),
                ps.PaneStoreState(*(x.clone() for x in carry[1])))

    def stream_o(keep=False):
        agg = StreamingAggregator(REPLAY_OPS, window=w)
        if agg.plan.backend != "cuda-panestore":
            raise AssertionError(f"run (o) planned {agg.plan}")
        outs, carries = [], []
        for pg, pk, pt in pushes:
            if keep:
                carries.append(copy(agg.carry))
            outs.append(agg.push(pg, pk, timestamps=pt))
        if keep:
            carries.append(copy(agg.carry))
        outs.append(agg.flush())
        return outs, carries

    (outs, carries), counts, peak = counted_call(
        torch, lambda: stream_o(keep=True), wrappers)
    want = {"reorder": npush + 1, "pergroup_scan_time": npush + 1,
            "pergroup_replay_ring": npush + 1}
    if any(counts[nm] != v for nm, v in want.items()) \
            or sum(counts.values()) != sum(want.values()):
        raise AssertionError(f"run (o) launched {counts}, not one reorder, "
                             f"one time-mode placement and one ring replay "
                             f"a push and for the flush")
    run_launches["o"] = counts
    t1 = time.perf_counter()
    lane = torch.arange(c, dtype=torch.int32)

    def plain_eval(pstate, eval_time):
        ovs, ug, num = sk.pergroup_replay_ring_plain(
            spec, ps.PaneStoreState(*(x[None] for x in pstate)),
            REPLAY_OPS, eval_time=eval_time.reshape(1))
        valid = lane < num[0]
        return (torch.where(valid, ug[0], PAD_GROUP), valid, num[0],
                torch.where(valid, lane % 4, -1).to(torch.int32),
                {nm: v[0] for nm, v in ovs.items()})

    def check_eval(res, want, what):
        got = (res.groups, res.valid, res.num_groups, res.rr_port)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want[:4])) \
                or not all(torch.equal(res.values[nm].cpu(), v)
                           for nm, v in want[4].items()):
            raise AssertionError(f"run (o) {what} differs from the plain "
                                 f"versions")

    # push by push, the plain chain from a fresh carry on the host, through
    # the first push whose placement retires a pane
    host = torch.device("cpu")
    rst = et.init_reorder(rspec, torch.int32, host)
    pst = ps.init_store(spec, torch.int32, device=host)
    checked = retirements = evictions = 0
    at = None
    for i, ((pg, pk, pt), res) in enumerate(zip(pushes, outs)):
        before = (rst, pst)
        (emit, rst), r_ms = plain_once(torch, lambda: et.reorder_push(
            rspec, before[0], pt.cpu(), pg.cpu(), pk.cpu()))
        wm = rst.max_ts - lat
        (pst, events), p_ms = plain_once(torch, lambda: ps.push_time_events(
            spec, before[1], emit.groups, emit.keys, emit.ts, emit.live,
            wm - w.range))
        check_eval(res, plain_eval(pst, wm), f"push {i}")
        if int(res.stats["late_dropped"]) != 0 or int(rst.dropped) != 0:
            raise AssertionError(f"run (o) push {i} dropped late tuples")
        kr, kp = carries[i + 1]
        if _state_err(torch, kr, rst) or _state_err(torch, kp, pst):
            raise AssertionError(f"run (o): the carry after push {i} "
                                 f"differs from the plain versions'")
        checked += 1
        evictions += int(events[0])
        retirements += int(events[1])
        at = (i, emit, wm, r_ms, p_ms, events)
        if retirements:
            break
    if not retirements:
        raise AssertionError(f"run (o): no retirement in the {checked} "
                             f"pushes checked")
    # the flush against the plain flush on a host copy of the carry
    rst, pst = (type(x)(*(y.cpu() for y in x)) for x in carries[-1])
    emit_f, rst = et.reorder_flush(rspec, rst)
    pst, _ = ps.push_time_events(spec, pst, emit_f.groups, emit_f.keys,
                                 emit_f.ts, emit_f.live)
    check_eval(outs[-1], plain_eval(pst, rst.max_ts + 1), "flush")
    check_s = time.perf_counter() - t1
    print(f"run (o) checked {checked} pushes (through the first that "
          f"retires: {retirements} retirements, {evictions} evictions) and "
          f"the flush against the plain versions", flush=True)
    final, (r_before, p_before) = carries[-1], carries[at[0]]
    del outs, carries
    phases = [_stream_phase(
        torch, "o", "StreamingAggregator push/flush (event time)",
        "cuda-panestore", stream_o, n, npush, counts, peak, check_s,
        identity, ops=list(REPLAY_OPS), window=dict(EVENT_WINDOW),
        checked_pushes=checked, retirements_checked=retirements,
        evictions_checked=evictions, late_dropped=0)]
    rows = []
    j, emit, wm, r_ms, p_ms, events = at

    # reorder at a push's shape: push j onto the buffer before it
    pg, pk, pt = pushes[j]
    got, ms = timed(torch, lambda: ek.reorder_push(rspec, r_before, pt, pg,
                                                   pk), 5)
    want = ek.reorder_push_plain(rspec, r_before, pt, pg, pk)
    err = max(_emit_err(torch, got[0], want[0], EVENT_PUSH),
              _state_err(torch, got[1], want[1]))
    fk = _specials(torch, pk)
    r_float = r_before._replace(val=r_before.val.to(torch.float32))
    gf = ek.reorder_push(rspec, r_float, pt, pg, fk)
    wf = ek.reorder_push_plain(rspec, r_float, pt, pg, fk)
    float_err = max(_emit_err(torch, gf[0], wf[0], EVENT_PUSH),
                    _state_err(torch, gf[1], wf[1]))
    # forced pops and late tuples: a 32-slot buffer (about 60 tuples are in
    # flight) and eight lanes 500 units behind, from an empty buffer
    spec32 = et.ReorderSpec(32, lat)
    lt = pt.clone()
    lt[100::113] -= 500
    empty = et.init_reorder(spec32, torch.int32, dev)
    ge, edge_ms = timed(torch, lambda: ek.reorder_push(spec32, empty, lt, pg,
                                                       pk), 5)
    we = ek.reorder_push_plain(spec32, empty, lt, pg, pk)
    edge_err = max(_emit_err(torch, ge[0], we[0], EVENT_PUSH),
                   _state_err(torch, ge[1], we[1]))
    m = lt.shape[0]
    gate = torch.cummax(lt.cpu(), 0).values - lat
    forced = int((we[0].live[:m].cpu() & (we[0].ts[:m].cpu() > gate)).sum())
    late = int(we[1].dropped)
    if forced == 0 or late == 0:
        raise AssertionError(f"reorder edge check: {forced} forced pops, "
                             f"{late} late tuples")
    # the widest buffer, 1024 slots (32 a lane), with a lateness that keeps
    # about 900 tuples in flight, from an empty buffer
    spec1k = et.ReorderSpec(1024, 1000)
    empty1k = et.init_reorder(spec1k, torch.int32, dev)
    g1k, wide_ms = timed(torch, lambda: ek.reorder_push(spec1k, empty1k, pt,
                                                        pg, pk), 5)
    w1k = ek.reorder_push_plain(spec1k, empty1k, pt, pg, pk)
    wide_err = max(_emit_err(torch, g1k[0], w1k[0], EVENT_PUSH),
                   _state_err(torch, g1k[1], w1k[1]))
    held = int(w1k[1].occ.sum())
    if float_err or edge_err or wide_err or held < 512:
        raise AssertionError(f"reorder: float32 keys differ by {float_err}, "
                             f"the forced-pop push by {edge_err}, the "
                             f"1024-slot push by {wide_err} ({held} held)")
    nb = (12 * m + 14 * (m + rspec.capacity) + 2 * 17 * rspec.capacity + 32)
    bnd, by = bound_ms(nb, 0.0)
    rows.append({"name": "reorder", "ms": ms, "ns_a_tuple": ms * 1e6 / m,
                 "plain_ms": r_ms, "library_ms": None, "max_abs_err": err,
                 "bound_ms": bnd, "bound_by": by,
                 "shape": [m, rspec.capacity], "runs": ["o"],
                 "float32_check": {"max_abs_err": float_err,
                                   "keys": "-0.0 and NaN"},
                 "edge_check": {"capacity": 32, "forced_pops": forced,
                                "late": late, "max_abs_err": edge_err,
                                "ms": edge_ms},
                 "wide_check": {"capacity": 1024, "lateness": 1000,
                                "held": held, "max_abs_err": wide_err,
                                "ms": wide_ms}})

    # the time-mode placement at a push's shape: push j's emission onto
    # the store before it
    em = type(emit)(*(x.to(dev) for x in emit))
    rb = (wm - w.range).to(dev)
    got, ms = timed(torch, lambda: sk.pergroup_scan_time(
        spec, p_before, em.groups, em.keys, em.ts, em.live, rb), 5)
    want = sk.pergroup_scan_time_plain(spec, p_before, em.groups, em.keys,
                                       em.ts, em.live, rb)
    err = max(_state_err(torch, got[0], want[0]),
              max_abs_err(torch, [got[1]], [want[1].to(dev)]))
    # the launch alone, its pane index and bitmaps in shared memory (where
    # the wrapper puts them at this shape) and in device memory (where it
    # puts them when they do not fit): on fresh copies of the store, the
    # two homes alternated shared, device, device, shared
    aux = torch.empty((sk.time_aux_bytes(c),), dtype=torch.uint8,
                      device=dev)
    home_ms = {"shared": [], "device": []}
    for where in ("shared", "device", "device", "shared"):
        copies = [ps.PaneStoreState(*(x.clone() for x in p_before))
                  for _ in range(8)]

        def launch_on_copy():
            st = copies.pop()
            return st, sk.time_scan_launch(
                spec, st, em.groups, em.keys, em.ts, em.live, rb,
                aux=aux if where == "device" else None)

        (st_h, ev_h), t_h = timed(torch, launch_on_copy, 7)
        home_ms[where].append(t_h)
        err = max(err, _state_err(torch, st_h, want[0]),
                  max_abs_err(torch, [ev_h], [want[1].to(dev)]))
    p_float = p_before._replace(keys=p_before.keys.to(torch.float32))
    fkeys = _specials(torch, em.keys)
    gf = sk.pergroup_scan_time(spec, p_float, em.groups, fkeys, em.ts,
                               em.live, rb)
    wf = sk.pergroup_scan_time_plain(spec, p_float, em.groups, fkeys, em.ts,
                                     em.live, rb)
    float_err = max(_state_err(torch, gf[0], wf[0]),
                    max_abs_err(torch, [gf[1]], [wf[1].to(dev)]))
    # chaining, evictions and negative timestamps: four groups (about 128
    # tuples a pane of 16), 32 slots, the stream a million units back
    spec_e = ps.PaneStoreSpec(wa=wa, capacity=32, default_ws=1,
                              slide=w.slide, time_range=w.range)
    st_e = wt_e = ps.init_store(spec_e, torch.int32, device=dev)
    ev_e = np.zeros(2, np.int64)
    edge_err = 0.0
    for q in range(2):
        qg, qk, qt = pushes[q]
        qg = (qg % 4).contiguous()
        qt = qt - 1_000_000
        live = torch.ones_like(qg, dtype=torch.bool)
        qrb = qt.max() - lat - w.range
        before_e = st_e
        (st_e, kev), edge_ms = timed(torch, lambda: sk.pergroup_scan_time(
            spec_e, before_e, qg, qk, qt, live, qrb), 5)
        wt_e, pev = sk.pergroup_scan_time_plain(spec_e, wt_e, qg, qk, qt,
                                                live, qrb)
        edge_err = max(edge_err, _state_err(torch, st_e, wt_e),
                       max_abs_err(torch, [kev], [pev.to(dev)]))
        ev_e += pev.cpu().numpy()
    occ = (wt_e.owner != PAD_GROUP).cpu()
    pairs = list(zip(wt_e.owner.cpu()[occ].tolist(),
                     wt_e.base.cpu()[occ].tolist()))
    chained = len(pairs) - len(set(pairs))
    if ev_e[0] == 0 or chained == 0 or int(wt_e.base.cpu()[occ].max()) >= 0:
        raise AssertionError(f"time placement edge check: {ev_e.tolist()} "
                             f"events, {chained} chained slots")
    if float_err or edge_err:
        raise AssertionError(f"pergroup_scan_time: float32 keys differ by "
                             f"{float_err}, the edge pushes by {edge_err}")
    fin = want[0]
    same = ((p_before.count == wa) & (p_before.owner == fin.owner)
            & (p_before.base == fin.base) & (p_before.stamp == fin.stamp))
    closes = int(((fin.count == wa) & ~same).sum())
    m = em.ts.shape[0]
    live_lanes = int(em.live.sum())
    # read: the emission (group, key, ts, live), the directory; written:
    # each live lane's key and timestamp, the directory and clock; a
    # closing pane's keys and timestamps read and written once
    nb = 13 * m + 8 * live_lanes + 16 * wa * closes + 32 * c + 16
    bnd, by = bound_ms(nb, 0.0)
    rows.append({"name": "pergroup_scan_time", "ms": ms,
                 "ns_a_tuple": ms * 1e6 / live_lanes, "plain_ms": p_ms,
                 "library_ms": None, "max_abs_err": err, "bound_ms": bnd,
                 "bound_by": by, "shape": [m, c, wa], "live_lanes":
                 live_lanes, "closes": closes, "events": events.tolist(),
                 "runs": ["o"], "launch_ms_by_index_home": home_ms,
                 "float32_check": {"max_abs_err": float_err,
                                   "keys": "-0.0 and NaN"},
                 "edge_check": {"capacity": 32, "groups": 4,
                                "evictions": int(ev_e[0]),
                                "retirements": int(ev_e[1]),
                                "chained_slots": chained,
                                "max_abs_err": edge_err,
                                "ms": edge_ms}})

    # the ring replay's time form at a push's shape: one evaluation of the
    # store before the flush, at its watermark
    one = ps.PaneStoreState(*(x[None] for x in final[1]))
    et_t = (final[0].max_ts - lat).reshape(1)
    out, ms = timed(torch, lambda: sk.pergroup_replay_ring(
        spec, one, REPLAY_OPS, eval_time=et_t), 5)
    want, plain_ms = plain_once(torch, lambda: sk.pergroup_replay_ring_plain(
        spec, one, REPLAY_OPS, eval_time=et_t))
    err = max_abs_err(torch, [out[1], out[2], *out[0].values()],
                      [want[1], want[2], *(want[0][nm] for nm in out[0])])
    dirs, glue_ms = timed(torch, lambda: sk.ring_directory(spec, one, et_t),
                          5)
    cnt = torch.empty((1, c), dtype=torch.int32, device=dev)
    _, launch_ms = timed(torch, lambda: sk.replay_ring_launch(
        spec, one.keys, dirs, REPLAY_OPS, live_out=cnt), 5)
    bound = ring_replay_bound(torch, spec, dirs, cnt, len(REPLAY_OPS))
    # float32 keys: the placement's float store (-0.0 and NaN) on the ops
    # that do not order the window, and with NaN made +inf (panes stay
    # sorted) on every op, zeros compared without their sign
    fone = ps.PaneStoreState(*(x[None] for x in gf[0]))
    ft = (rb + w.range).reshape(1)
    free_ops = ("count", "sum", "mean")
    a = sk.pergroup_replay_ring(spec, fone, free_ops, eval_time=ft)
    b = sk.pergroup_replay_ring_plain(spec, fone, free_ops, eval_time=ft)
    if not (torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
            and torch.equal(a[0]["count"], b[0]["count"])):
        raise AssertionError("pergroup_replay_ring (time, float32, NaN): "
                             "groups or counts differ")
    for nm in ("sum", "mean"):
        torch.testing.assert_close(a[0][nm], b[0][nm], rtol=1e-5, atol=1e-5,
                                   equal_nan=True, msg=nm)
    inf_keys = torch.where(torch.isnan(fone.keys), float("inf"), fone.keys)
    fone = fone._replace(keys=inf_keys)
    a = sk.pergroup_replay_ring(spec, fone, REPLAY_OPS, eval_time=ft)
    b = sk.pergroup_replay_ring_plain(spec, fone, REPLAY_OPS, eval_time=ft)
    float_err = max_abs_err(torch, [a[1], a[2]], [b[1], b[2]])
    for nm in REPLAY_OPS:
        x, y = a[0][nm], b[0][nm]
        if nm in INEXACT:
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5, msg=nm)
        else:
            x, y = (v + 0.0 if v.dtype.is_floating_point else v
                    for v in (x, y))
            if not torch.equal(x, y):
                raise AssertionError(f"pergroup_replay_ring (time, float32):"
                                     f" {nm} differs from plain")
        float_err = max(float_err, max_abs_err(torch, [x], [y]))
    rows.append({"name": "pergroup_replay_ring", "form": "time", "ms": ms,
                 "launch_ms": launch_ms, "glue_ms": glue_ms,
                 "plain_ms": plain_ms, "library_ms": None,
                 "max_abs_err": err, **bound, "shape": [1, c, spec.runs, wa],
                 "runs": ["o"],
                 "float32_check": {"max_abs_err": float_err,
                                   "keys": "-0.0 (all ops, zeros unsigned), "
                                           "NaN (count, sum, mean)"}})
    for row in rows:
        print(f"{row['name']} at run (o)'s shape {row['shape']}: "
              f"{row['ms']:.4f} ms"
              + (f" ({row['ns_a_tuple']:.1f} ns a tuple; the first design "
                 f"{PARENT_NS[row['name']]:.0f}, from PERF.md)"
                 if "ns_a_tuple" in row else "")
              + f", bound {row['bound_ms']:.6f} ({row['bound_by']}), plain "
              f"{row['plain_ms']:.2f} ms [{identity}]", flush=True)
        for key in ("edge_check", "wide_check"):
            check = dict(row.get(key, {}))
            if "ms" in check:
                ms = check.pop("ms")
                print(f"{row['name']} {key}: {ms:.4f} ms ({check})",
                      flush=True)
        if "launch_ms_by_index_home" in row:
            print(f"{row['name']} launch alone, index in shared / device "
                  f"memory (s d d s): {row['launch_ms_by_index_home']} ms",
                  flush=True)
    return phases, rows


def slice5_kernels(torch, sk, data, dev) -> list:
    """twostack_flip at (h)'s shape, swag at (i)'s, bitonic_sort at (j)'s
    and segmented_scan at (k)'s, each against its plain version."""
    import numpy as np

    from repro_torch.core import eventtime as et
    from repro_torch.core import twostack as t2
    from repro_torch.core.combiners import get_combiner
    from repro_torch.core.engine import PAD_GROUP
    from repro_torch.kernels.bitonic import kernel as bk
    from repro_torch.kernels.segscan import kernel as ssk

    rows = []
    g, k, ts = data["time"]
    lay = et.time_window_layout(et.concrete_timestamps(ts),
                                TIME_WINDOW["range"], TIME_WINDOW["slide"])
    ep = t2.epoch_layout(lay.starts.cpu().numpy(), lay.ends.cpu().numpy())
    ks = k[lay.order]
    col = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev)
    f_lo, hi, b_hi = col(ep.f_lo), col(ep.hi), col(ep.b_hi)
    wcap = lay.wcap
    kf, vf = t2._region(ks, f_lo, hi - f_lo, wcap)
    kb, vb = t2._region(ks, hi, b_hi - hi, wcap)
    out, ms = timed(torch, lambda: sk.twostack_flip(kf, vf, kb, vb,
                                                    TWOSTACK), 5)
    b2b_ms = back_to_back_ms(torch, lambda: sk.twostack_flip(
        kf, vf, kb, vb, TWOSTACK))
    want, plain_ms = timed(torch, lambda: sk.twostack_flip_plain(
        kf, vf, kb, vb, TWOSTACK))
    err = max_abs_err(torch, [x for pair in out.values() for x in pair],
                      [x for pair in want.values() for x in pair])

    def library_flip():
        """Every op: the masked lanes at the op's identity, then a torch
        scan (cumsum, cummin, cummax) over the flipped front rows and over
        the back rows."""
        scans = {"sum": lambda x: torch.cumsum(x, -1, dtype=x.dtype),
                 "count": lambda x: torch.cumsum(x, -1, dtype=x.dtype),
                 "min": lambda x: torch.cummin(x, -1).values,
                 "max": lambda x: torch.cummax(x, -1).values}
        res = {}
        for nm in TWOSTACK:
            comb = get_combiner(nm)
            ident = comb.identity((), kf.dtype, dev)
            front = torch.where(vf, comb.lift(kf), ident)
            back = torch.where(vb, comb.lift(kb), ident)
            res[nm] = (torch.flip(scans[nm](torch.flip(front, (-1,))),
                                  (-1,)), scans[nm](back))
        return res

    lib, lib_ms = timed(torch, library_flip, 5)
    for nm in TWOSTACK:
        if max_abs_err(torch, lib[nm], out[nm]) != 0.0:
            raise AssertionError(f"the torch scans disagree with "
                                 f"twostack_flip on op {nm}")
    del out, want, lib
    ne = kf.shape[0]
    lanes = ne * wcap
    b, by = bound_ms(lanes * 10 + lanes * 8 * len(TWOSTACK),
                     lanes * 2.0 * len(TWOSTACK))
    rows.append({"name": "twostack_flip", "ms": ms,
                 "ms_back_to_back": b2b_ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms,
                 "library": "every op: torch.cumsum (sum, count), "
                            "torch.cummin, torch.cummax over the masked, "
                            "flipped front rows and the masked back rows",
                 "max_abs_err": err, "bound_ms": b, "bound_by": by,
                 "shape": [ne, wcap], "ops": list(TWOSTACK), "runs": ["h"]})
    del kf, vf, kb, vb

    # swag over run (i)'s framed windows
    ops = OPS[:4] + ("distinct_count", "median")
    fg, fk, _ = et.frame_time_windows(lay, g[lay.order], ks, PAD_GROUP)
    out, ms = timed(torch, lambda: sk.swag(fg, fk, ops), 3)
    want, plain_ms = plain_once(torch, lambda: sk.swag_plain(fg, fk, ops))
    err = max_abs_err(torch, flat(out), flat(want))
    del out, want
    nw = fg.shape[0]
    b, by = bound_ms(nw * wcap * 8 + nw * wcap * 4 * (1 + len(ops)) + nw * 4,
                     network_exchanges(nw, wcap) * 4
                     + nw * wcap * 2 * len(ops))
    rows.append({"name": "swag", "ms": ms, "plain_ms": plain_ms,
                 "library_ms": None, "max_abs_err": err, "bound_ms": b,
                 "bound_by": by, "shape": [nw, wcap], "runs": ["i"]})
    del fg, fk, ks

    # bitonic_sort at run (j)'s shape
    sg, skk = data["stream"]
    r, t = SORT_ROWS
    pay = torch.from_numpy(np.random.default_rng(SEED).random(
        r * t, dtype=np.float32)).to(dev).reshape(r, t)
    ops3 = (sg[:r * t].reshape(r, t), skk[:r * t].reshape(r, t), pay)
    out, ms = timed(torch, lambda: bk.bitonic_sort(ops3, 2), 5)
    b2b_ms = back_to_back_ms(torch, lambda: bk.bitonic_sort(ops3, 2))
    want, plain_ms = timed(torch, lambda: bk.bitonic_plain(ops3, 2))
    err = max_abs_err(torch, out, want)

    def library_sort():
        by_key = torch.sort(ops3[1], dim=-1, stable=True).indices
        g1 = torch.gather(ops3[0], -1, by_key)
        by_group = torch.sort(g1, dim=-1, stable=True).indices
        return tuple(torch.gather(torch.gather(x, -1, by_key), -1, by_group)
                     for x in ops3)

    lib, lib_ms = timed(torch, library_sort, 5)
    if max_abs_err(torch, lib[:2], out[:2]) != 0.0:
        raise AssertionError("library sort disagrees with bitonic_sort")
    del out, want, lib
    b, by = bound_ms(r * t * 12 * 2, network_exchanges(r, t) * 4)
    rows.append({"name": "bitonic_sort", "ms": ms,
                 "ms_back_to_back": b2b_ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms,
                 "library": "two stable torch.sort passes + gathers of the "
                            "three operands",
                 "max_abs_err": err, "bound_ms": b, "bound_by": by,
                 "shape": [r, t], "keys": 2, "payloads": 1, "runs": ["j"]})

    # segmented_scan at run (k)'s shape, one row an op
    sg, skk = data["sorted"]
    flags = torch.ones_like(sg, dtype=torch.bool)
    flags[1:] = sg[1:] != sg[:-1]
    n = sg.numel()
    for op in ("sum", "mean"):
        comb = get_combiner(op)
        leaves = comb.lift(skk)
        leaves = leaves if isinstance(leaves, tuple) else (leaves,)
        out, ms = timed(torch, lambda: ssk.segscan(flags, leaves, comb,
                                                   tile=1024), 5)
        b2b_ms = back_to_back_ms(torch, lambda: ssk.segscan(
            flags, leaves, comb, tile=1024))
        want, plain_ms = timed(torch, lambda: ssk.segscan_plain(
            flags, leaves, comb))
        err = max_abs_err(torch, out, want)
        del out, want
        leaf_bytes = sum(x.element_size() for x in leaves)
        b, by = bound_ms(n * (1 + 2 * leaf_bytes), n * 2.0 * len(leaves))
        rows.append({"name": "segmented_scan", "op": op, "ms": ms,
                     "ms_back_to_back": b2b_ms,
                     "plain_ms": plain_ms, "library_ms": None,
                     "max_abs_err": err, "bound_ms": b, "bound_by": by,
                     "shape": [n // 1024, 1024], "runs": ["k"]})
    return rows


#: the kernels whose ptxas report is printed, by source: mangled name
#: pattern -> (kernel, names of the template arguments); "keys" is the key
#: type (i or f), "float_keys" the sort's mask of float32 keys (-1: read
#: at run time)
PTXAS_KERNELS = {
    "swag.cu": [
        (r"swag_rows_kernelI([if])Li(\d+)ELi(\d+)E", "swag_rows_kernel",
         ("keys", "lanes", "max_threads")),
        (r"sort_rows_kernelI([if])Li(\d+)ELi(\d+)E", "sort_rows_kernel",
         ("keys", "lanes", "max_threads"))],
    "pergroup.cu": [
        (r"pergroup_replay_kernelI([if])Lb([01])ELb([01])E",
         "pergroup_replay_kernel", ("keys", "ring", "time")),
        (r"pergroup_scan_time_kernelI([if])E", "pergroup_scan_time_kernel",
         ("keys",))],
    "reorder.cu": [(r"reorder_kernelILi(\d+)E", "reorder_kernel",
                    ("slots",))],
    "bitonic.cu": [
        (r"bitonic_rows_kernelILi(\d)ELi(n?\d)E", "bitonic_rows_kernel",
         ("num_keys", "float_keys"))],
    "twostack.cu": [
        (r"twostack_flip_kernelI([if])Li(\d+)E", "twostack_flip_kernel",
         ("keys", "lanes"))],
    "groupagg.cu": [
        (r"groupagg_kernelI([if])Li(\d+)ELb([01])E", "groupagg_kernel",
         ("keys", "lanes", "flat"))],
    "segscan.cu": [
        (r"segscan_kernelILi(\d+)E([if])Li(\d+)E", "segscan_kernel",
         ("op", "keys", "lanes"))],
}


def kernel_ptxas(build) -> list:
    """ptxas's report (``-Xptxas -v``) of every instantiation of the window
    kernel, the pane sort, the replay kernel, the standalone sort, the
    two-stack flip, the group-by kernel and the scan, from one more
    ``nvcc`` of each of their sources (all at once): kernel, template
    arguments, registers a thread, spill bytes (stores + loads), stack
    frame (local arrays) and static shared memory."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = {src: subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(build.CSRC / src), "-o", str(Path(tmp) / (src + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in PTXAS_KERNELS}
        reports = {src: proc.communicate()[0] for src, proc in procs.items()}
        for src, proc in procs.items():
            if proc.returncode != 0:
                raise AssertionError(f"nvcc -Xptxas -v {src}:\n{reports[src]}")
    rows = []
    for src, pats in PTXAS_KERNELS.items():
        cur = None
        for line in reports[src].splitlines():
            if "Compiling entry function" in line:
                cur = None
                for pat, kernel, args in pats:
                    m = re.search(pat, line)
                    if m:
                        cur = {"kernel": kernel, **{
                            a: ({"i": "int32", "f": "float32"}[v]
                                if a == "keys" else int(v.replace("n", "-")))
                            for a, v in zip(args, m.groups())}}
                        rows.append(cur)
            elif cur is not None and "spill stores" in line:
                fr, st, ld = re.search(
                    r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads", line).groups()
                cur["spill_bytes"] = int(st) + int(ld)
                cur["stack_bytes"] = int(fr)
            elif cur is not None and "registers" in line:
                cur["registers"] = int(re.search(r"Used (\d+) registers",
                                                 line)[1])
                sm = re.search(r"(\d+) bytes smem", line)
                cur["static_smem"] = int(sm[1]) if sm else 0
    shown = ("op", "keys", "num_keys", "float_keys", "lanes", "slots",
             "max_threads", "ring", "time", "flat")
    for r in rows:
        args = ", ".join(f"{k} {r[k]}" for k in shown if k in r)
        print(f"ptxas {r['kernel']}<{args}>: "
              f"{r['registers']} registers, {r['spill_bytes']} spill bytes, "
              f"{r['stack_bytes']} bytes stack frame, {r['static_smem']} "
              f"bytes static shared memory", flush=True)
    for _, kernel, _ in (x for pats in PTXAS_KERNELS.values() for x in pats):
        if not any(r["kernel"] == kernel for r in rows):
            raise AssertionError(f"no {kernel} in ptxas's report")
    return rows


#: every op the window kernels take: the float32-key checks run them all
ALL_WINDOW_OPS = ("sum", "min", "max", "count", "mean", "distinct_count",
                  "first", "last", "variance", "argmin", "argmax", "median")
#: float sums, means and variances reduce in another order in the kernels
#: than in the plain versions: rtol = atol = 1e-5; every other op exact
INEXACT = ("sum", "mean", "variance")
#: window rows of the float32-key checks (the plain versions set the pace)
FLOAT_ROWS = 4096


def float_key_check(torch, got, want, tag: str) -> float:
    """Hold a window kernel's (og, {op: ov}, oc) on float32 keys to its
    plain version's; returns the largest |difference| over all outputs."""
    (og, ov, oc), (wg, wv, wc) = got, want
    if not (torch.equal(og, wg) and torch.equal(oc, wc)):
        raise AssertionError(f"{tag}: groups or counts differ from plain")
    for name, w in wv.items():
        if name in INEXACT:
            torch.testing.assert_close(ov[name], w, rtol=1e-5, atol=1e-5,
                                       msg=f"{tag}: {name}")
        elif not torch.equal(ov[name], w):
            raise AssertionError(f"{tag}: {name} differs from plain")
    return max_abs_err(torch, flat(got), flat(want))


def float_key_checks(torch, sk, data, dev) -> dict:
    """swag at (c)'s row width and swag_panes at (b)'s, on float32 keys
    (standard normal, from SEED) over (b)'s groups, every window op,
    against their plain versions on the card."""
    import numpy as np

    g = data["stream"][0]
    keys = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        FLOAT_ROWS * 1024 + 4096).astype(np.float32)).to(dev)
    out = {}
    n = 1024 + 256 * (FLOAT_ROWS - 1)
    fg, fk = g[:n].unfold(0, 1024, 256), keys[:n].unfold(0, 1024, 256)
    out["swag"] = {"rows": FLOAT_ROWS, "width": 1024,
                   "ops": len(ALL_WINDOW_OPS), "max_abs_err": float_key_check(
                       torch, sk.swag(fg, fk, ALL_WINDOW_OPS),
                       sk.swag_plain(fg, fk, ALL_WINDOW_OPS), "swag float32")}
    np_ = FLOAT_ROWS + 3
    pg, pk = (x[:np_ * 1024].reshape(np_, 1024) for x in (g, keys))
    sg, skk = sk.sort_panes(pg, pk)
    out["swag_panes"] = {
        "rows": np_ - 3, "width": 4096, "ops": len(ALL_WINDOW_OPS),
        "max_abs_err": float_key_check(
            torch, sk.swag_panes(sg, skk, ALL_WINDOW_OPS, p=4),
            sk.swag_panes_plain(sg, skk, ALL_WINDOW_OPS, p=4),
            "swag_panes float32")}
    for name, row in out.items():
        print(f"{name} float32 keys: {row['rows']} rows of {row['width']}, "
              f"{row['ops']} ops, equal to plain (inexact ops within 1e-5; "
              f"max |err| {row['max_abs_err']:.3g})", flush=True)
    return out


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

    from repro_torch.core import panestore as ps
    from repro_torch.interop import from_numpy, make_stream, make_time_stream
    from repro_torch.kernels import _build, common
    from repro_torch.kernels.bitonic import kernel as bk
    from repro_torch.kernels.eventtime import kernel as ek
    from repro_torch.kernels.groupagg import kernel as gk
    from repro_torch.kernels.segscan import kernel as ssk
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
                "sort_panes": sk.sort_panes, "swag_panes": sk.swag_panes,
                "pergroup_scan": sk.pergroup_scan,
                "pergroup_scan_time": sk.pergroup_scan_time,
                "reorder": ek.reorder_push,
                "pergroup_fused": sk.pergroup_fused,
                "pergroup_replay": sk.pergroup_replay,
                "pergroup_replay_ring": sk.pergroup_replay_ring,
                "twostack_flip": sk.twostack_flip,
                "bitonic_sort": bk.bitonic_sort,
                "segmented_scan": ssk.segscan}
    run_launches = {}

    t0 = time.perf_counter()
    data = {
        "sorted": from_numpy(*make_stream(SEED, N, 4096, 1000,
                                          sorted_by="group_key"), dev),
        "stream": from_numpy(*make_stream(SEED, N, 64, 1000), dev),
        "median": from_numpy(*make_stream(SEED, sk.MAX_ROW, 64, 1000,
                                          sorted_by="group_key"), dev),
        "pergroup32": from_numpy(*make_stream(SEED, 1 << 20, 32, 1000), dev),
        "pergroup64": from_numpy(*make_stream(SEED, 1 << 16, 64, 1000), dev),
    }
    g_t, k_t, ts_t = make_time_stream(SEED, N, 64, **TIME_STREAM)
    data["time"] = (*from_numpy(g_t, k_t, dev),
                    torch.from_numpy(ts_t).to(dev))
    del g_t, k_t, ts_t
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
        ("f", "cuda-panestore", Query(ops=PARTIAL,
                                      window=Window(**PERGROUP)),
         "pergroup32", ("pergroup_scan", "pergroup_fused")),
        ("g", "cuda-panestore", Query(ops=PARTIAL + ("median", "dc"),
                                      window=Window(**PERGROUP)),
         "pergroup64", ("pergroup_scan", "pergroup_replay_ring")),
        ("h", "cuda", Query(ops=TWOSTACK, group_by=False,
                            window=Window(**TIME_WINDOW)),
         "time", ("twostack_flip",)),
        ("i", "cuda", Query(ops=OPS + ("median",),
                            window=Window(**TIME_WINDOW)),
         "time", ("swag",)),
    ]
    #: the store event each per-group run exists to exercise: (f)'s 32
    #: groups fit the 292 slots (9 panes each at most), so it retires and
    #: never evicts; (g)'s 64 groups do not fit, so it evicts
    must_see = {"f": "retirements", "g": "evictions"}
    phases = []
    for tag, backend, q, which, expect in runs:
        g, k, *ts = data[which]
        g_in = g if q.group_by else None
        extra = {"timestamps": ts[0]} if ts else {}
        (res, _), counts, peak = counted_call(
            torch, lambda: execute(q, g_in, k, backend=backend, **extra),
            wrappers)
        for name in expect:
            if counts[name] == 0:
                raise AssertionError(f"run ({tag}) did not launch {name}")
        if tag == "a" and counts["groupagg"] != 1:
            raise AssertionError(f"run (a) launched groupagg "
                                 f"{counts['groupagg']} times, not once for "
                                 f"all its ops")
        run_launches[tag] = counts
        t1 = time.perf_counter()
        events = None
        if q.window is not None and q.window.per_group:
            # evaluation e depends on nothing after tuple (e + 1) * WA
            checked = min(PREFIX, k.shape[0])
            want, _ = execute(q, g_in[:checked], k[:checked],
                              backend="reference")
            res = leading(res, checked // q.window.wa)
        else:
            want, _ = execute(q, g_in, k, backend="reference", **extra)
            checked = k.shape[0]
        check_against_reference(torch, res, want, f"run ({tag})")
        if tag == "h":
            check_time_strategies(torch, q, k, ts[0], res)
        check_s = time.perf_counter() - t1
        if tag in must_see:
            spec = q.window.store_spec()
            ev = sk.pergroup_scan(spec, ps.init_store(spec, device=dev),
                                  g_in[:checked]).events.tolist()
            events = {"evictions": ev[0], "retirements": ev[1]}
            if events[must_see[tag]] == 0:
                raise AssertionError(f"run ({tag}): no {must_see[tag]} in "
                                     f"the {checked} tuples checked")
        del want, res
        # [1]: the last timed result is dropped here, not held into the
        # next run's peak memory
        times = timed_all(torch, lambda: execute(q, g_in, k, backend=backend,
                                                 **extra), 7)[1]
        ms = times[len(times) // 2]
        n = k.shape[0]
        layout = None
        if ts:
            lay_ms, walk_ms = host_layout_ms(torch, q, ts[0])
            share = (lay_ms + (walk_ms or 0.0)) / ms
            layout = {"layout_ms": lay_ms, "epoch_walk_ms": walk_ms,
                      "share_of_run": share}
            print(f"run ({tag}) host layout: time_window_layout "
                  f"{lay_ms:.3f} ms" + ("" if walk_ms is None else
                                        f" + epoch walk {walk_ms:.3f} ms")
                  + f" = {share:.1%} of the run's {ms:.3f} ms", flush=True)
        row = {"run": tag, "backend": backend, "tuples": n,
               "ops": list(q.op_names), "window": window_desc(q.window),
               "group_by": q.group_by, "ms": ms, "ms_min": times[0],
               "ms_max": times[-1], "calls": len(times),
               "tuples_per_s": n / (ms / 1e3), "peak_bytes": peak,
               "launches": counts, "reference_check_s": check_s,
               "reference_checked_tuples": checked,
               "store_events_checked": events, "host_layout": layout,
               "equal_to_reference": True}
        phases.append(row)
        print(f"run ({tag}) {backend}: {n} tuples in {ms:.3f} ms (median "
              f"of {len(times)}, {times[0]:.3f}-{times[-1]:.3f}) = "
              f"{row['tuples_per_s']:.4g} tuples/s, peak {peak / 2**30:.2f} "
              f"GiB, launches {counts}, equal to reference over "
              f"{checked} tuples ({check_s:.1f} s)"
              + ("" if events is None else f" with {events}")
              + f" [{identity}]", flush=True)

    data["replay"] = replay_inputs(torch, sk, ps, data, dev)
    phases += standalone_runs(torch, data, dev, wrappers, run_launches,
                              identity)
    stream_phases, kernels = stream_runs(torch, data, dev, wrappers,
                                         run_launches, identity)
    phases += stream_phases
    stream_phases, rows = event_time_run(torch, dev, wrappers, run_launches,
                                         identity)
    phases += stream_phases
    kernels += rows

    # groupagg as run (a) launches it: the flat layout, every op of (a) in
    # one launch over the unpadded stream
    g, k = data["sorted"]
    names = ("min", "max", "sum", "count", "distinct_count")
    out, ms = timed(torch, lambda: gk.groupagg_flat(g, k, names, tile=1024),
                    5)
    b2b_ms = back_to_back_ms(torch, lambda: gk.groupagg_flat(
        g, k, names, tile=1024))
    want, plain_ms = timed(torch, lambda: gk.groupagg_flat_plain(
        g, k, names, tile=1024))
    err = max_abs_err(torch, flat(out[:3]) + [out[3]],
                      flat(want[:3]) + [want[3]])
    del out, want
    n = g.numel()
    # read: group and key; written: group, valid and each op's value
    b, by = bound_ms(n * 8 + n * (4 + 1 + 4 * len(names)), n * 4.0 * len(names))
    kernels.append({"name": "groupagg", "layout": "flat", "ops": list(names),
                    "ms": ms, "ms_back_to_back": b2b_ms,
                    "plain_ms": plain_ms, "library_ms": None,
                    "max_abs_err": err, "bound_ms": b, "bound_by": by,
                    "shape": [n // 1024 + 1, 1024], "runs": ["a"]})

    # the per-tile layout (the TPU kernel's) over the padded stream, op sum
    pad = torch.full((1024,), 2**31 - 1, dtype=torch.int32, device=dev)
    gp = torch.cat([g, pad])
    kp = torch.cat([k, torch.zeros_like(pad)])
    err = 0.0
    for op in names:
        err = max(err, max_abs_err(torch, gk.groupagg(gp, kp, op, tile=1024),
                                   gk.groupagg_plain(gp, kp, op, tile=1024)))
    _, ms = timed(torch, lambda: gk.groupagg(gp, kp, "sum", tile=1024), 5)
    b2b_ms = back_to_back_ms(torch, lambda: gk.groupagg(gp, kp, "sum",
                                                        tile=1024))
    _, plain_ms = timed(torch, lambda: gk.groupagg_plain(gp, kp, "sum",
                                                         tile=1024))
    g64 = g.long()
    _, lib_ms = timed(torch, lambda: torch.zeros(
        4096, dtype=torch.int32, device=dev).scatter_reduce_(
        0, g64, k, "sum"), 5)
    npad = gp.numel()
    b, by = bound_ms(npad * 8 + npad * 8 + (npad // 1024) * 4, npad * 4)
    kernels.append({"name": "groupagg", "layout": "per tile", "op": "sum",
                    "ms": ms, "ms_back_to_back": b2b_ms,
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
    # the same rows with one op: the sort and the tails' fixed part
    _, one_op_ms = timed(torch, lambda: sk.swag(fg, fk, ("count",)), 3)
    nw = fg.shape[0]
    b, by = bound_ms(N * 8 + nw * 1024 * 4 * (1 + len(ops)) + nw * 4,
                     network_exchanges(nw, 1024) * 4
                     + nw * 1024 * 2 * len(ops))
    kernels.append({"name": "swag", "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None, "max_abs_err": err, "bound_ms": b,
                    "bound_by": by, "shape": [nw, 1024], "runs": ["c"],
                    "one_op_ms": one_op_ms})

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
    _, one_op_ms = timed(torch, lambda: sk.swag_panes(sg, skk, ("count",),
                                                      p=p), 3)
    nw = np_ - p + 1
    b, by = bound_ms(np_ * wa * 8 + nw * 4096 * 4 * (1 + len(ops)) + nw * 4,
                     network_exchanges(nw, 4096, wa) * 4
                     + nw * 4096 * 2 * len(ops))
    kernels.append({"name": "swag_panes", "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None, "max_abs_err": err, "bound_ms": b,
                    "bound_by": by, "shape": [nw, 4096],
                    "runs": ["b", "d"], "one_op_ms": one_op_ms})

    kernels += pergroup_kernels(torch, sk, data, dev)
    kernels += slice5_kernels(torch, sk, data, dev)

    float_checks = float_key_checks(torch, sk, data, dev)
    ptxas = kernel_ptxas(_build)
    for row in kernels:
        # the int32-key instantiation the main path's launch shape runs
        if row["name"] in ("pergroup_replay", "pergroup_replay_ring"):
            row["ptxas"] = next(
                r for r in ptxas if r["kernel"] == "pergroup_replay_kernel"
                and r["keys"] == "int32"
                and r["ring"] == (row["name"] == "pergroup_replay_ring")
                and r["time"] == (row.get("form") == "time"))
        if row["name"] in ("reorder", "pergroup_scan_time"):
            row["ptxas"] = next(
                r for r in ptxas if r["kernel"] == row["name"] + "_kernel"
                and r.get("keys", "int32") == "int32")
        if row["name"] == "sort_panes":
            geo = sk.swag_geometry(row["shape"][1])
            row["ptxas"] = min(
                (r for r in ptxas if r["kernel"] == "sort_rows_kernel"
                 and r["keys"] == "int32"
                 and r["lanes"] == geo["lanes_per_thread"]
                 and r["max_threads"] >= geo["threads"]),
                key=lambda r: r["max_threads"])
        if row["name"] == "bitonic_sort":  # int32 keys, float32 payload
            row["geometry"] = geo = bk.bitonic_geometry(
                row["keys"], row["shape"][1], 4)
            row["ptxas"] = next(
                r for r in ptxas if r["kernel"] == "bitonic_rows_kernel"
                and r["num_keys"] == row["keys"] and r["float_keys"] == 0)
        # int32 keys, tile 1024: the instantiation of several lanes a thread
        if row["name"] == "groupagg":
            row["ptxas"] = next(
                r for r in ptxas if r["kernel"] == "groupagg_kernel"
                and r["keys"] == "int32" and r["lanes"] > 1
                and r["flat"] == (row["layout"] == "flat"))
        if row["name"] == "segmented_scan":
            # (k)'s rows scan one op, (m)'s every op of a push
            found = [next(
                r for r in ptxas if r["kernel"] == "segscan_kernel"
                and r["op"] == common.OP_CODES[op]
                and r["keys"] == "int32" and r["lanes"] > 1)
                for op in row.get("ops", [row.get("op")])]
            row["ptxas"] = found if "ops" in row else found[0]
        if row["name"] == "twostack_flip":
            row["geometry"] = geo = sk.twostack_geometry(row["shape"][1])
            row["ptxas"] = next(
                r for r in ptxas if r["kernel"] == "twostack_flip_kernel"
                and r["keys"] == "int32"
                and r["lanes"] == geo["lanes_per_thread"])
        if row["name"] in ("swag", "swag_panes"):
            row["geometry"] = geo = sk.swag_geometry(row["shape"][1])
            row["ptxas"] = min(
                (r for r in ptxas if r["kernel"] == "swag_rows_kernel"
                 and r["keys"] == "int32"
                 and r["lanes"] == geo["lanes_per_thread"]
                 and r["max_threads"] >= geo["threads"]),
                key=lambda r: r["max_threads"])
            if row["runs"] in (["c"], ["b", "d"]):  # (c)'s, (b)'s widths
                row["float32_check"] = float_checks[row["name"]]
        if row["name"] == "groupagg" or (row["name"] == "segmented_scan"
                                         and "op" in row):
            print(f"{row['name']} ({row.get('layout') or row['op']}) "
                  f"{row['shape'][0]} x {row['shape'][1]}: "
                  f"{row['ptxas']['registers']} registers a thread, "
                  f"{row['ms']:.4f} ms ({row['ms_back_to_back']:.4f} ms a "
                  f"call back to back; bound {row['bound_ms']:.4f}, plain "
                  f"{row['plain_ms']:.3f})", flush=True)
        if "geometry" in row:
            geo = row["geometry"]
            print(f"{row['name']} {row['shape'][0]} x {row['shape'][1]}: "
                  f"{geo['lanes_per_thread']} lanes a thread, "
                  f"{geo['threads']} threads a block, {geo['smem_bytes']} "
                  f"bytes of dynamic shared memory, "
                  f"{row['ptxas']['registers']} registers a "
                  f"thread, {row['ms']:.4f} ms"
                  + (f" ({row['one_op_ms']:.4f} ms with op count alone)"
                     if "one_op_ms" in row else "")
                  + (f" ({row['ms_back_to_back']:.4f} ms a call back to "
                     f"back)" if "ms_back_to_back" in row else ""),
                  flush=True)

    for row in kernels:
        if row["max_abs_err"] != 0.0:
            raise AssertionError(f"{row['name']}: kernel and plain version "
                                 f"differ by {row['max_abs_err']} (int32 "
                                 f"keys and lane payloads must match "
                                 f"exactly)")
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
    spilled = [r for r in ptxas if r["spill_bytes"]]
    if spilled:
        raise AssertionError(f"register spills: {spilled}")
    print(card_identity(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
