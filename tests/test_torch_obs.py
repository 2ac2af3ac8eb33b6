"""Observability of the port (``repro_torch.obs``, ``collect_stats=True``,
spans, the metrics registry, exporters) against the JAX package on the
CPU.  Mirrors ``tests/test_obs.py`` case by case, but for its
``REPRO_BACKEND`` case (the port reads no environment variable).

The load-bearing guarantees:

  * the stats dicts equal the JAX package's key for key and value for
    value: on plain, count-window and event-time streams, push by push, on
    ``reference`` and on ``cuda`` / ``cuda-panestore`` (their kernels'
    plain versions here), a stream that evicts and one whose full reorder
    buffer forces pops among them; and on the batch paths, ``reference``
    against ``reference`` and ``cuda-panestore`` against
    ``pallas-panestore``;
  * ``collect_stats=True`` never changes a result: outputs and states are
    bit-identical with stats on and off, over fixed seeds;
  * ``collect_stats=False`` is free: with the counter helpers patched to
    raise, every stats-off path still runs and returns ``stats is None``
    (torch has no jaxpr to count; this replaces the JAX package's trace
    check);
  * fingerprints and the Prometheus text equal the JAX package's, and
    ``choose_backend`` consults the registry as the JAX package's does.

Counters are exact integers: compared element-exact.  The JAX side is
jitted (one program a stream); the port runs in its own process
(``_torch_parity.port``).
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_result_same, port  # noqa: F401 (fixture)
from _torch_parity import oracle_jit
from repro import query as jq
from repro.core import StreamingAggregator as JaxAggregator
from repro.obs import export as jax_export
from repro.obs.registry import MetricsRegistry as JaxRegistry
from repro.obs.registry import query_fingerprint as jax_fingerprint

N = 64
#: (ops, window) of each stream, and the port's backends held to JAX on it
STREAMS = {
    "plain": (("sum",), None, ("reference", "cuda")),
    # 6 groups of 3-pane windows in 8 slots: the store evicts
    "evict": (("sum",), dict(ws=16, wa=8, capacity=8),
              ("reference", "cuda-panestore")),
    "median": (("median",), dict(ws=16, wa=8, capacity=8),
               ("reference", "cuda-panestore")),
    "time": (("min",), dict(range=32, slide=8, max_lateness=4,
                            reorder_capacity=32),
             ("reference", "cuda-panestore")),
    # a lateness of 64 holds tuples back; 8 slots fill: forced pops
    "forced": (("min",), dict(range=32, slide=8, max_lateness=64,
                              reorder_capacity=8),
               ("reference", "cuda-panestore")),
}
#: live prefixes of the pushes: all, 40, none (the occupancy mark of a push
#: whose tuples are all dead), all
N_VALIDS = (None, 40, 0, None)


def _stream(case, seed=0):
    """Four pushes of N tuples of 6 groups: (groups, keys[, timestamps])."""
    rng = np.random.default_rng(seed)
    _, window, _ = STREAMS[case]
    jitter = 30 if case == "forced" else 3
    out = []
    for i in range(len(N_VALIDS)):
        g = rng.integers(0, 6, N).astype(np.int32)
        if window is None:
            g = np.sort(g)
        k = rng.integers(-50, 50, N).astype(np.int32)
        if window is not None and "range" in window:
            ts = (np.arange(N) + N * i
                  + rng.integers(-jitter, jitter + 1, N)).astype(np.int32)
            out.append((g, k, ts))
        else:
            out.append((g, k))
    return out


def _np_dict(d):
    return {name: np.asarray(v) for name, v in d.items()}


@functools.lru_cache(maxsize=None)
def _jax_stream(case):
    """The JAX reference stream with stats: per push its outputs and
    counters (numpy)."""
    ops, window, _ = STREAMS[case]
    q = jq.Query(ops=ops, streaming=True,
                 window=None if window is None else jq.Window(**window))
    p = jq.plan(q, backend="reference")
    state = jq.init_stream_state(p, collect_stats=True)
    step = oracle_jit(jq.stream_fn(p, collect_stats=True))
    out = []
    for (g, k, *ts), nv in zip(_stream(case), N_VALIDS):
        nv = jnp.int32(N if nv is None else nv)
        (og, ov, valid, num, _rr), state = step(g, k, state, nv, *ts)
        out.append(((np.asarray(og), _np_dict(ov), np.asarray(valid),
                     np.asarray(num)), _np_dict(state[1])))
    return out


def _assert_stats_equal(want, got, where=""):
    """Key for key; a counter is int32 (``tuples`` and ``num_shards`` are
    plain numbers, as the JAX package's are outside a jit)."""
    assert set(want) == set(got), (where, sorted(want), sorted(got))
    for name in want:
        w, g = np.asarray(want[name]), got[name]
        if isinstance(g, np.ndarray):
            assert g.dtype == np.int32, (where, name, g.dtype)
        else:
            assert isinstance(g, int), (where, name, type(g))
        np.testing.assert_array_equal(np.asarray(g, np.int32),
                                      w.astype(np.int32),
                                      err_msg=f"{where} {name}")


def _assert_outputs_equal(a, b, where=""):
    ga, va, valid_a, na = a
    gb, vb, valid_b, nb = b
    np.testing.assert_array_equal(ga, gb, err_msg=where)
    np.testing.assert_array_equal(valid_a, valid_b, err_msg=where)
    np.testing.assert_array_equal(na, nb, err_msg=where)
    assert set(va) == set(vb)
    for name in va:
        np.testing.assert_array_equal(va[name], vb[name],
                                      err_msg=f"{where} {name}")


def _assert_states_equal(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for f in a:
            _assert_states_equal(a[f], b[f], f"{where}.{f}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_states_equal(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)


# ---------------------------------------------------------------------------
# the stats dicts equal the JAX package's (the batch paths first: their
# JAX side, a Pallas kernel in interpret mode, is the file's longest)


#: per-group batch queries: the partial path, and the merge path
PERGROUP = dict(ws=32, wa=8, ws_per_group={0: 16})


@pytest.mark.parametrize("ops", [("sum", "min"), ("sum", "median")],
                         ids=["partial", "merge"])
def test_pergroup_batch_counters_match_jax(port, ops):
    """The per-group batch path's stats: ``reference`` equals the JAX
    reference (evictions, the occupancy mark, the regime gauges) and
    ``cuda-panestore`` the JAX ``pallas-panestore`` (its gauges only; run
    in interpret mode on the partial path, the file's longest JAX call,
    and on the merge path taken as the reference's gauges, which the JAX
    package computes by the same rule for both backends)."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 8, 128).astype(np.int32)
    k = rng.integers(-100, 100, 128).astype(np.int32)
    merge = "median" in ops

    def jax_run(backend):
        return oracle_jit(lambda g, k: jq.execute(
            jq.Query(ops=ops, window=jq.Window(**PERGROUP)), g, k,
            backend=backend, collect_stats=True)[0])(g, k)

    ref = jax_run("reference")
    for backend in ("reference", "cuda-panestore"):
        want = ref
        stats = _np_dict(ref.stats)
        if backend == "cuda-panestore":
            if merge:
                for name in ("pane_evictions", "pane_occupancy_hwm"):
                    del stats[name]
            else:
                want = jax_run("pallas-panestore")
                stats = _np_dict(want.stats)
        off, on = port.execute_on_off(ops, g, k, backend=backend,
                                      window=PERGROUP)
        _assert_stats_equal(stats, on.stats, backend)
        assert off.stats is None
        assert_result_same(want, on)
        assert_result_same(want, off)
    ne = 128 // 8
    assert int(on.stats["pergroup_evals_batched"]) == ne
    assert int(on.stats["pergroup_partial_dispatch"]) == (0 if merge else 2)
    assert int(on.stats["pergroup_merge_dispatch"]) == (2 if merge else 0)


# ---------------------------------------------------------------------------
# ... and push by push


@pytest.mark.parametrize("case", list(STREAMS))
def test_stream_stats_match_jax(port, case):
    """Every push's stats (``execute(state=..., collect_stats=True)``) equal
    the JAX reference stream's counters key for key, on each of the port's
    backends; the outputs too, and they and the state are bit-identical to
    the stats-off stream's."""
    ops, window, backends = STREAMS[case]
    want = _jax_stream(case)
    for backend in backends:
        got = port.stream_on_off(ops, _stream(case), backend=backend,
                                 window=window, n_valids=list(N_VALIDS))
        for i, (w, push) in enumerate(zip(want, got)):
            where = f"{case}/{backend} push {i}"
            _assert_stats_equal(w[1], push["stats"], where)
            _assert_stats_equal(w[1], push["carried"], where)
            _assert_outputs_equal(push["off"], push["on"], where)
            _assert_outputs_equal(w[0], push["on"], where)
            _assert_states_equal(push["state_off"], push["state_on"], where)
    last = want[-1][1]
    if case == "evict":
        assert int(last["pane_evictions"]) > 0
    if case == "forced":
        assert int(last["reorder_forced_pops"]) > 0
        assert int(last["reorder_depth_hwm"]) == 8


def test_engine_stats_match_jax(port):
    rng = np.random.default_rng(3)
    g = np.sort(rng.integers(0, 8, 256)).astype(np.int32)
    k = rng.integers(-100, 100, 256).astype(np.int32)
    q = jq.Query(ops=("sum", "min", "count"))
    want = oracle_jit(lambda g, k: jq.execute(
        q, g, k, backend="reference", collect_stats=True)[0])(g, k)
    for backend in ("reference", "cuda"):
        off, on = port.execute_on_off(("sum", "min", "count"), g, k,
                                      backend=backend)
        _assert_stats_equal(_np_dict(want.stats), on.stats, backend)
        assert off.stats is None and on.stats == {"tuples": 256,
                                                  "num_shards": 1}
        assert_result_same(want, on)


def test_sharded_stats_report_combine_rounds(port):
    """A 4-shard plan's stats: the combine tree's rounds, their widths
    (each round doubles the table), live groups and bytes, equal to the
    JAX package's; stats off gives the same result."""
    rng = np.random.default_rng(11)
    g = np.sort(rng.integers(0, 8, 256)).astype(np.int32)
    k = rng.integers(-100, 100, 256).astype(np.int32)
    p = jq.plan(jq.Query(ops=("sum", "min")), backend="reference",
                num_shards=4)
    want = oracle_jit(lambda g, k: jq.execute(p, g, k,
                                              collect_stats=True)[0])(g, k)
    on, off = port.sharded_stats(("sum", "min"), g, k, 4)
    s = on.stats
    assert s["num_shards"] == 4 and s["tuples"] == 256
    widths = s["combine_round_width"]
    assert widths.shape == (2,)          # log2(4) tree rounds
    assert widths[1] == 2 * widths[0]    # pairwise merge doubles the table
    assert s["combine_round_groups"].shape == (2,)
    assert s["combine_round_bytes"].shape == (2,)
    assert set(want.stats) == set(s)
    for name, v in want.stats.items():
        w = np.asarray(v)
        np.testing.assert_array_equal(s[name], w, err_msg=name)
        if name.startswith("combine_"):
            assert s[name].dtype == w.dtype, (name, s[name].dtype, w.dtype)
    assert_result_same(want, on)
    assert_result_same(want, off)


# ---------------------------------------------------------------------------
# collect_stats on/off bit-identity, over fixed seeds


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouped_stats_bit_identical(port, seed, backend):
    rng = np.random.default_rng(seed)
    g = np.sort(rng.integers(0, 8, 256)).astype(np.int32)
    k = rng.integers(-100, 100, 256).astype(np.int32)
    off, on = port.execute_on_off(("sum", "min", "count"), g, k,
                                  backend=backend)
    assert_result_same(off, on)
    assert off.stats is None
    assert on.stats["tuples"] == 256


@pytest.mark.parametrize("backend", ["reference", "cuda", "cuda-panes"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windowed_stats_bit_identical(port, seed, backend):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 8, 256).astype(np.int32)
    k = rng.integers(-100, 100, 256).astype(np.int32)
    off, on = port.execute_on_off(("sum", "min"), g, k, backend=backend,
                                  window=dict(ws=32, wa=8))
    assert_result_same(off, on)
    assert off.stats is None and on.stats == {"tuples": 256,
                                              "num_shards": 1}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_streaming_stats_bit_identical(port, seed):
    """Plain, pane-store and event-time streams push bit-identically (the
    outputs and the carried state) with the counters attached, on every
    backend that streams them."""
    for case in ("plain", "evict", "forced"):
        ops, window, backends = STREAMS[case]
        for backend in backends:
            got = port.stream_on_off(ops, _stream(case, seed),
                                     backend=backend, window=window,
                                     n_valids=list(N_VALIDS))
            for i, push in enumerate(got):
                where = f"{case}/{backend} push {i}"
                _assert_outputs_equal(push["off"], push["on"], where)
                _assert_states_equal(push["state_off"], push["state_on"],
                                     where)
                assert isinstance(push["stats"], dict) and push["stats"]


def test_stats_off_never_counts(port):
    """With the counter helpers patched to raise, every stats-off path (the
    engine, count windows, per-group windows, time windows, and plain,
    count-window and event-time streams with their flushes, on the
    reference and the kernel backends' plain versions) still runs and
    surfaces no stats; an event-time stream keeps its late-drop count, as
    the JAX package's does."""
    rng = np.random.default_rng(7)
    g = rng.integers(0, 6, N).astype(np.int32)
    k = rng.integers(-50, 50, N).astype(np.int32)
    ts = (np.arange(N) + rng.integers(-3, 4, N)).astype(np.int32)
    seen = port.stats_off_paths(g, k, ts)
    assert len(seen) == 20
    for name, stats in seen.items():
        if name.split("/")[0] in ("stream time", "flush time"):
            assert stats == ["late_dropped"], name
        else:
            assert stats is None, name


def test_stats_constancy_enforced_across_stream(port):
    """A stream started with collect_stats=True keeps it (the counters
    live in its state): flipping the flag raises, either way."""
    errors = port.execute_stats_toggled()
    assert len(errors) == 2
    assert all("collect_stats must stay constant" in e for e in errors)


# ---------------------------------------------------------------------------
# the aggregator


@pytest.mark.parametrize("case,backend", [
    ("plain", "reference"), ("evict", "cuda-panestore"),
    ("forced", "cuda-panestore")])
def test_streaming_aggregator_surfaces_stats(port, case, backend):
    """Per push, the aggregator's stats are the JAX aggregator's, key for
    key; the flush surfaces the stats of the stream it closes, and resets
    them with it.  ``store_donated_buffers`` counts the carry's tensors
    the pushes updated in place: on ``cuda-panestore`` all of them, the
    JAX package's count of the buffers it donates; on the others, which
    make a new state a push, the counters alone."""
    ops, window, _ = STREAMS[case]
    batches = _stream(case)[:2]
    agg = JaxAggregator(ops[0], collect_stats=True,
                        window=None if window is None
                        else jq.Window(**window))
    pushes = [_np_dict(agg.push(g, k, timestamps=ts[0] if ts else None)
                       .stats) for g, k, *ts in batches]
    # the JAX flush surfaces the stats of the stream it closes (those of
    # its last push), and resets them with it: the next push's stats are
    # the first push's (the donated buffers keep counting)
    want = [pushes[0], pushes[1], pushes[1], dict(pushes[0])]
    got, leaves = port.aggregator_stats(ops[0], batches, backend=backend,
                                        window=window)
    assert leaves == agg._carry_leaves
    assert int(pushes[1]["store_donated_buffers"]) == 2 * leaves
    in_place = leaves if backend == "cuda-panestore" else len(pushes[0]) - 1
    for i, (w, s) in enumerate(zip(want, got)):
        w = {k: v for k, v in w.items() if k != "store_donated_buffers"}
        donated = int(s.pop("store_donated_buffers"))
        assert donated == in_place * (1, 2, 2, 3)[i], (i, donated)
        _assert_stats_equal(w, s, f"{case}/{backend} result {i}")


def test_streaming_windowed_dispatch_counters(port):
    z, one = np.zeros(16, np.int32), np.ones(16, np.int32)
    window = dict(ws=16, wa=8, capacity=8)
    for ops, partial in ((("sum",), 1), (("median",), 0)):
        for backend in ("reference", "cuda-panestore"):
            (push,) = port.stream_on_off(ops, [(z, one)], backend=backend,
                                         window=window)
            assert int(push["stats"]["pergroup_partial_ops"]) == partial
            assert int(push["stats"]["pergroup_merge_ops"]) == 1 - partial


# ---------------------------------------------------------------------------
# host-side substrate: spans, registry, helpers, exporters


def test_trace_registry_helpers_and_jsonl(port, tmp_path):
    rng = np.random.default_rng(3)
    g = np.sort(rng.integers(0, 8, 256)).astype(np.int32)
    k = rng.integers(-100, 100, 256).astype(np.int32)
    out = port.obs_substrate(g, k, str(tmp_path / "stats.jsonl"))

    names = [s[0] for s in out["spans"]]
    assert names == ["plan", "dispatch:reference/engine"]
    assert out["spans"][0][1] == out["spans"][1][1] == 0
    assert all(s[2] >= 0 for s in out["spans"])
    assert "dispatch:reference/engine:" in out["report"]
    assert out["null_shared"]

    tps, cell, best, none = out["registry"]
    assert tps == 1000.0 and best == "cuda" and none is None
    assert cell["calls"] == 2 and cell["tuples"] == 2000.0
    assert out["reset"] == {}
    calls, tps = out["observed"]
    assert calls == 1 and tps > 0

    h = out["helpers"]
    assert h["none"] == [None] * 4 and h["keys"] == ["a", "b"]
    assert h["a"] == (3, 0) and h["b"] == 7   # a functional update
    assert h["dtype"] == "torch.int32"

    [rec] = out["jsonl"]
    assert rec["name"] == "t"
    stats = rec["engine_stats"]
    assert stats["tuples"] == 256 and stats["num_shards"] == 1
    assert stats["pergroup_evals_batched"] == 256 // 8
    assert isinstance(stats["pane_evictions"], int)


def test_plan_fingerprints_equal_jax(port):
    """The port's fingerprints are the JAX package's strings, and a
    query's equals its plan's (``choose_backend`` fingerprints a query
    before a plan exists)."""
    cases = [
        (("sum", "min"), None, None, 1),
        (("sum",), dict(ws=64, wa=16), None, 2),
        (("sum",), dict(ws=16, wa=4, ws_per_group={0: 8}), None, 1),
        (("sum",), None, {"streaming": True}, 1),
        (("min",), dict(range=32, slide=8, max_lateness=4,
                        reorder_capacity=16), {"streaming": True}, 1),
        (("median",), dict(ws=64, wa=16), {"interpolate": True}, 1),
        (("dc", "max"), None, {"group_by": False}, 1),
    ]
    got = port.fingerprints(cases)
    for (ops, window, query, shards), (qfp, pfp) in zip(cases, got):
        q = jq.Query(ops=ops, window=None if window is None
                     else jq.Window(**window), **(query or {}))
        want = jax_fingerprint(q, num_shards=shards)
        assert qfp == want
        if shards == 1:
            assert pfp == want
    assert got[0][0] == "ops=sum,min;group_by=1;path=engine;shards=1"
    assert "window=count:ws64:wa16" in got[1][0] and "shards=2" in got[1][0]
    assert "window=time:r32:s8:l4:rc16" in got[4][0]
    assert "path=stream" in got[4][0] and "reference" not in got[4][0]


def test_prometheus_text_equals_jax(port):
    cells = [("reference", 'fp"x', 100, 1.0), ("cuda", "ops=sum", 250, 0.5),
             ("reference", "ops=sum", 7, 3.0)]
    stats = {"pane_evictions": np.int32(5),
             "combine_round_width": np.array([4, 8], np.int32),
             "watermark": np.int32(-(2 ** 30))}
    reg = JaxRegistry()
    for backend, fp, tuples, seconds in cells:
        reg.observe(backend, fp, tuples=tuples, seconds=seconds)
    want = jax_export.prometheus_metrics(
        registry=reg, stats={name: jnp.asarray(v)
                             for name, v in stats.items()})
    got = port.prometheus_text(cells, stats)
    assert got == want
    assert '# TYPE repro_observed_tuples_per_s gauge' in got
    assert 'plan="fp\\"x"' in got                    # label escaping
    assert 'repro_engine_stat{name="pane_evictions"} 5.0' in got
    assert 'name="combine_round_width",round="1"} 8.0' in got


def test_choose_backend_consults_metrics(port):
    """With a seeded registry, ``auto`` picks the measured-fastest capable
    backend; with fewer than two measured candidates the static choice
    (the reference on the CPU) stands."""
    got = port.backend_routing(("sum",), dict(ws=16, wa=4,
                                              ws_per_group={0: 8}))
    assert got == ["reference", "reference", "cuda-panestore",
                   "cuda-panestore", "cuda-panestore", "cuda-panestore",
                   "reference"]
