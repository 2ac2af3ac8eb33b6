"""Streaming queries of the port (``Query(streaming=True)``,
``StreamingAggregator``, ``execute(state=)``) against the JAX package on
the CPU, push by push.

The JAX side runs ``backend="reference"``, the only JAX backend that
streams; each of the port's ``reference``, ``cuda`` (non-windowed: the
segmented-scan kernel's plain version) and ``cuda-panestore`` (windowed:
the placement scan's and the ring replay's plain versions) is held against
it.  Every push's full outputs (groups, values, valid, num, rr_port,
padded tails included) and the carry or pane store it leaves are
compared.  Mirrors ``tests/test_streaming.py`` (ops x batch sizes, a group
over 8 batches, alternating singletons, seeded run lengths with an
``n_valid`` last batch) and adds multi-op streams with distinct count and
float keys, count-window streams with ragged pushes, an eviction and a
flush, repeated ``execute(state=)`` calls, a stream begun in JAX and
continued in the port, and the refusals.

Tolerance: element-exact, except float ``sum``/``mean`` values and their
carried sums, which the port reduces in another order: rtol = atol = 1e-5
(``tests/_torch_parity.py``).  The port runs in its own process
(``_torch_parity.port``); the JAX steps are jitted, one program per batch
shape.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_same, port  # noqa: F401
from _torch_parity import oracle_jit
from repro import query as jq
from repro.core import StreamingAggregator as JaxAggregator
from repro.core.panestore import PaneStoreState as JaxStore
from repro_torch.interop import make_stream

ALL_DIRECT = ("sum", "count", "min", "max", "mean", "median",
              "distinct_count")
MULTI = ("sum", "min", "max", "count", "mean", "distinct_count")
#: count windows whose stores evict: 6 slots of 4-lane panes for 6 groups
PER_GROUP = {"ws": 8, "wa": 4, "ws_per_group": {0: 16, 1: 4},
             "capacity": 6}
PLAIN = {"ws": 8, "wa": 4, "capacity": 6}
#: pushes that are not multiples of WA = 4 (two batch shapes to compile)
RAGGED = [7, 13] * 4


def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_np_tree(v) for v in x)
    return np.asarray(x)


def _jax_state_np(state):
    """A JAX stream state in the port's numpy layout (``interop``)."""
    if isinstance(state, JaxStore):
        return {f: np.asarray(v) for f, v in zip(JaxStore._fields, state)}
    return tuple({"group": np.asarray(c.group), "state": _np_tree(c.state),
                  "nonempty": np.asarray(c.nonempty),
                  "emitted": np.asarray(c.emitted)} for c in state)


#: the jitted JAX stream step of each (ops, window): a stream continued
#: from a JAX state, or another test's stream of the same query and batch
#: shapes, reuses the compile
_JAX_STEPS: dict = {}


def _jax_stream(ops, batches, *, window=None, state=None, n_valids=None,
                key_dtype=jnp.int32):
    """The JAX reference stream through ``stream_fn`` (jitted): per push
    its outputs and the state it left (numpy), and the last JAX state."""
    key = (ops, None if window is None else repr(sorted(window.items())))
    if key not in _JAX_STEPS:
        q = jq.Query(ops=ops, streaming=True,
                     window=None if window is None else jq.Window(**window))
        p = jq.plan(q, backend="reference")
        _JAX_STEPS[key] = (p, oracle_jit(jq.stream_fn(p)))
    p, step = _JAX_STEPS[key]
    st = jq.init_stream_state(p, key_dtype) if state is None else state
    out = []
    for (g, k), nv in zip(batches, n_valids or [None] * len(batches)):
        (og, ov, valid, num, rr), st = step(jnp.array(g), jnp.array(k), st,
                                            nv)
        out.append({"groups": np.asarray(og), "values": _np_tree(ov),
                    "valid": np.asarray(valid), "num": np.asarray(num),
                    "rr": np.asarray(rr), "state": _jax_state_np(st)})
    return out, st


def _same_state(want, got, names, what, float_keys):
    if isinstance(want, dict):  # a pane store: copies of keys, exact
        assert set(want) == set(got)
        for f in want:
            assert_same(want[f], got[f], name=f"{what} store {f}")
        return
    assert len(want) == len(got) == len(names)
    for nm, w, g in zip(names, want, got):
        for f in ("group", "nonempty", "emitted"):
            assert_same(w[f], g[f], name=f"{what} carry {nm} {f}")
        ws = w["state"] if isinstance(w["state"], tuple) else (w["state"],)
        gs = g["state"] if isinstance(g["state"], tuple) else (g["state"],)
        assert len(ws) == len(gs), (what, nm)
        for a, b in zip(ws, gs):
            assert_same(a, b, name=nm, float_keys=float_keys)


#: a push's output fields: the JAX side's name, the port side's
STEP_FIELDS = (("groups", "groups"), ("valid", "valid"), ("num", "num"),
               ("rr", "rr"))
AGG_FIELDS = (("groups", "groups"), ("valid", "valid"),
              ("num", "num_groups"), ("rr", "rr_port"))


def _same_pushes(want, got, names, what, float_keys=False,
                 fields=STEP_FIELDS):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        tag = f"{what} push {i}"
        for f, gf in fields:
            assert_same(w[f], g[gf], name=f"{tag} {f}")
        for nm in names:
            assert_same(w["values"][nm], g["values"][nm], name=nm,
                        float_keys=float_keys)
        _same_state(w["state"], g["state"], names, tag, float_keys)


def _batches(g, k, sizes):
    edges = np.cumsum([0] + list(sizes))
    return [(g[a:b], k[a:b]) for a, b in zip(edges[:-1], edges[1:])]


@pytest.mark.parametrize("batch", [4, 16, 64])
@pytest.mark.parametrize("op", ["sum", "min", "max", "count", "mean"])
def test_stream_push_matches_jax(port, op, batch, rng):
    g = np.sort(rng.integers(0, 13, 128)).astype(np.int32)
    k = rng.integers(0, 50, 128).astype(np.int32)
    batches = _batches(g, k, [batch] * (128 // batch))
    want, _ = _jax_stream((op,), batches)
    for backend in ("reference", "cuda"):
        got = port.stream_steps((op,), batches, backend=backend)
        _same_pushes(want, got, (op,), backend)


def _jax_aggregator(op, batches, *, window=None, n_valids=None,
                    key_dtype=jnp.int32):
    agg = JaxAggregator(op, key_dtype=key_dtype,
                        window=None if window is None
                        else jq.Window(**window))
    out = []
    for (g, k), nv in zip(batches, n_valids or [None] * len(batches)):
        r = agg.push(jnp.array(g), jnp.array(k),
                     None if nv is None else jnp.asarray(nv))
        out.append({"groups": np.asarray(r.groups),
                    "values": {agg.combiner.name: np.asarray(r.values)},
                    "valid": np.asarray(r.valid),
                    "num": np.asarray(r.num_groups),
                    "rr": np.asarray(r.rr_port),
                    "state": _jax_state_np(agg.carry)})
    if window is None:
        r = agg.flush()
        return out, {"groups": np.asarray(r.groups),
                     "values": np.asarray(r.values),
                     "valid": np.asarray(r.valid),
                     "num": np.asarray(r.num_groups),
                     "rr": np.asarray(r.rr_port)}
    # a windowed flush is the replay of the store the pushes left
    # (repro.core.streaming.StreamingAggregator.flush), jitted: eager, its
    # every primitive compiles on its own
    from repro.core import panestore as jps

    spec = jq.Window(**window).store_spec()
    g, values, valid, num = oracle_jit(lambda st: jps.replay(
        spec, st, (agg.combiner,)))(agg.carry)
    rr = np.where(valid, np.arange(spec.capacity) % 4, -1).astype(np.int32)
    return out, {"groups": np.asarray(g),
                 "values": np.asarray(values[agg.combiner.name]),
                 "valid": np.asarray(valid), "num": np.asarray(num),
                 "rr": rr}


def _same_aggregator(want, got, name, what, backends=("reference", "cuda"),
                     **kw):
    (wpush, wflush), results = want, {}
    for backend in backends:
        pushes, flush = got(backend)
        for p in pushes:
            p["values"] = {name: p["values"]}
        _same_pushes(wpush, pushes, (name,), f"{what} {backend}",
                     fields=AGG_FIELDS, **kw)
        for f, gf in AGG_FIELDS + (("values", "values"),):
            assert_same(wflush[f], flush[gf], name=f"{what} {backend} "
                        f"flush {f}")
        results[backend] = flush
    return results


def test_group_spanning_many_batches(port):
    # one group crossing 8 batch boundaries accumulates exactly once
    g = np.zeros(64, np.int32)
    k = np.ones(64, np.int32)
    batches = _batches(g, k, [8] * 8)
    flush = _same_aggregator(
        _jax_aggregator("count", batches),
        lambda b: port.aggregator_stream("count", batches, backend=b),
        "count", "spanning")
    assert int(flush["cuda"]["values"][0]) == 64


def test_alternating_singletons(port, rng):
    g = np.arange(32, dtype=np.int32)
    k = rng.integers(0, 9, 32).astype(np.int32)
    batches = _batches(g, k, [4] * 8)
    _same_aggregator(
        _jax_aggregator("sum", batches),
        lambda b: port.aggregator_stream("sum", batches, backend=b),
        "sum", "singletons")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_run_lengths_with_n_valid(port, seed):
    # arbitrary group run lengths, the last batch padded and masked
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 7, rng.integers(3, 13))
    batch = int(rng.choice([4, 8]))
    op = ("sum", "count", "max")[seed]
    g = np.concatenate([np.full(n, i, np.int32)
                        for i, n in enumerate(lengths)])
    k = rng.integers(0, 20, len(g)).astype(np.int32)
    n_last = len(g) % batch or batch
    pad = batch - n_last
    g = np.pad(g, (0, pad))
    k = np.pad(k, (0, pad))
    batches = _batches(g, k, [batch] * (len(g) // batch))
    n_valids = [None] * (len(batches) - 1) + [n_last]
    _same_aggregator(
        _jax_aggregator(op, batches, n_valids=n_valids),
        lambda b: port.aggregator_stream(op, batches, backend=b,
                                         n_valids=n_valids),
        op, f"runs {seed}")


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_multi_op_with_dc_matches_jax(port, dtype):
    # keys sorted within groups, with repeats (distinct count's contract);
    # float keys are whole and fractional numbers
    rng = np.random.default_rng(7)
    g = rng.integers(0, 9, 200).astype(np.int32)
    k = (rng.integers(0, 8, 200) * (1.25 if dtype == np.float32 else 1)
         ).astype(dtype)
    order = np.lexsort((k, g))
    g, k = g[order], k[order]
    batches = _batches(g, k, [25] * 8)
    want, _ = _jax_stream(MULTI, batches, key_dtype=jnp.dtype(dtype))
    for backend in ("reference", "cuda"):
        got = port.stream_steps(MULTI, batches, backend=backend)
        _same_pushes(want, got, MULTI, backend,
                     float_keys=dtype == np.float32)


def test_int32_sums_wrap_across_pushes(port):
    # one group over 8 pushes of keys near 2^30: its int32 sum wraps in
    # the scan and again in the carry merge, as JAX's does
    g = np.zeros(64, np.int32)
    k = (2**30 + np.arange(64)).astype(np.int32)
    batches = _batches(g, k, [8] * 8)
    want, _ = _jax_stream(("sum", "mean"), batches)
    # it wrapped
    assert int(want[-1]["state"][0]["state"]) != int(k.sum(dtype=np.int64))
    for backend in ("reference", "cuda"):
        got = port.stream_steps(("sum", "mean"), batches, backend=backend)
        _same_pushes(want, got, ("sum", "mean"), backend)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("window", [PER_GROUP, PLAIN],
                         ids=["ws_per_group", "plain"])
def test_windowed_stream_matches_jax(port, window, dtype):
    # pushes of 7 and 13 tuples at WA = 4 leave ragged chunks; 6 groups
    # in 6 slots evict
    g, k = make_stream(31, sum(RAGGED), 6, 60, dtype=dtype)
    batches = _batches(g, k, RAGGED)
    want, _ = _jax_stream(ALL_DIRECT, batches, window=window,
                          key_dtype=jnp.dtype(dtype))
    for backend in ("reference", "cuda-panestore"):
        got = port.stream_steps(ALL_DIRECT, batches, backend=backend,
                                window=window)
        _same_pushes(want, got, ALL_DIRECT, backend,
                     float_keys=dtype == np.float32)
    assert port.stream_evictions(window, batches) > 0


@pytest.mark.parametrize("window", [PER_GROUP, PLAIN],
                         ids=["ws_per_group", "plain"])
def test_windowed_aggregator_flush_matches_jax(port, window):
    g, k = make_stream(32, sum(RAGGED), 6, 60)
    batches = _batches(g, k, RAGGED)
    _same_aggregator(
        _jax_aggregator("distinct_count", batches, window=window),
        lambda b: port.aggregator_stream("distinct_count", batches,
                                         backend=b, window=window),
        "distinct_count", "windowed", backends=("reference",
                                                "cuda-panestore"))


def test_multi_op_windowed_aggregator_matches_jax(port):
    # the aggregator over a tuple of ops (median included) against the JAX
    # stream step, and its flush against the JAX replay of the last store
    from repro.core import panestore as jps

    g, k = make_stream(35, sum(RAGGED), 6, 60)
    batches = _batches(g, k, RAGGED)
    want, jstate = _jax_stream(ALL_DIRECT, batches, window=PER_GROUP)
    spec = jq.Window(**PER_GROUP).store_spec()
    fg, fv, fvalid, fnum = oracle_jit(
        lambda st: jps.replay(spec, st, ALL_DIRECT))(jstate)
    frr = np.where(fvalid, np.arange(spec.capacity) % 4, -1)
    for backend in ("reference", "cuda-panestore"):
        pushes, flush = port.aggregator_stream(ALL_DIRECT, batches,
                                               backend=backend,
                                               window=PER_GROUP)
        _same_pushes(want, pushes, ALL_DIRECT, backend, fields=AGG_FIELDS)
        for w, f in ((fg, "groups"), (fvalid, "valid"), (fnum, "num_groups"),
                     (frr.astype(np.int32), "rr_port")):
            assert_same(w, flush[f], name=f"{backend} flush {f}")
        for nm in ALL_DIRECT:
            assert_same(fv[nm], flush["values"][nm], name=nm)


@pytest.mark.parametrize("kind", ["carries", "store"])
def test_execute_state_twice_gives_the_same(port, kind):
    # a state passed to execute is left as it was: the same call twice on
    # it gives the same result and the same next state
    window, backend = ((None, "cuda") if kind == "carries"
                       else (PER_GROUP, "cuda-panestore"))
    g, k = make_stream(33, 60, 6, 60, sorted_by="group_key")
    first = port.stream_steps(MULTI, [(g[:27], k[:27])], backend=backend,
                              window=window)
    r1, r2, s1, s2, before, after = port.execute_twice(
        MULTI, g[27:], k[27:], backend=backend, window=window,
        state=first[0]["state"])
    (g1, v1, valid1, n1), (g2, v2, valid2, n2) = r1, r2
    for a, b in ((g1, g2), (valid1, valid2), (n1, n2),
                 *((v1[nm], v2[nm]) for nm in MULTI)):
        np.testing.assert_array_equal(a, b)
    _same_state(s1, s2, MULTI, "next", False)
    _same_state(before, after, MULTI, "given", False)
    _same_state(first[0]["state"], before, MULTI, "carried in", False)


@pytest.mark.parametrize("kind", ["carries", "store"])
def test_jax_stream_continues_in_the_port(port, kind):
    # a stream begun in JAX (its state carried across as numpy) continues
    # in the port as it continues in JAX
    window, backends = ((None, ("reference", "cuda")) if kind == "carries"
                        else (PER_GROUP, ("reference", "cuda-panestore")))
    g, k = make_stream(34, sum(RAGGED), 6, 60, sorted_by="group_key")
    batches = _batches(g, k, RAGGED)
    _, jstate = _jax_stream(MULTI, batches[:4], window=window)
    want, _ = _jax_stream(MULTI, batches[4:], window=window, state=jstate)
    for backend in backends:
        got = port.stream_steps(MULTI, batches[4:], backend=backend,
                                window=window, state=_jax_state_np(jstate))
        _same_pushes(want, got, MULTI, f"continued {backend}")


@pytest.mark.parametrize("emitted_before", [0, 3, 2**31 - 2])
def test_rr_ports_match_jax(port, emitted_before):
    from repro.core import engine as je

    g = np.arange(10, dtype=np.int32)
    valid = np.arange(10) < 7
    want = je.rr_ports(je.GroupAggResult(jnp.array(g), jnp.array(g),
                                         jnp.array(valid), jnp.int32(7)),
                       jnp.int32(emitted_before), 4)
    assert_same(want, port.rr_ports(g, valid, emitted_before, 4),
                name="rr_port")


def test_streaming_median_without_a_window_is_refused(port):
    # no carry merges a median across batches: both packages raise (the
    # JAX package on the missing carry, the port in its planner)
    g = np.zeros(8, np.int32)
    with pytest.raises(Exception):
        jq.execute(jq.Query(ops="median", streaming=True), jnp.array(g),
                   jnp.array(g), backend="reference")
    with pytest.raises(ValueError, match="no mergeable carry"):
        port.plan_backend("median", query={"streaming": True})


@pytest.mark.parametrize("what,slice_no", [
    # sharded rolling streams are ported (slice 7a): the sharded aggregator
    # and the table push return the one-device emissions
    ("shards", "7"), ("mesh", "7"), ("table", "7"), ("stats", "6"),
    # event-time streaming is ported (slice 5b): timestamps without a time
    # window are the JAX package's ValueError
    pytest.param("timestamps", None, id="timestamps-5b"),
    pytest.param("time window stats", "6", id="time window-5b"),
    # a sharded event-time stream is ported (slice 7b)
    pytest.param("time window shards", "7b", id="time window shards-7b")])
def test_later_slices_raise_naming_theirs(port, what, slice_no):
    if slice_no is None:
        with pytest.raises(ValueError, match="timestamps apply to "
                           "event-time windows"):
            port.aggregator_later_slice(what)
        return
    if slice_no == "7":
        # groups 0..3, two tuples each, keys = groups: the push emits the
        # groups it proves closed, 0, 2, 4 (the last stays open)
        got = port.aggregator_later_slice(what)
        if what == "table":
            groups, values, num = got
            assert int(num) == 3
            np.testing.assert_array_equal(groups[:3], [0, 1, 2])
            np.testing.assert_array_equal(values[:3], [0, 2, 4])
        else:
            np.testing.assert_array_equal(got[:4], [0, 2, 4, 0])
        return
    if slice_no == "6":
        # observability is ported (slice 6): the aggregator collects stats,
        # a time window's the JAX package's keys (tests/test_torch_obs.py
        # holds the values to it)
        want = True if what == "stats" else [
            "late_dropped", "pane_evictions", "pane_occupancy_hwm",
            "reorder_depth_hwm", "reorder_forced_pops",
            "store_donated_buffers", "watermark"]
        assert port.aggregator_later_slice(what) == want
        return
    # slice 7b: the sharded event-time aggregator plans and stacks a
    # reorder buffer a shard
    assert port.aggregator_later_slice(what) == ("reference", [2, 64])
