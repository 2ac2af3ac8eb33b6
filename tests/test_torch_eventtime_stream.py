"""Event-time streaming of the port (slice 5b) against the JAX package on
the CPU: the watermark tracker, the bounded-lateness reorder buffer, the
time-mode pane store (placement by time pane, watermark retirement,
evaluation at a time) and whole ``Query(streaming=True)`` streams with a
``Window(range=...)`` through ``stream_fn``, ``execute(state=)`` and
``StreamingAggregator``, push by push.

The port's ``reference`` and ``cuda-panestore`` (on CPU tensors its
wrappers run the kernels' plain versions: the reorder loop, the time-mode
placement loop, the gather and plain replay) are each held against the
JAX ``reference``: every push's outputs (groups, values, valid, num,
rr_port) and the carried (reorder buffer, pane store) pair, padded tails
and the buffer's unreleased slots included.  Emissions are compared whole:
the plain cycle reads the same slot as JAX's on a lane it does not
release.  Mirrors ``tests/test_eventtime.py``'s streaming tests (the
watermark oracle, shuffled ingest, the flush, the late-drop count).

Tolerance: element-exact, except float ``sum``/``mean`` values, which the
port reduces in another order: rtol = atol = 1e-5 (``_torch_parity``).
The JAX steps are jitted, one program per batch shape; the port runs in
its own process (``_torch_parity.port``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_same, port  # noqa: F401 (fixture)
from _torch_parity import oracle_jit
from repro import query as jq
from repro.core import eventtime as jet
from repro.core import panestore as jps
from repro.core.streaming import StreamingAggregator as JaxAggregator

ALL_DIRECT = ("sum", "count", "min", "max", "mean", "median",
              "distinct_count")
#: a window whose store chains (wa 4, dense panes) and evicts (8 slots for
#: six groups over about four live time panes)
WINDOW = dict(range=48, slide=16, max_lateness=12, reorder_capacity=16,
              wa=4, capacity=8)
OPS = ("min", "max", "sum", "count")
#: the JAX package's streaming test window (tests/test_eventtime.py)
ORACLE_WINDOW = dict(range=48, slide=16, max_lateness=24,
                     reorder_capacity=64)
L = 24


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_np(v) for v in x)
    return np.asarray(x)


def _time_stream(seed, n, n_groups=6, jitter=(-10, 14), late=(),
                 dtype=np.int32, offset=0):
    """``n`` tuples, tuple i stamped about i plus jitter; ``late`` lists
    lanes pushed far behind."""
    rng = np.random.default_rng(seed)
    ts = (np.arange(n) + offset + rng.integers(*jitter, n)).astype(np.int32)
    for i in late:
        ts[i] = np.int32(offset - 200)
    g = rng.integers(0, n_groups, n).astype(np.int32)
    if np.issubdtype(dtype, np.integer):
        k = rng.integers(-20, 50, n).astype(dtype)
    else:
        k = (rng.integers(-8, 8, n) * 0.5).astype(dtype)
        k[::7] = -0.0
    return g, k, ts


def _batches(g, k, ts, size):
    return [(g[i:i + size], k[i:i + size], ts[i:i + size])
            for i in range(0, len(g), size)]


def _same_tree(want, got, what, float_keys=False):
    """Two numpy trees (JAX's, the port's) with the same arrays."""
    if isinstance(want, dict):
        assert set(want) == set(got), what
        for f in want:
            _same_tree(want[f], got[f], f"{what} {f}", float_keys)
    elif isinstance(want, (tuple, list)):
        assert len(want) == len(got), what
        for i, (a, b) in enumerate(zip(want, got)):
            _same_tree(a, b, f"{what}[{i}]", float_keys)
    else:
        name = what.split()[-1]
        assert_same(want, got, name=name if float_keys else what,
                    float_keys=float_keys)


def _pair_np(state):
    rstate, pstate = state
    return ({f: np.asarray(v) for f, v in zip(rstate._fields, rstate)},
            {f: np.asarray(v) for f, v in zip(pstate._fields, pstate)})


# --------------------------------------------------------------- tracker

def test_watermark_tracker_matches_jax(port):
    batches = [(np.array([5, -3, 9], np.int32), None),
               (np.array([40, 2], np.int32), np.array([False, True])),
               (np.array([11, 12, 13], np.int32), None)]
    tr = jet.init_tracker()
    seen = []
    for ts, live in batches:
        tr = jet.observe(tr, jnp.array(ts),
                         None if live is None else jnp.array(live))
        seen.append(int(tr.max_ts))
    shard_wms = [17, -4, 30]
    want = (seen, int(jet.watermark(tr, 6)),
            int(jet.merge_watermarks(shard_wms)),
            int(jet.merge_watermarks(jnp.array(shard_wms, jnp.int32))))
    assert port.watermarks(batches, 6, shard_wms) == want


# ---------------------------------------------------------- reorder buffer

def _jax_reorder(capacity, lateness, pushes, key_dtype=jnp.int32):
    spec = jet.ReorderSpec(capacity, lateness)
    st = jet.init_reorder(spec, key_dtype)
    push = oracle_jit(lambda st, ts, g, k, nv, dw: jet.reorder_push(
        spec, st, ts, g, k, n_valid=nv, drain_wm=dw))
    push_local = oracle_jit(lambda st, ts, g, k, nv: jet.reorder_push(
        spec, st, ts, g, k, n_valid=nv))
    out = []
    for ts, g, k, nv, dw in pushes:
        args = (st, jnp.array(ts), jnp.array(g), jnp.array(k),
                jnp.asarray(len(ts) if nv is None else nv))
        emit, st = (push_local(*args) if dw is None
                    else push(*args, jnp.asarray(dw, jnp.int32)))
        out.append((_np(tuple(emit)), _np(st._asdict())))
    emit, st = oracle_jit(lambda st: jet.reorder_flush(spec, st))(st)
    out.append((_np(tuple(emit)), _np(st._asdict())))
    return out


#: (capacity, lateness, float keys, pushes of (n, late lanes, n_valid,
#: drain_wm offset from the push's largest timestamp))
REORDER_CASES = {
    "late_stragglers": (16, 8, False, [(24, (), None, None),
                                       (24, (3, 17), None, None),
                                       (24, (0,), None, None)]),
    "forced_pops": (8, 30, False, [(24, (), None, None)] * 3),
    "n_valid_tail": (16, 12, False, [(24, (), 19, None),
                                     (24, (5,), 0, None),
                                     (24, (), 24, None)]),
    "drain_wm": (16, 12, False, [(24, (), None, -30), (24, (), None, 5),
                                 (24, (), None, None)]),
    "float_keys": (8, 10, True, [(24, (9,), None, None),
                                 (24, (), 20, None)]),
}


@pytest.mark.parametrize("case", sorted(REORDER_CASES))
def test_reorder_push_matches_jax(port, case):
    capacity, lateness, float_keys, spec = REORDER_CASES[case]
    pushes = []
    for i, (n, late, nv, dw) in enumerate(spec):
        g, k, ts = _time_stream(40 + i, n, late=late, offset=30 * i,
                                jitter=(-14, 14),
                                dtype=np.float32 if float_keys else np.int32)
        if float_keys:
            k[4] = np.nan
        pushes.append((ts, g, k, nv,
                       None if dw is None else int(ts.max()) + dw))
    want = _jax_reorder(capacity, lateness, pushes,
                        jnp.float32 if float_keys else jnp.int32)
    got = port.reorder_pushes(capacity, lateness, pushes,
                              float_keys=float_keys)
    for i, ((we, ws), (ge, gs)) in enumerate(zip(want, got)):
        for f, a, b in zip(jet.ReorderEmit._fields, we, ge):
            _same_tree(a, b, f"{case} push {i} emit {f}")
        _same_tree(ws, gs, f"{case} push {i} buffer")
    dropped = int(want[-1][1]["dropped"])
    assert dropped > 0 if case in ("late_stragglers", "float_keys") \
        else True, "the case has no late tuple"
    if case == "forced_pops":  # more in flight than the buffer holds
        live = [int(e[3][:len(p[0])].sum()) for (e, _), p
                in zip(want, pushes)]
        assert live[0] > 0


# --------------------------------------------------------- time-mode store

TIME_SPEC = dict(wa=4, capacity=8, default_ws=1, slide=10, time_range=30)


def _jax_push_time(spec_kw, pushes, key_dtype=jnp.int32):
    spec = jps.PaneStoreSpec(**spec_kw)
    st = jps.init_store(spec, key_dtype)
    step = oracle_jit(lambda st, g, k, ts, lv, rb: jps.push_time(
        spec, st, g, k, ts, live=lv, retire_below=rb))
    out = []
    for g, k, ts, live, rb in pushes:
        st = step(st, jnp.array(g), jnp.array(k), jnp.array(ts),
                  jnp.array(live),
                  jnp.asarray(jps.TS_FLOOR if rb is None else rb,
                              jnp.int32))
        out.append(_np(st._asdict()))
    return out, st


def _placement_pushes(case):
    """Pushes of (groups, keys, ts, live, retire_below) for a case."""
    rng = np.random.default_rng(sorted(PLACEMENT_CASES).index(case))
    if case == "cycle0_eviction":
        # four slots fill: group 0's pane at pid 10 (the oldest stamp,
        # alive), three panes at pid 0; then a push with the horizon past
        # pid 0: its first tuple evicts slot 0 (no slot is free yet), and
        # only then do the three dead panes retire
        return [(np.arange(4, dtype=np.int32),
                 np.array([7, 8, 9, 10], np.int32),
                 np.array([100, 5, 6, 7], np.int32), np.ones(4, bool),
                 None),
                (np.array([4, 5], np.int32), np.array([1, 2], np.int32),
                 np.array([200, 201], np.int32), np.ones(2, bool), 50)]
    pushes = []
    n, groups, base = 40, 3, 0
    if case == "evictions":
        groups = 8
    if case == "negative":
        base = -137
    for i in range(4):
        ts = np.sort(rng.integers(base + 25 * i, base + 25 * i + 40, n)
                     ).astype(np.int32)
        g = rng.integers(0, groups, n).astype(np.int32)
        k = rng.integers(0, 9, n).astype(np.int32)
        live = (rng.random(n) < 0.7 if case == "dead_lanes"
                else np.ones(n, bool))
        if case == "dead_lanes":
            ts[~live] = rng.integers(-10**6, 10**6, (~live).sum())
        rb = base + 25 * i - 10
        pushes.append((g, k, ts, live, rb))
    return pushes


#: chaining beyond wa (three groups, about 5 tuples a pane of 10 time
#: units), evictions (8 groups), one eviction beside dead slots, negative
#: timestamps, dead lanes
PLACEMENT_CASES = ("chaining", "evictions", "cycle0_eviction", "negative",
                   "dead_lanes")


@pytest.mark.parametrize("case", PLACEMENT_CASES)
def test_push_time_matches_jax(port, case):
    pushes = _placement_pushes(case)
    spec = dict(TIME_SPEC, capacity={"cycle0_eviction": 4,
                                     "evictions": 8}.get(case, 16))
    want, _ = _jax_push_time(spec, pushes)
    got = port.push_time_steps(spec, pushes)
    for i, (w, (g, events)) in enumerate(zip(want, got)):
        _same_tree(w, g, f"{case} push {i}")
    evictions, retirements = np.sum([e for _, e in got], axis=0)
    if case == "cycle0_eviction":
        # the evicted pane is group 0's; the dead ones retired after it
        assert want[-1]["owner"].tolist()[0] == 4
        assert (evictions, retirements) == (1, 3)
    if case in ("chaining", "negative"):
        assert retirements > 0
    if case == "evictions":
        assert evictions > 0
    if case == "chaining":  # a (group, pane) holds more than wa tuples
        o, b = want[-1]["owner"], want[-1]["base"]
        pairs = [(x, y) for x, y in zip(o, b) if x != 2**31 - 1]
        assert len(pairs) > len(set(pairs))


def test_push_time_float_keys_match_jax(port):
    # closing panes sort stably: -0.0 beside 0.0 in arrival order, NaN last
    rng = np.random.default_rng(5)
    pushes = []
    for i in range(3):
        n = 40
        ts = np.sort(rng.integers(20 * i, 20 * i + 30, n)).astype(np.int32)
        g = rng.integers(0, 2, n).astype(np.int32)
        k = rng.choice(np.array([-1.0, -0.0, 0.0, 0.5, np.nan], np.float32),
                       n)
        pushes.append((g, k, ts, np.ones(n, bool), 20 * i - 30))
    want, _ = _jax_push_time(TIME_SPEC, pushes, jnp.float32)
    got = port.push_time_steps(TIME_SPEC, pushes, float_keys=True)
    for i, (w, (g, _)) in enumerate(zip(want, got)):
        for f in w:  # bit for bit: signed zeros and NaN payloads
            a, b = w[f], g[f]
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            assert_same(a, b, name=f"push {i} {f}")


@pytest.mark.parametrize("float_keys", [False, True], ids=["int", "float"])
def test_time_gather_and_replay_match_jax(port, float_keys):
    # the store of the chaining case, evaluated at three times: one whose
    # window misses group 2's tuples altogether, so its row is dropped
    pushes = _placement_pushes("chaining")
    if float_keys:
        pushes = [(g, (k * 0.75).astype(np.float32), ts, lv, rb)
                  for g, k, ts, lv, rb in pushes]
    dt = jnp.float32 if float_keys else jnp.int32
    _, jstate = _jax_push_time(TIME_SPEC, pushes, dt)
    spec = jps.PaneStoreSpec(**TIME_SPEC)
    state_np = _np(jstate._asdict())
    owners = set(state_np["owner"].tolist()) - {2**31 - 1}
    # the evaluation time an argument: one compile for the three times
    gather = oracle_jit(lambda st, et: jps.gather_runs(spec, st, eval_time=et))
    replay = oracle_jit(lambda st, et: jps.replay(spec, st, ALL_DIRECT,
                                                  eval_time=et))
    for et in (int(pushes[-1][2].max()) + 1, int(pushes[-1][2].max()) - 17,
               int(pushes[-1][2].min()) - 25):
        runs = gather(jstate, jnp.int32(et))
        rep = replay(jstate, jnp.int32(et))
        got_runs, got_rep, ring = port.time_replay(TIME_SPEC, state_np,
                                                   ALL_DIRECT, et)
        _same_tree(_np(tuple(runs)), got_runs, f"et {et} runs")
        _same_tree(_np(tuple(rep)), got_rep, f"et {et} replay",
                   float_keys=float_keys)
        # the ring replay's plain version: the replay's rows
        rg, rv, _, rn = got_rep
        _same_tree((rv, rg, rn), (ring[0] and {k: v[0] for k, v in
                                              ring[0].items()},
                                  ring[1][0], ring[2][0]),
                   f"et {et} ring", float_keys=float_keys)
        if et == int(pushes[-1][2].min()) - 25:
            assert int(rep[3]) < len(owners)  # a group's row dropped


# ------------------------------------------------------------ whole streams

_JAX_STEPS = {}


def _jax_time_stream(ops, window, batches, key_dtype=jnp.int32,
                     n_valids=None, state=None):
    key = (ops, tuple(sorted(window.items())), jnp.dtype(key_dtype).name)
    if key not in _JAX_STEPS:
        p = jq.plan(jq.Query(ops=ops, window=jq.Window(**window),
                             streaming=True), backend="reference")
        _JAX_STEPS[key] = (p, oracle_jit(jq.stream_fn(p)))
    p, step = _JAX_STEPS[key]
    st = jq.init_stream_state(p, key_dtype) if state is None else state
    out = []
    for (g, k, ts), nv in zip(batches, n_valids or [None] * len(batches)):
        (og, ov, valid, num, rr), st = step(
            jnp.array(g), jnp.array(k), st,
            None if nv is None else jnp.asarray(nv), jnp.array(ts))
        out.append({"groups": np.asarray(og), "values": _np(ov),
                    "valid": np.asarray(valid), "num": np.asarray(num),
                    "rr": np.asarray(rr), "state": _pair_np(st)})
    return out, st


def _same_pushes(want, got, ops, what, float_keys=False,
                 fields=(("groups", "groups"), ("valid", "valid"),
                         ("num", "num"), ("rr", "rr"))):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        tag = f"{what} push {i}"
        for f, gf in fields:
            assert_same(w[f], g[gf], name=f"{tag} {f}")
        for nm in ops:
            assert_same(w["values"][nm], g["values"][nm], name=nm,
                        float_keys=float_keys)
        _same_tree(w["state"], g["state"], f"{tag} state")


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_time_stream_matches_jax(port, dtype):
    # pushes of 32 tuples with late stragglers, an n_valid push, a store
    # that chains, evicts and retires
    g, k, ts = _time_stream(11, 192, late=(40, 41, 130), dtype=dtype)
    batches = _batches(g, k, ts, 32)
    n_valids = [None, None, 27, None, None, None]
    want, _ = _jax_time_stream(ALL_DIRECT, WINDOW, batches,
                               jnp.dtype(dtype), n_valids)
    for backend in ("reference", "cuda-panestore"):
        got = port.stream_steps(ALL_DIRECT, batches, backend=backend,
                                window=WINDOW, n_valids=n_valids)
        _same_pushes(want, got, ALL_DIRECT, backend,
                     float_keys=dtype == np.float32)
    assert int(want[-1]["state"][0]["dropped"]) >= 3


def _jax_aggregator(op, window, batches):
    agg = JaxAggregator(op, window=jq.Window(**window))
    out = []
    for g, k, ts in batches:
        r = agg.push(jnp.array(g), jnp.array(k), timestamps=jnp.array(ts))
        out.append({"groups": np.asarray(r.groups),
                    "values": {agg.combiner.name: np.asarray(r.values)},
                    "valid": np.asarray(r.valid),
                    "num": np.asarray(r.num_groups),
                    "rr": np.asarray(r.rr_port),
                    "late": int(r.stats["late_dropped"]),
                    "state": _pair_np(agg.carry)})
    # the flush (repro.core.streaming.StreamingAggregator.flush): drain the
    # reorder buffer, place what it releases, replay past the last tuple;
    # jitted (eager, its every primitive compiles on its own)
    w = jq.Window(**window)
    spec, rspec = w.store_spec(), w.reorder_spec()

    def flush(rstate, pstate):
        emit, rstate = jet.reorder_flush(rspec, rstate)
        pstate = jps.push_time(spec, pstate, emit.groups, emit.keys,
                               emit.ts, live=emit.live)
        return jps.replay(spec, pstate, (agg.combiner,),
                          eval_time=rstate.max_ts + 1)

    g, values, valid, num = oracle_jit(flush)(*agg.carry)
    rr = np.where(valid, np.arange(spec.capacity) % 4, -1).astype(np.int32)
    return out, {"groups": np.asarray(g),
                 "values": np.asarray(values[agg.combiner.name]),
                 "valid": np.asarray(valid), "num": np.asarray(num),
                 "rr": rr, "late": int(agg.carry[0].dropped)}


@pytest.mark.parametrize("backend", ["reference", "cuda-panestore"])
def test_time_aggregator_push_flush_matches_jax(port, backend):
    g, k, ts = _time_stream(12, 128, late=(33, 90))
    batches = _batches(g, k, ts, 32)
    want, wflush = _jax_aggregator("distinct_count", WINDOW, batches)
    pushes, flush = port.aggregator_stream("distinct_count", batches,
                                           backend=backend, window=WINDOW)
    fields = (("groups", "groups"), ("valid", "valid"),
              ("num", "num_groups"), ("rr", "rr_port"))
    for p in pushes:
        p["values"] = {"distinct_count": p["values"]}
    _same_pushes(want, pushes, ("distinct_count",), backend,
                 fields=fields)
    for w, p in zip(want, pushes):
        assert w["late"] == int(p["stats"]["late_dropped"])
    for f, gf in fields + (("values", "values"),):
        assert_same(wflush[f], flush[gf], name=f"flush {f}")
    assert wflush["late"] == int(flush["stats"]["late_dropped"]) >= 2


def test_time_execute_state_twice_and_jax_state(port):
    # a stream begun in JAX crosses as numpy; execute(state=) twice on it
    # gives the same, leaves it alone, and equals the JAX push
    g, k, ts = _time_stream(13, 96)
    batches = _batches(g, k, ts, 32)
    _, jstate = _jax_time_stream(ALL_DIRECT, WINDOW, batches[:2])
    want, _ = _jax_time_stream(ALL_DIRECT, WINDOW, batches[2:], state=jstate)
    carried = _pair_np(jstate)
    r1, r2, s1, s2, before, after = port.execute_twice(
        ALL_DIRECT, *batches[2][:2], backend="cuda-panestore",
        window=WINDOW, state=carried, timestamps=batches[2][2])
    for a, b in zip(r1, r2):
        _same_tree(a, b, "twice")
    _same_tree(s1, s2, "next")
    _same_tree(before, after, "given")
    _same_tree(carried, before, "carried in")
    (g1, v1, valid1, n1) = r1
    assert_same(want[0]["groups"], g1, name="groups")
    assert_same(want[0]["valid"], valid1, name="valid")
    for nm in ALL_DIRECT:
        assert_same(want[0]["values"][nm], v1[nm], name=nm)
    _same_tree(want[0]["state"], s1, "state")


def test_event_time_kernel_limits(port):
    # what the kernels cannot hold, cuda-panestore refuses with the reason
    # (the reference still serves it)
    stream = {"streaming": True}
    assert port.backend_reason("cuda-panestore", ("sum",),
                               window=dict(range=64), query=stream) is None
    cases = [(dict(range=64, reorder_capacity=2048), "one warp"),
             (dict(range=64, slide=16, capacity=1024, wa=32),
              "replay kernel"),
             (dict(range=64), None)]
    for window, msg in cases[:2]:
        reason = port.backend_reason("cuda-panestore", ("sum",),
                                     window=window, query=stream)
        assert msg in reason
        assert port.plan_backend(("sum",), window=window,
                                 query=stream) == "reference"
    assert "event-time streams" in port.backend_reason(
        "cuda-panestore", ("sum",), window=dict(range=64))


# ------------------------------------------ the JAX package's oracle tests

def _window_oracle(g, k, t, wm, rng_, ops):
    buckets: dict[int, list[int]] = {}
    for gi, ki, ti in zip(g, k, t):
        if wm - rng_ <= ti < wm:
            buckets.setdefault(int(gi), []).append(int(ki))
    fns = {"min": min, "max": max, "sum": sum, "count": len}
    return {gi: tuple(fns[op](vals) for op in ops)
            for gi, vals in sorted(buckets.items())}


def _eval_dict(push, ops):
    return {int(push["groups"][j]): tuple(int(push["values"][op][j])
                                          for op in ops)
            for j in range(push["groups"].shape[0]) if push["valid"][j]}


def _perturb(rng, ts, lateness):
    return np.argsort(ts + rng.integers(0, max(lateness, 1), ts.shape[0]),
                      kind="stable")


def _sorted_time_stream(rng, n, t_max=400, n_groups=4):
    g = rng.integers(0, n_groups, n).astype(np.int32)
    k = rng.integers(-50, 50, n).astype(np.int32)
    t = np.sort(rng.integers(0, t_max, n)).astype(np.int32)
    return g, k, t


def _port_evals(port, g, k, t, backend, size=32):
    pushes = port.stream_steps(OPS, _batches(g, k, t, size),
                               backend=backend, window=ORACLE_WINDOW)
    return pushes, [_eval_dict(p, OPS) for p in pushes]


@pytest.mark.parametrize("backend", ["reference", "cuda-panestore"])
def test_streaming_evals_match_watermark_oracle(port, backend):
    rng = np.random.default_rng(0)
    n, b = 128, 32
    g, k, t = _sorted_time_stream(rng, n)
    _, evals = _port_evals(port, g, k, t, backend)
    assert "watermark" in port.plan_note(OPS, window=ORACLE_WINDOW,
                                         query={"streaming": True})
    for i, ev in zip(range(0, n, b), evals):
        wm = int(np.max(t[:i + b])) - L
        assert ev == _window_oracle(g[:i + b], k[:i + b], t[:i + b], wm, 48,
                                    OPS)


def test_streaming_shuffled_ingest_bit_identical(port):
    rng = np.random.default_rng(1)
    n, b = 128, 32
    g, k, t = _sorted_time_stream(rng, n)
    pushes, base = _port_evals(port, g, k, t, "cuda-panestore")
    assert int(pushes[-1]["state"][0]["dropped"]) == 0
    gw, kw, tw = np.empty_like(g), np.empty_like(k), np.empty_like(t)
    for i in range(0, n, b):
        pp = _perturb(rng, t[i:i + b], L)
        gw[i:i + b], kw[i:i + b], tw[i:i + b] = (
            g[i:i + b][pp], k[i:i + b][pp], t[i:i + b][pp])
    pushes, shuffled = _port_evals(port, gw, kw, tw, "cuda-panestore")
    assert int(pushes[-1]["state"][0]["dropped"]) == 0
    assert shuffled == base


def test_streaming_global_shuffle_matches_at_watermarks(port):
    rng = np.random.default_rng(2)
    n, b = 128, 32
    g, k, t = _sorted_time_stream(rng, n)
    pert = _perturb(rng, t, L)

    def run(gv, kv, tv):
        _, evals = _port_evals(port, gv, kv, tv, "reference")
        return [(int(np.max(tv[:i + b])) - L, ev)
                for i, ev in zip(range(0, n, b), evals)]

    base, shuf = run(g, k, t), run(g[pert], k[pert], t[pert])
    for wm_o, ev_o in base:
        for wm_s, ev_s in shuf:
            if wm_o == wm_s:
                assert ev_o == ev_s
    assert base[-1] == shuf[-1]


@pytest.mark.parametrize("backend", ["reference", "cuda-panestore"])
def test_streaming_aggregator_flush_and_zero_drops(port, backend):
    # the flush evaluates past the last tuple; in-contract shuffles drop
    # nothing, and a straggler far behind is counted
    rng = np.random.default_rng(3)
    n, b = 96, 32
    g, k, t = _sorted_time_stream(rng, n)
    pert = _perturb(rng, t, L)
    g, k, t = g[pert], k[pert], t[pert]
    stale = np.zeros(b, np.int32)
    batches = _batches(g, k, t, b) + [(stale, stale, stale)]
    pushes, fin = port.aggregator_stream("min", batches, backend=backend,
                                         window=ORACLE_WINDOW)
    assert [int(p["stats"]["late_dropped"]) for p in pushes[:-1]] \
        == [0, 0, 0]
    assert int(pushes[-1]["stats"]["late_dropped"]) >= 1
    end = int(np.max(t)) + 1
    want = {gi: v[0] for gi, v in
            _window_oracle(g, k, t, end, 48, ("min",)).items()}
    got = {int(fin["groups"][j]): int(fin["values"][j])
           for j in range(fin["valid"].shape[0]) if fin["valid"][j]}
    assert got == want


def test_streaming_push_requires_timestamps(port):
    z = np.zeros(8, np.int32)
    with pytest.raises(ValueError, match="timestamps"):
        port.stream_steps(OPS, [(z, z)], backend="reference",
                          window=ORACLE_WINDOW)
    with pytest.raises(ValueError, match="need timestamps="):
        port.aggregator_stream("min", [(z, z)], backend="reference",
                               window=ORACLE_WINDOW)
    with pytest.raises(ValueError, match="pass timestamps="):
        port.execute(("min",), z, z, backend="reference",
                     window=ORACLE_WINDOW, query={"streaming": True})
