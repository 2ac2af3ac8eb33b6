"""Sharded event-time streams of the port (slice 7b) against the JAX package
on the CPU: stacked reorder buffers, released against the min-merged
watermark, their emissions merged by timestamp into one time-mode pane
store, through ``stream_fn``, ``execute(state=, num_shards= | mesh=)`` and
``StreamingAggregator(num_shards=, mesh=)``.

The port's plain sharded reorder (``kernels.eventtime.kernel.
reorder_push_sharded`` on CPU tensors: the plain push looped over the
shards on a host copy) is held to a JAX ``vmap`` of ``reorder_push`` under
external gates, emissions whole; whole streams on ``reference`` and
``cuda-panestore`` (its plain paths) to the JAX ``stream_fn`` on
``reference`` push by push: outputs with ``rr_port``, the stacked carry
(every shard's buffer, unreleased slots included) and the pane store, and
with stats on every counter (``watermark_lag`` included).  Mirrors the
sharded cases of ``tests/test_eventtime.py`` (the min-watermark oracle,
the flush, the late-drop count).

Tolerance: element-exact (int32 keys; the float-key reorder case moves
keys without arithmetic).  Every JAX oracle is jitted once per query
(``_torch_parity.oracle_jit``); the port runs in its own process
(``_torch_parity.port``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_same, oracle_jit
from _torch_parity import port  # noqa: F401 (fixture)
from repro import query as jq
from repro.core import eventtime as jet
from repro.distributed import query_exec as jqx

OPS = ("min", "max", "sum", "count")
#: the JAX package's streaming test window (tests/test_eventtime.py)
ORACLE_WINDOW = dict(range=48, slide=16, max_lateness=24,
                     reorder_capacity=64)
L = 24
#: a window whose store chains (wa 4) and evicts (8 slots), and whose
#: 16-slot buffers force pops once a shard holds back a push
WINDOW = dict(range=48, slide=16, max_lateness=12, reorder_capacity=16,
              wa=4, capacity=8)
STREAM_OPS = ("sum", "count", "min", "max", "median")


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_np(v) for v in x)
    return np.asarray(x)


def _same_tree(want, got, what):
    if isinstance(want, dict):
        assert set(want) == set(got), what
        for f in want:
            _same_tree(want[f], got[f], f"{what} {f}")
    elif isinstance(want, (tuple, list)):
        assert len(want) == len(got), what
        for i, (a, b) in enumerate(zip(want, got)):
            _same_tree(a, b, f"{what}[{i}]")
    else:
        assert_same(want, got, name=what)


def _pair_np(state):
    rstate, pstate = state
    return ({f: np.asarray(v) for f, v in zip(rstate._fields, rstate)},
            {f: np.asarray(v) for f, v in zip(pstate._fields, pstate)})


# ------------------------------------------------ the sharded reorder

_REORDER_JIT: dict = {}


def _jax_sharded_reorder(capacity, lateness, pushes, key_dtype):
    """A JAX ``vmap`` of ``reorder_push`` over stacked buffers, fresh
    counters a shard reduced as the JAX sharded push reduces them (max,
    sum), then the vmapped flush."""
    spec = jet.ReorderSpec(capacity, lateness)
    shards, length = pushes[0][0].shape
    key = (capacity, lateness, shards, length, jnp.dtype(key_dtype).name)
    if key not in _REORDER_JIT:
        def push(st, ts, g, k, nv, rel, late, drain):
            nvs = jnp.clip(nv - jnp.arange(shards) * length, 0, length)
            fresh = {"reorder_depth_hwm": jnp.zeros((), jnp.int32),
                     "reorder_forced_pops": jnp.zeros((), jnp.int32)}

            def one(rst, t, gg, kk, n):
                return jet.reorder_push(spec, rst, t, gg, kk, n_valid=n,
                                        release_wm=rel, late_wm=late,
                                        drain_wm=drain, counters=fresh)

            emit, st, cnt = jax.vmap(one)(st, ts, g, k, nvs)
            return emit, st, {
                "reorder_depth_hwm": jnp.max(cnt["reorder_depth_hwm"]),
                "reorder_forced_pops": jnp.sum(cnt["reorder_forced_pops"])}

        def push_local(st, ts, g, k, nv):
            nvs = jnp.clip(nv - jnp.arange(shards) * length, 0, length)
            emit, st = jax.vmap(lambda rst, t, gg, kk, n: jet.reorder_push(
                spec, rst, t, gg, kk, n_valid=n))(st, ts, g, k, nvs)
            return emit, st

        _REORDER_JIT[key] = (
            oracle_jit(push), oracle_jit(push_local),
            oracle_jit(jax.vmap(lambda st: jet.reorder_flush(spec, st))))
    push, push_local, flush = _REORDER_JIT[key]
    st = jax.tree.map(lambda x: jnp.broadcast_to(x, (shards,) + x.shape),
                      jet.init_reorder(spec, key_dtype))
    out = []
    for ts, g, k, nv, rel, late, drain in pushes:
        nv = jnp.asarray(shards * length if nv is None else nv, jnp.int32)
        args = (st, jnp.array(ts), jnp.array(g), jnp.array(k), nv)
        if rel is None:
            emit, st = push_local(*args)
            cnt = None
        else:
            emit, st, cnt = push(*args, *(jnp.asarray(x, jnp.int32)
                                          for x in (rel, late, drain)))
        out.append((_np(tuple(emit)), _np(st._asdict()),
                    None if cnt is None else _np(cnt)))
    emit, st = flush(st)
    out.append((_np(tuple(emit)), _np(st._asdict()), None))
    return out


#: (capacity, lateness, shards, length, float keys, pushes of (n_valid or
#: None, late lanes, gates: "merged" as the sharded stream sets them, or
#: "local" — every gate the buffer's own watermark))
SHARDED_REORDER_CASES = {
    "merged_gates": (16, 12, 4, 16, False,
                     [(None, (), "merged"), (None, (5, 40), "merged"),
                      (None, (), "merged")]),
    "forced_pops": (8, 30, 2, 24, False,
                    [(None, (), "merged"), (None, (), "merged")]),
    "dead_shard": (16, 12, 3, 16, False,
                   [(27, (3,), "merged"), (None, (), "merged"),
                    (20, (), "merged")]),
    "local_gates": (16, 12, 2, 16, False,
                    [(None, (), "local"), (None, (7,), "local")]),
    "float_keys": (8, 10, 2, 16, True,
                   [(None, (9,), "merged"), (21, (), "merged")]),
}


def _gated_pushes(capacity, lateness, shards, length, float_keys, spec):
    """The case's pushes with their gates, computed as the JAX sharded
    push computes them from the shards' largest timestamps."""
    rng = np.random.default_rng(70 + shards)
    max_ts = np.full(shards, jet.TS_MIN, np.int64)
    pushes = []
    for i, (nv, late, gates) in enumerate(spec):
        n = shards * length
        ts = (np.arange(n) + 30 * i + rng.integers(-14, 14, n)).astype(
            np.int32)
        ts[list(late)] = np.int32(30 * i - 200)
        g = rng.integers(0, 6, n).astype(np.int32)
        if float_keys:
            k = (rng.integers(-8, 8, n) * 0.5).astype(np.float32)
            k[4] = np.nan
            k[::7] = -0.0
        else:
            k = rng.integers(-20, 50, n).astype(np.int32)
        live = np.arange(n) < (n if nv is None else nv)
        prev = int((max_ts - lateness).min())
        top = np.where(live, ts, jet.TS_MIN).reshape(shards, length)
        max_ts = np.maximum(max_ts, top.max(axis=1))
        merged = int((max_ts - lateness).min())
        cut = [x.reshape(shards, length) for x in (ts, g, k)]
        pushes.append((*cut, nv, *((prev, prev, merged) if gates == "merged"
                                   else (None, None, None))))
    return pushes


@pytest.mark.parametrize("case", sorted(SHARDED_REORDER_CASES))
def test_sharded_reorder_matches_jax_vmap(port, case):
    capacity, lateness, shards, length, float_keys, spec = \
        SHARDED_REORDER_CASES[case]
    pushes = _gated_pushes(capacity, lateness, shards, length, float_keys,
                           spec)
    want = _jax_sharded_reorder(capacity, lateness, pushes,
                                jnp.float32 if float_keys else jnp.int32)
    got = port.reorder_sharded(capacity, lateness, pushes,
                               float_keys=float_keys)
    for i, ((we, ws, wc), (ge, gs, gc)) in enumerate(zip(want, got)):
        for f, a, b in zip(jet.ReorderEmit._fields, we, ge):
            if a.dtype == np.float32:  # bit for bit: -0.0 and NaN
                a, b = a.view(np.int32), b.view(np.int32)
            _same_tree(a, b, f"{case} push {i} emit {f}")
        for f in ws:
            a, b = ws[f], gs[f]
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            _same_tree(a, b, f"{case} push {i} buffer {f}")
        if wc is not None:
            _same_tree(wc, gc, f"{case} push {i} counters")
    # the case shows what it is named for
    forced = sum(int(c["reorder_forced_pops"]) for _, _, c in want[:-1]
                 if c is not None)
    dropped = int(want[-2][1]["dropped"].sum())
    if case == "forced_pops":
        assert forced > 0
    if case in ("merged_gates", "float_keys"):
        assert dropped > 0
    if case == "dead_shard":  # shard 2 sees no live tuple in push 0
        assert not want[0][0][3][2].any()
    # the merge of a push's emissions: JAX's lax.sort on (ts, lane)
    emit = want[1][0]
    assert_same(np.stack(_np(jqx.merge_emissions(jet.ReorderEmit(
        *(jnp.asarray(x) for x in emit))))[0]),
        port.merge_emissions(emit)[0], name=f"{case} merged groups")
    for a, b, f in zip(_np(jqx.merge_emissions(jet.ReorderEmit(
            *(jnp.asarray(x) for x in emit)))),
            port.merge_emissions(emit), ("groups", "keys", "ts", "live")):
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        assert_same(a, b, name=f"{case} merged {f}")


# ------------------------------------------------------- whole streams

_STREAM_JIT: dict = {}


def _jax_stream(ops, window, shards, batches, n_valids, state=None,
                collect_stats=False):
    """The JAX ``stream_fn`` on ``reference`` with ``num_shards``, jitted
    once a (query, shards, stats): per push its outputs and the state."""
    key = (ops, tuple(sorted(window.items())), shards, collect_stats)
    if key not in _STREAM_JIT:
        p = jq.plan(jq.Query(ops=ops, window=jq.Window(**window),
                             streaming=True), backend="reference",
                    num_shards=shards)
        _STREAM_JIT[key] = (p, oracle_jit(jq.stream_fn(
            p, collect_stats=collect_stats)))
    p, step = _STREAM_JIT[key]
    st = (jq.init_stream_state(p, jnp.int32, collect_stats=collect_stats)
          if state is None else state)
    out = []
    for (g, k, ts), nv in zip(batches, n_valids):
        (og, ov, valid, num, rr), st = step(
            jnp.array(g), jnp.array(k), st, jnp.asarray(nv, jnp.int32),
            jnp.array(ts))
        inner, stats = st if collect_stats else (st, None)
        out.append({"groups": np.asarray(og), "values": _np(ov),
                    "valid": np.asarray(valid), "num": np.asarray(num),
                    "rr": np.asarray(rr), "state": _pair_np(inner),
                    "stats": None if stats is None else _np(stats)})
    return out, st


def _same_pushes(want, got, ops, what, stats=False):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        tag = f"{what} push {i}"
        for f in ("groups", "valid", "num", "rr"):
            assert_same(w[f], g[f], name=f"{tag} {f}")
        for nm in ops:
            assert_same(w["values"][nm], g["values"][nm], name=f"{tag} {nm}")
        _same_tree(w["state"], g["state"], f"{tag} state")
        if stats:
            _same_tree(w["stats"], g["stats"], f"{tag} stats")


def _stream(seed, n, batch, lateness=12, late=()):
    """``n`` tuples, tuple i stamped about i and shuffled within the
    lateness contract; ``late`` lists lanes moved far behind (beyond the
    contract); pushes of ``batch``."""
    rng = np.random.default_rng(seed)
    ts = np.arange(n) + rng.integers(0, 8, n)
    ts = ts[np.argsort(ts + rng.integers(0, lateness, n), kind="stable")]
    ts = ts.astype(np.int32)
    for i in late:
        ts[i] = np.int32(ts[i] - 150)
    g = rng.integers(0, 6, n).astype(np.int32)
    k = rng.integers(-20, 50, n).astype(np.int32)
    return [(g[i:i + batch], k[i:i + batch], ts[i:i + batch])
            for i in range(0, n, batch)]


#: shards -> (tuples, batch, n_valid of each push)
STREAM_SHAPES = {2: (128, 32, [32, 32, 27, 32]),
                 3: (96, 48, [48, 41]),
                 4: (128, 32, [32, 13, 32, 32])}


@pytest.mark.parametrize("shards", sorted(STREAM_SHAPES))
def test_sharded_time_stream_matches_jax(port, shards):
    n, b, n_valids = STREAM_SHAPES[shards]
    batches = _stream(80 + shards, n, b, late=(b + 3,))
    want, _ = _jax_stream(STREAM_OPS, WINDOW, shards, batches, n_valids)
    for backend in ("reference", "cuda-panestore"):
        got = port.stream_steps(STREAM_OPS, batches, backend=backend,
                                window=WINDOW, n_valids=n_valids,
                                num_shards=shards)
        _same_pushes(want, got, STREAM_OPS, f"{backend} S={shards}")
    assert int(want[-1]["state"][0]["dropped"].sum()) >= 1


def test_sharded_time_stream_stats_match_jax(port):
    # 8-slot buffers and a tight lateness: pops are forced, stragglers
    # dropped, the fast shard ahead of the merged watermark
    window = dict(WINDOW, reorder_capacity=8)
    batches = _stream(90, 128, 32, late=(40, 100))
    n_valids = [32, 32, 30, 32]
    want, _ = _jax_stream(OPS, window, 2, batches, n_valids,
                          collect_stats=True)
    got = port.stream_steps(OPS, batches, backend="cuda-panestore",
                            window=window, n_valids=n_valids, num_shards=2,
                            collect_stats=True)
    _same_pushes(want, got, OPS, "stats", stats=True)
    last = want[-1]["stats"]
    assert int(last["reorder_forced_pops"]) > 0
    assert int(last["late_dropped"]) > 0 and int(last["watermark_lag"]) > 0


def test_jax_sharded_state_continues_in_port(port):
    # a sharded stream begun in JAX crosses as numpy (its stacked buffers
    # included, through interop.carries_from_numpy) and continues
    n, b, n_valids = STREAM_SHAPES[2]
    batches = _stream(82, n, b, late=(b + 3,))
    _, jstate = _jax_stream(STREAM_OPS, WINDOW, 2, batches[:2],
                            n_valids[:2])
    want, _ = _jax_stream(STREAM_OPS, WINDOW, 2, batches[2:], n_valids[2:],
                          state=jstate)
    got = port.stream_steps(STREAM_OPS, batches[2:],
                            backend="cuda-panestore", window=WINDOW,
                            n_valids=n_valids[2:], num_shards=2,
                            state=_pair_np(jstate))
    _same_pushes(want, got, STREAM_OPS, "continued")


def test_sharded_time_stream_on_a_cpu_mesh(port):
    # a mesh of "cpu" entries runs the same push as num_shards (the
    # buffers live on the first entry, as the JAX push ignores the mesh)
    batches = _stream(83, 96, 32)
    by_count = port.stream_steps(OPS, batches, backend="reference",
                                 window=ORACLE_WINDOW, num_shards=4)
    on_mesh = port.stream_steps(OPS, batches, backend="reference",
                                window=ORACLE_WINDOW, num_shards=4,
                                mesh=["cpu"] * 4)
    for i, (a, m) in enumerate(zip(by_count, on_mesh)):
        _same_tree({k: v for k, v in a.items() if k != "stats"},
                   {k: v for k, v in m.items() if k != "stats"},
                   f"mesh push {i}")
    counted = port.time_aggregator("min", batches, window=ORACLE_WINDOW,
                                   num_shards=4)
    meshed = port.time_aggregator("min", batches, window=ORACLE_WINDOW,
                                  mesh=["cpu"] * 4)
    _same_tree(counted, meshed, "aggregator on a mesh")


# ------------------------------ the JAX package's sharded oracle tests

def _window_oracle(g, k, t, wm, rng_, ops):
    buckets: dict[int, list[int]] = {}
    for gi, ki, ti in zip(g, k, t):
        if wm - rng_ <= ti < wm:
            buckets.setdefault(int(gi), []).append(int(ki))
    fns = {"min": min, "max": max, "sum": sum, "count": len}
    return {gi: tuple(fns[op](vals) for op in ops)
            for gi, vals in sorted(buckets.items())}


def _perturb(rng, ts, lateness):
    return np.argsort(ts + rng.integers(0, max(lateness, 1), ts.shape[0]),
                      kind="stable")


def _sorted_time_stream(rng, n, t_max=400, n_groups=4):
    g = rng.integers(0, n_groups, n).astype(np.int32)
    k = rng.integers(-50, 50, n).astype(np.int32)
    t = np.sort(rng.integers(0, t_max, n)).astype(np.int32)
    return g, k, t


def _batches(g, k, t, size):
    return [(g[i:i + size], k[i:i + size], t[i:i + size])
            for i in range(0, len(g), size)]


@pytest.mark.parametrize("backend", ["reference", "cuda-panestore"])
def test_sharded_streaming_min_watermark_oracle(port, backend):
    rng = np.random.default_rng(0)
    n, b = 96, 32
    g, k, t = _sorted_time_stream(rng, n)
    pert = _perturb(rng, t, L)
    g, k, t = g[pert], k[pert], t[pert]
    pushes = port.stream_steps(OPS, _batches(g, k, t, b), backend=backend,
                               window=ORACLE_WINDOW, num_shards=2)
    wm_shard = np.full(2, jet.TS_MIN, np.int64)
    for i, push in zip(range(0, n, b), pushes):
        wm_shard = np.maximum(wm_shard,
                              t[i:i + b].reshape(2, b // 2).max(axis=1))
        gwm = int(wm_shard.min()) - L
        got = {int(push["groups"][j]): tuple(int(push["values"][op][j])
                                             for op in OPS)
               for j in range(push["groups"].shape[0]) if push["valid"][j]}
        assert got == _window_oracle(g[:i + b], k[:i + b], t[:i + b], gwm,
                                     48, OPS)


@pytest.mark.parametrize("backend", ["reference", "cuda-panestore"])
def test_sharded_aggregator_flush_and_zero_drops(port, backend):
    # test_streaming_aggregator_flush[2] and
    # test_stream_stats_zero_drops_for_in_contract_shuffles[2]: the flush
    # evaluates past the last tuple; in-contract shuffles drop nothing, a
    # straggler far behind is counted
    rng = np.random.default_rng(3)
    n, b = 96, 32
    g, k, t = _sorted_time_stream(rng, n)
    pert = _perturb(rng, t, L)
    g, k, t = g[pert], k[pert], t[pert]
    stale = np.zeros(b, np.int32)
    out = port.time_aggregator("min", _batches(g, k, t, b),
                               window=ORACLE_WINDOW, num_shards=2,
                               backend=backend)
    assert [int(p[3]) for p in out[:-1]] == [0, 0, 0]
    groups, values, valid, _ = out[-1]
    end = int(np.max(t)) + 1
    want = {gi: v[0] for gi, v in
            _window_oracle(g, k, t, end, 48, ("min",)).items()}
    got = {int(groups[j]): int(values[j]) for j in range(valid.shape[0])
           if valid[j]}
    assert got == want
    late = port.time_aggregator(
        "min", _batches(g, k, t, b) + [(stale, stale, stale)],
        window=ORACLE_WINDOW, num_shards=2, backend=backend)
    assert int(late[-2][3]) >= 1


# ---------------------------------------- chip_smoke.py run (s)'s buffer

#: run (s) of ``chip_smoke.py``: run (o)'s event-time stream (2^16 tuples
#: over 64 groups, 0.875 a time unit, out of order within 64) in 64 pushes
#: of 1024 on 4 shards, lateness 64, and its reorder buffers' slots
RUN_S = dict(n=1 << 16, n_groups=64, key_max=1 << 20, density=0.875,
             jitter=64, push=1024, shards=4, lateness=64, capacity=512)


def _run_s_reorder(capacity):
    """The JAX sharded reorder over run (s)'s stream with ``capacity``
    slots a shard: (forced pops, depth mark, late drops) over the
    stream."""
    from repro_torch.interop import make_time_stream

    r = RUN_S
    g, k, ts = make_time_stream(0, r["n"], r["n_groups"], r["key_max"],
                                r["density"], r["jitter"])
    shards, lat = r["shards"], r["lateness"]
    spec = jet.ReorderSpec(capacity, lat)

    @oracle_jit
    def push(st, t, gg, kk):
        prev = jnp.min(st.max_ts - lat)
        merged = jnp.min(jnp.maximum(st.max_ts, jnp.max(t, axis=-1)) - lat)
        fresh = {"reorder_depth_hwm": jnp.zeros((), jnp.int32),
                 "reorder_forced_pops": jnp.zeros((), jnp.int32)}
        _, st, cnt = jax.vmap(lambda r_, a, b, c: jet.reorder_push(
            spec, r_, a, b, c, release_wm=prev, late_wm=prev,
            drain_wm=merged, counters=fresh))(st, t, gg, kk)
        return (st, jnp.sum(cnt["reorder_forced_pops"]),
                jnp.max(cnt["reorder_depth_hwm"]))

    st = jax.tree.map(lambda x: jnp.broadcast_to(x, (shards,) + x.shape),
                      jet.init_reorder(spec, jnp.int32))
    forced = depth = 0
    for i in range(0, r["n"], r["push"]):
        cut = [jnp.array(x[i:i + r["push"]].reshape(shards, -1))
               for x in (ts, g, k)]
        st, f, d = push(st, *cut)
        forced, depth = forced + int(f), max(depth, int(d))
    return forced, depth, int(st.dropped.sum())


def test_run_s_reorder_capacity_is_the_least_that_forces_no_pop():
    # under the min-merged gate the last shard holds its slices of two
    # pushes (2 x 256 tuples) at the peak: 512 slots force no pop and drop
    # nothing; 256 force pops
    assert _run_s_reorder(RUN_S["capacity"]) == (0, RUN_S["capacity"], 0)
    forced, depth, dropped = _run_s_reorder(RUN_S["capacity"] // 2)
    assert forced > 0 and depth == RUN_S["capacity"] // 2 and dropped == 0
