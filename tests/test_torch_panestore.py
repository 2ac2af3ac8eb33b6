"""Per-group windows of the port (``Window(ws_per_group=...)`` on the shared
pane store) against the JAX package on the CPU.

* ``execute``: the port's ``reference`` against JAX ``reference``, and the
  port's ``cuda-panestore`` (its kernels' plain versions) against JAX
  ``pallas-panestore`` (Pallas interpret mode), both op sets, capacity
  ``None`` and 6 (eviction) with int32 keys, 6 with float32 keys;
* the store itself (``push``, ``gather_runs``, ``replay``, the stores after
  every chunk), ``pergroup_write_plan`` and a stream continued from a
  JAX-made state;
* each ``*_plain`` kernel of ``pergroup_fused`` and ``pergroup_replay``
  against its TPU kernel in interpret mode, on inputs the JAX package
  built, and the ring-form ``pergroup_replay_ring_plain`` against the JAX
  path it stands for (gather_runs, then ``pergroup_replay_pallas``);
* what the placement scan kernel assumes of the stores the plain
  placement makes, and its wrapper's preparation of a store;
* the probes and errors of the planner.

Tolerance: element-exact (padded tails included), except float ``sum`` and
``mean``, which the port reduces in another order: rtol = atol = 1e-5.
The port runs in its own process (``_torch_parity.port``); the JAX side is
jitted, one program per call.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_result_same, assert_same, port  # noqa: F401
from _torch_parity import oracle_jit
from _torch_parity import execute_both
from repro.core import panestore as jps
from repro.core.swag import (per_group_chunk_scan, pergroup_write_plan,
                             swag_per_group)
from repro.kernels.swag import kernel as jk
from repro_torch.interop import make_stream

WS_MAP = {0: 32, 1: 8}
PARTIAL = ("sum", "count", "min", "max", "mean")
ALL_DIRECT = PARTIAL + ("median", "distinct_count")
#: a store small enough to evict (capacity 5 with 4-lane panes)
SQUEEZE = dict(wa=4, capacity=5, default_ws=8, per_group=((0, 16), (1, 4)))
AMPLE = dict(SQUEEZE, capacity=40)
#: 8 slots for 4 groups: the store evicts and retires
CHURN = dict(SQUEEZE, capacity=8)


def _stream(seed, n, dtype=np.int32):
    return make_stream(seed, n, 6, 60, dtype=dtype)


def _jspec(spec_kw):
    return jps.PaneStoreSpec(**spec_kw)


def _same_tree(want, got, what, float_keys=False):
    for i, (w, g) in enumerate(zip(want, got)):
        assert_same(w, g, name=f"{what}[{i}]", float_keys=float_keys)


@pytest.mark.parametrize("capacity,dtype", [
    (None, np.int32), (6, np.int32), (6, np.float32)])
@pytest.mark.parametrize("ops", [PARTIAL, ALL_DIRECT],
                         ids=["partial", "all_direct"])
@pytest.mark.parametrize("backend", ["reference", "cuda-panestore"])
def test_execute_matches_jax(port, backend, ops, capacity, dtype):
    g, k = make_stream(3, 160, 5, 60, dtype=dtype)
    window = {"ws": 16, "wa": 8, "ws_per_group": WS_MAP,
              "capacity": capacity}
    want, got = execute_both(port, ops, g, k, backend=backend,
                             window=window)
    assert got.groups.shape == (20, 32 if capacity is None else 6)
    assert_result_same(want, got, float_keys=dtype == np.float32)


@pytest.mark.parametrize("spec_kw", [SQUEEZE, AMPLE],
                         ids=["squeeze", "ample"])
def test_push_gather_replay_match_jax(port, spec_kw):
    g, k = _stream(21, 96)
    spec = _jspec(spec_kw)

    @oracle_jit
    def jax_side(g, k):
        st = jps.push(spec, jps.init_store(spec, k.dtype), g, k)
        return st, jps.gather_runs(spec, st), \
            jps.replay(spec, st, list(ALL_DIRECT))

    want = jax_side(jnp.array(g), jnp.array(k))
    st, runs, rep = port.pane_push_gather_replay(spec_kw, g, k, ALL_DIRECT)
    for field, w in zip(jps.PaneStoreState._fields, want[0]):
        assert_same(w, st[field], name=field)
    _same_tree(want[1], runs, "gather_runs")
    _same_tree((want[2][0], *want[2][2:]), (rep[0], *rep[2:]), "replay")
    for name in ALL_DIRECT:
        assert_same(want[2][1][name], rep[1][name], name=name)


def test_chunk_states_match_jax(port):
    # the stores after every chunk, as the kernel path's placement scan
    # records them, against the JAX per-chunk push
    g, k = _stream(22, 96)
    spec = _jspec(SQUEEZE)
    final, states = oracle_jit(lambda g, k: per_group_chunk_scan(
        spec, jps.init_store(spec, k.dtype), g, k, lambda st: st))(
        jnp.array(g), jnp.array(k))
    got_states, got_final = port.chunk_states(SQUEEZE, g, k)
    _same_tree(states, got_states, "states")
    _same_tree(final, got_final, "final")


@pytest.mark.parametrize("spec_kw", [SQUEEZE, AMPLE],
                         ids=["squeeze", "ample"])
def test_write_plan_matches_jax(port, spec_kw):
    g, _ = _stream(23, 96)
    spec = _jspec(spec_kw)
    want = oracle_jit(lambda g: pergroup_write_plan(spec, g))(
        jnp.array(g))
    got = port.write_plan(spec_kw, g)
    assert len(want) == len(got) == 9
    _same_tree(want, got, "write_plan")


@pytest.mark.parametrize("dtype,ops", [
    (np.int32, PARTIAL),
    (np.float32, ("min", "count", "max", "sum", "mean")),
])
def test_fused_plain_matches_pallas(port, dtype, ops):
    g, k = _stream(24, 96, dtype)
    spec = _jspec(SQUEEZE)
    plan = oracle_jit(lambda g: pergroup_write_plan(spec, g))(
        jnp.array(g))
    ck = k[:len(k) // spec.wa * spec.wa].reshape(-1, spec.wa)
    inputs = (ck,) + tuple(np.asarray(x) for x in plan[:8])
    want = jk.pergroup_fused_pallas(*(jnp.array(x) for x in inputs), ops,
                                    interpret=True)
    got = port.pergroup_fused(inputs, ops)
    assert list(got) == list(ops)
    for name in ops:
        assert_same(want[name], got[name], name=name,
                    float_keys=dtype == np.float32)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_replay_plain_matches_pallas(port, dtype):
    g, k = _stream(25, 96, dtype)
    spec = _jspec(SQUEEZE)
    _final, runs = oracle_jit(lambda g, k: per_group_chunk_scan(
        spec, jps.init_store(spec, k.dtype), g, k,
        lambda st: jps.gather_runs(spec, st)))(jnp.array(g), jnp.array(k))
    length = runs.run_keys.shape[-1]
    rk = np.asarray(runs.run_keys).reshape(-1, length)
    rv = np.asarray(runs.run_valid).reshape(-1, length).astype(np.int32)
    want = jk.pergroup_replay_pallas(jnp.array(rk), jnp.array(rv),
                                     ALL_DIRECT, run=spec.wa, interpret=True)
    got = port.pergroup_replay(rk, rv, ALL_DIRECT, spec.wa)
    for name in ALL_DIRECT:
        assert_same(want[name], got[name], name=name,
                    float_keys=dtype == np.float32)


#: lanes of a run in the NaN-key replay rows
NAN_RUN = 8


def _nan_rows():
    """Six replay rows of four sorted runs of ``NAN_RUN`` float32 lanes
    holding NaN keys (as the close sort leaves them: last in each run),
    80 % live: a row without a live NaN, a row of NaN alone, four mixed."""
    rng = np.random.default_rng(3)
    rows, length = 6, 32
    rk = rng.choice(np.array([-1.0, 0.5, 2.0, 3.0, np.nan], np.float32),
                    (rows, length))
    rk = np.sort(rk.reshape(rows, -1, NAN_RUN), -1).reshape(rows, length)
    rv = (rng.random((rows, length)) < 0.8).astype(np.int32)
    rv[0] = rv[0] * ~np.isnan(rk[0])  # a row without NaN
    rk[1] = np.nan  # a row of NaN alone
    return rk, rv


def test_replay_plain_orders_nan_last(port):
    # the port's contract where a window holds NaN keys (README): the runs
    # merge with NaN after every number, as the panes are sorted, so min,
    # max, the lower median and distinct count are those of np.sort's
    # order of the live keys, every NaN a distinct key (the JAX network
    # compares NaN with nothing, so it is not the yardstick here)
    rk, rv = _nan_rows()
    rows = rk.shape[0]
    got = port.pergroup_replay(rk, rv, ALL_DIRECT, NAN_RUN)
    for r in range(rows):
        live = np.sort(rk[r][rv[r] != 0])
        n = live.shape[0]
        want = {"count": n, "min": live[0], "max": live[n - 1],
                "median": live[(n - 1) // 2],
                "distinct_count": int(np.isnan(live).sum())
                + np.unique(live[~np.isnan(live)]).shape[0]}
        for name, w in want.items():
            np.testing.assert_array_equal(got[name][r], w,
                                          err_msg=f"row {r} {name}")


@pytest.mark.parametrize("yardstick", ["reference", "pallas"])
def test_replay_plain_nan_keys_match_jax_where_order_free(port, yardstick):
    # the port's plain merge orders NaN keys last and the JAX network does
    # not (README, "NaN keys"), so min, max, median and distinct count of
    # such a window may differ; count, sum and mean do not depend on the
    # merge order and stay held to the JAX package's replay of the same
    # rows: the reference's replay_rows and the TPU kernel (interpreted)
    rk, rv = _nan_rows()
    ops = ("count", "sum", "mean")
    if yardstick == "reference":
        spec = jps.PaneStoreSpec(wa=NAN_RUN, capacity=4, default_ws=NAN_RUN)
        want, _cnt = oracle_jit(lambda k, v: jps.replay_rows(
            spec, k, v, ops, ops, key_dtype=jnp.float32,
            interpolate=False))(jnp.array(rk), jnp.array(rv))
    else:
        want = jk.pergroup_replay_pallas(jnp.array(rk), jnp.array(rv), ops,
                                         run=NAN_RUN, interpret=True)
    got = port.pergroup_replay(rk, rv, ops, NAN_RUN)
    assert np.isnan(np.asarray(want["sum"])).sum() >= 2  # NaN windows held
    for name in ops:
        assert_same(want[name], got[name], name=name, float_keys=True)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_replay_ring_plain_matches_pallas(port, dtype):
    # the ring-form replay (the port's merge-replay path: the placement
    # scan's stores after every chunk, replayed per live group) against the
    # JAX path it stands for: the chunk scan's stores, gather_runs and
    # pergroup_replay_pallas in interpret mode; over a stream that evicts,
    # retires and leaves partly filled open panes
    g, k = make_stream(32, 128, 4, 60, dtype=dtype)
    spec = _jspec(CHURN)
    _final, runs = oracle_jit(lambda g, k: per_group_chunk_scan(
        spec, jps.init_store(spec, k.dtype), g, k,
        lambda st: jps.gather_runs(spec, st)))(jnp.array(g), jnp.array(k))
    ne, c, length = runs.run_keys.shape
    want = jk.pergroup_replay_pallas(
        jnp.array(np.asarray(runs.run_keys).reshape(-1, length)),
        jnp.array(np.asarray(runs.run_valid).reshape(-1, length)
                  .astype(np.int32)), ALL_DIRECT, run=spec.wa,
        interpret=True)
    got = port.pergroup_replay_ring(CHURN, g, k, ALL_DIRECT)
    evictions, retirements = got["events"]
    assert evictions > 0 and retirements > 0 and got["open_panes"] > 0, got
    assert_same(runs.groups, got["ugroups"], name="ugroups")
    assert_same(runs.num_groups, got["num"], name="num")
    for name in ALL_DIRECT:
        assert_same(np.asarray(want[name]).reshape(ne, c),
                    got["values"][name], name=name,
                    float_keys=dtype == np.float32)


@pytest.mark.parametrize("ops", [PARTIAL, ALL_DIRECT],
                         ids=["partial", "all_direct"])
def test_jax_state_continues_in_the_port(port, ops):
    # a stream begun in JAX (its final state carried across as numpy)
    # continues in the port as it continues in JAX
    g, k = _stream(26, 128)
    spec = _jspec(SQUEEZE)
    run = oracle_jit(lambda g, k, st: swag_per_group(
        g, k, spec=spec, ops=list(ops), state=st))
    (og, vals, valid, num), jstate = oracle_jit(
        lambda g, k: swag_per_group(g, k, spec=spec, ops=list(ops)))(
        jnp.array(g[:96]), jnp.array(k[:96]))
    # the port's own run of the first part ends in the same state
    (pg, pvals, pvalid, pnum), pstate = port.swag_per_group(
        SQUEEZE, g[:96], k[:96], ops)
    _same_tree((og, valid, num), (pg, pvalid, pnum), "first part")
    for field, w in zip(jps.PaneStoreState._fields, jstate):
        assert_same(w, pstate[field], name=field)

    arrays = {f: np.asarray(v) for f, v in zip(jps.PaneStoreState._fields,
                                               jstate)}
    (og2, vals2, valid2, num2), jfinal = run(jnp.array(g[96:]),
                                             jnp.array(k[96:]), jstate)
    (pg2, pvals2, pvalid2, pnum2), pfinal = port.swag_per_group(
        SQUEEZE, g[96:], k[96:], ops, arrays)
    _same_tree((og2, valid2, num2), (pg2, pvalid2, pnum2), "continued")
    for name in ops:
        assert_same(vals2[name], pvals2[name], name=name)
    for field, w in zip(jps.PaneStoreState._fields, jfinal):
        assert_same(w, pfinal[field], name=f"final {field}")


def test_placement_kernel_assumptions(port):
    # what the placement scan kernel's constant-time path assumes, held on
    # the plain placement: churn in a squeezed store (every other tuple
    # from two hot groups, which retire panes; the rest evict), then a
    # stream continued from its store whose owners include groups the
    # second stream lacks; and the kernel wrapper's dense indices, pane
    # chains and window table (with per-group overrides) on that store
    g1, _ = _stream(29, 96)
    g1 = np.where(np.arange(96) % 2 == 0, g1 % 2, g1).astype(np.int32)
    g2, _ = _stream(30, 96)
    got = port.pane_invariants(dict(SQUEEZE, capacity=12), g1, g2 + 3)
    assert got["tuples"] == 192
    assert got["retired"] > 0 and got["evicted"] > 0, got
    assert got["absent_owners"] > 0 and got["groups"] > 6, got


@pytest.mark.parametrize("backend", ["reference", "cuda-panestore"])
def test_stream_shorter_than_a_pane(port, backend):
    g, k = _stream(27, 5)
    want, got = execute_both(port, ("sum", "median"), g, k, backend=backend,
                             window={"ws": 16, "wa": 8,
                                     "ws_per_group": {0: 8}})
    assert got.groups.shape == (0, 16)
    assert got.num_groups.shape == (0,)
    assert_result_same(want, got)


def test_probe_rejections(port):
    w = {"ws": 16, "wa": 4, "ws_per_group": {0: 8}}
    reason = port.backend_reason
    assert reason("cuda-panestore", ("sum",), w) is None
    assert "per-group windows" in reason("cuda-panestore", ("sum",))
    assert "per-group windows" in reason("cuda-panestore", ("sum",),
                                         {"ws": 16})
    # streaming count windows run on the pane-store kernels (slice 3)
    assert reason("cuda-panestore", ("sum",), w, {"streaming": True}) is None
    assert "use the cuda-panestore backend" in reason(
        "cuda", ("sum",), w, {"streaming": True})
    assert "lower-median" in reason("cuda-panestore", ("median",), w,
                                    {"interpolate": True})
    assert "variance" in reason("cuda-panestore", ("variance",), w)
    for backend in ("cuda", "cuda-panes"):
        assert "use the cuda-panestore backend" in reason(backend,
                                                          ("sum",), w)
    with pytest.raises(ValueError, match="cuda-panestore backend"):
        port.plan_backend(("sum",), backend="cuda", window=w)
    assert port.plan_backend(("sum",), window=w) == "reference"  # auto, CPU


def test_reference_runs_engine_tail_ops(port):
    # ops outside DIRECT_OPS fall back to an engine pass on the reference
    g, k = _stream(28, 96)
    want, got = execute_both(port, ("variance", "sum"), g, k,
                             backend="reference",
                             window={"ws": 16, "wa": 8,
                                     "ws_per_group": WS_MAP})
    assert_result_same(want, got, float_keys=True)


def test_kernel_path_probe(port):
    w = {"ws": 16, "wa": 4, "ws_per_group": {0: 8}}
    path = port.pergroup_kernel_path
    assert path(("sum", "mean"), w) == "partial-fused"
    assert path(("sum", "median"), w) == "merge-replay"
    assert path(("sum",), w, True) == "merge-replay"
    assert path(("min", "max"), w, True) == "partial-fused"


@pytest.mark.parametrize("window,exc", [
    (dict(ws=16, wa=6, ws_per_group={0: 8}), ValueError),    # wa not pow2
    (dict(ws=16, wa=4, ws_per_group={0: 0}), ValueError),    # ws_g <= 0
    (dict(ws=16, wa=4, ws_per_group={0: 8}, capacity=2), ValueError),
    (dict(ws=16, wa=4, ws_per_group="eight"), TypeError),    # bad type
    (dict(ws=16, wa=4, ws_per_group={0: 8}, capacity=0), ValueError),
])
def test_pergroup_window_errors(port, window, exc):
    with pytest.raises(exc):
        port.plan_backend(("sum",), window=window)


def test_pergroup_plan_conflicts(port):
    w = {"ws": 16, "wa": 4, "ws_per_group": {0: 8}}
    with pytest.raises(ValueError, match="presorted"):
        port.plan_backend(("sum",), window=w, query={"presorted": True})
    with pytest.raises(ValueError, match="panes"):
        port.plan_backend(("sum",), window=dict(w, panes=False))


def test_range_window_still_raises(port):
    # batch time windows are ported (slice 5a) and a time clause takes no
    # per-group windows; time-mode pane stores serve event-time streaming
    # (slice 5b): a fresh one equals the JAX package's
    port.make_window(range=10)
    with pytest.raises(ValueError, match="time-bounded"):
        port.make_window(range=10, ws_per_group={0: 8})
    spec = dict(wa=8, capacity=16, default_ws=1, slide=4, time_range=16)
    got = port.init_time_store(spec)
    want = jps.init_store(jps.PaneStoreSpec(**spec))
    for f, w in zip(jps.PaneStoreState._fields, want):
        assert_same(w, got[f], name=f)
