"""Sharded execution of the port (``execute(num_shards=, mesh=)``,
``stream_fn(mesh=)``, ``StreamingAggregator(num_shards=)``, the partial
tables and the combine tree) against the JAX package's two-phase pipeline
on the CPU.  Mirrors ``tests/test_query_exec.py``, but its event-time
cases (a later slice of the port) and its 8-device mesh: the port's mesh
(8 ``cpu`` devices) is held here to the JAX package's ``num_shards=8``.

Held element-exact to the JAX **sharded** result (padded tails included;
float ``variance`` within rtol = atol = 1e-5, as the JAX test itself), and
to the port's own one-device result on the valid lanes only (the sharded
median writes 0 past ``num_groups``, the one-device rank pick does not).
The port's ``cuda`` and ``cuda-panes`` run their kernels' plain versions
here: one small case each is held to JAX ``pallas`` / ``pallas-panes`` in
interpret mode, the others to JAX ``reference``.  Every JAX oracle is
jitted once a query and shape; the port runs in its own process
(``_torch_parity.port``).
"""
from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_result_same, assert_same, port  # noqa: F401
from _torch_parity import oracle_jit
from _torch_parity import assert_valid_lanes_same, execute_both_sharded
from conftest import PY_OPS, py_group_aggregate, sorted_stream
from repro import query as jq
from repro.core import StreamingAggregator as JaxAggregator
from repro.core import engine as E
from repro.core.combiners import ALL_OPS, get_combiner
from repro.distributed import query_exec as QX

MERGEABLE = tuple(op for op in ALL_OPS if get_combiner(op).mergeable)
ALL9 = ("sum", "min", "max", "count", "mean", "dc", "median", "first",
        "last")
WINDOW_OPS = ("sum", "min", "dc", "median", "mean")
MESH8 = ["cpu"] * 8


def _tables_np(t):
    """A JAX ``PartialTable`` in the port's numpy layout (``interop``)."""
    return {"groups": np.asarray(t.groups),
            "states": {name: (tuple(np.asarray(x) for x in st)
                              if isinstance(st, tuple) else np.asarray(st))
                       for name, st in t.states.items()},
            "valid": np.asarray(t.valid),
            "num_groups": np.asarray(t.num_groups)}


def _assert_tables_same(want, got, *, rows=None):
    """Two partial tables in numpy: every field equal (``rows``: the state
    arrays compared on those rows only); variance within 1e-5."""
    for f in ("groups", "valid", "num_groups"):
        assert_same(want[f], got[f], name=f)
    assert set(want["states"]) == set(got["states"])
    for name, st in want["states"].items():
        w = st if isinstance(st, tuple) else (st,)
        g = got["states"][name]
        g = g if isinstance(g, tuple) else (g,)
        assert len(w) == len(g), name
        for a, b in zip(w, g):
            if rows is not None:
                a, b = np.asarray(a)[rows], np.asarray(b)[rows]
            if name == "variance":
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                           err_msg=name)
            else:
                assert_same(a, b, name=name)


def _sorted(seed, n, n_groups, key_max=1000):
    return sorted_stream(np.random.default_rng(seed), n, n_groups,
                         key_max=key_max, full_sort=True)


# ---------------------------------------------------------------------------
# the partial-state merge algebra
# ---------------------------------------------------------------------------

@oracle_jit
def _jax_algebra(g, k, cut):
    """JAX's tables of the whole stream, its first ``cut`` tuples and the
    rest (masked prefixes of full-width streams; one vmapped engine pass
    for the three), and their merge."""
    n = g.shape[0]
    tables = jax.vmap(lambda a, b, nv: E.multi_engine_partials(
        a, b, MERGEABLE, n_valid=nv))(
        jnp.stack([g, g, jnp.roll(g, -cut)]),
        jnp.stack([k, k, jnp.roll(k, -cut)]), jnp.stack([n, cut, n - cut]))
    full, pa, pb = (jax.tree.map(lambda x: x[i], tables) for i in range(3))
    return full, pa, pb, E.combine_partial_tables(pa, pb, MERGEABLE,
                                                  key_dtype=jnp.int32)


def test_merge_partials_matches_full(port):
    """merge(partials(A), partials(B)) == partials(A ++ B) for every
    mergeable combiner at once, at fixed seeds and cuts: mid-group cuts
    exercise dc's boundary rule, ``key_max=3`` its boundary key equality,
    cuts 0 and 128 the empty-shard identity.  Every table is also held to
    JAX's, padded rows included."""
    for seed, key_max in ((0, 3), (1, 3), (0, 1000), (1, 1000)):
        g, k = _sorted(seed, 128, 7, key_max)
        for cut in (0, 1, 37, 64, 128):
            want = _jax_algebra(jnp.array(g), jnp.array(k), cut)
            tables, (full, merged) = port.partials_algebra(g, k, MERGEABLE,
                                                           cut)
            for w, got in zip(want, tables):
                _assert_tables_same(_tables_np(w), got)
            n = int(full[3])
            assert int(merged[3]) == n
            assert_same(full[0][:n], merged[0][:n], name="groups")
            for name in MERGEABLE:
                a, b = full[1][name][:n], merged[1][name][:n]
                if name == "variance":  # float re-association: ~ulp
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
                else:
                    assert_same(a, b, name=name)


def test_dc_boundary_subtract_exact(port):
    """The distributed rule, verbatim: equal boundary keys across the shard
    cut are counted once."""
    g = np.array([0, 0, 0, 0], np.int32)
    k = np.array([1, 5, 5, 9], np.int32)
    tables, (full, merged) = port.partials_algebra(g, k,
                                                   ("distinct_count",), 2)
    assert int(full[1]["distinct_count"][0]) == 3
    assert int(merged[1]["distinct_count"][0]) == 3
    # the merged table's states: one live row, dc 3, first key 1, last 9
    dc, first, last = tables[3]["states"]["distinct_count"]
    assert (int(dc[0]), int(first[0]), int(last[0])) == (3, 1, 9)
    assert int(tables[3]["num_groups"]) == 1


def test_empty_shard_is_identity(port):
    """The empty table (JAX's, row for row) is the merge's identity."""
    g, k = _sorted(2, 64, 5)
    empty, (pb, merged) = port.empty_identity(g, k, MERGEABLE, 32)
    _assert_tables_same(
        _tables_np(E.empty_partial_table(32, MERGEABLE, jnp.int32)), empty)
    n = int(pb[3])
    assert int(merged[3]) == n
    assert_same(pb[0][:n], merged[0][:n], name="groups")
    for name in MERGEABLE:
        assert_same(pb[1][name][:n], merged[1][name][:n], name=name)


def test_combine_tree_nonpow2_shards(port):
    """A 3-shard tree pads with the identity table and still matches: JAX's
    own tables through the port's tree give JAX's tree, counters
    included."""
    g, k = _sorted(3, 96, 6)
    ops = ("sum", "distinct_count")

    @oracle_jit
    def jax_side(g, k):
        stacked = jax.vmap(lambda a, b: E.multi_engine_partials(a, b, ops))(
            g.reshape(3, 32), k.reshape(3, 32))
        merged, counters = QX.combine_tree(stacked, ops, key_dtype=jnp.int32,
                                           counters={})
        return (stacked, merged, counters,
                E.multi_engine_partials(g, k, ops))

    stacked, merged, counters, full = jax_side(jnp.array(g), jnp.array(k))
    got, (gg, gv, _, gnum), gc = port.combine_tables(_tables_np(stacked),
                                                     ops)
    _assert_tables_same(_tables_np(merged), got)
    assert set(gc) == set(counters)
    for name, v in counters.items():
        assert_same(v, gc[name], name=name)
    n = int(full.num_groups)
    assert int(gnum) == n
    _, fv, _, _ = E.finalize_partial_table(full, ops)
    for name in fv:
        assert_same(np.asarray(fv[name])[:n], gv[name][:n], name=name)


@oracle_jit
def _jax_shard_tables(gs, ks, nvs):
    return jax.vmap(lambda a, b, c: E.multi_engine_partials(
        a, b, ("sum", "count", "min", "max"), n_valid=c))(gs, ks, nvs)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_per_shard_partial_tables_match_jax(port, backend):
    """The engine path's local phase, shard by shard, through
    ``interop.partial_table_to_numpy``: the reference's tables are JAX's,
    padded rows included; ``cuda``'s (the groupagg kernel's plain version,
    one call for all ops a shard) hold JAX's states on the live rows, and
    zeros past them as the kernel writes them."""
    g, k = _sorted(4, 256, 9)
    ops = ("sum", "count", "min", "max")
    nv = 200
    gm = np.where(np.arange(256) < nv, g, np.iinfo(np.int32).max)
    nvs = np.clip(nv - np.arange(4) * 64, 0, 64)
    want = _jax_shard_tables(jnp.array(gm.reshape(4, 64)),
                             jnp.array(k.reshape(4, 64)),
                             jnp.array(nvs, jnp.int32))
    got = port.local_tables(ops, g, k, 4, backend=backend, tile=128,
                            n_valid=nv)
    if backend == "reference":
        _assert_tables_same(_tables_np(want), got)
    else:
        live = np.asarray(want.valid)
        _assert_tables_same(_tables_np(want), got, rows=live)
        for name, st in got["states"].items():
            assert not np.asarray(st)[~live].any(), name


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["argmin", "argmax"])
def test_argminmax_not_mergeable(port, op):
    with pytest.raises(ValueError, match="partial-state merge"):
        port.plan_sharded((op,), backend="reference", num_shards=2)


@pytest.mark.parametrize("ops,backend,window,query,err,msg", [
    (("sum",), "reference", {"ws": 16, "wa": 4, "ws_per_group": {0: 8}}, {},
     ValueError, "pane store"),
    (("sum",), "cuda-panestore", {"ws": 16, "wa": 4, "ws_per_group": 8}, {},
     ValueError, "pane store"),
    (("sum",), "reference", {"ws": 16, "wa": 4}, {"streaming": True},
     ValueError, "shared pane store"),
    (("sum",), "reference", {"ws": 16}, {"presorted": True}, ValueError,
     "presorted"),
    (("mean",), "cuda", None, {}, ValueError, "partial states"),
    (("dc",), "cuda", None, {}, ValueError, "cannot shard"),
    (("sum",), "reference", {"range": 16}, {}, ValueError,
     "batch time-range windows"),
    # a sharded event-time stream plans (slice 7b): no refusal
    (("sum",), "reference", {"range": 16}, {"streaming": True},
     None, None),
], ids=["per_group", "panestore", "stream_window", "presorted", "mean_cuda",
        "dc_cuda", "batch_time", "time_stream-7b"])
def test_sharded_plan_validation(port, ops, backend, window, query, err,
                                 msg):
    """The JAX package's refusals and messages (``cuda`` in place of
    ``pallas``); a sharded event-time stream plans on the backend asked
    for, as the JAX package's does."""
    if err is None:
        assert port.plan_sharded(ops, backend=backend, window=window,
                                 query=query, num_shards=2)[0] == backend
        jp = jq.plan(jq.Query(ops=ops, window=jq.Window(**window), **query),
                     backend=backend, num_shards=2)
        assert jp.backend == backend and jp.num_shards == 2
        return
    with pytest.raises(err, match=msg):
        port.plan_sharded(ops, backend=backend, window=window, query=query,
                          num_shards=2)
    if err is ValueError and backend in ("reference", "cuda"):
        jw = None if window is None else jq.Window(**window)
        with pytest.raises(ValueError, match=msg):
            jq.plan(jq.Query(ops=ops, window=jw, **query),
                    backend="pallas" if backend == "cuda" else backend,
                    num_shards=2)


def test_sharded_plan_stages(port):
    assert port.plan_sharded(("sum",), backend="reference",
                             num_shards=4)[2:] == (
        ("partition", "local", "merge", "finalize"), 4)
    assert port.plan_sharded(("sum",))[2:] == (("local", "finalize"), 1)
    with pytest.raises(ValueError, match="num_shards must be >= 1"):
        port.plan_sharded(("sum",), backend="reference", num_shards=0)


def test_partition_needs_divisibility(port):
    g, k = _sorted(5, 100, 5)
    with pytest.raises(ValueError, match="divide"):
        port.execute(("sum",), g, k, backend="reference", num_shards=8)
    with pytest.raises(ValueError, match="contradicts the mesh"):
        port.execute(("sum",), g[:96], k[:96], backend="reference",
                     num_shards=4, mesh=MESH8)


def test_auto_probe_falls_back_to_reference_for_sharded(port):
    """An ``auto``-chosen kernel backend must not turn a shardable query
    into a plan failure on the card: dc's kernel output is not its partial
    state, so auto falls back to the reference (an explicit request still
    raises); a median rides the run channel, so ``cuda`` stays."""
    backend, note, _, _ = port.plan_sharded(("dc",), num_shards=2,
                                            devices=["cuda"])
    assert backend == "reference"
    assert "cannot shard" in note
    with pytest.raises(ValueError, match="cannot shard"):
        port.plan_sharded(("dc",), backend="cuda", num_shards=2)
    assert port.plan_sharded(("sum", "median"), backend="cuda",
                             num_shards=2)[0] == "cuda"
    assert port.plan_sharded(("sum", "median"), num_shards=2,
                             devices=["cuda"])[0] == "cuda"


def test_choose_backend_device_aware(port):
    window = {"ws": 64, "wa": 16}
    assert port.choose_backend_on(("sum",), window, ["cpu"]) == "reference"
    # CUDA devices flip the very same query to the pane kernels
    assert port.choose_backend_on(("sum",), window, ["cuda"] * 4) \
        == "cuda-panes"


def test_sharded_without_a_card_raises(port):
    if port.cuda_available():
        pytest.skip("a card is present: device='cuda' runs")
    g = np.zeros(8, np.int32)
    with pytest.raises(RuntimeError, match="is_available"):
        port.execute("sum", g, g, backend=None, device="cuda", num_shards=2)
    with pytest.raises(RuntimeError, match="is_available"):
        port.execute("sum", g, g, backend=None, mesh=["cuda", "cuda"])


# ---------------------------------------------------------------------------
# batch queries: logical shards and the 8-device mesh
# ---------------------------------------------------------------------------

def _columns(res, names):
    """A result's columns ``names`` only."""
    return SimpleNamespace(groups=res.groups, valid=res.valid,
                           num_groups=res.num_groups,
                           values={name: res.values[name] for name in names})


def _engine_stream():
    """The engine cases' stream: 128 (group, key)-sorted tuples, 16
    groups."""
    return _sorted(7, 128, 16)


@pytest.mark.parametrize("num_shards", [2, 8])
def test_engine_sharded_bit_identical(port, num_shards):
    """Nine ops on 2 and 8 logical shards (and a mesh of 8 CPU devices),
    whole and with a masked tail (``n_valid``: every shard's real prefix):
    on 8 shards equal to JAX's sharded result, tails included (the JAX
    oracle takes ``n_valid`` as an argument: one compile), on 2 to the
    port's 8 (a sharded result does not depend on the shard count); each
    to one device's on the valid lanes and to a Python oracle.  ``cuda``
    (the groupagg kernel's plain version a shard, its ``n_valid`` the
    shard's prefix) is held to the same columns of the nine-op result."""
    g, k = _engine_stream()
    cols = ("sum", "count", "min", "max", "median")
    for nv in (128, 100):
        if num_shards == 8:
            want, got = execute_both_sharded(port, ALL9, g, k,
                                             backend="reference",
                                             num_shards=8, n_valid=nv)
            assert_result_same(want, port.execute(ALL9, g, k,
                                                  backend="reference",
                                                  mesh=MESH8, n_valid=nv))
        else:
            want = port.execute(ALL9, g, k, backend="reference",
                                num_shards=8, n_valid=nv)
            got = port.execute(ALL9, g, k, backend="reference",
                               num_shards=num_shards, n_valid=nv)
        assert_result_same(want, got)
        cuda = port.execute(cols, g, k, backend="cuda",
                            num_shards=num_shards, n_valid=nv)
        assert_result_same(_columns(want, cols), cuda)
        for ops, backend, res in ((ALL9, "reference", got),
                                  (cols, "cuda", cuda)):
            assert_valid_lanes_same(port.execute(ops, g, k, backend=backend,
                                                 n_valid=nv), res)
    unmasked = port.execute(ALL9, g, k, backend="reference",
                            num_shards=num_shards)
    assert_result_same(port.execute(ALL9, g, k, backend="reference",
                                    num_shards=num_shards, n_valid=128),
                       unmasked)
    n = int(unmasked.num_groups)
    for op in ("sum", "count", "mean", "distinct_count", "median"):
        og, ov = py_group_aggregate(g, k, PY_OPS[op])
        assert n == len(og)
        np.testing.assert_array_equal(unmasked.groups[:n], og)
        np.testing.assert_allclose(unmasked.values[op][:n], ov, rtol=1e-6)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_engine_sharded_n_valid(port, backend):
    """A masked tail on 8 shards gives the groups of the unmasked prefix on
    4 (the port against itself; JAX holds both in
    :func:`test_engine_sharded_bit_identical`)."""
    g, k = _engine_stream()
    ops = ("sum", "count", "min", "max", "median") if backend == "cuda" \
        else ("sum", "dc")
    ref = port.execute(ops, g[:100], k[:100], backend=backend, num_shards=4)
    pad = port.execute(ops, g, k, backend=backend, num_shards=8,
                       n_valid=100)
    n = int(ref.num_groups)
    assert n == int(pad.num_groups)
    for name in ref.values:
        np.testing.assert_array_equal(ref.values[name][:n],
                                      pad.values[name][:n])


def test_pallas_engine_sharded_parity(port):
    """``cuda``'s local phase is the groupagg kernel a shard (its plain
    version here), held to JAX's ``pallas`` (interpret mode) on 2 shards
    of one 128-lane tile, element for element."""
    g, k = sorted_stream(np.random.default_rng(9), 256, 9)
    want, got = execute_both_sharded(port, ("sum", "max"), g, k,
                                     backend="cuda", num_shards=2, tile=128)
    assert_result_same(want, got)
    assert_valid_lanes_same(port.execute(("sum", "max"), g, k,
                                         backend="reference"), got)


def test_nonpow2_shards_uniform_result_widths(port):
    """Power-of-two shard padding must not leak into the result: every
    column (the run channel's median too) keeps one device's width."""
    g, k = _sorted(10, 300, 7)
    want, got = execute_both_sharded(port, ("sum", "median"), g, k,
                                     backend="reference", num_shards=3)
    assert_result_same(want, got)
    one = port.execute(("sum", "median"), g, k, backend="reference")
    assert got.groups.shape == one.groups.shape == (300,)
    for name in got.values:
        assert got.values[name].shape == one.values[name].shape, name
    assert_valid_lanes_same(one, got)
    # streaming: N + 1 output slots whatever the padding, one device's
    # emission (the JAX package's own check)
    (out,) = port.stream_steps(("sum",), [(g, k)], backend="reference",
                               num_shards=3)
    (ref,) = port.stream_steps(("sum",), [(g, k)], backend="reference")
    assert out["groups"].shape == ref["groups"].shape == (301,)
    v = ref["valid"]
    for name in ("valid", "num", "rr"):
        assert_same(ref[name], out[name], name=name)
    assert_same(ref["groups"][v], out["groups"][v], name="groups")
    assert_same(ref["values"]["sum"][v], out["values"]["sum"][v],
                name="sum")


def test_window_run_channel_only_sharded(port):
    """All-run-channel windowed query (median alone): the local phase is
    the pane sort alone."""
    rng = np.random.default_rng(11)
    g = rng.integers(0, 8, 1024).astype(np.int32)
    k = rng.integers(0, 500, 1024).astype(np.int32)
    window = {"ws": 256, "wa": 64}
    want, got = execute_both_sharded(port, ("median",), g, k,
                                     backend="reference", window=window,
                                     num_shards=4)
    assert_result_same(want, got)
    assert_valid_lanes_same(port.execute(("median",), g, k,
                                         backend="reference", window=window),
                            got)


def _window_stream(seed=12, n=1024):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 16, n).astype(np.int32),
            rng.integers(0, 1000, n).astype(np.int32))


@pytest.mark.parametrize("ws,wa,num_shards", [(256, 64, 8), (96, 24, 2)])
def test_window_sharded_bit_identical(port, ws, wa, num_shards):
    """Pane-compatible windows run the pane pipeline (per-pane tables, a
    combine tree a window), other shapes partition the window axis (on 2
    shards: the JAX oracle unrolls a shard loop); both equal JAX's, and one
    device on the valid lanes.  The pane-compatible
    case also runs on the mesh of 8 CPU devices and on the kernel
    backends, which partition the window axis: each shard's block of whole
    windows through the swag kernel (``cuda``) or sort_panes + swag_panes
    (``cuda-panes``), their plain versions here, on 2 and 8 shards: equal
    to the same backend on one device, padded tails included, and to JAX's
    sharding on the valid lanes (JAX's reference leaves the rank pick's
    value in a median's padded lanes, the kernels a zero)."""
    g, k = _window_stream()
    window = {"ws": ws, "wa": wa}
    want, got = execute_both_sharded(port, WINDOW_OPS, g, k,
                                     backend="reference", window=window,
                                     num_shards=num_shards)
    assert_result_same(want, got)
    one = port.execute(WINDOW_OPS, g, k, backend="reference", window=window)
    assert_valid_lanes_same(one, got)
    if num_shards != 8:
        return
    _, on_mesh = execute_both_sharded(port, WINDOW_OPS, g, k,
                                      backend="reference", window=window,
                                      mesh=MESH8)
    assert_result_same(want, on_mesh)
    for backend in ("cuda", "cuda-panes"):
        one = port.execute(WINDOW_OPS, g, k, backend=backend, window=window)
        for num_shards in (2, 8):
            got = port.execute(WINDOW_OPS, g, k, backend=backend,
                               window=window, num_shards=num_shards)
            assert_valid_lanes_same(want, got)
            assert_result_same(one, got)


def test_pallas_panes_window_sharded_parity(port):
    """One small case held to JAX's ``pallas-panes`` (interpret mode) on 2
    shards, element for element: the port's ``cuda-panes`` runs
    sort_panes and swag_panes' plain versions a shard."""
    g, k = _window_stream(13, 256)
    want, got = execute_both_sharded(port, ("sum", "max", "median"), g, k,
                                     backend="cuda-panes",
                                     window={"ws": 128, "wa": 32},
                                     num_shards=2)
    assert_result_same(want, got)


# ---------------------------------------------------------------------------
# rolling streams
# ---------------------------------------------------------------------------

_STREAM_JIT: dict = {}


def _jax_sharded_stream(ops, batches, num_shards, n_valids):
    """JAX's sharded rolling stream (``stream_fn``, jitted once, counters
    on), push by push: outputs, carries and counters in numpy."""
    key = (ops, num_shards)
    if key not in _STREAM_JIT:
        p = jq.plan(jq.Query(ops=ops, streaming=True), backend="reference",
                    num_shards=num_shards)
        _STREAM_JIT[key] = (p, oracle_jit(jq.stream_fn(
            p, collect_stats=True)))
    p, step = _STREAM_JIT[key]
    st = jq.init_stream_state(p, collect_stats=True)
    out = []
    for (g, k), nv in zip(batches, n_valids):
        (og, ov, valid, num, rr), st = step(jnp.array(g), jnp.array(k), st,
                                            jnp.asarray(nv, jnp.int32))
        carries, counters = st
        out.append({"groups": np.asarray(og),
                    "values": {n: np.asarray(v) for n, v in ov.items()},
                    "valid": np.asarray(valid), "num": np.asarray(num),
                    "rr": np.asarray(rr),
                    "carries": [jax.tree.map(np.asarray, tuple(c))
                                for c in carries],
                    "stats": {n: np.asarray(v) for n, v in counters.items()}})
    return out


def _assert_carries_same(want, got):
    """JAX carries (tuples of numpy leaves) against the port's numpy
    carries."""
    for cw, cg in zip(want, got):
        group, state, nonempty, emitted = cw
        assert_same(group, cg["group"], name="group")
        assert_same(nonempty, cg["nonempty"], name="nonempty")
        assert_same(emitted, cg["emitted"], name="emitted")
        ws = state if isinstance(state, tuple) else (state,)
        gs = cg["state"] if isinstance(cg["state"], tuple) else (cg["state"],)
        for a, b in zip(ws, gs):
            assert_same(a, b, name="state")


def _assert_stream_same(want, got, one, ops):
    for w, o, s in zip(want, got, one):
        for name in ("groups", "valid", "num", "rr"):
            assert_same(w[name], o[name], name=name)
            assert_same(s[name], o[name], name=name)
        for name in ops:
            assert_same(w["values"][name], o["values"][name], name=name)
            assert_same(s["values"][name], o["values"][name], name=name)
        _assert_carries_same(w["carries"], o["state"])
        _assert_carries_same([tuple(c[f] for f in ("group", "state",
                                                   "nonempty", "emitted"))
                              for c in s["state"]], o["state"])
        assert set(w["stats"]) == set(o["stats"])
        for name, v in w["stats"].items():
            assert_same(v, o["stats"][name], name=name)


def test_streaming_sharded_bit_identical(port):
    """4 shards, 4 pushes of 128 (the last with a masked tail): every
    push's outputs (rr_port too), carries and combine-tree counters equal
    JAX's; the outputs and carries equal one device's stream.  ``cuda``
    scans each shard with the segmented-scan kernel's plain version; a
    mesh of 4 CPU devices runs the reference's."""
    g, k = _sorted(14, 512, 13)
    ops = ("sum", "count", "distinct_count")
    batches = [(g[lo:lo + 128], k[lo:lo + 128]) for lo in range(0, 512, 128)]
    n_valids = [128, 128, 128, 100]
    want = _jax_sharded_stream(ops, batches, 4, n_valids)
    for backend in ("reference", "cuda"):
        got = port.stream_steps(ops, batches, backend=backend, num_shards=4,
                                n_valids=n_valids, collect_stats=True)
        one = port.stream_steps(ops, batches, backend=backend,
                                n_valids=n_valids)
        _assert_stream_same(want, got, one, ops)
    # over a mesh of 4 CPU devices: the same pushes
    got = port.stream_steps(ops, batches, backend="reference", num_shards=4,
                            mesh=["cpu"] * 4, n_valids=n_valids,
                            collect_stats=True)
    _assert_stream_same(want, got, one, ops)


def test_streaming_aggregator_per_shard_pushes(port):
    """Pre-cut [4, 32] pushes: every push and the flush equal JAX's
    sharded aggregator's and the port's one-device aggregator's."""
    g, k = sorted_stream(np.random.default_rng(15), 512, 9)
    sh = JaxAggregator("sum", num_shards=4)
    batches = [(g[lo:lo + 128].reshape(4, 32), k[lo:lo + 128].reshape(4, 32))
               for lo in range(0, 512, 128)]
    got, flush = port.aggregator_stream("sum", batches, backend="reference",
                                        num_shards=4)
    one, one_flush = port.aggregator_stream(
        "sum", [(gb.reshape(-1), kb.reshape(-1)) for gb, kb in batches],
        backend="reference")
    fields = ("groups", "values", "valid", "num_groups", "rr_port")
    for (gb, kb), o, r in zip(batches, got, one):
        want = sh.push(jnp.array(gb), jnp.array(kb))
        for name in fields:
            assert_same(getattr(want, name), o[name], name=name)
            assert_same(r[name], o[name], name=name)
    want = sh.flush()
    for name in fields:
        assert_same(getattr(want, name), flush[name], name=name)
        assert_same(one_flush[name], flush[name], name=name)
