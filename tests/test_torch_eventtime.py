"""The port's batch time-range windows (``Window(range=R, slide=S)``)
against the JAX package on the same numpy inputs: the layout, the framing,
the two-stack's epoch schedule and flip scans, and whole queries through
``repro_torch.query.execute(..., timestamps=...)`` on the CPU under
``reference`` and ``cuda`` (whose wrappers run the kernels' plain versions
on CPU tensors).

Tolerance: every array equal (int32 keys, and float min/max/count);
float sum/mean within rtol = atol = 1e-5 (``_torch_parity``).  The JAX
side of a time query frames its windows from the concrete timestamps (its
window count and width are shapes), so whole queries are jitted with the
timestamps closed over as constants, once a case; the streams stay small
(N <= 512, wcap <= 64) and the Pallas kernel runs once, in interpret mode,
as the JAX package's own test does.  The port runs in its own process
(``_torch_parity.port``).
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

from _torch_parity import assert_result_same, assert_same
from _torch_parity import oracle_jit
from _torch_parity import port  # noqa: F401 (fixture)
from repro_torch.interop import make_time_stream

PAD_GROUP = 2**31 - 1
TWOSTACK_OPS = ("sum", "count", "min", "max")
GROUPED_OPS = ("min", "max", "sum", "count", "dc", "median", "mean")


def _stream(seed, n, offset=0, density=0.875, jitter=16):
    g, k, ts = make_time_stream(seed, n, 5, 200, density, jitter)
    return g, k - 100, (ts + offset).astype(np.int32)


#: (timestamps, range, slide): a dense stream, gaps (a sparse stream whose
#: slides leave windows empty), slide > range (sampling), negative
#: timestamps, an empty stream, one tuple
LAYOUT_CASES = {
    "dense": (_stream(1, 300)[2], 40, 10),
    "gaps": (np.sort(np.random.default_rng(2).choice(
        np.arange(0, 2000, 7), 60, replace=False)).astype(np.int32), 30, 20),
    "slide_gt_range": (_stream(3, 200)[2], 10, 25),
    "negative": (_stream(4, 300, offset=-517)[2], 64, 16),
    "empty": (np.zeros(0, np.int32), 16, 4),
    "one": (np.array([-3], np.int32), 16, 4),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_layout_framing_and_epochs_match_jax(port, case):
    import jax.numpy as jnp

    from repro.core import eventtime as et
    from repro.core import twostack as t2

    ts, rng_, slide = LAYOUT_CASES[case]
    want = et.time_window_layout(et.concrete_timestamps(ts), rng_, slide)
    got, got_epochs = port.time_layout(ts, rng_, slide)
    for name, a, b in zip(want._fields, got, want):
        if name == "wcap":
            assert a == b
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    if case == "gaps":
        assert (want.ends == want.starts).any()  # empty windows frame too
    epochs = t2.epoch_layout(want.starts, want.ends)
    for name, a, b in zip(epochs._fields, got_epochs, epochs):
        np.testing.assert_array_equal(a, b, err_msg=name)

    n = ts.shape[0]
    g = np.arange(n, dtype=np.int32) % 3
    k = np.arange(n, dtype=np.int32) * 7 - 50
    fwant = et.frame_time_windows(want, jnp.asarray(g[want.order]),
                                  jnp.asarray(k[want.order]), PAD_GROUP)
    fgot = port.frame_time(ts, g, k, rng_, slide, PAD_GROUP)
    for name, a, b in zip(("groups", "keys", "counts"), fgot, fwant):
        assert_same(b, a, name=name)


def test_too_many_windows_raises_like_jax(port):
    from repro.core import eventtime as et

    ts = np.array([0, et.MAX_TIME_WINDOWS + 5], np.int32)
    with pytest.raises(ValueError, match="windows over this batch"):
        et.time_window_layout(ts.astype(np.int64), 4, 1)
    with pytest.raises(ValueError, match="windows over this batch"):
        port.time_layout(ts, 4, 1)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_flip_scans_match_jax(port, dtype):
    import jax.numpy as jnp

    from repro.core import twostack as t2

    rng = np.random.default_rng(5)
    ne, wcap = 6, 64
    if dtype == np.int32:
        kf, kb = (rng.integers(-2**31, 2**31 - 1, (ne, wcap)).astype(dtype)
                  for _ in range(2))
    else:
        kf, kb = ((rng.normal(size=(ne, wcap)) * 100).astype(dtype)
                  for _ in range(2))
    lane = np.arange(wcap)[None, :]
    nf, nb = rng.integers(0, wcap + 1, ne), rng.integers(0, wcap + 1, ne)
    nf[0], nb[1], nf[2] = 0, 0, wcap  # an empty front, empty back, full row
    vf, vb = lane < nf[:, None], lane < nb[:, None]
    want = oracle_jit(lambda *a: t2.flip_scans(*a, TWOSTACK_OPS,
                                               jnp.dtype(dtype)))(
        kf, vf, kb, vb)
    got = port.flip_scans(kf, vf, kb, vb, TWOSTACK_OPS)
    for name in TWOSTACK_OPS:
        for side in (0, 1):
            assert_same(want[name][side], got[name][side], name=name,
                        float_keys=dtype == np.float32)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_twostack_flip_arbitrary_masks_match_jax(port, dtype):

    from repro.kernels.swag.kernel import twostack_flip_pallas

    rng = np.random.default_rng(6)
    ne, wcap = 3, 64
    if dtype == np.int32:
        kf, kb = (rng.integers(-2**31, 2**31 - 1, (ne, wcap)).astype(dtype)
                  for _ in range(2))
    else:
        kf, kb = ((rng.normal(size=(ne, wcap)) * 100).astype(dtype)
                  for _ in range(2))
    # live lanes anywhere in the row, not a prefix as _region makes them
    vf, vb = (rng.random((ne, wcap)) < 0.5 for _ in range(2))
    want = oracle_jit(lambda *a: twostack_flip_pallas(
        *a, TWOSTACK_OPS, interpret=True))(kf, vf, kb, vb)
    got = port.flip_scans(kf, vf, kb, vb, TWOSTACK_OPS)
    for name in TWOSTACK_OPS:
        for side in (0, 1):
            assert_same(want[name][side], got[name][side], name=name,
                        float_keys=dtype == np.float32)


#: (ops, group_by, key dtype, window): the two-stack (int32 and float32
#: keys, a sampling slide), and grouped replay with median and dc
QUERY_CASES = [
    (TWOSTACK_OPS, False, np.int32, dict(range=48, slide=16)),
    (TWOSTACK_OPS, False, np.float32, dict(range=48, slide=16)),
    (("min", "max"), False, np.int32, dict(range=10, slide=30)),
    (GROUPED_OPS, True, np.int32, dict(range=40, slide=20)),
]


def _query_case(case):
    ops, group_by, dtype, window = QUERY_CASES[case]
    g, k, ts = _stream(10 + case, 400, offset=-200)
    k = k.astype(dtype) / (3 if dtype == np.float32 else 1)
    return ops, group_by, dtype, window, g if group_by else None, k, ts


@functools.lru_cache(maxsize=None)
def _jax_query_case(case):
    """The JAX reference result of a query case, computed once a process:
    one jit of the whole query (the timestamps, which frame the windows on
    the host, closed over as constants); eager, every primitive of the
    grouped replay compiles on its own."""
    from repro import query as jq

    ops, group_by, _, window, g_in, k, ts = _query_case(case)
    q = jq.Query(ops=ops, group_by=group_by, window=jq.Window(**window))
    return oracle_jit(lambda g, k: jq.execute(
        q, g, k, backend="reference", timestamps=ts)[0])(g_in, k)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("case", range(len(QUERY_CASES)))
def test_execute_matches_jax_reference(port, case, backend):
    ops, group_by, dtype, window, g_in, k, ts = _query_case(case)
    want = _jax_query_case(case)
    got = port.execute(ops, g_in, k, backend=backend, window=window,
                       query={"group_by": group_by}, timestamps=ts)
    assert_result_same(want, got, float_keys=dtype == np.float32)


def test_twostack_kernel_path_matches_pallas_interpret(port):
    # the case of the JAX package's own two-stack kernel test
    from repro import query as jq

    rng = np.random.default_rng(0)
    k = rng.integers(-500, 500, 180).astype(np.int32)
    t = rng.integers(0, 600, 180).astype(np.int32)
    window = dict(range=100, slide=25)
    q = jq.Query(ops=("min", "max"), group_by=False,
                 window=jq.Window(**window))
    want, _ = jq.execute(q, None, k, backend="pallas", timestamps=t,
                         interpret=True)
    got = port.execute(("min", "max"), None, k, backend="cuda",
                       window=window, query={"group_by": False},
                       timestamps=t)
    assert_result_same(want, got)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_both_strategies_agree_on_the_port(port, backend):
    # the two-stack against replay of the same windows, on the port alone
    g, k, ts = _stream(20, 500, offset=-1000, jitter=40)
    res = {}
    for strategy in ("twostack", "replay"):
        res[strategy] = port.execute(
            TWOSTACK_OPS, None, k, backend=backend,
            window=dict(range=64, slide=16, strategy=strategy),
            query={"group_by": False}, timestamps=ts)
    live = res["twostack"].valid[:, 0]
    np.testing.assert_array_equal(live, res["replay"].valid[:, 0])
    for name in TWOSTACK_OPS:
        np.testing.assert_array_equal(res["twostack"].values[name][live, 0],
                                      res["replay"].values[name][live, 0])


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("ops,group_by", [(TWOSTACK_OPS, False),
                                          (GROUPED_OPS, True)])
def test_empty_batch_matches_jax(port, backend, ops, group_by):
    from repro import query as jq

    z = np.zeros(0, np.int32)
    window = dict(range=32, slide=8)
    q = jq.Query(ops=ops, group_by=group_by, window=jq.Window(**window))
    want, _ = jq.execute(q, z if group_by else None, z, backend="reference",
                         timestamps=z)
    got = port.execute(ops, z if group_by else None, z, backend=backend,
                       window=window, query={"group_by": group_by},
                       timestamps=z)
    assert_result_same(want, got)


# ------------------------------------------------ errors (test_eventtime.py)

@pytest.mark.parametrize("window,msg", [
    (dict(range=64, ws=32), "time-bounded"),
    (dict(range=64, ws_per_group={0: 8}), "time-bounded"),
    (dict(range=64, panes=True), "panes is a count-window"),
    (dict(range=64, slide=16, wa=6), "power of two"),
    (dict(range=64, reorder_capacity=48), "reorder_capacity"),
    (dict(range=64, strategy="resort"), "strategy"),
    (dict(range=0), "range must be positive"),
    (dict(range=64, slide=-1), "slide must be positive"),
    (dict(range=64, max_lateness=-1), "max_lateness"),
    (dict(ws=32, slide=8), "event-time parameter"),
    (dict(ws=32, max_lateness=4), "event-time parameter"),
])
def test_window_time_clause_validation(port, window, msg):
    with pytest.raises(ValueError, match=msg):
        port.make_window(**window)


def test_time_clause_defaults_and_store_spec(port):
    from repro import query as jq

    w = jq.Window(range=64)
    spec = w.store_spec()
    want = (w.slide, w.wa, w.max_lateness, w.reorder_capacity, w.is_time,
            spec.is_time, spec.min_capacity, spec.capacity)
    assert port.window_info(dict(range=64)) == want
    assert want[0] == 64 and want[6] == 2
    assert port.window_info(dict(range=100, slide=30, capacity=64))[6:] \
        == (5, 64)


@pytest.mark.parametrize("ops,window,query,msg", [
    (("min",), dict(range=64, strategy="twostack"), {}, "group_by=False"),
    (("median",), dict(range=64, strategy="twostack"),
     {"group_by": False}, "replay strategy"),
    (("sum",), dict(range=64), {"presorted": True}, "presorted"),
])
def test_strategy_and_plan_checks(port, ops, window, query, msg):
    for backend in ("reference", "cuda"):
        with pytest.raises(ValueError, match=msg):
            port.plan_backend(ops, backend=backend, window=window,
                              query=query)


def test_backend_probes_for_time_windows(port):
    window = dict(range=64, slide=16)
    with pytest.raises(ValueError, match="re-frame by timestamp"):
        port.plan_backend(("sum",), backend="cuda-panes", window=window)
    with pytest.raises(ValueError, match="per-group windows"):
        port.plan_backend(("sum",), backend="cuda-panestore", window=window)
    with pytest.raises(ValueError, match="lower-median"):
        port.plan_backend(("median",), backend="cuda", window=window,
                          query={"interpolate": True})
    for ops, query in ((TWOSTACK_OPS, {"group_by": False}),
                       (GROUPED_OPS, {})):
        assert port.plan_backend(ops, backend="cuda", window=window,
                                 query=query) == "cuda"
        assert port.plan_backend(ops, window=window, query=query) \
            == "reference"  # auto on the CPU


def test_execute_timestamp_guards(port):
    g, k, ts = _stream(30, 32)
    with pytest.raises(ValueError, match="pass timestamps="):
        port.execute(("sum",), g, k, backend="reference",
                     window=dict(range=64))
    with pytest.raises(ValueError, match="time-range windows"):
        port.execute(("sum",), g, k, backend="reference",
                     window=dict(ws=8), timestamps=ts)
    with pytest.raises(ValueError, match="timestamps length"):
        port.execute(("sum",), g, k, backend="reference",
                     window=dict(range=64), timestamps=ts[:-1])


def test_event_time_streaming_and_sharding_raise(port):
    # event-time streaming is ported (slice 5b, held to the JAX package in
    # test_torch_eventtime_stream.py): the planner serves it and a time
    # clause's reorder buffer is the JAX package's.  Sharding (slice 7a)
    # refuses a batch time window with the JAX package's message; a
    # sharded event-time stream is ported (slice 7b, held to the JAX
    # package in test_torch_eventtime_sharded.py) and plans on both
    # backends
    from repro import query as jq

    g, k, ts = _stream(31, 32)
    stream = {"streaming": True}
    assert port.plan_backend(("sum",), window=dict(range=64),
                             query=stream) == "reference"  # auto on the CPU
    assert port.plan_backend(("sum",), backend="cuda-panestore",
                             window=dict(range=64), query=stream) \
        == "cuda-panestore"
    for window in (dict(range=64, max_lateness=4), dict(range=64),
                   dict(range=64, reorder_capacity=8, max_lateness=0)):
        want = jq.Window(**window).reorder_spec()
        assert port.reorder_spec(window) == (want.capacity,
                                             want.max_lateness)
    with pytest.raises(ValueError, match="batch time-range windows"):
        port.execute(("sum",), g, k, backend="reference",
                     window=dict(range=64), timestamps=ts, num_shards=2)
    with pytest.raises(ValueError, match="batch time-range windows"):
        jq.plan(jq.Query(ops="sum", window=jq.Window(range=64)),
                backend="reference", num_shards=2)
    for backend in ("reference", "cuda-panestore"):
        assert port.plan_sharded(("sum",), backend=backend,
                                 window=dict(range=64), query=stream,
                                 num_shards=2)[0] == backend
    res = port.execute(("sum",), g, k, backend="reference",
                       window=dict(range=64), query=stream, timestamps=ts,
                       num_shards=2)
    assert res.groups.shape == res.valid.shape == res.values["sum"].shape
