"""The port's swag kernel module against the JAX package's ``swag_pallas``,
``sort_panes_pallas`` and ``swag_pallas_panes`` (Pallas interpret mode) on
the CPU.

On CPU tensors the port's wrappers run the kernels' plain torch versions;
every output (``og``, each op's ``ov``, ``oc``) must equal the TPU
kernel's, padded lanes included.  Float keys: sum/mean/variance within
rtol = atol = 1e-5, every other op exact.  The port runs in its own
process (``_torch_parity.port``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from _swag_edges import EDGE_CASES, edge_stream
from _torch_parity import assert_same, port  # noqa: F401 (fixture)
from _torch_parity import oracle_jit
from repro.core import sorter as jax_sorter
from repro.kernels.swag import kernel as jk
from repro.kernels.swag.ops import \
    _engine_median_kernel_exec as jax_engine_median
from repro_torch.interop import make_stream

OPS = ("sum", "min", "max", "count", "mean", "distinct_count", "median")


def _frames(seed, nw, ws, wa, dtype):
    n = ws + (nw - 1) * wa
    g, k = make_stream(seed, n, 6, 25, dtype=dtype)
    idx = np.arange(nw)[:, None] * wa + np.arange(ws)[None, :]
    return g, k, g[idx], k[idx]


def _assert_tails(want, got, ops, float_keys):
    (wg, wvals, wc), (og, ovals, oc) = want, got
    assert_same(wc, oc, name="oc")
    assert_same(wg, og, name="og")
    assert list(wvals) == list(ovals)
    for name in ops:
        assert_same(wvals[name], ovals[name], name=name,
                    float_keys=float_keys)


@pytest.mark.parametrize("dtype,ops", [
    (np.int32, OPS + ("last", "argmin")),
    (np.float32, ("sum", "mean", "variance", "median", "max")),
    (np.int32, ("median",)),                  # median alone supplies og/oc
])
def test_swag_matches_pallas(port, dtype, ops):
    _, _, fg, fk = _frames(1, 5, 32, 8, dtype)
    want = jk.swag_pallas(jnp.array(fg), jnp.array(fk), ops, interpret=True)
    _assert_tails(want, port.swag(fg, fk, ops), ops, dtype == np.float32)


def test_swag_takes_strided_window_rows(port):
    g, k, fg, fk = _frames(2, 6, 16, 4, np.int32)
    _assert_tails(port.swag(fg, fk, OPS),
                  port.swag_unfolded(g, k, 16, 4, OPS), OPS, False)


@pytest.mark.parametrize("dtype,wa,p", [(np.int32, 8, 4), (np.float32, 16, 2),
                                        (np.int32, 16, 1)])
def test_pane_kernels_match_pallas(port, dtype, wa, p):
    nw = 4
    g, k = make_stream(wa * p, (nw + p - 1) * wa, 5, 25, dtype=dtype)
    pg, pk = g.reshape(-1, wa), k.reshape(-1, wa)
    wsg, wsk = jk.sort_panes_pallas(jnp.array(pg), jnp.array(pk),
                                    interpret=True)
    sg, skk = port.sort_panes(pg, pk)
    assert_same(wsg, sg, name="sorted groups")
    assert_same(wsk, skk, name="sorted keys")
    want = jk.swag_pallas_panes(wsg, wsk, OPS, p=p, interpret=True)
    _assert_tails(want, port.swag_panes(sg, skk, OPS, p), OPS,
                  dtype == np.float32)


#: the edge rows' ops: the int32 sum, mean and distinct count that the
#: kernel takes as prefix differences, and the max, median and argmax it
#: reads off a segment's ends (a smaller set keeps the two JAX compiles
#: of this test near 3.5 s each)
EDGE_OPS = ("sum", "max", "count", "mean", "distinct_count", "argmax",
            "median")
EDGE_WS, EDGE_WA = 8, 4


@oracle_jit
def _jax_edge_tails(fg, fk, pg, pk):
    return (jk.swag_pallas(fg, fk, EDGE_OPS, interpret=True),
            jk.swag_pallas_panes(pg, pk, EDGE_OPS, p=EDGE_WS // EDGE_WA,
                                 interpret=True))


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_rows_match_pallas(port, case):
    """The rows the CUDA kernel's tails find hardest, through the JAX
    kernels and the port's plain versions (which the card's tests hold the
    kernel to)."""
    g, k = edge_stream(case, EDGE_WS + 3 * EDGE_WA, seed=7)
    nw = 4
    idx = np.arange(nw)[:, None] * EDGE_WA + np.arange(EDGE_WS)[None, :]
    fg, fk = g[idx], k[idx]
    pg, pk = g.reshape(-1, EDGE_WA), k.reshape(-1, EDGE_WA)
    order = np.lexsort((pk, pg), axis=-1)
    pg = np.take_along_axis(pg, order, -1)
    pk = np.take_along_axis(pk, order, -1)
    # jit hands dicts back in key order: restore the ops' order
    want_rows, want_panes = ((og, {n: ov[n] for n in EDGE_OPS}, oc)
                             for og, ov, oc in _jax_edge_tails(fg, fk, pg,
                                                               pk))
    float_keys = EDGE_CASES[case] == np.float32
    _assert_tails(want_rows, port.swag(fg, fk, EDGE_OPS), EDGE_OPS,
                  float_keys)
    _assert_tails(want_panes,
                  port.swag_panes(pg, pk, EDGE_OPS, EDGE_WS // EDGE_WA),
                  EDGE_OPS, float_keys)
    if case == "distinct_groups":
        assert (np.asarray(want_rows[2]) == EDGE_WS).all()
    if case == "all_pad":
        assert (np.asarray(want_rows[2]) == 0).all()


def test_engine_median_matches_pallas(port):
    g, k = make_stream(4, 100, 7, 30, sorted_by="group_key")
    want = jax_engine_median(jnp.array(g), jnp.array(k), ("median", "sum"),
                             n_valid=90, interpret=True)
    got = port.engine_median(g, k, ("median", "sum"), 90)
    assert_same(want[0], got[0], name="groups")
    assert_same(want[2], got[2], name="valid")
    assert_same(want[3], got[3], name="num_groups")
    for name in ("median", "sum"):
        assert_same(want[1][name], got[1][name], name=name)


_jax_sort_pairs = oracle_jit(jax_sorter.sort_pairs,
                             static_argnames="full_width")
_jax_sort_pairs_xla = oracle_jit(jax_sorter.sort_pairs_xla,
                                 static_argnames="full_width")


@pytest.mark.parametrize("full_width", [True, False])
def test_sort_pairs_match_jax(port, full_width):
    # by group only, the network is not stable: equal output means the same
    # network, compare for compare
    g, k = make_stream(5, 28, 4, 6)
    net, lib = port.sort_pairs(g, k, full_width)
    gj, kj = jnp.array(g), jnp.array(k)
    for want, got in ((_jax_sort_pairs(gj, kj, full_width=full_width), net),
                      (_jax_sort_pairs_xla(gj, kj, full_width=full_width),
                       lib)):
        assert_same(want[0], got[0], name="groups")
        assert_same(want[1], got[1], name="keys")


def test_swag_wrappers_check_their_inputs(port):
    g = np.zeros((2, 12), np.int32)
    with pytest.raises(ValueError, match="power-of-two"):
        port.swag(g, g, ("sum",))
    g = np.zeros((3, 8), np.int32)
    with pytest.raises(ValueError, match="P <= NP"):
        port.swag_panes(g, g, ("sum",), 4)
