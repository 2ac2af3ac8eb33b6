"""The port's groupagg kernel module against the JAX package's
``groupagg_pallas`` (Pallas interpret mode) on the CPU.

On CPU tensors the port's wrapper runs the kernel's plain torch version;
its per-tile outputs ``og``/``ov``/``oc`` must equal the TPU kernel's,
padded lanes included (float sums/means within rtol = atol = 1e-5: the
pending run is folded across tiles in another order).  The port runs in
its own process (``_torch_parity.port``).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from _torch_parity import assert_same, port  # noqa: F401 (fixture)
from _torch_parity import oracle_jit
from repro.core import engine as jax_engine
from repro.core.combiners import get_combiner as jax_combiner
from repro.core.engine import PAD_GROUP
from repro.core.engine import _group_by_aggregate as jax_group_by
from repro.kernels.groupagg.kernel import groupagg_pallas
from repro.kernels.groupagg.ops import \
    _groupagg_kernel_exec as jax_groupagg_exec
from repro_torch.interop import make_stream

#: the JAX reference engine, compiled once per op (a fixed stream length
#: with ``n_valid`` keeps the property test to one compile per op)
_jax_group_by = oracle_jit(jax_group_by, static_argnums=2)
_LEN = 256
FIELDS = ("groups", "values", "valid", "num_groups")


def _closed(g, k, tile):
    """Pad to a tile multiple plus one PAD_GROUP tile, as the exec does."""
    pad = (-g.shape[0]) % tile + tile
    return (np.concatenate([g, np.full(pad, PAD_GROUP, np.int32)]),
            np.concatenate([k, np.zeros(pad, k.dtype)]))


@pytest.mark.parametrize("op,dtype,n,tile,groups", [
    ("sum", np.int32, 200, 32, 5),            # runs span many tiles
    ("distinct_count", np.int32, 120, 16, 9),
    ("mean", np.float32, 100, 32, 3),
    ("min", np.int32, 64, 64, 1),              # one group, one tile
])
def test_groupagg_per_tile_outputs_match_pallas(port, op, dtype, n, tile,
                                                groups):
    g, k = make_stream(n, n, groups, 20, dtype=dtype, sorted_by="group_key")
    g, k = _closed(g, k, tile)
    comb = jax_combiner(op)
    out_dt = jax.eval_shape(lambda x: comb.finalize(comb.lift(x)),
                            jnp.array(k)).dtype
    wg, wv, wc = groupagg_pallas(jnp.array(g)[None], jnp.array(k)[None],
                                 comb, tile=tile, out_dtype=out_dt,
                                 interpret=True)
    og, ov, oc = port.groupagg(g, k, op, tile)
    assert_same(wc, oc, name="oc")
    assert_same(wg, og, name="og")
    assert_same(wv, ov, name=op, float_keys=dtype == np.float32)


@pytest.mark.parametrize("op", ["max", "count", "first", "last",
                                "variance"])
def test_groupagg_exec_matches_pallas_exec(port, op):
    g, k = make_stream(7, 150, 6, 30, sorted_by="group_key")
    want = jax_groupagg_exec(jnp.array(g), jnp.array(k), op, n_valid=131,
                             tile=32, interpret=True)
    got = port.groupagg_exec(g, k, op, 32, n_valid=131)
    for field in FIELDS:
        assert_same(getattr(want, field), getattr(got, field), name=field)


def test_groupagg_exec_multi_op_matches_single_op_pallas_exec(port):
    # one call for three ops over a ragged stream (N = 203, tiles of 32)
    # masked past n_valid: each op as the JAX exec gives it alone
    ops = ("sum", "distinct_count", "mean")
    g, k = make_stream(9, 203, 8, 30, sorted_by="group_key")
    got = port.groupagg_exec_multi(g, k, ops, 32, n_valid=170)
    assert list(got) == list(ops)
    for op in ops:
        want = jax_groupagg_exec(jnp.array(g), jnp.array(k), op, n_valid=170,
                                 tile=32, interpret=True)
        for field in FIELDS:
            assert_same(getattr(want, field), getattr(got[op], field),
                        name=f"{op} {field}")


def test_groupagg_int32_sum_wraps_like_jax(port):
    g = np.zeros(_LEN, np.int32)
    k = np.full(_LEN, 1 << 24, np.int32)  # 256 * 2^24 = 2^32 wraps to 0
    want = _jax_group_by(jnp.array(g), jnp.array(k), "sum")
    got = port.groupagg_exec(g, k, "sum", 16)
    assert int(want.values[0]) == int(got.values[0]) == 0
    assert_same(want.values, got.values, name="sum")


def test_groupagg_rejects_position_ops(port):
    g = np.zeros(32, np.int32)
    with pytest.raises(NotImplementedError, match="global iota"):
        port.groupagg(g, g, "argmin", 32)


def _leaves(tree):
    """Nested tuples/dicts of arrays -> flat list (dicts in key order)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


@functools.partial(oracle_jit, static_argnums=(2, 3))
def _jax_two_chunks(g, k, ops, split, n_valid):
    r1, c1 = jax_engine.multi_engine_step(g[:split], k[:split], ops,
                                          open_tail=True)
    r2, c2 = jax_engine.multi_engine_step(g[split:], k[split:], ops,
                                          carries=c1, n_valid=n_valid)
    return r1, r2, c2


def test_engine_carries_and_open_tail_match_jax(port):
    # the group open at the split is withheld by the first chunk and folded
    # into the second through the carries; the second chunk ends in padding
    ops = ("sum", "distinct_count", "mean", "min")
    g, k = make_stream(8, 160, 7, 30, sorted_by="group_key")
    assert g[69] == g[70]
    want = _leaves(_jax_two_chunks(jnp.array(g), jnp.array(k), ops, 70, 75))
    got = _leaves(port.engine_two_chunks(g, k, ops, 70, 75))
    assert len(want) == len(got)
    for i, (w, o) in enumerate(zip(want, got)):
        assert_same(w, o, name=f"leaf {i}")


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       op=st.sampled_from(("sum", "min", "distinct_count")),
       tile=st.sampled_from((8, 32)))
def test_property_groupagg_exec_vs_jax_engine(port, seed, op, tile):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, _LEN + 1))
    g, k = make_stream(seed, _LEN, int(rng.integers(1, 40)), 50,
                       sorted_by="group_key")
    want = _jax_group_by(jnp.array(g), jnp.array(k), op, n_valid=n)
    got = port.groupagg_exec(g, k, op, tile, n_valid=n)
    for field in FIELDS:
        assert_same(getattr(want, field), getattr(got, field), name=field)
