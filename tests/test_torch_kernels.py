"""The port's standalone sort and scan entry points against the JAX
package: ``bitonic_sort_cuda`` / ``sort_pairs_cuda`` against
``bitonic_sort_tpu`` / ``sort_pairs_tpu`` (Pallas interpret mode), and
``segmented_scan_cuda`` against ``segmented_scan_ref``, on the CPU, where
the wrappers run their kernels' plain versions.

Tolerance: every array equal — payloads under tied keys included, since
the port's network swaps where the TPU network swaps — except float
sum/mean scans, which reduce in another order: rtol = atol = 1e-5.  The
port runs in its own process (``_torch_parity.port``).
"""
from __future__ import annotations

import numpy as np
import pytest

from _torch_parity import port  # noqa: F401 (fixture)
from _torch_parity import oracle_jit

SCAN_OPS = ("sum", "min", "max", "count", "mean", "distinct_count")


def test_bitonic_rows_with_ties_and_payloads_match_jax(port):
    import jax.numpy as jnp

    from repro.kernels.bitonic.ops import bitonic_sort_tpu

    rng = np.random.default_rng(0)
    # few distinct (group, key) pairs: most lanes tie, and the payloads
    # (a float and an index) show where the network moved each lane
    g = rng.integers(0, 3, (5, 64)).astype(np.int32)
    k = rng.integers(0, 4, (5, 64)).astype(np.int32)
    pay = rng.normal(size=(5, 64)).astype(np.float32)
    idx = np.tile(np.arange(64, dtype=np.int32), (5, 1))
    ops = (g, k, pay, idx)
    want = bitonic_sort_tpu(tuple(jnp.asarray(o) for o in ops), num_keys=2,
                            interpret=True)
    got = port.bitonic_sort_cuda(ops, 2)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"op {i}")


def test_bitonic_one_row_float_keys_match_jax(port):
    import jax.numpy as jnp

    from repro.kernels.bitonic.ops import bitonic_sort_tpu

    rng = np.random.default_rng(1)
    k = (rng.integers(-3, 3, 128) * 0.5).astype(np.float32)
    k[::9] = -0.0  # ties between -0.0 and 0.0 never swap
    pay = np.arange(128, dtype=np.int32)
    want = bitonic_sort_tpu((jnp.asarray(k), jnp.asarray(pay)), num_keys=1,
                            interpret=True)
    got = port.bitonic_sort_cuda((k, pay), 1)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"op {i}")
        assert a.dtype == np.asarray(b).dtype


def test_bitonic_nan_and_zero_ties_match_jax(port):
    import jax.numpy as jnp

    from repro.kernels.bitonic.ops import bitonic_sort_tpu

    rng = np.random.default_rng(3)
    # two float keys from a few values: ties everywhere, -0.0 beside 0.0
    # (equal, so never swapped) and NaN in either key position (neither
    # less nor equal, so it ends the compare); the lane index shows where
    # the network moved each lane
    vals = np.array([-1.0, -0.0, 0.0, 0.5, np.nan], np.float32)
    k1 = vals[rng.integers(0, 5, (2, 128))]
    k2 = vals[rng.integers(0, 5, (2, 128))]
    k1[0, :4], k2[0, :4] = np.nan, 0.0   # NaN first key, tied second
    k2[1, :4], k1[1, :4] = np.nan, -0.0  # NaN second key behind a tie
    idx = np.tile(np.arange(128, dtype=np.int32), (2, 1))
    ops = (k1, k2, idx)
    want = bitonic_sort_tpu(tuple(jnp.asarray(o) for o in ops), num_keys=2,
                            interpret=True)
    got = port.bitonic_sort_cuda(ops, 2)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.dtype == b.dtype
        # bit patterns: NaN positions and the sign of each zero included
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=f"op {i}")


@pytest.mark.parametrize("full_width", [True, False])
def test_sort_pairs_match_jax(port, full_width):
    import jax.numpy as jnp

    from repro.kernels.bitonic.ops import sort_pairs_tpu

    rng = np.random.default_rng(2)
    g = rng.integers(0, 23, 500).astype(np.int32)
    k = (rng.normal(size=500) * 50).astype(np.float32)
    want = sort_pairs_tpu(jnp.asarray(g), jnp.asarray(k),
                          full_width=full_width, interpret=True)
    got = port.sort_pairs_cuda(g, k, full_width)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def _scan_case(rng, n, n_groups, dtype, op):
    g = np.sort(rng.integers(0, n_groups, n)).astype(np.int32)
    if dtype == np.float32:
        # positive keys: prefix sums grow, so no sum cancels to near zero,
        # where reordered float additions differ by more than 1e-5
        k = rng.uniform(0, 50, n).astype(np.float32)
    else:
        k = rng.integers(0, 100, n).astype(np.int32)
    if op == "distinct_count":  # needs keys sorted within groups
        order = np.lexsort((k, g))
        g, k = g[order], k[order]
    return np.concatenate([[True], g[1:] != g[:-1]]), k


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", SCAN_OPS)
def test_segmented_scan_matches_jax_ref(port, op, dtype):
    import jax
    import jax.numpy as jnp

    from repro.core.combiners import get_combiner
    from repro.kernels.segscan.ref import segmented_scan_ref

    rng = np.random.default_rng(SCAN_OPS.index(op))
    # 1000 lanes in tiles of 128 (the last one padded), 11 segments; and
    # 1024 lanes of one segment over eight tiles, the carry path, with
    # integer-valued keys: every partial sum is exact in float32 too, so
    # the carry is held exactly whatever the order of the additions
    one = np.sort(rng.integers(0, 10, 1024)).astype(dtype)
    cases = [(_scan_case(rng, 1000, 11, dtype, op), 128),
             ((np.eye(1, 1024, dtype=bool)[0], one), 128)]
    comb = get_combiner(op)
    for (flags, k), tile in cases:
        state = comb.lift(jnp.asarray(k))
        want = jax.tree.leaves(oracle_jit(
            lambda f, s: segmented_scan_ref(f, s, op))(
                jnp.asarray(flags), state))
        leaves = tuple(np.asarray(x) for x in jax.tree.leaves(state))
        got, launches = port.segmented_scan_cuda(flags, leaves, op, tile)
        assert launches == 0  # CPU tensors: the plain version
        assert len(got) == len(want)
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert a.dtype == b.dtype
            if dtype == np.float32 and op in ("sum", "mean"):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(a, b)
