"""Edge streams for the window kernels' tests (numpy only).

Framed into windows of WS lanes, or cut into WA-lane panes, each case hits
one identity that the swag kernel's tails rest on: a window that is one
segment, a window of WS one-lane segments (``oc == WS``), windows of
padding only (as time frames give), int32 sums that wrap, keys at the
int32 extremes, and float keys with repeats and both signed zeros.
"""
from __future__ import annotations

import numpy as np

PAD_GROUP = 2**31 - 1
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1

#: case -> key dtype
EDGE_CASES = {
    "one_group": np.int32,
    "distinct_groups": np.int32,
    "all_pad": np.int32,
    "wrapping_sums": np.int32,
    "int32_extremes": np.int32,
    "signed_zeros": np.float32,
}


def edge_stream(case: str, n: int, seed: int = 0):
    """``n`` (group, key) tuples of ``case``: (int32 groups, keys)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-50, 50, n)
    if case == "one_group":
        groups = np.zeros(n)
    elif case == "distinct_groups":
        groups = rng.permutation(n)
    elif case == "all_pad":
        groups = np.full(n, PAD_GROUP)
    elif case == "wrapping_sums":
        # two groups of keys near 2^30: a group's sum wraps past 4 lanes
        groups = rng.integers(0, 2, n)
        keys = (1 << 30) + rng.integers(0, 4, n)
    elif case == "int32_extremes":
        groups = rng.integers(0, 3, n)
        keys = rng.choice(np.array([INT32_MIN, INT32_MIN + 1, -1, 0,
                                    INT32_MAX - 1, INT32_MAX]), n)
    elif case == "signed_zeros":
        groups = rng.integers(0, 3, n)
        keys = rng.choice(np.array([0.0, -0.0, 0.5, -0.5, 1.0]), n)
    else:
        raise ValueError(f"no edge case {case!r}")
    return groups.astype(np.int32), keys.astype(EDGE_CASES[case])
