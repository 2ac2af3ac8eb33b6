"""The slice's count windows as a whole: ``repro_torch.query.execute(...,
device="cpu")`` with a ``Window`` under ``reference``, ``cuda`` and
``cuda-panes`` against ``repro.query.execute`` under ``reference``,
``pallas`` and ``pallas-panes`` (Pallas interpret mode), on the same numpy
inputs.

Int32 keys: every array equal, padded tails included (float keys are in
``test_torch_query.py``).  The port runs in its own process
(``_torch_parity.port``).
"""
from __future__ import annotations

import numpy as np
import pytest

from _torch_parity import assert_result_same, port  # noqa: F401 (fixture)
from _torch_parity import execute_both
from repro_torch.interop import make_stream

DC_OPS = ("min", "max", "sum", "count", "dc")


@pytest.mark.parametrize("backend", ["reference", "cuda", "cuda-panes"])
@pytest.mark.parametrize("window", [
    {"ws": 16},                   # wa == ws (tumbling)
    {"ws": 16, "wa": 4},          # wa < ws: re-sort on cuda, panes else
])
def test_windows_match_jax(port, backend, window):
    g, k = make_stream(12, 120, 6, 30)
    want, got = execute_both(port, DC_OPS + ("mean", "median"), g, k,
                             backend=backend, window=window)
    assert_result_same(want, got)


def test_reference_single_op_paths_match_jax(port):
    g, k = make_stream(13, 150, 5, 30)
    for ops, window in ((("sum",), {"ws": 32, "wa": 8, "panes": False}),
                        (("sum",), {"ws": 32, "wa": 8}),
                        (("median",), {"ws": 16, "wa": 4}),
                        (("dc",), {"ws": 16, "wa": 4})):
        want, got = execute_both(port, ops, g, k, backend="reference",
                                 window=window)
        assert_result_same(want, got)


def test_library_sort_equals_the_network(port):
    # the re-sort path's windows, sorted by the network and by the library
    g, k = make_stream(16, 96, 4, 8)
    fg = np.lib.stride_tricks.sliding_window_view(g, 32)[::8]
    fk = np.lib.stride_tricks.sliding_window_view(k, 32)[::8]
    net, lib = port.sort_pairs(fg, fk, True)
    for a, b in zip(net, lib):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["reference", "cuda", "cuda-panes"])
def test_stream_shorter_than_one_window(port, backend):
    g, k = make_stream(15, 20, 3, 10)
    want, got = execute_both(port, ("sum", "median"), g, k, backend=backend,
                             window={"ws": 32, "wa": 8})
    assert got.groups.shape == (0, 32)
    assert_result_same(want, got)
