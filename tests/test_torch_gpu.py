"""The port's CUDA kernels against their plain torch versions, on the card.

Needs a CUDA card and imports neither JAX nor the JAX package (the machine
with the card has no JAX), so it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a card every test skips; torch is imported inside the tests, so
collecting this file elsewhere loads nothing of it.  Tolerance: integer
keys and the order-free ops (min, max, count, distinct_count, median,
first, last, argmin, argmax) must match exactly; float sums, means and
variances are reduced in another order by the kernels (thread-local runs,
then warp and block scans), so they get rtol = atol = 1e-5.
"""
from __future__ import annotations

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

INEXACT = ("sum", "mean", "variance")
PAD_GROUP = 2**31 - 1
ALL_WINDOW_OPS = ("sum", "min", "max", "count", "mean", "distinct_count",
                  "first", "last", "variance", "argmin", "argmax", "median")


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def assert_same(got, want, *, inexact=False, what=""):
    import torch

    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if inexact and got.dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, msg=what)
    else:
        assert torch.equal(got, want), what


def _stream(seed, n, n_groups, dtype, sorted_by, device):
    from repro_torch.interop import from_numpy, make_stream

    return from_numpy(*make_stream(seed, n, n_groups, 50, dtype=dtype,
                                   sorted_by=sorted_by), device)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", ["sum", "min", "max", "count", "mean",
                                "distinct_count", "first", "last",
                                "variance"])
@pytest.mark.parametrize("n,tile,groups", [
    (4096, 1024, 3), (2048, 128, 40), (640, 32, 7), (8192, 4096, 1),
    (96, 1, 5)])
def test_groupagg_kernel_vs_plain(cuda, op, dtype, n, tile, groups):
    import torch

    from repro_torch.kernels.groupagg import kernel as gk

    g, k = _stream(n + groups, n, groups, dtype, "group_key", cuda)
    g = torch.cat([g, torch.full((tile,), PAD_GROUP, dtype=torch.int32,
                                 device=cuda)])
    k = torch.cat([k, torch.zeros((tile,), dtype=k.dtype, device=cuda)])
    want = gk.groupagg_plain(g, k, op, tile=tile)
    got = gk.groupagg(g, k, op, tile=tile)
    torch.cuda.synchronize()
    assert_same(got[2], want[2], what="oc")
    assert_same(got[0], want[0], what="og")
    assert_same(got[1], want[1], inexact=op in INEXACT, what="ov")


def test_groupagg_int32_sum_wraps(cuda):
    import torch

    from repro_torch.kernels.groupagg import kernel as gk

    n = 1 << 16
    g = torch.cat([torch.zeros((n,), dtype=torch.int32),
                   torch.full((1024,), PAD_GROUP, dtype=torch.int32)])
    k = torch.cat([torch.full((n,), 1 << 16, dtype=torch.int32),
                   torch.zeros((1024,), dtype=torch.int32)])
    og, ov, oc = gk.groupagg(g.to(cuda), k.to(cuda), "sum", tile=1024)
    want = gk.groupagg_plain(g, k, "sum", tile=1024)
    assert_same(ov, want[1], what="wrapped int32 sum")
    assert int(want[1][-1, 0]) == 0  # 2^32 wraps to 0


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("ws,wa", [(64, 16), (1024, 256), (4096, 1024),
                                   (16, 16), (16384, 16384)])
def test_swag_kernels_vs_plain(cuda, dtype, ws, wa):
    import torch

    from repro_torch.kernels.swag import kernel as sk

    n = ws + 3 * wa + 5
    g, k = _stream(ws, n, 9, dtype, None, cuda)
    fg, fk = g.unfold(0, ws, wa), k.unfold(0, ws, wa)
    got = sk.swag(fg, fk, ALL_WINDOW_OPS)
    want = sk.swag_plain(fg, fk, ALL_WINDOW_OPS)
    torch.cuda.synchronize()
    assert_same(got[2], want[2], what="oc")
    assert_same(got[0], want[0], what="og")
    for name in ALL_WINDOW_OPS:
        assert_same(got[1][name], want[1][name], inexact=name in INEXACT,
                    what=name)

    p = ws // wa
    np_ = (n - ws) // wa + p
    pg = g[:np_ * wa].reshape(np_, wa)
    pk = k[:np_ * wa].reshape(np_, wa)
    sg, skk = sk.sort_panes(pg, pk)
    wg, wk = sk.sort_panes_plain(pg, pk)
    assert_same(sg, wg, what="sorted pane groups")
    assert_same(skk, wk, what="sorted pane keys")
    got = sk.swag_panes(sg, skk, ALL_WINDOW_OPS, p=p)
    want = sk.swag_panes_plain(wg, wk, ALL_WINDOW_OPS, p=p)
    torch.cuda.synchronize()
    assert_same(got[2], want[2], what="panes oc")
    assert_same(got[0], want[0], what="panes og")
    for name in ALL_WINDOW_OPS:
        assert_same(got[1][name], want[1][name], inexact=name in INEXACT,
                    what=f"panes {name}")


def test_swag_rejects_rows_past_shared_memory(cuda):
    import torch

    from repro_torch.kernels.swag import kernel as sk

    g = torch.zeros((1, 2 * sk.MAX_ROW), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        sk.swag(g, g, ("sum",))


@pytest.mark.parametrize("backend,window", [
    ("cuda", None), ("cuda", (1024, 256)), ("cuda-panes", (4096, 1024)),
    ("cuda-panes", (256, 256))])
def test_execute_on_card_matches_reference(cuda, backend, window):
    import torch

    from repro_torch.interop import make_stream
    from repro_torch.query import Query, Window, execute

    ops = ("min", "max", "sum", "count", "dc") + (
        ("median",) if window is not None else ())
    g, k = make_stream(3, 20000, 37, 1000,
                       sorted_by="group_key" if window is None else None)
    q = Query(ops=ops, window=None if window is None else Window(*window))
    got, _ = execute(q, g, k, backend=backend)
    want, _ = execute(q, g, k, backend="reference")
    assert_same(got.groups, want.groups, what="groups")
    assert_same(got.valid, want.valid, what="valid")
    assert_same(got.num_groups, want.num_groups, what="num_groups")
    # valid lanes only: past num_groups the reference's median column holds
    # the key its clipped rank pick read, the kernels' a zero (as in JAX)
    for name in want.values:
        assert_same(torch.where(want.valid, got.values[name], 0),
                    torch.where(want.valid, want.values[name], 0), what=name)
