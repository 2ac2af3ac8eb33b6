"""The port's CUDA kernels against their plain torch versions, on the card.

Needs a CUDA card and imports neither JAX nor the JAX package (the machine
with the card has no JAX), so it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a card every test skips; torch is imported inside the tests, and
not at all where ``nvidia-smi`` is missing, so collecting or running this
file elsewhere loads nothing of it into a process that holds JAX.  Tolerance: integer
keys and the order-free ops (min, max, count, distinct_count, median,
first, last, argmin, argmax) must match exactly; float sums, means and
variances are reduced in another order by the kernels (thread-local runs,
then warp and block scans, then the look-back across tiles), so they get
rtol = atol = 1e-5.
"""
from __future__ import annotations

import shutil

import numpy as np
import pytest
from _swag_edges import EDGE_CASES, edge_stream

pytestmark = pytest.mark.gpu

INEXACT = ("sum", "mean", "variance")
PAD_GROUP = 2**31 - 1
ALL_WINDOW_OPS = ("sum", "min", "max", "count", "mean", "distinct_count",
                  "first", "last", "variance", "argmin", "argmax", "median")


@pytest.fixture
def cuda():
    # no NVIDIA driver tool, no card: skip before importing torch, so a
    # test process that also runs the JAX package's tests never loads it
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs a CUDA card (no nvidia-smi)")
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


GROUPAGG_OPS = ("sum", "min", "max", "count", "mean", "distinct_count",
                "first", "last", "variance")
#: the op sets of the flat launch: one op at a time, run (a)'s five, all
FLAT_OP_SETS = [(op,) for op in GROUPAGG_OPS] + [
    ("min", "max", "sum", "count", "distinct_count"), GROUPAGG_OPS]


def _assert_flat(got, want, what):
    (og, ov, valid, num), (wg, wv, wvalid, wnum) = got, want
    assert_same(num, wnum, what=f"{what}: num")
    assert_same(og, wg, what=f"{what}: groups")
    assert_same(valid, wvalid, what=f"{what}: valid")
    assert list(ov) == list(wv), what
    for name, v in wv.items():
        assert_same(ov[name], v, inexact=name in INEXACT,
                    what=f"{what}: {name}")


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("ops", FLAT_OP_SETS,
                         ids=lambda ops: "+".join(ops))
@pytest.mark.parametrize("n,tile,groups,n_valid", [
    (4096, 1024, 3, None), (2000, 128, 40, 1500), (639, 32, 7, None),
    (8192, 4096, 1, 8000), (95, 1, 5, 60), (1000, 256, 600, 0),
    (5000, 2048, 9, "device")])
def test_groupagg_flat_kernel_vs_plain(cuda, ops, dtype, n, tile, groups,
                                       n_valid):
    import torch

    from repro_torch.kernels.groupagg import kernel as gk

    g, k = _stream(n + groups, n, groups, dtype, "group_key", cuda)
    if n_valid == "device":  # read on the card, past n
        n_valid = torch.tensor(n + 3, device=cuda)
    want = gk.groupagg_flat_plain(g, k, ops, tile=tile, n_valid=n_valid)
    got = gk.groupagg_flat(g, k, ops, tile=tile, n_valid=n_valid)
    torch.cuda.synchronize()
    _assert_flat(got, want, f"{ops} n={n} tile={tile} n_valid={n_valid}")


@pytest.mark.parametrize("tile", [128, 1024])
def test_groupagg_one_group_over_many_tiles(cuda, tile):
    # 2^22 lanes of one group at tile 128 are 32,768 tiles, far more than
    # are resident at once: the pending state rides the whole chain
    import torch

    from repro_torch.kernels.groupagg import kernel as gk

    n = 1 << 22
    g = torch.zeros((n,), dtype=torch.int32, device=cuda)
    k = torch.randint(0, 10, (n,), dtype=torch.int32, device=cuda)
    kf = k.float()  # partial sums below 2^24: exact in float32 in any order
    for keys in (k, kf):
        want = gk.groupagg_flat_plain(g, keys, GROUPAGG_OPS, tile=tile)
        got = gk.groupagg_flat(g, keys, GROUPAGG_OPS, tile=tile)
        torch.cuda.synchronize()
        assert int(got[3]) == 1
        _assert_flat(got, want, f"one group, tile {tile}, {keys.dtype}")
    pg = torch.cat([g, torch.full((tile,), PAD_GROUP, dtype=torch.int32,
                                  device=cuda)])
    pk = torch.cat([k, torch.zeros((tile,), dtype=torch.int32, device=cuda)])
    for op in ("sum", "distinct_count"):
        got = gk.groupagg(pg, pk, op, tile=tile)
        want = gk.groupagg_plain(pg, pk, op, tile=tile)
        for a, b, what in zip(got, want, ("og", "ov", "oc")):
            assert_same(a, b, what=f"per tile {op} {what}")


@pytest.mark.parametrize("tile", [1, 32, 1024, 4096])
def test_groupagg_every_lane_its_own_group(cuda, tile):
    import torch

    from repro_torch.kernels.groupagg import kernel as gk

    n = 100_003
    g = torch.arange(n, dtype=torch.int32, device=cuda)
    k = torch.randint(-50, 50, (n,), dtype=torch.int32, device=cuda)
    got = gk.groupagg_flat(g, k, GROUPAGG_OPS, tile=tile)
    torch.cuda.synchronize()
    assert int(got[3]) == n
    _assert_flat(got, gk.groupagg_flat_plain(g, k, GROUPAGG_OPS, tile=tile),
                 f"every lane its own group, tile {tile}")


def test_groupagg_repeated_calls_read_no_stale_status(cuda):
    # the chain's status words are zeroed per call: twenty calls on one
    # stream size all give the first call's result
    import torch

    from repro_torch.core.combiners import get_combiner
    from repro_torch.kernels.groupagg import kernel as gk
    from repro_torch.kernels.segscan import kernel as ssk
    from repro_torch.kernels.segscan.ops import segmented_scan_cuda

    ops = ("min", "max", "sum", "count", "distinct_count")
    g, k = _stream(11, 1 << 20, 300, np.int32, "group_key", cuda)
    want = gk.groupagg_flat_plain(g, k, ops, tile=256)
    flags = torch.cat([torch.ones(1, dtype=torch.bool, device=cuda),
                       g[1:] != g[:-1]])
    swant = ssk.segscan_plain(flags, (k,), get_combiner("sum"))[0]
    for i in range(20):
        _assert_flat(gk.groupagg_flat(g, k, ops, tile=256), want, f"call {i}")
        assert_same(segmented_scan_cuda(flags, k, "sum", tile=256), swant,
                    what=f"segscan call {i}")


def test_groupagg_flat_int32_sum_wraps(cuda):
    # 2^16 keys of 2^16 in one group: 2^32 wraps to 0 through the look-back
    import torch

    from repro_torch.kernels.groupagg import kernel as gk

    n = 1 << 16
    g = torch.zeros((n,), dtype=torch.int32, device=cuda)
    k = torch.full((n,), 1 << 16, dtype=torch.int32, device=cuda)
    for tile in (32, 1024):
        og, ov, valid, num = gk.groupagg_flat(g, k, ("sum", "mean"), tile=tile)
        assert int(num) == 1 and int(og[0]) == 0
        assert int(ov["sum"][0]) == 0
        _assert_flat((og, ov, valid, num), gk.groupagg_flat_plain(
            g, k, ("sum", "mean"), tile=tile), f"wrap, tile {tile}")


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("ws,wa", [
    (64, 16), (1024, 256), (4096, 1024), (16, 16), (16384, 16384),
    (32, 16), (128, 16), (256, 128), (2048, 128), (8192, 1024),
    (16384, 1024)])
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


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
@pytest.mark.parametrize("ws,wa", [(32, 8), (1024, 256), (4096, 1024),
                                   (16384, 1024)])
def test_swag_edge_rows_vs_plain(cuda, case, ws, wa):
    import torch

    from repro_torch.kernels.swag import kernel as sk

    g, k = (torch.from_numpy(x).to(cuda)
            for x in edge_stream(case, ws + 3 * wa, seed=ws))
    fg, fk = g.unfold(0, ws, wa), k.unfold(0, ws, wa)
    pg, pk = g.reshape(-1, wa), k.reshape(-1, wa)
    sg, skk = sk.sort_panes_plain(pg, pk)
    p = ws // wa
    for what, got, want in (
            ("swag", sk.swag(fg, fk, ALL_WINDOW_OPS),
             sk.swag_plain(fg, fk, ALL_WINDOW_OPS)),
            ("swag_panes", sk.swag_panes(sg, skk, ALL_WINDOW_OPS, p=p),
             sk.swag_panes_plain(sg, skk, ALL_WINDOW_OPS, p=p))):
        torch.cuda.synchronize()
        assert_same(got[2], want[2], what=f"{what} oc")
        assert_same(got[0], want[0], what=f"{what} og")
        for name in ALL_WINDOW_OPS:
            assert_same(got[1][name], want[1][name],
                        inexact=name in INEXACT, what=f"{what} {name}")
        if case == "distinct_groups":
            assert bool((got[2] == ws).all()), what
        if case == "all_pad":
            assert bool((got[2] == 0).all()), what


def _zero_mapped(x):
    """``x`` with -0.0 made +0.0, as int32 bits (float32), or ``x``."""
    import torch

    if not x.dtype.is_floating_point:
        return x
    return (x + 0.0).view(torch.int32)


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
@pytest.mark.parametrize("wa", [128, 1024, 4096])
def test_sort_panes_edge_rows_vs_plain(cuda, case, wa):
    # int32 keys element-exact; float32 keys equal once -0.0 is +0.0, and
    # every row holds exactly its input's (group, key bits) pairs
    import torch

    from repro_torch.kernels.swag import kernel as sk

    g, k = (torch.from_numpy(x).to(cuda)
            for x in edge_stream(case, 5 * wa, seed=wa))
    pg, pk = g.reshape(-1, wa), k.reshape(-1, wa)
    got = sk.sort_panes(pg, pk)
    want = sk.sort_panes_plain(pg, pk)
    torch.cuda.synchronize()
    assert_same(got[0], want[0], what="groups")
    assert_same(_zero_mapped(got[1]), _zero_mapped(want[1]), what="keys")

    def pairs(gr, kr):
        words = (gr.to(torch.int64) << 32) | (
            kr.view(torch.int32).to(torch.int64) & 0xffffffff)
        return torch.sort(words, dim=-1).values

    assert_same(pairs(*got), pairs(pg, pk), what="bit patterns")


@pytest.mark.parametrize("kernel", ["swag", "swag_panes"])
@pytest.mark.parametrize("keys", ["negative_zero_row", "signed_zeros"])
def test_swag_signed_zero_contract(cuda, kernel, keys):
    # the documented contract of swag and swag_panes on float keys: every
    # output equals the plain version's bit for bit once -0.0 is mapped to
    # +0.0 (the kernels pack -0.0 as +0.0).  The smallest case: one row,
    # one group, every key -0.0.
    import torch

    from repro_torch.kernels.swag import kernel as sk

    ws, wa = 1024, 256
    if keys == "negative_zero_row":
        g = torch.zeros((ws,), dtype=torch.int32, device=cuda)
        k = torch.full((ws,), -0.0, dtype=torch.float32, device=cuda)
    else:
        g, k = (torch.from_numpy(x).to(cuda)
                for x in edge_stream("signed_zeros", ws + 3 * wa, seed=7))
    if kernel == "swag":
        fg, fk = g.unfold(0, ws, wa), k.unfold(0, ws, wa)
        got = sk.swag(fg, fk, ALL_WINDOW_OPS)
        want = sk.swag_plain(fg, fk, ALL_WINDOW_OPS)
    else:
        sg, skk = sk.sort_panes_plain(g.reshape(-1, wa), k.reshape(-1, wa))
        got = sk.swag_panes(sg, skk, ALL_WINDOW_OPS, p=ws // wa)
        want = sk.swag_panes_plain(sg, skk, ALL_WINDOW_OPS, p=ws // wa)
    torch.cuda.synchronize()
    assert_same(got[0], want[0], what="og")
    assert_same(got[2], want[2], what="oc")
    for name in ALL_WINDOW_OPS:
        a, b = got[1][name], want[1][name]
        if name in INEXACT and keys == "signed_zeros":
            # reduced in another order: the stated tolerance
            assert_same(a, b, inexact=True, what=name)
        else:
            assert_same(_zero_mapped(a), _zero_mapped(b), what=name)


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


# ------------------------------------------------------ per-group windows

PARTIAL_OPS = ("sum", "count", "min", "max", "mean")
DIRECT_OPS = PARTIAL_OPS + ("median", "distinct_count")
#: (wa, capacity, default ws, overrides, tuples, groups, hot groups,
#: start): a squeezed store that evicts, an ample one, the repo's per-group
#: configuration (C = 292, a [C, WA] ring larger than one block's shared
#: memory), and C = 292 under churn: half the tuples from 4 hot groups,
#: which retire panes, the rest from 600 cold ones, which evict.  Then what
#: the scan kernel's batches and tables must survive: every tuple a new
#: group (groups = 0: more than its shared-memory group table holds, every
#: lane of every batch allocating, evictions throughout); one group (every
#: batch of 32 one group) in 37 slots; and scans continued from the final
#: store of a first scan (start = "continued") whose owners include groups
#: the second stream lacks, at WA 128 and at WA 4 under churn.  Capacities
#: 5, 37 and 292 are not multiples of 32.
PERGROUP_CASES = [(4, 5, 8, ((0, 16), (1, 4)), 200, 6, 0, "empty"),
                  (8, 40, 16, ((0, 32), (1, 8)), 320, 5, 0, "empty"),
                  (128, 292, 1024, (), 2048, 64, 0, "empty"),
                  (4, 292, 8, ((0, 16),), 2048, 600, 4, "empty"),
                  (4, 292, 8, ((0, 16), (7, 4)), 6144, 0, 0, "empty"),
                  (128, 37, 1024, ((0, 512),), 4096, 1, 0, "empty"),
                  (128, 300, 512, ((1, 2048), (2, 128)), 4096, 12, 0,
                   "continued"),
                  (4, 292, 8, ((0, 16),), 2048, 600, 4, "continued")]
CHURN, MANY_GROUPS = PERGROUP_CASES[3], PERGROUP_CASES[4]
#: the replay kernels also take panes wider than a warp's 32 x 8 lanes,
#: whose open pane is sorted through shared memory, and rows of 16384
#: lanes (16 a thread)
REPLAY_CASES = PERGROUP_CASES + [(512, 12, 1024, (), 4096, 3, 0, "empty"),
                                 (1024, 20, 15360, (), 20480, 2, 0,
                                  "empty")]


def _pergroup_stream(case, dtype, device):
    """``(spec, state, groups, keys)``: the case's stream and the store it
    starts from."""
    wa, cap, ws, pg, n, ngroups, hot, start = case
    import torch

    from repro_torch.core import panestore as ps

    spec = ps.PaneStoreSpec(wa=wa, capacity=cap, default_ws=ws, per_group=pg)
    if ngroups:
        g, k = _stream(n + cap, n, ngroups, dtype, None, device)
    else:
        _, k = _stream(n + cap, n, 1, dtype, None, device)
        g = torch.arange(n, dtype=torch.int32, device=device)
    if hot:
        pick = np.random.default_rng(n).random(n) < 0.5
        g = torch.where(torch.from_numpy(pick).to(device), g % hot, g)
    state = ps.init_store(spec, k.dtype, device=device)
    if start == "continued":
        # a first stream over ngroups + 6 groups, all but the hot ones
        # moved up by 7: some of its owners are absent from the second
        g1, k1 = _stream(n + 1, n, ngroups + 6, dtype, None, device)
        state = ps.scan(spec, state, (g1 + 7 * (g1 >= hot)).to(torch.int32),
                        k1).final
    return spec, state, g, k
def _assert_trees(got, want, what, inexact=()):
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            assert a is None and b is None, (what, i)
        elif isinstance(a, tuple):
            _assert_trees(a, b, f"{what}[{i}]")
        else:
            assert_same(a, b, what=f"{what}[{i}]")


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("case", PERGROUP_CASES)
def test_pergroup_scan_kernel_vs_plain(cuda, case, dtype, ring):
    import torch

    from repro_torch.kernels.swag import kernel as sk

    spec, st, g, k = _pergroup_stream(case, dtype, cuda)
    keys = k if ring else None
    got = sk.pergroup_scan(spec, st, g, keys)
    want = sk.pergroup_scan_plain(spec, st, g, keys)
    torch.cuda.synchronize()
    _assert_trees(got, want, "scan")
    evictions, retirements = want.events.tolist()
    if case == CHURN:
        assert evictions > 0 and retirements > 0, want.events
    if case == MANY_GROUPS:
        assert evictions > 0, want.events
        assert torch.unique(g).numel() > sk.SCAN_GROUP_SMEM_MAX


@pytest.mark.parametrize("mode", ["push", "push_no_ring", "inplace"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("case", PERGROUP_CASES)
def test_pergroup_scan_push_modes_vs_plain(cuda, case, dtype, mode):
    # a streaming push's placement: every tuple (the stream cut 3 short of
    # the case's chunks, so the last chunk is ragged) and only the store
    # after the last, from an empty or a continued store; inplace updates
    # the given store where it lies
    import torch

    from repro_torch.core import panestore as ps
    from repro_torch.kernels.swag import kernel as sk

    spec, st, g, k = _pergroup_stream(case, dtype, cuda)
    g, k = g[:-3].contiguous(), k[:-3].contiguous()
    keys = None if mode == "push_no_ring" else k
    want = sk.pergroup_scan_plain(spec, st, g, keys, push=True)
    mine = ps.PaneStoreState(*(x.clone() for x in st))
    got = sk.pergroup_scan(spec, mine, g, keys, push=True,
                           inplace=mode == "inplace")
    torch.cuda.synchronize()
    _assert_trees(got, want, "scan")
    if mode == "inplace":
        assert got.final is mine
        assert got.final.keys.data_ptr() == mine.keys.data_ptr()
    else:
        _assert_trees(mine, st, "the given store")
    assert got.slots is None and got.states is None


def test_pergroup_scan_rejects_the_free_slot_id(cuda):
    # PAD_GROUP marks a free slot: a push that carries it raises
    import torch

    from repro_torch.core import panestore as ps
    from repro_torch.kernels.swag import kernel as sk

    spec = ps.PaneStoreSpec(wa=4, capacity=8, default_ws=8)
    g = torch.tensor([0, 1, PAD_GROUP], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="free slot"):
        sk.pergroup_scan(spec, ps.init_store(spec, device=cuda), g, g,
                         push=True)


def _card_streams(cuda, windowed, dtype):
    """A stream on the card cut into pushes of uneven lengths (the
    windowed ones leave ragged chunks): ``(query ops, window, batches,
    n_valids)``."""
    import torch

    from repro_torch.query import Window

    if windowed:
        g, k = _stream(41, 9000, 70, dtype, None, cuda)
        sizes = [1000, 1, 2999, 127, 4873]
        window = Window(ws=256, wa=32, ws_per_group={0: 1024, 1: 32},
                        capacity=300)
        ops = DIRECT_OPS
    else:
        g, k = _stream(42, 12000, 300, dtype, "group_key", cuda)
        sizes = [3000, 1, 5000, 999, 3000]
        window = None
        ops = SEGSCAN_OPS
    edges = np.cumsum([0] + sizes)
    batches = [(g[a:b], k[a:b]) for a, b in zip(edges[:-1], edges[1:])]
    # the last push padded past its real tuples
    last_g, last_k = batches[-1]
    batches[-1] = (torch.cat([last_g, torch.zeros_like(last_g[:77])]),
                   torch.cat([last_k, torch.zeros_like(last_k[:77])]))
    return ops, window, batches, [None] * (len(sizes) - 1) + [sizes[-1]]


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("windowed", [False, True],
                         ids=["carries", "pane_store"])
def test_streams_on_card_match_reference(cuda, windowed, dtype):
    # cuda (non-windowed) and cuda-panestore (count windows) streams
    # against the reference backend on the card, push by push: outputs,
    # rr_port and the state after each push; one segscan launch an op a
    # push, or one placement scan and one ring replay a push
    import torch

    from repro_torch.kernels.segscan import kernel as ssk
    from repro_torch.kernels.swag import kernel as sk
    from repro_torch.query import Query, init_stream_state, plan, stream_fn

    ops, window, batches, n_valids = _card_streams(cuda, windowed, dtype)
    q = Query(ops=ops, window=window, streaming=True)
    p = plan(q, backend="cuda-panestore" if windowed else "cuda",
             device=cuda)
    assert plan(q, device=cuda).backend == p.backend  # auto on the card
    pr = plan(q, backend="reference", device=cuda)
    assert ("per-tuple placement on the host" in pr.note) == windowed, \
        pr.note
    kdt = batches[0][1].dtype
    step, ref = stream_fn(p, tile=256), stream_fn(pr)
    st, rst = init_stream_state(p, kdt), init_stream_state(pr, kdt)
    for i, ((g, k), nv) in enumerate(zip(batches, n_valids)):
        sk.pergroup_scan.launches = 0
        sk.pergroup_replay_ring.launches = 0
        ssk.segscan.launches = 0
        got, st = step(g, k, st, nv)
        counts = (sk.pergroup_scan.launches, sk.pergroup_replay_ring.launches,
                  ssk.segscan.launches)
        assert counts == ((1, 1, 0) if windowed else (0, 0, len(ops))), \
            counts
        want, rst = ref(g, k, rst, nv)
        torch.cuda.synchronize()
        tag = f"push {i}"
        for a, b, what in zip(got[:1] + got[2:], want[:1] + want[2:],
                              ("groups", "valid", "num", "rr_port")):
            assert_same(a, b, what=f"{tag} {what}")
        for name in ops:
            assert_same(got[1][name], want[1][name],
                        inexact=name in INEXACT, what=f"{tag} {name}")
        if windowed:
            _assert_trees(st, rst, f"{tag} store")
        else:
            for name, c, r in zip(ops, st, rst):
                _assert_trees((c.group, c.nonempty, c.emitted),
                              (r.group, r.nonempty, r.emitted), tag)
                cs = c.state if isinstance(c.state, tuple) else (c.state,)
                rs = r.state if isinstance(r.state, tuple) else (r.state,)
                for a, b in zip(cs, rs):
                    assert_same(a, b, inexact=name in INEXACT,
                                what=f"{tag} carry {name}")


def test_stream_auto_reference_on_card_says_so(cuda):
    # a windowed stream that no kernel backend serves resolves to the
    # reference on the card, and its plan says that the placement runs on
    # the host and why cuda-panestore refused
    from repro_torch.query import Query, Window, plan

    q = Query(ops=("median",), window=Window(ws=64, wa=16, capacity=40),
              streaming=True, interpolate=True)
    p = plan(q, device=cuda)
    assert p.backend == "reference", p
    assert "per-tuple placement on the host (cuda-panestore: " in p.note, \
        p.note


def test_aggregator_on_card_updates_its_store_in_place(cuda):
    # a windowed StreamingAggregator's pushes keep the store's ring where
    # it lies, and its flush equals the reference's
    import torch

    from repro_torch.core import StreamingAggregator
    from repro_torch.query import Window

    w = Window(ws=64, wa=16, capacity=40)
    g, k = _stream(43, 3000, 12, np.int32, None, cuda)
    agg = StreamingAggregator("distinct_count", window=w, device=cuda)
    ref = StreamingAggregator("distinct_count", window=w,
                              backend="reference", device=cuda)
    ring = agg.carry.keys.data_ptr()
    for a, b in ((0, 999), (999, 1000), (1000, 3000)):
        got, want = agg.push(g[a:b], k[a:b]), ref.push(g[a:b], k[a:b])
        assert agg.carry.keys.data_ptr() == ring
        _assert_trees(got[:5], want[:5], f"push {a}")
    _assert_trees(agg.flush()[:5], ref.flush()[:5], "flush")
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("case", PERGROUP_CASES)
def test_pergroup_fused_kernel_vs_plain(cuda, case, dtype):
    import torch

    from repro_torch.core.swag import frame_panes, write_plan
    from repro_torch.kernels.swag import kernel as sk

    spec, st, g, k = _pergroup_stream(case, dtype, cuda)
    plan = write_plan(spec, sk.pergroup_scan_plain(spec, st, g))
    ck = frame_panes(k, spec.wa, plan[0].shape[0]).contiguous()
    got = sk.pergroup_fused(ck, *plan[:8], PARTIAL_OPS)
    want = sk.pergroup_fused_plain(ck, *plan[:8], PARTIAL_OPS)
    torch.cuda.synchronize()
    for name in PARTIAL_OPS:
        assert_same(got[name], want[name], inexact=name in INEXACT,
                    what=name)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("case", REPLAY_CASES)
def test_pergroup_replay_kernel_vs_plain(cuda, case, dtype):
    import torch

    from repro_torch.core import panestore as ps
    from repro_torch.core.swag import per_group_chunk_scan
    from repro_torch.kernels.swag import kernel as sk

    spec, st, g, k = _pergroup_stream(case, dtype, cuda)
    _, runs = per_group_chunk_scan(spec, st, g, k,
                                   lambda s: ps.gather_runs(spec, s))
    length = runs.run_keys.shape[-1]
    rk = runs.run_keys.reshape(-1, length).contiguous()
    rv = runs.run_valid.reshape(-1, length).to(torch.int32)
    got = sk.pergroup_replay(rk, rv, DIRECT_OPS, run=spec.wa)
    want = sk.pergroup_replay_plain(rk, rv, DIRECT_OPS, run=spec.wa)
    torch.cuda.synchronize()
    for name in DIRECT_OPS:
        assert_same(got[name], want[name], inexact=name in INEXACT,
                    what=name)


def _assert_ring_same(got, want, c, *, zero_mapped=False):
    """Ring-form replays: groups and num equal, values equal on the rows
    below num (the kernel leaves the rest unwritten)."""
    import torch

    (gv, gg, gn), (wv, wg, wn) = got, want
    assert_same(gg, wg, what="ugroups")
    assert_same(gn, wn, what="num")
    valid = torch.arange(c, device=gn.device)[None, :] < wn[:, None]
    for name in DIRECT_OPS:
        a = torch.where(valid, gv[name], 0).to(gv[name].dtype)
        b = torch.where(valid, wv[name], 0).to(wv[name].dtype)
        if zero_mapped and name not in INEXACT:
            a, b = _zero_mapped(a), _zero_mapped(b)
        assert_same(a, b, inexact=name in INEXACT, what=name)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("case", REPLAY_CASES)
def test_pergroup_replay_ring_kernel_vs_plain(cuda, case, dtype):
    import torch

    from repro_torch.kernels.swag import kernel as sk

    spec, st, g, k = _pergroup_stream(case, dtype, cuda)
    states = sk.pergroup_scan(spec, st, g, k).states
    got = sk.pergroup_replay_ring(spec, states, DIRECT_OPS)
    want = sk.pergroup_replay_ring_plain(spec, states, DIRECT_OPS)
    torch.cuda.synchronize()
    _assert_ring_same(got, want, spec.capacity)


@pytest.mark.parametrize("keys", [-0.0, "signed_zeros"])
def test_pergroup_replay_signed_zeros(cuda, keys):
    # replay keeps the keys' bits: a window whose zeros are all -0.0 gives
    # -0.0; one that holds both signs may differ from the plain version
    # only in the sign of a zero.  Both forms.
    import torch

    from repro_torch.core import panestore as ps
    from repro_torch.kernels.swag import kernel as sk

    spec = ps.PaneStoreSpec(wa=8, capacity=12, default_ws=24)
    n = 480
    g = torch.from_numpy(np.random.default_rng(1).integers(
        0, 5, n).astype(np.int32)).to(cuda)
    if keys == "signed_zeros":
        k = torch.from_numpy(edge_stream("signed_zeros", n)[1]).to(cuda)
    else:
        k = torch.full((n,), keys, dtype=torch.float32, device=cuda)
    states = sk.pergroup_scan(spec, ps.init_store(spec, k.dtype, device=cuda),
                              g, k).states
    got = sk.pergroup_replay_ring(spec, states, DIRECT_OPS)
    want = sk.pergroup_replay_ring_plain(spec, states, DIRECT_OPS)
    torch.cuda.synchronize()
    _assert_ring_same(got, want, spec.capacity,
                      zero_mapped=keys == "signed_zeros")
    if keys != "signed_zeros":
        valid = torch.arange(spec.capacity, device=cuda)[None, :] \
            < want[2][:, None]
        for name in ("min", "max", "median"):
            bits = got[0][name][valid].view(torch.int32)
            assert bool((bits == -2**31).all()), name  # -0.0 itself
    runs = ps.gather_runs(spec, states)
    length = runs.run_keys.shape[-1]
    rk = runs.run_keys.reshape(-1, length).contiguous()
    rv = runs.run_valid.reshape(-1, length).to(torch.int32)
    rgot = sk.pergroup_replay(rk, rv, DIRECT_OPS, run=spec.wa)
    rwant = sk.pergroup_replay_plain(rk, rv, DIRECT_OPS, run=spec.wa)
    for name in DIRECT_OPS:
        a, b = rgot[name], rwant[name]
        if keys == "signed_zeros" or name in INEXACT:
            a, b = _zero_mapped(a), _zero_mapped(b)
        assert_same(a, b, what=f"row form {name}")


@pytest.mark.parametrize("ops", [PARTIAL_OPS, DIRECT_OPS])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("capacity", [None, 6])
def test_pergroup_execute_on_card_matches_reference(cuda, ops, dtype,
                                                    capacity):
    import torch

    from repro_torch.interop import make_stream
    from repro_torch.query import Query, Window, execute, plan

    g, k = make_stream(5, 400, 7, 60, dtype=dtype)
    q = Query(ops=ops, window=Window(ws=16, wa=8, ws_per_group={0: 32, 1: 8},
                                     capacity=capacity))
    assert plan(q).backend == "cuda-panestore"
    got, _ = execute(q, g, k)
    want, _ = execute(q, g, k, backend="reference")
    torch.cuda.synchronize()
    assert_same(got.groups, want.groups, what="groups")
    assert_same(got.valid, want.valid, what="valid")
    assert_same(got.num_groups, want.num_groups, what="num_groups")
    for name in ops:
        assert_same(got.values[name], want.values[name],
                    inexact=name in INEXACT, what=name)


# ------------------------------------------------- two-stack time windows

TWOSTACK_OPS = ("sum", "count", "min", "max")


def _flip_inputs(torch, seed, ne, wcap, dtype, device):
    """[NE, wcap] front/back keys and masks: row 0 with an empty front,
    row 1 with an empty back, the others live prefixes of random length
    (the two-stack regions), full rows included."""
    rng = np.random.default_rng(seed)

    def keys():
        if dtype == np.float32:
            return (rng.normal(size=(ne, wcap)) * 100).astype(np.float32)
        return rng.integers(-2**31, 2**31 - 1, (ne, wcap)).astype(np.int32)

    lane = np.arange(wcap)[None, :]
    nf = rng.integers(0, wcap + 1, ne)
    nb = rng.integers(0, wcap + 1, ne)
    nf[0], nb[min(1, ne - 1)] = 0, 0
    nf[-1] = wcap
    return (torch.from_numpy(keys()).to(device),
            torch.from_numpy(lane < nf[:, None]).to(device),
            torch.from_numpy(keys()).to(device),
            torch.from_numpy(lane < nb[:, None]).to(device))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("ne,wcap", [(3, 1), (4, 2), (9, 64), (5, 1024),
                                     (3, 4096), (2, 8192)])
def test_twostack_flip_kernel_vs_plain(cuda, dtype, ne, wcap):
    import torch

    from repro_torch.kernels.swag import kernel as sk

    kf, vf, kb, vb = _flip_inputs(torch, ne * wcap, ne, wcap, dtype, cuda)
    got = sk.twostack_flip(kf, vf, kb, vb, TWOSTACK_OPS)
    want = sk.twostack_flip_plain(kf, vf, kb, vb, TWOSTACK_OPS)
    torch.cuda.synchronize()
    # the kernel's sweeps add in the plain version's order: float sums
    # are equal bit for bit, int32 sums wrap alike
    for name in TWOSTACK_OPS:
        assert_same(got[name][0], want[name][0], what=f"{name} front")
        assert_same(got[name][1], want[name][1], what=f"{name} back")
    assert got["count"][0].dtype == torch.int32


def _bits(x):
    """A tensor's bit patterns: float32 viewed as int32, so NaNs and the
    sign of a zero compare too."""
    import torch

    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("ne,wcap", [(3, 1), (5, 32), (4, 1024), (3, 8192)])
def test_twostack_flip_arbitrary_masks_vs_plain(cuda, ne, wcap):
    import torch

    from repro_torch.kernels.swag import kernel as sk

    rng = np.random.default_rng(wcap)

    def keys():
        # magnitudes from 1e-3 to 1e6, both signs: a sum's rounding depends
        # on the order of its additions
        mag = 10.0 ** rng.uniform(-3, 6, (ne, wcap))
        return (rng.choice([-1.0, 1.0], (ne, wcap)) * mag).astype(np.float32)

    # live lanes anywhere in the row, not a prefix as _region makes them
    kf, kb = (torch.from_numpy(keys()).to(cuda) for _ in range(2))
    vf, vb = (torch.from_numpy(rng.random((ne, wcap)) < 0.5).to(cuda)
              for _ in range(2))
    vf[0] = False  # an empty front row
    vb[-1] = True  # a full back row
    got = sk.twostack_flip(kf, vf, kb, vb, TWOSTACK_OPS)
    want = sk.twostack_flip_plain(kf, vf, kb, vb, TWOSTACK_OPS)
    torch.cuda.synchronize()
    for name in TWOSTACK_OPS:
        for side, what in enumerate(("front", "back")):
            a, b = got[name][side], want[name][side]
            assert a.dtype == b.dtype, (name, what)
            assert torch.equal(_bits(a).cpu(), _bits(b).cpu()), \
                f"{name} {what}"


def test_twostack_flip_rejects_rows_past_shared_memory(cuda):
    import torch

    from repro_torch.kernels.swag import kernel as sk

    k = torch.zeros((1, 2 * sk.MAX_WCAP), dtype=torch.int32, device=cuda)
    v = torch.ones_like(k, dtype=torch.bool)
    with pytest.raises(ValueError, match=str(sk.MAX_WCAP)):
        sk.twostack_flip(k, v, k, v, ("sum",))


def _time_query(ops, group_by, window):
    from repro_torch.query import Query, Window

    return Query(ops=ops, group_by=group_by, window=Window(**window))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("ops,group_by,window", [
    (TWOSTACK_OPS, False, dict(range=300, slide=100)),
    (TWOSTACK_OPS, False, dict(range=40, slide=100)),     # gaps: slide > range
    (("min", "max"), False, dict(range=4096, slide=1024)),
    (("min", "max", "sum", "count", "dc", "median", "mean"), True,
     dict(range=300, slide=100)),
    (TWOSTACK_OPS, False, dict(range=300, slide=100, strategy="replay")),
])
def test_time_windows_on_card_match_reference(cuda, dtype, ops, group_by,
                                              window):
    import torch

    from repro_torch.interop import make_time_stream
    from repro_torch.query import execute, plan

    g, k, ts = make_time_stream(7, 5000, 9, 1000, 0.875, 64)
    ts = ts - 3000  # negative timestamps frame by floor division
    if dtype == np.float32:
        k = k.astype(np.float32) / 7
    q = _time_query(ops, group_by, window)
    assert plan(q).backend == "cuda"
    g_in = g if group_by else None
    got, _ = execute(q, g_in, k, timestamps=ts)
    want, _ = execute(q, g_in, k, backend="reference", timestamps=ts)
    torch.cuda.synchronize()
    assert_same(got.groups, want.groups, what="groups")
    assert_same(got.valid, want.valid, what="valid")
    assert_same(got.num_groups, want.num_groups, what="num_groups")
    for name in want.values:
        assert_same(torch.where(want.valid, got.values[name], 0),
                    torch.where(want.valid, want.values[name], 0),
                    inexact=name in INEXACT, what=name)


def test_time_windows_empty_batch_on_card(cuda):
    import torch

    from repro_torch.query import execute

    for ops, group_by in ((TWOSTACK_OPS, False), (("median",), True)):
        q = _time_query(ops, group_by, dict(range=64, slide=16))
        got, _ = execute(q, np.zeros(0, np.int32), np.zeros(0, np.int32),
                         timestamps=np.zeros(0, np.int32))
        want, _ = execute(q, np.zeros(0, np.int32), np.zeros(0, np.int32),
                          backend="reference",
                          timestamps=np.zeros(0, np.int32))
        assert got.groups.shape == want.groups.shape
        assert got.groups.shape[0] == 0


def test_time_replay_rejects_frames_past_shared_memory(cuda):
    import torch

    from repro_torch.kernels.swag import kernel as sk
    from repro_torch.query import execute

    n = sk.MAX_ROW + 1  # one window of every tuple: a frame of 2 * MAX_ROW
    q = _time_query(("median",), True, dict(range=64))
    args = (np.zeros(n, np.int32), np.ones(n, np.int32))
    with pytest.raises(ValueError, match=str(sk.MAX_ROW)):
        execute(q, *args, timestamps=np.zeros(n, np.int32))
    execute(q, *args, backend="reference", timestamps=np.zeros(n, np.int32))


# ------------------------------------------- standalone sort and scan

#: (key types, rows, lanes): rows of up to 16384 lanes with one or two
#: keys, 8192 with three or four (the key words and the lane index fill
#: one block's shared memory)
BITONIC_CASES = [(kt, rows, t)
                 for kt in (("i",), ("f",), ("i", "i"), ("i", "f"),
                            ("f", "i", "i"), ("i", "i", "f", "i"))
                 for rows, t in ((3, 1), (2, 2), (5, 64), (4, 1024),
                                 (2, 8192), (1, 16384))
                 if t <= (16384 if len(kt) <= 2 else 8192)]


@pytest.mark.parametrize("key_types,rows,t", BITONIC_CASES)
def test_bitonic_kernel_vs_plain(cuda, key_types, rows, t):
    import torch

    from repro_torch.kernels.bitonic import kernel as bk

    num_keys = len(key_types)
    rng = np.random.default_rng(rows * t + num_keys)
    keys = [rng.integers(0, 5, (rows, t)).astype(np.int32) if kt == "i"
            else (rng.integers(-3, 3, (rows, t)) * 0.5).astype(np.float32)
            for kt in key_types]
    if key_types[0] == "f":
        keys[0][:, ::7] = -0.0  # -0.0 ties with 0.0: neither swaps
    # tied keys everywhere: payloads must land where the network puts them
    pays = [rng.normal(size=(rows, t)).astype(np.float32),
            rng.integers(-100, 100, (rows, t)).astype(np.int8),
            rng.integers(-2**40, 2**40, (rows, t)).astype(np.int64),
            rng.integers(0, 9, (rows, t)).astype(np.int16)]
    ops = [torch.from_numpy(x).to(cuda) for x in keys + pays]
    got = bk.bitonic_sort(ops, num_keys)
    want = bk.bitonic_plain(ops, num_keys)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert_same(a, b, what=f"operand {i}")


def test_bitonic_kernel_limits(cuda):
    import torch

    from repro_torch.kernels.bitonic import kernel as bk

    x = torch.zeros((1, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=f"at most {bk.MAX_KEYS} keys"):
        bk.bitonic_sort((x,) * 5, 5)
    with pytest.raises(ValueError, match=f"at most {bk.MAX_ROW} lanes"):
        y = torch.zeros((1, 2 * bk.MAX_ROW), dtype=torch.int32, device=cuda)
        bk.bitonic_sort((y, y), 2)
    with pytest.raises(ValueError, match="at most 8192 lanes"):
        y = torch.zeros((1, bk.MAX_ROW), dtype=torch.int32, device=cuda)
        bk.bitonic_sort((y, y, y), 3)


@pytest.mark.parametrize("key_types,t", [
    (("f", "f", "i", "f"), 64), (("f", "f", "i", "f"), 1024),
    (("f", "f", "i", "f"), 8192), (("f", "f"), 16384)])
def test_bitonic_kernel_nan_and_zero_ties_vs_plain(cuda, key_types, t):
    import torch

    from repro_torch.kernels.bitonic import kernel as bk

    rng = np.random.default_rng(t + len(key_types))
    rows = 3
    # float keys from a few values, NaN among them: ties everywhere, -0.0
    # beside 0.0 (equal, never swapped), NaN in every float key position
    # (neither less nor equal: it ends the compare)
    vals = np.array([-1.0, -0.0, 0.0, 0.5, np.nan], np.float32)
    keys = [vals[rng.integers(0, 5, (rows, t))] if kt == "f"
            else rng.integers(0, 3, (rows, t)).astype(np.int32)
            for kt in key_types]
    keys[0][0, :] = np.where(rng.random(t) < 0.5, -0.0, 0.0)  # zeros only
    keys[1][1, ::3] = np.nan
    pays = [np.tile(np.arange(t, dtype=np.int32), (rows, 1)),
            rng.normal(size=(rows, t)).astype(np.float32),
            rng.integers(-100, 100, (rows, t)).astype(np.int8)]
    ops = [torch.from_numpy(x).to(cuda) for x in keys + pays]
    got = bk.bitonic_sort(ops, len(key_types))
    want = bk.bitonic_plain(ops, len(key_types))
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, f"operand {i}"
        assert torch.equal(_bits(a).cpu(), _bits(b).cpu()), f"operand {i}"


@pytest.mark.parametrize("full_width", [True, False])
@pytest.mark.parametrize("shape", [(1000,), (3, 100), (1,), (16384,)])
def test_sort_pairs_cuda_vs_plain(cuda, full_width, shape):
    import torch

    from repro_torch.core import sorter
    from repro_torch.kernels.bitonic.ops import sort_pairs_cuda

    rng = np.random.default_rng(shape[-1])
    g = torch.from_numpy(rng.integers(0, 23, shape).astype(np.int32))
    k = torch.from_numpy((rng.normal(size=shape) * 50).astype(np.float32))
    got = sort_pairs_cuda(g.to(cuda), k.to(cuda), full_width=full_width)
    want = sorter.sort_pairs(g, k, full_width=full_width)
    torch.cuda.synchronize()
    assert_same(got[0], want[0], what="groups")
    assert_same(got[1], want[1], what="keys")


SEGSCAN_OPS = ("sum", "min", "max", "count", "mean", "distinct_count")


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", SEGSCAN_OPS)
@pytest.mark.parametrize("n,tile,groups", [
    (64, 64, 3), (1000, 128, 11), (513, 256, 1), (4096, 32, 1),
    (70000, 4096, 50), (37, 1, 4), (3000, 1024, 2000)])
def test_segscan_kernel_vs_plain(cuda, op, dtype, n, tile, groups):
    import torch

    from repro_torch.core.combiners import get_combiner
    from repro_torch.kernels.segscan import kernel as ssk
    from repro_torch.kernels.segscan.ops import segmented_scan_cuda

    g, k = _stream(n + tile, n, groups, dtype, "group_key", cuda)
    flags = torch.cat([torch.ones(1, dtype=torch.bool, device=cuda),
                       g[1:] != g[:-1]])
    state = get_combiner(op).lift(k)
    got = segmented_scan_cuda(flags, state, op, tile=tile)
    want = ssk.segscan_plain(flags, state if isinstance(state, tuple)
                             else (state,), get_combiner(op))
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    for i, (a, b) in enumerate(zip(got, want)):
        # float sums: thread-local runs, then warp and block scans, then
        # the tile carries — another order than the Hillis–Steele rounds
        assert_same(a, b, inexact=op in INEXACT, what=f"{op} leaf {i}")


def test_segscan_one_segment_over_many_tiles(cuda):
    import torch

    from repro_torch.kernels.segscan.ops import segmented_scan_cuda

    n = 1 << 20
    k = torch.randint(0, 10, (n,), dtype=torch.int32, device=cuda)
    flags = torch.zeros(n, dtype=torch.bool, device=cuda)
    flags[0] = True
    got = segmented_scan_cuda(flags, k, "sum", tile=1024)
    want = torch.cumsum(k, 0, dtype=torch.int32)
    assert_same(got, want, what="one segment over 1024 tiles")


@pytest.mark.parametrize("op", ["sum", "mean", "distinct_count"])
def test_segscan_chain_over_many_tiles(cuda, op):
    # 2^22 lanes at tile 128 (32,768 tiles): one segment over the first
    # 2^21 lanes, whose int32 sum wraps through the look-back (keys near
    # 2^12: the sum passes 2^31 after about 2^19 lanes), then segments of
    # 1000 lanes, then one segment over the ragged tail
    import torch

    from repro_torch.core.combiners import get_combiner
    from repro_torch.kernels.segscan import kernel as ssk
    from repro_torch.kernels.segscan.ops import segmented_scan_cuda

    n = (1 << 22) - 77
    k = torch.randint(4000, 4096, (n,), dtype=torch.int32, device=cuda)
    if op == "distinct_count":
        k = torch.sort(k[: 1 << 21]).values.repeat(2)[:n]
    flags = torch.zeros(n, dtype=torch.bool, device=cuda)
    flags[0] = True
    flags[1 << 21: 3 << 20: 1000] = True
    flags[3 << 20] = True
    comb = get_combiner(op)
    state = comb.lift(k)
    leaves = state if isinstance(state, tuple) else (state,)
    got = segmented_scan_cuda(flags, state, op, tile=128)
    got = got if isinstance(got, tuple) else (got,)
    want = ssk.segscan_plain(flags, leaves, comb)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert_same(a, b, what=f"{op} leaf {i}")


def test_segscan_kernel_rejects(cuda):
    import torch

    from repro_torch.kernels.segscan import kernel as ssk

    f = torch.ones(8192, dtype=torch.bool, device=cuda)
    k = torch.zeros(8192, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=str(ssk.MAX_TILE)):
        ssk.segscan(f, (k,), "sum", tile=8192)
    with pytest.raises(ValueError, match="variance"):
        ssk.segscan(f, (k,), "variance", tile=1024)


# ------------------------------------------------- event-time streaming

def _bits(t):
    """A tensor's bits: float32 viewed as int32 (NaN payloads, signed
    zeros), anything else as it is."""
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _time_tuples(seed, n, dtype, device, *, offset=0, jitter=(-14, 14),
                 late=(), n_groups=6, special=False):
    """``n`` (ts, group, key) tuples on the card, tuple i stamped about
    ``offset + i``; ``late`` lanes far behind; ``special`` float keys
    include -0.0 and NaN."""
    import torch

    rng = np.random.default_rng(seed)
    ts = (np.arange(n) + offset + rng.integers(*jitter, n)).astype(np.int32)
    for i in late:
        ts[i] = offset - 500
    g = rng.integers(0, n_groups, n).astype(np.int32)
    if dtype == np.float32:
        k = (rng.integers(-6, 6, n) * 0.5).astype(np.float32)
        if special:
            k[::5] = -0.0
            k[3::11] = np.nan
    else:
        k = rng.integers(-20, 50, n).astype(np.int32)
    return tuple(torch.from_numpy(x).to(device) for x in (ts, g, k))


def _assert_emit_same(got, want, n, what):
    """Reorder emissions: the live lanes' ts, group and key bits, every
    lane's live and late flags, ts 0 on the dead drain lanes (a dead
    lane's other fields are whatever its cycle read)."""
    import torch

    assert_same(got.live, want.live, what=f"{what} live")
    assert_same(got.late, want.late, what=f"{what} late")
    lv = want.live
    for f in ("ts", "groups", "keys"):
        a, b = _bits(getattr(got, f)), _bits(getattr(want, f))
        assert_same(torch.where(lv, a, 0), torch.where(lv, b, 0),
                    what=f"{what} {f}")
    assert bool((got.ts[n:][~got.live[n:]] == 0).all()), what


#: (capacity, lateness, pushes of (n, late lanes, n_valid, drain_wm
#: offset), and optionally the tuples' jitter and the buffer's starting
#: arrival clock): forced pops, stragglers, an n_valid tail (an int and a
#: tensor on the card), a drain gate behind the watermark and ahead; every
#: register width of the kernel (capacities 1 to 1024: 1 to 32 slots a
#: lane, lanes without a slot); an in-order stream released on every
#: cycle; buffers that stay full (every register rank held, releases
#: forced); arrival seqs that wrap past INT32_MAX
REORDER_CARD_CASES = {
    "forced_pops": (8, 40, [(300, (), None, None)] * 3),
    "late": (128, 8, [(1024, (5, 77, 900), None, None),
                      (1024, (0, 1023), None, None)]),
    "n_valid": (64, 16, [(500, (), 431, None), (500, (7,), "tensor", None),
                         (500, (), 0, None)]),
    "drain_wm": (32, 16, [(400, (), None, -40), (400, (), None, 9),
                          (400, (), None, None)]),
    "capacity_1024": (1024, 300, [(2048, (3,), None, None)] * 2),
    "capacity_1": (1, 10, [(200, (), None, None), (200, (3,), None, None)]),
    "capacity_32": (32, 20, [(600, (), None, None)] * 2),
    "capacity_256": (256, 200, [(700, (9,), None, None)] * 2),
    "in_order": (16, 0, [(512, (), None, None)] * 2, {"jitter": (0, 1)}),
    "full": (32, 10**6, [(400, (), None, None)] * 2),
    "full_64": (64, 10**6, [(400, (), None, None)] * 2),
    "clock_wrap": (64, 16, [(500, (), None, None)] * 3,
                   {"clock": 2**31 - 8}),
}


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("case", sorted(REORDER_CARD_CASES))
def test_reorder_kernel_vs_plain(cuda, case, dtype):
    import torch

    from repro_torch.core import eventtime as et
    from repro_torch.kernels.eventtime import kernel as ek

    capacity, lateness, pushes, *opts = REORDER_CARD_CASES[case]
    opts = opts[0] if opts else {}
    spec = et.ReorderSpec(capacity, lateness)
    kdt = torch.float32 if dtype == np.float32 else torch.int32
    st = et.init_reorder(spec, kdt, cuda)
    ref = et.init_reorder(spec, kdt, cuda)
    if "clock" in opts:
        st.seq_clock.fill_(opts["clock"])
        ref.seq_clock.fill_(opts["clock"])
    for i, (n, late, nv, dw) in enumerate(pushes):
        ts, g, k = _time_tuples(100 + i, n, dtype, cuda, offset=n * i,
                                late=late, special=True,
                                jitter=opts.get("jitter", (-14, 14)))
        if nv == "tensor":
            nv = torch.tensor(n - 50, dtype=torch.int32, device=cuda)
        gate = None if dw is None else ts.max() + dw
        ek.reorder_push.launches = 0
        got, st = ek.reorder_push(spec, st, ts, g, k, n_valid=nv,
                                  drain_wm=gate, inplace=True)
        assert ek.reorder_push.launches == 1
        want, ref = ek.reorder_push_plain(spec, ref, ts, g, k, n_valid=nv,
                                          drain_wm=gate)
        torch.cuda.synchronize()
        _assert_emit_same(got, want, n, f"{case} push {i}")
        _assert_trees(tuple(_bits(x) for x in st),
                      tuple(_bits(x) for x in ref), f"{case} buffer {i}")
        if case == "in_order":  # every cycle releases its own tuple
            assert bool(want.live[:n].all()), case
        if case.startswith("full"):  # every rank of the order held
            assert bool(ref.occ.all()), case
    if case == "late":
        assert int(st.dropped) >= 5
    if case == "clock_wrap":
        assert int(ref.seq_clock) < 0, case
    got, st = ek.reorder_flush(spec, st)
    want, ref = ek.reorder_flush_plain(spec, ref)
    torch.cuda.synchronize()
    _assert_emit_same(got, want, 0, f"{case} flush")
    _assert_trees(tuple(_bits(x) for x in st), tuple(_bits(x) for x in ref),
                  f"{case} flushed buffer")


def _time_store_pushes(case, dtype, device):
    """A time-mode spec and pushes of (groups, keys, ts, live,
    retire_below) for a placement case: chaining beyond wa, evictions, a
    first-cycle eviction beside dead panes, negative timestamps, dead
    lanes; one group, so whole batches share a pane that fills within
    them; group ids from both ends of int32 at negative pane ids, 40 of
    them in a 256-slot index; a store carried over retirements and
    reallocations; a store of the fewest slots that evicts on every
    allocation; a store clock about to wrap past INT32_MAX; and a store of
    8192 slots, whose pane index lies in device memory (it does not fit
    shared memory beside the directory)."""
    import torch

    from repro_torch.core import panestore as ps

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    rng = np.random.default_rng(PLACE_CASES.index(case))
    if case == "cycle0_eviction":
        spec = ps.PaneStoreSpec(wa=4, capacity=4, default_ws=1, slide=10,
                                time_range=30)
        k = np.array([7, 8, 9, 10, 1, 2]).astype(dtype)
        return spec, [
            (t(np.arange(4, dtype=np.int32)), t(k[:4]),
             t(np.array([100, 5, 6, 7], np.int32)), t(np.ones(4, bool)),
             None),
            (t(np.array([4, 5], np.int32)), t(k[4:]),
             t(np.array([200, 201], np.int32)), t(np.ones(2, bool)),
             torch.tensor(50, dtype=torch.int32, device=device))]
    capacity = {"evictions": 64, "carried": 192, "clock_wrap": 32,
                "evict_all": 5, "wide_store": 8192}.get(case, 256)
    wa = {"evict_all": 4, "wide_store": 2}.get(case, 16)
    spec = ps.PaneStoreSpec(wa=wa, capacity=capacity, default_ws=1, slide=64,
                            time_range=256)
    base = {"negative": -5000, "collisions": -1_000_000}.get(case, 0)
    n_groups = {"chaining": 3, "evictions": 48, "shared_pane": 1,
                "collisions": 40, "carried": 10, "evict_all": 16,
                "clock_wrap": 16}.get(case, 8)
    ids = np.arange(n_groups, dtype=np.int64)
    if case == "collisions":  # ids from both ends of int32, and between
        ids = np.concatenate([
            [-(2**31) + 1, 2**31 - 2, 0, -1, 2**30, -(2**30)],
            rng.integers(-(2**31) + 1, 2**31 - 1, n_groups - 6)])
    pushes = []
    for i in range(6 if case == "carried" else 4):
        n = 1152
        ts = np.sort(rng.integers(base + 600 * i, base + 600 * i + 700, n)
                     ).astype(np.int32)
        g = ids[rng.integers(0, n_groups, n)].astype(np.int32)
        if dtype == np.float32:
            k = rng.choice(np.array([-1.0, -0.0, 0.0, 0.5, 2.0, np.nan],
                                    np.float32), n)
        else:
            k = rng.integers(0, 1000, n).astype(np.int32)
        live = (rng.random(n) < 0.6 if case == "dead_lanes"
                else np.ones(n, bool))
        if case == "dead_lanes":
            ts[~live] = rng.integers(-10**6, 10**6, int((~live).sum()))
        rb = torch.tensor(base + 600 * i - 200, dtype=torch.int32,
                          device=device)
        if case in ("evict_all", "clock_wrap"):
            rb = None  # nothing retires: a full store stays full
        pushes.append((t(g), t(k), t(ts), t(live), rb))
    return spec, pushes


PLACE_CASES = ("chaining", "evictions", "cycle0_eviction", "negative",
               "dead_lanes", "shared_pane", "collisions", "carried",
               "evict_all", "clock_wrap", "wide_store")


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("case", PLACE_CASES)
def test_pergroup_scan_time_kernel_vs_plain(cuda, case, dtype):
    import torch

    from repro_torch.core import panestore as ps
    from repro_torch.kernels.swag import kernel as sk

    spec, pushes = _time_store_pushes(case, dtype, cuda)
    kdt = torch.float32 if dtype == np.float32 else torch.int32
    st = ps.init_store(spec, kdt, device=cuda)
    ref = ps.init_store(spec, kdt, device=cuda)
    if case == "clock_wrap":
        st.clock.fill_(2**31 - 8)
        ref.clock.fill_(2**31 - 8)
    events = np.zeros(2, np.int64)
    for i, (g, k, ts, live, rb) in enumerate(pushes):
        sk.pergroup_scan_time.launches = 0
        st, ev = sk.pergroup_scan_time(spec, st, g, k, ts, live, rb,
                                       inplace=True)
        assert sk.pergroup_scan_time.launches == 1
        ref, wev = sk.pergroup_scan_time_plain(spec, ref, g, k, ts, live, rb)
        torch.cuda.synchronize()
        assert_same(ev, wev, what=f"{case} push {i} events")
        _assert_trees(tuple(_bits(x) for x in st),
                      tuple(_bits(x) for x in ref), f"{case} store {i}")
        events += wev.cpu().numpy()
    occ = (ref.owner != PAD_GROUP).cpu()
    stamps = ref.stamp.cpu()[occ]
    if case == "cycle0_eviction":
        assert events.tolist() == [1, 3] and int(st.owner[0]) == 4
    elif case in ("evictions", "evict_all"):
        assert events[0] > (200 if case == "evict_all" else 0)
    elif case == "clock_wrap":
        # stamps on both sides of the wrap: argmin evicts the newest
        assert events[0] > 0 and int(ref.clock) < 0 < int(stamps.max())
    else:
        assert events[1] > 0
    if case == "carried":  # allocation order is not slot order
        assert not bool((stamps[1:] > stamps[:-1]).all())
    if case == "wide_store":
        assert sk.time_scan_smem(spec.capacity, spec.wa) \
            + sk.time_aux_bytes(spec.capacity) > sk.SMEM_BUDGET


@pytest.mark.parametrize("keys", ["int32", "float32", "signed_zeros", "nan"])
def test_pergroup_replay_ring_time_form_vs_plain(cuda, keys):
    # a time-mode store evaluated at several times (one whose window holds
    # no tuple of some groups, whose rows are then dropped); -0.0 may
    # differ only in the sign of a zero (the kernel merges by value); NaN
    # keys order after every number in both, so min, max, median and
    # distinct count are held bit for bit too
    import torch

    from repro_torch.core import panestore as ps
    from repro_torch.kernels.swag import kernel as sk

    dtype = np.int32 if keys == "int32" else np.float32
    spec, pushes = _time_store_pushes("chaining", dtype, cuda)
    kdt = torch.float32 if dtype == np.float32 else torch.int32
    st = ps.init_store(spec, kdt, device=cuda)
    for g, k, ts, live, rb in pushes:
        if keys == "float32":
            k = torch.where(torch.isnan(k) | (k == 0), 1.5, k)
        elif keys == "signed_zeros":
            k = torch.where(torch.isnan(k), -0.0, k)
        st, _ = sk.pergroup_scan_time(spec, st, g, k, ts, live, rb)
    one = ps.PaneStoreState(*(x[None] for x in st))
    top = int(pushes[-1][2].max())
    ops = tuple(sorted(DIRECT_OPS))
    for et in (top + 1, top - 150, top + 300):
        et_t = torch.tensor([et], dtype=torch.int32, device=cuda)
        sk.pergroup_replay_ring.launches = 0
        gv, gg, gn = sk.pergroup_replay_ring(spec, one, ops, eval_time=et_t)
        assert sk.pergroup_replay_ring.launches == 1
        wv, wg, wn = sk.pergroup_replay_ring_plain(spec, one, ops,
                                                   eval_time=et_t)
        torch.cuda.synchronize()
        assert_same(gg, wg, what=f"et {et} ugroups")
        assert_same(gn, wn, what=f"et {et} num")
        for name in ops:
            a, b = gv[name], wv[name]
            if keys == "nan":
                _assert_nan_keys_same(a, b, name, f"et {et}")
                continue
            if keys == "signed_zeros" and name not in INEXACT:
                a, b = _zero_mapped(a), _zero_mapped(b)
            assert_same(a, b, inexact=name in INEXACT, what=f"et {et} {name}")
        if et == top + 300:  # no tuple in the window: every row dropped
            assert int(gn[0]) == 0 < int((st.owner != PAD_GROUP).sum())


def _assert_nan_keys_same(got, want, name, what):
    """A replay op over windows that hold NaN keys: sums and means within
    the float tolerance (NaN where the plain version has NaN), every other
    op bit for bit but for the sign of a zero (the kernel merges -0.0 and
    +0.0 by value, in another order than the plain network)."""
    import torch

    if name in INEXACT:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   equal_nan=True, msg=f"{what} {name}")
    else:
        assert_same(_zero_mapped(got), _zero_mapped(want),
                    what=f"{what} {name}")


def test_pergroup_replay_nan_keys_vs_plain(cuda):
    # the count form over windows that hold NaN keys: the placement scan's
    # close sort puts NaN last, as the plain version's stable sort does
    # (ring and store bit for bit), and both replay forms merge NaN after
    # every number, as the plain merge does, so min, max, median and
    # distinct count equal it bit for bit
    import torch

    from repro_torch.core import panestore as ps
    from repro_torch.kernels.swag import kernel as sk

    spec = ps.PaneStoreSpec(wa=8, capacity=12, default_ws=24)
    n = 480
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)).to(cuda)
    k = torch.from_numpy(rng.choice(np.array(
        [-1.0, 0.5, 2.0, 3.0, np.inf, np.nan], np.float32), n)).to(cuda)
    st0 = ps.init_store(spec, k.dtype, device=cuda)
    trace = sk.pergroup_scan(spec, st0, g, k)
    want_trace = sk.pergroup_scan_plain(spec, st0, g, k)
    torch.cuda.synchronize()
    for a, b, what in ((trace.states, want_trace.states, "snapshots"),
                       (trace.final, want_trace.final, "store")):
        _assert_trees(tuple(_bits(x) for x in a),
                      tuple(_bits(x) for x in b), what)
    got = sk.pergroup_replay_ring(spec, trace.states, DIRECT_OPS)
    want = sk.pergroup_replay_ring_plain(spec, trace.states, DIRECT_OPS)
    torch.cuda.synchronize()
    assert_same(got[1], want[1], what="ugroups")
    assert_same(got[2], want[2], what="num")
    valid = torch.arange(spec.capacity, device=cuda)[None, :] \
        < want[2][:, None]
    for name in DIRECT_OPS:
        a = torch.where(valid, got[0][name], 0).to(got[0][name].dtype)
        b = torch.where(valid, want[0][name], 0).to(want[0][name].dtype)
        _assert_nan_keys_same(a, b, name, "ring form")
    assert bool(torch.isnan(want[0]["max"][valid]).any())
    runs = ps.gather_runs(spec, trace.states)
    length = runs.run_keys.shape[-1]
    rk = runs.run_keys.reshape(-1, length).contiguous()
    rv = runs.run_valid.reshape(-1, length).to(torch.int32)
    rgot = sk.pergroup_replay(rk, rv, DIRECT_OPS, run=spec.wa)
    rwant = sk.pergroup_replay_plain(rk, rv, DIRECT_OPS, run=spec.wa)
    for name in DIRECT_OPS:
        _assert_nan_keys_same(rgot[name], rwant[name], name, "row form")


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_event_time_stream_on_card_matches_reference(cuda, dtype):
    # auto plans cuda-panestore on the card; each push is one reorder, one
    # time-mode placement and one ring replay launch, and equals the
    # reference backend on the card push by push (outputs and the carried
    # pair); the aggregator updates its buffers in place and its flush
    # (three launches) equals the reference's
    import torch

    from repro_torch.core import StreamingAggregator
    from repro_torch.kernels.eventtime import kernel as ek
    from repro_torch.kernels.swag import kernel as sk
    from repro_torch.query import (Query, Window, init_stream_state, plan,
                                   stream_fn)

    w = Window(range=512, slide=128, wa=8, capacity=256, max_lateness=32,
               reorder_capacity=128)
    ops = tuple(sorted(DIRECT_OPS))
    q = Query(ops=ops, window=w, streaming=True)
    p = plan(q, device=cuda)
    assert p.backend == "cuda-panestore" and "watermark" in p.note, p
    pr = plan(q, backend="reference", device=cuda)
    kdt = torch.float32 if dtype == np.float32 else torch.int32
    step, ref = stream_fn(p), stream_fn(pr)
    st, rst = init_stream_state(p, kdt), init_stream_state(pr, kdt)
    agg = StreamingAggregator(ops, window=w, key_dtype=kdt, device=cuda)
    aref = StreamingAggregator(ops, window=w, key_dtype=kdt,
                               backend="reference", device=cuda)
    ring = agg.carry[1].keys.data_ptr()
    wrappers = (ek.reorder_push, sk.pergroup_scan_time,
                sk.pergroup_replay_ring)
    for i in range(6):
        ts, g, k = _time_tuples(200 + i, 700, dtype, cuda, offset=700 * i,
                                jitter=(-15, 15), late=(9,), n_groups=20)
        nv = 650 if i == 2 else None
        for wr in wrappers:
            wr.launches = 0
        got, st = step(g, k, st, nv, ts)
        assert tuple(wr.launches for wr in wrappers) == (1, 1, 1)
        want, rst = ref(g, k, rst, nv, ts)
        torch.cuda.synchronize()
        tag = f"push {i}"
        for a, b, what in zip(got[:1] + got[2:], want[:1] + want[2:],
                              ("groups", "valid", "num", "rr_port")):
            assert_same(a, b, what=f"{tag} {what}")
        for name in ops:
            assert_same(got[1][name], want[1][name],
                        inexact=name in INEXACT, what=f"{tag} {name}")
        for a, b in zip(st, rst):
            _assert_trees(tuple(_bits(x) for x in a),
                          tuple(_bits(x) for x in b), f"{tag} state")
        _same_stream_result(agg.push(g, k, nv, ts), aref.push(g, k, nv, ts),
                            f"aggregator {tag}")
        assert agg.carry[1].keys.data_ptr() == ring
    for wr in wrappers:
        wr.launches = 0
    fin = agg.flush()
    assert tuple(wr.launches for wr in wrappers) == (1, 1, 1)
    _same_stream_result(fin, aref.flush(), "flush")
    assert int(fin.stats["late_dropped"]) == 6
    torch.cuda.synchronize()


def _same_stream_result(got, want, what):
    """Two ``StreamResult`` of several ops: every field, ``stats``
    included."""
    for f in ("groups", "valid", "num_groups", "rr_port"):
        assert_same(getattr(got, f), getattr(want, f), what=f"{what} {f}")
    for name, v in want.values.items():
        assert_same(got.values[name], v, inexact=name in INEXACT,
                    what=f"{what} {name}")
    assert_same(got.stats["late_dropped"], want.stats["late_dropped"],
                what=f"{what} late_dropped")
