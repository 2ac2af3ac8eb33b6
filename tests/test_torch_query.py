"""The slice as a whole: ``repro_torch.query.execute(..., device="cpu")``
under ``reference``, ``cuda`` and ``cuda-panes`` against
``repro.query.execute`` under ``reference``, ``pallas`` and
``pallas-panes`` (Pallas interpret mode), on the same numpy inputs.

Here: the group-by engine and float keys (count windows over int keys are
in ``test_torch_windows.py``).  Int32 keys: every array equal, padded tails
included.  Float32 keys: sum/mean within rtol = atol = 1e-5 (another
reduction order), the rest exact.  Also: the port's capability probes and
the errors of what later slices bring, and that the package and
``chip_smoke.py`` import neither JAX nor ``repro``.  The port runs in its
own process (``_torch_parity.port``).
"""
from __future__ import annotations

import ast
import pathlib

import numpy as np
import pytest

from _torch_parity import assert_result_same, port  # noqa: F401 (fixture)
from _torch_parity import execute_both
from repro_torch.interop import make_stream

@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("ops,kw", [
    (("sum", "dc", "median"), {}),       # on cuda: the one-row swag kernel
    (("count", "mean"), {"n_valid": 80}),
    (("max",), {"group_by": False}),
])
def test_engine_matches_jax(port, backend, ops, kw):
    g, k = make_stream(11, 100, 9, 40, sorted_by="group_key")
    want, got = execute_both(port, ops,
                             None if kw.get("group_by") is False else g,
                             k, backend=backend, **kw)
    assert_result_same(want, got)


@pytest.mark.parametrize("backend", ["reference", "cuda", "cuda-panes"])
def test_float_keys_match_jax(port, backend):
    g, k = make_stream(14, 160, 5, 10, dtype=np.float32,
                       sorted_by="group_key")
    want, got = execute_both(port, ("sum", "mean", "min", "median"), g, k,
                             backend=backend, window={"ws": 16, "wa": 4})
    assert_result_same(want, got, float_keys=True)
    if backend != "cuda-panes":
        want, got = execute_both(port, ("mean",), g, k, backend=backend)
        assert_result_same(want, got, float_keys=True)


def test_auto_picks_reference_on_cpu_and_probes_match_jax(port):
    assert port.plan_backend("sum", window={"ws": 64, "wa": 16}) \
        == "reference"
    cases = [
        (("sum",), "cuda", {"ws": 48, "wa": 16}, {}, "power-of-two WS"),
        (("argmin",), "cuda", None, {}, "global iota"),
        (("median",), "cuda", None, {"interpolate": True}, "lower-median"),
        (("sum",), "cuda-panes", None, {}, "windowed-query backend"),
        (("sum",), "cuda-panes", {"ws": 64, "wa": 24}, {},
         "power-of-two WS/WA"),
        (("sum",), "cuda", {"ws": 64, "wa": 16, "panes": True}, {},
         "cuda-panes backend"),
        (("sum",), "cuda", {"ws": 64}, {"presorted": True}, "always sort"),
    ]
    for ops, backend, window, query, msg in cases:
        with pytest.raises(ValueError, match=msg):
            port.plan_backend(ops, backend=backend, window=window,
                              query=query)


def test_later_slices_raise_not_implemented(port):
    g = np.zeros(8, np.int32)
    with pytest.raises(NotImplementedError, match="slice 3"):
        port.plan_backend("sum", query={"streaming": True})
    with pytest.raises(NotImplementedError, match="slice 6"):
        port.swag_per_group_counters()
    with pytest.raises(NotImplementedError, match="slice 5"):
        port.make_window(range=10)
    with pytest.raises(NotImplementedError, match="slice 6"):
        port.execute("sum", g, g, backend=None, collect_stats=True)
    with pytest.raises(NotImplementedError, match="slice 7"):
        port.execute("sum", g, g, backend=None, num_shards=2)


def test_cuda_device_without_a_card_raises(port):
    if port.cuda_available():
        pytest.skip("a card is present: device='cuda' runs")
    g = np.zeros(8, np.int32)
    with pytest.raises(RuntimeError, match="is_available"):
        port.execute("sum", g, g, backend=None, device="cuda")


def test_package_imports_neither_jax_nor_repro():
    # every import statement of the package and of chip_smoke.py, those
    # inside functions included
    root = pathlib.Path(__file__).resolve().parents[1]
    files = [*sorted((root / "src" / "repro_torch").rglob("*.py")),
             root / "chip_smoke.py"]
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [f"{path.name}: {n}" for n in names
                      if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 15 and found == []
