"""Public names and behaviour of ported modules against the JAX package,
on the CPU: the backend environment variable (the port's own,
``REPRO_TORCH_BACKEND``, with the JAX package's precedence and eager
errors), ``register_backend``, ``register_combiner`` (a registered monoid
runs on ``reference`` in both packages with equal results; every kernel
backend refuses it with a reason), the paper's op sets, ``bitonic_merge``,
and ``repro_torch.core``'s re-exports (each name of ``repro.core``'s
``__init__`` exists in the port and is its counterpart, the lazy query
names included).  Results exact.
"""
from __future__ import annotations

import ast
import pathlib

import numpy as np
import pytest

from _torch_parity import assert_result_same, oracle_jit, port  # noqa: F401
from repro_torch.interop import make_stream

CORE_INIT = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro"
             / "core" / "__init__.py")


def test_backend_env_var_precedence_and_eager_errors(port):
    """``tests/test_obs.py::test_env_backend_validated_eagerly`` on the
    port's variable: an unknown value raises at plan time naming it and
    the backends; a known one is planned; the explicit argument wins;
    unset means ``auto``; an unknown explicit name raises.  The JAX
    package's ``REPRO_BACKEND`` (set to ``pallas``) is not read."""
    out = port.backend_env_cases()
    assert out["name"] == "REPRO_TORCH_BACKEND"
    for kind, msg in out["bad"]:
        assert kind == "ValueError"
        assert "REPRO_TORCH_BACKEND='no-such-engine'" in msg
        assert "available backends" in msg
    assert out["cuda"] == ("cuda", "cuda", "reference", "reference")
    assert out["unset"] == ("auto", "reference")
    assert out["bogus"][0] == "ValueError"
    assert "unknown backend 'bogus'" in out["bogus"][1]
    assert out["registered"] == ("probe-only", True)


def _sumsq():
    import jax.numpy as jnp

    from repro.core.combiners import Combiner

    return Combiner(name="sumsq", lift=lambda k: k * k,
                    op=lambda a, b: a + b, finalize=lambda s: s,
                    identity=lambda shape, dtype: jnp.zeros(shape, dtype))


def test_register_combiner_runs_on_reference(port):
    """The same monoid registered in both packages: engine and window
    results on ``reference`` equal; each kernel backend refuses it, naming
    the registered op, whatever the window."""
    import jax.numpy as jnp

    from repro import query as jq
    from repro.core import register_combiner

    register_combiner("sumsq", _sumsq)
    g, k = make_stream(8, 96, 6, 50, sorted_by="group_key")
    window = {"ws": 16, "wa": 8}
    got = port.registered_combiner(g, k, window)
    for kind, w in (("engine", None), ("window", window)):
        q = jq.Query(ops=("sumsq", "sum"),
                     window=None if w is None else jq.Window(**w))
        want = oracle_jit(lambda g, k: jq.execute(
            q, g, k, backend="reference", use_xla_sort=True)[0])(
            jnp.array(g), jnp.array(k))
        assert_result_same(want, got[kind])
    reasons = [v for key, v in got.items() if isinstance(key, tuple)]
    assert len(reasons) == 9
    for reason in reasons:
        assert reason and "['sumsq'] are registered combiners" in reason


def test_paper_op_sets_match_jax(port):
    from repro.core import combiners as jc

    names = ("PAPER_BASE_OPS", "PAPER_DC_OPS", "ALL_OPS")
    got = port.core_names(names)
    for name in names:
        assert got[name] == ("", repr(getattr(jc, name))), name
    assert jc.PAPER_DC_OPS[-1] == "distinct_count"


@pytest.mark.parametrize("n,num_keys", [(16, 1), (256, 2)])
def test_bitonic_merge_matches_jax(port, n, num_keys):
    """Two sorted halves (with ties) merged by one network stage, with a
    payload, against ``repro.core.sorter.bitonic_merge``."""
    import jax.numpy as jnp

    from repro.core.sorter import bitonic_merge

    rng = np.random.default_rng(n)
    keys = [np.sort(rng.integers(0, 7, (3, n // 2)).astype(np.int32))
            for _ in range(2)]
    a = np.concatenate(keys, axis=-1)
    b = rng.integers(0, 5, (3, n)).astype(np.int32)
    if num_keys == 2:  # each half sorted by (a, b)
        for lo in (0, n // 2):
            half = slice(lo, lo + n // 2)
            order = np.lexsort((b[:, half], a[:, half]), axis=-1)
            a[:, half] = np.take_along_axis(a[:, half], order, -1)
            b[:, half] = np.take_along_axis(b[:, half], order, -1)
    pay = np.arange(3 * n, dtype=np.float32).reshape(3, n)
    want = oracle_jit(lambda *ops: bitonic_merge(ops, num_keys=num_keys))(
        jnp.array(a), jnp.array(b), jnp.array(pay))
    got = port.call("repro_torch.core.sorter", "bitonic_merge", (a, b, pay),
                    num_keys=num_keys)
    for w, r in zip(want, got):
        np.testing.assert_array_equal(r, np.asarray(w))


def _jax_core_names() -> list:
    """The names ``src/repro/core/__init__.py`` exports: its imports and
    its lazy query names."""
    tree = ast.parse(CORE_INIT.read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Assign) and node.targets[0].id == \
                "_QUERY_NAMES":
            names += list(ast.literal_eval(node.value))
    return names


def test_core_reexports_are_the_counterparts(port):
    """Each name of ``repro.core`` exists in ``repro_torch.core`` and is
    the same kind of thing from the counterpart module (values equal);
    ``swag`` and ``swag_median`` are the functions, as in the JAX
    package, and the module's names import from ``repro_torch.core.swag``."""
    import inspect

    import repro.core as jcore

    names = _jax_core_names()
    assert len(names) > 40
    got = port.core_names(names)
    for name in names:
        obj = getattr(jcore, name)
        assert got[name] is not None, name
        if inspect.ismodule(obj):
            want = (obj.__name__.replace("repro.", "repro_torch.", 1),
                    "module")
        elif inspect.isclass(obj) or inspect.isfunction(obj):
            want = (obj.__module__.replace("repro.", "repro_torch.", 1),
                    type(obj).__name__)
        else:
            want = ("", repr(obj))
        assert got[name] == want, name
    assert got["swag"] == ("repro_torch.core.swag", "function")
    assert got["_swag_module"] == "repro_torch.core.swag"
