"""The port's slice 8 against the JAX package on the CPU: the deprecated
entry points (``repro_torch.core.group_by_aggregate``,
``multi_aggregate``, ``repro_torch.core.swag.swag``, ``swag_median``,
``repro_torch.kernels.groupagg.ops.group_by_aggregate_cuda`` and
``repro_torch.kernels.swag.ops.swag_cuda``), the entity-count complexity
model (``repro_torch.core.complexity``) and ``repro_torch.data.
domain_stats``.

Mirrors ``tests/test_backcompat.py``: each shim emits exactly one
DeprecationWarning naming ``repro_torch.query`` (the delegate triggers no
second shim) and returns what the JAX shim returns on the same inputs,
padded tails included (element-exact; the ``_cuda`` shims run their
kernels' plain versions on CPU tensors, held to the JAX ``pallas`` shims in
interpret mode).  Float ``mean`` values within rtol = atol = 1e-5 (the
port reduces in another order).  The JAX shims run jitted
(``_torch_parity.oracle_jit``); the port runs in its own process
(``_torch_parity.port``).
"""
from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_same, oracle_jit
from _torch_parity import port  # noqa: F401 (fixture)
from conftest import sorted_stream
from repro.core import complexity as jcx
from repro.core import (group_by_aggregate, multi_aggregate, swag,
                        swag_median)
from repro.data import domain_stats
from repro.kernels.groupagg.ops import group_by_aggregate_tpu
from repro.kernels.swag.ops import swag_tpu

WS, WA = 32, 16


def _quiet(fn, g, k, *args, **kwargs):
    """The JAX shim, jitted (its warning, raised while tracing, muted)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return oracle_jit(lambda g, k: fn(g, k, *args, **kwargs))(g, k)


def _same(want, got, what, float_keys=False):
    assert len(want) == len(got), what
    for i, (a, b) in enumerate(zip(want, got)):
        name = "mean" if float_keys and i == 1 else f"{what}[{i}]"
        assert_same(np.asarray(a), b, name=name, float_keys=float_keys)


def _one_warning(dep, name):
    assert len(dep) == 1, (name, dep)
    assert "is deprecated" in dep[0]


@pytest.mark.parametrize("op", ["sum", "min", "count", "distinct_count"])
def test_group_by_aggregate_shim(port, op, rng):
    g, k = sorted_stream(rng, 128, 9, full_sort=True)
    want = _quiet(group_by_aggregate, jnp.array(g), jnp.array(k), op)
    dep, kind, got = port.shim("group_by_aggregate", g, k, op)
    _one_warning(dep, op)
    assert kind == "GroupAggResult"
    _same(want, got, op)


def test_multi_aggregate_shim(port, rng):
    g, k = sorted_stream(rng, 128, 9, full_sort=True)
    ops = ("sum", "min", "distinct_count")
    want = _quiet(multi_aggregate, jnp.array(g), jnp.array(k), ops)
    dep, kind, got = port.shim("multi_aggregate", g, k, ops)
    _one_warning(dep, "multi")
    assert kind == "dict" and set(got) == set(ops)
    for op in ops:
        _same(want[op], got[op], op)


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("panes", [None, False, True])
def test_swag_shim(port, op, panes, rng):
    g = rng.integers(0, 6, 96).astype(np.int32)
    k = rng.integers(0, 50, 96).astype(np.int32)
    want = _quiet(swag, jnp.array(g), jnp.array(k), ws=WS, wa=WA, op=op,
                  use_xla_sort=True, panes=panes)
    dep, kind, got = port.shim("swag", g, k, ws=WS, wa=WA, op=op,
                               panes=panes)
    _one_warning(dep, op)
    assert kind == "GroupAggResult"
    _same(want, got, op)


def test_swag_shim_median_still_raises(port):
    z = np.zeros(64, np.int32)
    with pytest.raises(ValueError, match="median"):
        port.shim("swag", z, z, ws=WS, wa=WA, op="median")


@pytest.mark.parametrize("panes", [None, False])
def test_swag_median_shim(port, panes, rng):
    g = rng.integers(0, 6, 96).astype(np.int32)
    k = rng.integers(0, 50, 96).astype(np.int32)
    want = _quiet(swag_median, jnp.array(g), jnp.array(k), ws=WS, wa=WA,
                  use_xla_sort=True, panes=panes)
    dep, kind, got = port.shim("swag_median", g, k, ws=WS, wa=WA,
                               panes=panes)
    _one_warning(dep, "median")
    assert kind == "MedianResult"
    _same(want, got, "median")


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_group_by_aggregate_cuda_shim(port, op, rng):
    g, k = sorted_stream(rng, 300, 11)
    want = _quiet(group_by_aggregate_tpu, jnp.array(g), jnp.array(k), op,
                  tile=128)
    dep, kind, got = port.shim("group_by_aggregate_tpu", g, k, op, tile=128)
    _one_warning(dep, op)
    assert kind == "GroupAggResult"
    _same(want, got, op, float_keys=op == "mean")


@pytest.mark.parametrize("op", ["sum", "median"])
@pytest.mark.parametrize("panes", [None, False])
def test_swag_cuda_shim(port, op, panes, rng):
    g = rng.integers(0, 6, 128).astype(np.int32)
    k = rng.integers(0, 50, 128).astype(np.int32)
    want = _quiet(swag_tpu, jnp.array(g), jnp.array(k), ws=WS, wa=WA, op=op,
                  panes=panes)
    dep, kind, got = port.shim("swag_tpu", g, k, ws=WS, wa=WA, op=op,
                               panes=panes)
    _one_warning(dep, op)
    assert kind == "SwagResult"
    _same(want, got, op)


def test_complexity_matches_jax(port):
    ps = [2 ** i for i in range(1, 17)]
    want = [(jcx.prra_entities(p), jcx.engine_entities(p),
             jcx.modular_entities(p), jcx.reduction_ratio(p)) for p in ps]
    assert port.complexity_table(ps) == want
    for bad in (0, 1, 3, 12):
        with pytest.raises(ValueError) as e:
            jcx.engine_entities(bad)
        assert port.complexity_raises(bad) == str(e.value)


@pytest.mark.parametrize("ops", [("mean", "count", "min", "max"),
                                 ("sum", "dc")])
def test_domain_stats_matches_jax(port, ops, rng):
    d = rng.integers(0, 5, 64).astype(np.int32)
    v = rng.normal(size=64).astype(np.float32)
    if "dc" in ops:
        v = rng.integers(0, 7, 64).astype(np.int32)
    want = _quiet(domain_stats, jnp.array(d), jnp.array(v), ops)
    got = port.domain_stats(d, v, ops)
    assert set(got) == set(want)
    for op in ops:
        _same(want[op], got[op], op, float_keys=v.dtype == np.float32)
