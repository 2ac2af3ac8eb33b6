"""Shared parity harness of the port's CPU tests: the same numpy inputs go
through the JAX package (in the test process) and the port (in a spawned
child process, :data:`port`), and the full output arrays (padded tails
included) must agree.

Tolerance: element-exact, except float ``sum``/``mean`` (and ``variance``)
on float keys, which the port reduces in another order than XLA:
rtol = atol = 1e-5.
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

FLOAT_REORDERED = ("sum", "mean", "variance")


def _call(name, args, kwargs):
    """Run ``_torch_side.<name>`` — in the child process."""
    import _torch_side

    return getattr(_torch_side, name)(*args, **kwargs)


class Port:
    """Calls into ``_torch_side`` in one spawned child that holds torch;
    exceptions raised there re-raise here with their type and message."""

    def __init__(self, executor: ProcessPoolExecutor):
        self._executor = executor

    def __getattr__(self, name):
        def call(*args, **kwargs):
            return self._executor.submit(_call, name, args,
                                         kwargs).result(timeout=600)
        return call


@pytest.fixture(scope="module")
def port():
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as executor:
        # start the child now: it imports torch while the test process
        # compiles its first JAX side
        executor.submit(_call, "cuda_available", (), {})
        yield Port(executor)


#: the JAX backend each of the port's backends is held against
PAIRS = {"reference": "reference", "cuda": "pallas",
         "cuda-panes": "pallas-panes"}


def execute_both(port, ops, g, k, *, backend, window=None, **kw):
    """One query through ``repro.query.execute`` under the paired JAX
    backend and through the port's ``execute`` on the CPU: (want, got)."""
    import jax  # the test process only: the port's child holds no JAX
    import jax.numpy as jnp

    from repro import query as jq

    q = jq.Query(ops=ops, window=None if window is None
                 else jq.Window(**window), **kw)
    # one jit of the whole JAX query (eager, every primitive compiles on
    # its own); XLA's sort in the reference: the (group, key)-sorted
    # windows are unique, so it gives the network's result
    want = jax.jit(lambda g, k: jq.execute(
        q, g, k, backend=PAIRS[backend], use_xla_sort=True)[0])(
        None if g is None else jnp.array(g), jnp.array(k))
    got = port.execute(ops, g, k, backend=backend, window=window, query=kw)
    return want, got


def assert_same(want, got, *, name="", float_keys=False):
    """``want`` from JAX, ``got`` from the port: same dtype, same values."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype, (name, want.dtype, got.dtype)
    assert want.shape == got.shape, (name, want.shape, got.shape)
    if float_keys and name in FLOAT_REORDERED:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def assert_result_same(want, got, *, float_keys=False):
    """Two results (JAX's ``AggResult``, the port's in numpy) hold the
    same arrays."""
    assert_same(want.groups, got.groups, name="groups")
    assert_same(want.valid, got.valid, name="valid")
    assert_same(want.num_groups, got.num_groups, name="num_groups")
    assert set(want.values) == set(got.values)
    for name in want.values:
        assert_same(want.values[name], got.values[name], name=name,
                    float_keys=float_keys)
