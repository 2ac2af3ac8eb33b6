"""Shared parity harness of the port's CPU tests: the same numpy inputs go
through the JAX package (in the test process) and the port (in a spawned
child process, :data:`port`), and the full output arrays (padded tails
included) must agree.

Tolerance: element-exact, except float ``sum``/``mean`` (and ``variance``)
on float keys, which the port reduces in another order than XLA:
rtol = atol = 1e-5.
"""
from __future__ import annotations

import atexit
import functools
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest

FLOAT_REORDERED = ("sum", "mean", "variance")

#: XLA options of the JAX oracles: LLVM's machine-code optimisation off.
#: The HLO passes, which decide what the program computes, run as ever;
#: the machine code is slower, on inputs of a few hundred lanes, and it
#: compiles in about half the time (a 9-op sharded query: 25.9 -> 12.5
#: CPU seconds, outputs equal)
ORACLE_OPTIONS = {"xla_backend_optimization_level": 0,
                  "xla_llvm_disable_expensive_passes": True}


def oracle_jit(fun=None, **kw):
    """``jax.jit`` for a JAX oracle of the port's tests, compiled with
    :data:`ORACLE_OPTIONS`; usable as a decorator."""
    import jax  # the test process only: the port's child holds no JAX

    if fun is None:
        return functools.partial(oracle_jit, **kw)
    return jax.jit(fun, compiler_options=ORACLE_OPTIONS, **kw)


def _call(name, args, kwargs):
    """Run ``_torch_side.<name>`` — in the child process, with the port's
    metrics registry cleared first (as ``conftest`` clears JAX's after
    every test), so no earlier call steers ``auto``."""
    import _torch_side
    from repro_torch.obs.registry import METRICS

    METRICS.reset()
    return getattr(_torch_side, name)(*args, **kwargs)


class Port:
    """Calls into ``_torch_side`` in one spawned child that holds torch;
    exceptions raised there re-raise here with their type and message."""

    def __init__(self, executor: ProcessPoolExecutor):
        self._executor = executor

    def __getattr__(self, name):
        def call(*args, **kwargs):
            try:
                return self._executor.submit(_call, name, args,
                                             kwargs).result(timeout=600)
            except BrokenProcessPool:
                _drop_child(self._executor)
                raise
        return call


#: the one child of this test process (an xdist worker), shared by every
#: test file: a child a file cost each worker a spawn and a torch import
#: (~3 s) every time it moved on to another file
_CHILD: list = []


def _drop_child(executor) -> None:
    """Forget a child that died, so the next test spawns a fresh one."""
    if _CHILD and _CHILD[0] is executor:
        _CHILD.clear()


def _init_child() -> None:
    """The child's torch on one thread: the xdist workers beside it keep
    the cores busy, and its tensors are small (idle intra-op threads only
    spin)."""
    import torch

    torch.set_num_threads(1)


def _child() -> ProcessPoolExecutor:
    if not _CHILD:
        ctx = multiprocessing.get_context("spawn")
        executor = ProcessPoolExecutor(max_workers=1, mp_context=ctx,
                                       initializer=_init_child)
        # start the child now: it imports torch while the test process
        # compiles its first JAX side
        executor.submit(_call, "cuda_available", (), {})
        atexit.register(executor.shutdown, wait=True)
        _CHILD.append(executor)
    return _CHILD[0]


@pytest.fixture(scope="module")
def port():
    return Port(_child())


#: the JAX backend each of the port's backends is held against
PAIRS = {"reference": "reference", "cuda": "pallas",
         "cuda-panes": "pallas-panes", "cuda-panestore": "pallas-panestore"}


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
    want = oracle_jit(lambda g, k: jq.execute(
        q, g, k, backend=PAIRS[backend], use_xla_sort=True)[0])(
        None if g is None else jnp.array(g), jnp.array(k))
    got = port.execute(ops, g, k, backend=backend, window=window, query=kw)
    return want, got


#: jitted JAX sharded queries, one a (query, backend, shards, tile, n_valid
#: or not): a case that repeats a query on other data compiles nothing
_SHARDED_JIT: dict = {}


def execute_both_sharded(port, ops, g, k, *, backend, window=None,
                         num_shards=None, mesh=None, jax_backend=None,
                         n_valid=None, tile=1024, **kw):
    """The sharded twin of :func:`execute_both`: the query through
    ``repro.query.execute(..., num_shards=S)`` under the paired JAX backend
    (or ``jax_backend``), jitted, and through the port's ``execute`` with
    ``num_shards=S`` or ``mesh`` (a list of device names; JAX then shards
    ``len(mesh)`` ways) on the CPU: (want, got)."""
    import jax  # the test process only: the port's child holds no JAX
    import jax.numpy as jnp

    from repro import query as jq

    shards = len(mesh) if mesh is not None else num_shards
    jb = jax_backend or PAIRS[backend]
    key = (tuple(ops) if isinstance(ops, (tuple, list)) else ops,
           None if window is None else tuple(sorted(window.items())),
           tuple(sorted(kw.items())), jb, shards, tile, n_valid is None)
    if key not in _SHARDED_JIT:
        q = jq.Query(ops=ops, window=None if window is None
                     else jq.Window(**window), **kw)
        _SHARDED_JIT[key] = oracle_jit(lambda g, k, nv: jq.execute(
            q, g, k, backend=jb, num_shards=shards, n_valid=nv, tile=tile,
            use_xla_sort=True)[0])
    want = _SHARDED_JIT[key](
        None if g is None else jnp.array(g), jnp.array(k),
        None if n_valid is None else jnp.asarray(n_valid, jnp.int32))
    got = port.execute(ops, g, k, backend=backend, window=window, query=kw,
                       tile=tile, n_valid=n_valid,
                       **({"mesh": mesh} if mesh is not None
                          else {"num_shards": num_shards}))
    return want, got


def assert_valid_lanes_same(want, got, *, float_keys=False):
    """Two results agree where ``want`` is valid (``valid`` and
    ``num_groups`` everywhere): what ``tests/test_query_exec.py`` holds a
    sharded result to against one device."""
    v = np.asarray(want.valid)
    assert_same(want.valid, got.valid, name="valid")
    assert_same(want.num_groups, got.num_groups, name="num_groups")
    assert_same(np.asarray(want.groups)[v], np.asarray(got.groups)[v],
                name="groups")
    assert set(want.values) == set(got.values)
    for name in want.values:
        assert_same(np.asarray(want.values[name])[v],
                    np.asarray(got.values[name])[v], name=name,
                    float_keys=float_keys)


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


# ------------------------------------------------ the LLM serving path (9a)

#: the float32 tolerance of the model tests: the port multiplies and sums
#: in another order than XLA (matrix products, einsums, scans)
LLM_TOL = dict(rtol=1e-4, atol=1e-4)


def llm_config(arch, **overrides):
    """The JAX package's reduced ``arch`` in float32 (overrides first)."""
    from repro.configs import get_config

    return get_config(arch).reduced(**{"dtype": "float32", **overrides})


def _leaf(name: str, shape, rng) -> np.ndarray:
    """A parameter drawn with numpy: matrices N(0, 1/fan_in), scales about
    one, the rest small and nonzero (biases, gates, bonuses), so that every
    path of a block carries signal (the JAX init zeroes several)."""
    n = rng.standard_normal(shape).astype(np.float32)
    if name in ("scale", "gn_scale", "d_skip"):
        return 1.0 + 0.1 * n
    if name == "w_base":
        return -6.0 + 0.5 * n
    if name == "a_log":
        return np.log(np.linspace(1.0, 16.0, shape[0],
                                  dtype=np.float32)) + 0.1 * n
    if name in ("gate_attn", "gate_mlp", "mix_k", "mix_r"):
        return 0.5 + 0.1 * n
    if len(shape) >= 2 and name != "u":
        return n / np.sqrt(shape[-2])
    return 0.1 * n


def jax_params(cfg, seed: int = 0):
    """The parameter tree of ``repro.models.model.init_model(key, cfg)``
    (its shapes and dtypes traced, not run: no compile), every leaf drawn
    with numpy from ``seed`` (:func:`_leaf`)."""
    import jax

    from repro.models import model as MDL

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: MDL.init_model(key, cfg),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf(path[-1].key, s.shape, rng).astype(s.dtype),
        shapes)


def llm_memory(cfg, batch: int, rng):
    """The memory inputs of a float32 ``cfg``: ``(memory,
    encoder_embeds)``, numpy (``None`` where the family has none)."""
    if cfg.is_encoder_decoder:
        e = 0.5 * rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model))
        return None, e.astype(np.float32)
    if cfg.cross_attn_every:
        m = 0.5 * rng.standard_normal((batch, cfg.num_image_tokens,
                                       cfg.d_model))
        return m.astype(np.float32), None
    return None, None


def assert_close(got, want, *, name="", **tol):
    """Float arrays within ``tol`` (default :data:`LLM_TOL`), compared in
    float32."""
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               err_msg=name, **(tol or LLM_TOL))
