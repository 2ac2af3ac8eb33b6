"""The port's serving steps against the JAX package's, on the CPU: the
serve loop (``repro_torch.launch.serve.generate``: prompts prefilled token
by token through ``make_decode_step``, then greedy generation) teacher-
forced with the JAX loop's tokens, every step's logits within rtol = atol
= 1e-4 and the greedy tokens exact; the launcher's command line; the
engine's serving step ``make_query_step`` (mirroring
``tests/test_query.py::test_make_query_step_*`` and
``tests/test_panestore.py::test_make_query_step_pergroup_stream``, results
exact); and the configs registry (``tests/test_archs.py``'s spot fields).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from _torch_parity import (assert_close, assert_result_same,  # noqa: F401
                           assert_valid_lanes_same, jax_params, llm_config,
                           oracle_jit, port)
from repro_torch.interop import make_stream

ARCHS = ("arctic-480b", "chatglm3-6b", "granite-3-8b", "internlm2-1.8b",
         "llama-3.2-vision-11b", "mixtral-8x7b", "qwen1.5-4b", "rwkv6-1.6b",
         "whisper-medium", "zamba2-1.2b")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "zamba2-1.2b"])
def test_serve_teacher_forced_matches_jax(port, arch):
    """The JAX launcher's loop (``src/repro/launch/serve.py``: prefill
    through the decode step, then greedy argmax over the vocabulary) and
    the port's ``generate`` fed the JAX tokens: each of the 6 + 10 steps'
    logits, and the tokens the port picks."""
    import jax.numpy as jnp

    from repro.models import model as MDL

    cfg = llm_config(arch)
    tree = jax_params(cfg, seed=7)
    rng = np.random.default_rng(7)
    plen, gen = 6, 10
    prompts = rng.integers(0, cfg.vocab_size, (2, plen)).astype(np.int32)
    step = oracle_jit(lambda p, tok, st: MDL.decode_step(p, cfg, tok, st))
    state = MDL.init_decode_state(tree, cfg, 2, plen + gen)
    logits, out = [], []
    for t in range(plen + gen):
        if t < plen:
            tok = prompts[:, t]
        else:
            tok = np.asarray(jnp.argmax(
                logits[-1][:, :cfg.vocab_size], axis=-1)).astype(np.int32)
            out.append(tok)
        lg, state = step(tree, tok, state)
        logits.append(np.asarray(lg))
    want_tokens = np.stack(out, axis=1)
    tokens, got = port.llm_serve(arch, {"dtype": "float32"}, tree, prompts,
                                 gen, forced=want_tokens)
    assert_close(got, np.stack(logits, axis=1))
    np.testing.assert_array_equal(tokens, want_tokens)


def test_serve_launcher_runs_on_the_cpu(port):
    """``python -m repro_torch.launch.serve`` with the JAX launcher's flags
    and ``--device cpu``."""
    rc, text = port.serve_main(["--arch", "zamba2-1.2b", "--reduced",
                                "--batch", "2", "--prompt-len", "4",
                                "--gen", "3", "--device", "cpu"])
    assert rc == 0
    assert "[serve] zamba2-1.2b on cpu: prefill 4 tok x 2 reqs" in text
    assert "generated 3 tok/req" in text


# ------------------------------------------------------- make_query_step

def _jax_steps(query, batches, *, streaming, backend="reference"):
    import jax.numpy as jnp

    from repro.distributed.steps import make_query_step
    from repro.query import init_stream_state

    step, p = make_query_step(query, backend=backend)
    state = init_stream_state(p) if streaming else None
    out = []
    for g, k in batches:
        if streaming:
            res, state = step(jnp.array(g), jnp.array(k), state)
        else:
            res = step(jnp.array(g), jnp.array(k))
        out.append(res)
    return out


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_make_query_step_streaming(port, backend):
    """A rolling stream in two pushes through the step, the carry threaded
    (on ``cuda`` the segmented-scan kernel's plain version)."""
    from repro.query import Query

    g, k = make_stream(3, 64, 5, 100, sorted_by="group")
    batches = [(g[:32], k[:32]), (g[32:], k[32:])]
    want = _jax_steps(Query(ops=("sum", "count"), streaming=True), batches,
                      streaming=True)
    name, got = port.query_steps(("sum", "count"), batches, backend=backend,
                                 streaming=True)
    assert name == backend
    for w, r in zip(want, got):
        assert_result_same(w, r)


def test_make_query_step_batch(port):
    """A batch query planned once and stepped twice; and the same query
    with ``shard=True`` over a mesh of two CPU entries (one logical
    answer, equal to one device's on the valid lanes)."""
    from repro.query import Query

    g, k = make_stream(4, 64, 5, 100, sorted_by="group_key")
    batches = [(g, k), (g[:40], k[:40])]
    want = _jax_steps(Query(ops=("sum", "max")), batches, streaming=False)
    _, got = port.query_steps(("sum", "max"), batches, backend="reference")
    for w, r in zip(want, got):
        assert_result_same(w, r)
    name, got = port.query_steps(("sum", "max"), batches[:1],
                                 backend="reference", mesh=["cpu", "cpu"],
                                 shard=True)
    assert name == "reference"
    assert_valid_lanes_same(want[0], got[0])


@pytest.mark.parametrize("backend", ["reference", "cuda-panestore"])
def test_make_query_step_pergroup_stream(port, backend):
    """A streaming count window (each group's own last 8 tuples, panes of
    4) through the step, the pane store threaded."""
    from repro.query import Query, Window

    g, k = make_stream(5, 64, 3, 100)
    batches = [(g[:32], k[:32]), (g[32:], k[32:])]
    want = _jax_steps(Query(("sum",), window=Window(ws=8, wa=4),
                            streaming=True), batches, streaming=True)
    _, got = port.query_steps(("sum",), batches, backend=backend,
                              window={"ws": 8, "wa": 4}, streaming=True)
    for w, r in zip(want, got):
        assert_result_same(w, r)


# ---------------------------------------------------------------- configs

def test_configs_registry_matches_jax(port):
    """Every registered architecture, full and reduced, field for field;
    the shape grid, the applicability matrix (33 live cells of 40) and the
    paper's engine configs."""
    from repro import configs as C
    from repro.configs import paper_engine

    got = port.configs_table()
    archs = C.list_archs()
    assert got["archs"] == archs
    for a in archs:
        assert got["full"][a] == dataclasses.asdict(C.get_config(a)), a
        assert got["reduced"][a] == dataclasses.asdict(
            C.get_config(a).reduced()), a
    assert got["shapes"] == {n: dataclasses.asdict(s)
                             for n, s in C.SHAPES.items()}
    want = {(a, n): C.base.shape_applicable(C.get_config(a), s)[0]
            for a in archs for n, s in C.SHAPES.items()}
    assert got["applicable"] == want
    assert sum(want.values()) == 33
    assert got["engine"] == [dataclasses.asdict(paper_engine.config()),
                             dataclasses.asdict(paper_engine.config_dc()),
                             paper_engine.config_dc().op_list]


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_full_config_exact(port, arch):
    """The port's full config matches the assigned spec (the spot fields of
    ``tests/test_archs.py::test_arch_full_config_exact``)."""
    spec = {
        "rwkv6-1.6b": (24, 2048, 7168, 65536),
        "internlm2-1.8b": (24, 2048, 8192, 92544),
        "qwen1.5-4b": (40, 2560, 6912, 151936),
        "granite-3-8b": (40, 4096, 12800, 49155),
        "chatglm3-6b": (28, 4096, 13696, 65024),
        "mixtral-8x7b": (32, 4096, 14336, 32000),
        "arctic-480b": (35, 7168, 4864, 32000),
        "zamba2-1.2b": (38, 2048, 8192, 32000),
        "whisper-medium": (24, 1024, 4096, 51865),
        "llama-3.2-vision-11b": (40, 4096, 14336, 128256),
    }[arch]
    cfg = port.configs_table()["full"][arch]
    assert cfg["name"] == arch
    assert (cfg["num_layers"], cfg["d_model"], cfg["d_ff"],
            cfg["vocab_size"]) == spec
