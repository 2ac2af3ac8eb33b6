"""The port's LLM model stack (``repro_torch.models``) against the JAX
package's (``repro.models``), on the CPU: layers, attention and its caches,
the linear scans, RWKV and Mamba (sequence and step forms), MoE dispatch,
the forward of every architecture and ten decode steps of one architecture
a family.  The same numpy inputs and weights go to both; the JAX oracles
are jitted once a config (``_torch_parity.oracle_jit``) and the JAX
parameters are carried across (``repro_torch.interop``).

Tolerance: integers (experts, ranks, kept slots, expert counts, decode
positions) exact; float32 activations and logits rtol = atol = 1e-4
(another order of products and sums); the one bf16 case 2e-2.
"""
from __future__ import annotations

import numpy as np
import pytest

from _torch_parity import (assert_close, jax_params, llm_config, llm_memory,
                           oracle_jit, port)  # noqa: F401

B = 2

#: one architecture a family for the decode tests
DECODE_ARCHS = ("chatglm3-6b", "mixtral-8x7b", "rwkv6-1.6b", "zamba2-1.2b",
                "whisper-medium", "llama-3.2-vision-11b")

ARCHS = ("arctic-480b", "chatglm3-6b", "granite-3-8b", "internlm2-1.8b",
         "llama-3.2-vision-11b", "mixtral-8x7b", "qwen1.5-4b", "rwkv6-1.6b",
         "whisper-medium", "zamba2-1.2b")


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------- layers

def test_norms_rope_and_positions_match_jax(port):
    import jax.numpy as jnp

    from repro.models import layers as L

    rng = np.random.default_rng(0)
    x = _np(rng, 2, 5, 32)
    scale, bias = 1 + _np(rng, 32, scale=0.1), _np(rng, 32, scale=0.1)
    pos = np.arange(3, 8, dtype=np.int32)
    xr = _np(rng, 2, 5, 3, 16)
    want = {
        "rms": L.rmsnorm({"scale": jnp.array(scale)}, jnp.array(x)),
        "ln": L.layernorm({"scale": jnp.array(scale),
                           "bias": jnp.array(bias)}, jnp.array(x)),
        "sin": L.sinusoidal_positions(7, 32),
    }
    got = {
        "rms": port.call("repro_torch.models.layers", "rmsnorm",
                         {"scale": scale}, x),
        "ln": port.call("repro_torch.models.layers", "layernorm",
                        {"scale": scale, "bias": bias}, x),
        "sin": port.call("repro_torch.models.layers", "sinusoidal_positions",
                         7, 32),
    }
    for rd in (16, 8):  # standard and partial (chatglm3's half) rotary
        s, c = L.rope_angles(jnp.array(pos), rd, 1e4)
        want[f"rope{rd}"] = L.apply_rope(jnp.array(xr), s, c, rd)
        sp, cp = port.call("repro_torch.models.layers", "rope_angles", pos,
                           rd, 1e4)
        assert_close(sp, s, name="sin")
        got[f"rope{rd}"] = port.call("repro_torch.models.layers",
                                     "apply_rope", xr, sp, cp, rd)
    np.testing.assert_array_equal(got["rope8"][..., 8:], xr[..., 8:])
    for name, w in want.items():
        assert_close(got[name], w, name=name)


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("mode,window,h,hkv,q_block,t", [
    ("causal", 0, 4, 2, 0, 16),
    ("full", 0, 8, 1, 0, 16),
    ("swa", 4, 4, 4, 0, 16),
    ("causal", 0, 2, 2, 16, 64),   # blocked over queries
    ("swa", 16, 2, 2, 32, 128),    # the sliced key span
])
def test_attend_matches_jax(port, mode, window, h, hkv, q_block, t):
    import jax.numpy as jnp

    from repro.models import attention as A

    rng = np.random.default_rng(t + h)
    q, k, v = _np(rng, 1, t, h, 8), _np(rng, 1, t, hkv, 8), \
        _np(rng, 1, t, hkv, 8)
    want = oracle_jit(lambda q, k, v: A.attend(
        q, k, v, mode=mode, window=window, q_block=q_block))(
        jnp.array(q), jnp.array(k), jnp.array(v))
    got = port.call("repro_torch.models.attention", "attend", q, k, v,
                    mode=mode, window=window, q_block=q_block)
    assert_close(got, want)


@pytest.mark.parametrize("mode", ["dense", "ring", "prefill"])
def test_decode_cache_matches_jax(port, mode):
    """Appending one step at a time to a dense cache, or to a ring of the
    window's size, or after a prefill of the first four steps
    (``cache_prefill``), and attending against it."""
    import jax.numpy as jnp

    from repro.models import attention as A

    rng = np.random.default_rng(1)
    t, ring = 10, mode == "ring"
    size = 4 if ring else 12
    first = 4 if mode == "prefill" else 0
    q, k, v = _np(rng, 1, t, 4, 8), _np(rng, 1, t, 2, 8), _np(rng, 1, t, 2, 8)

    @oracle_jit
    def jax_side(q, k, v):
        cache = A.init_cache(1, size, 2, 8, jnp.float32)
        if first:
            cache = A.cache_prefill(cache, k[:, :first], v[:, :first])
        outs = []
        for i in range(first, t):
            cache = A.cache_append(cache, k[:, i:i + 1], v[:, i:i + 1],
                                   ring=ring)
            outs.append(A.decode_attend(q[:, i:i + 1], cache))
        return jnp.concatenate(outs, axis=1)

    got = port.cache_decode(q, k, v, ring, size, first)
    assert_close(got, jax_side(jnp.array(q), jnp.array(k), jnp.array(v)))


# ------------------------------------------------------------ linear scan

@pytest.mark.parametrize("form", ["inclusive", "exclusive_bonus", "scalar",
                                  "step"])
def test_linear_scans_match_jax(port, form):
    import jax.numpy as jnp

    from repro.models import linear_scan as LS

    rng = np.random.default_rng(2)
    b, t, h, dk, dv = 2, 37, 3, 8, 5
    q, k, v = _np(rng, b, t, h, dk), _np(rng, b, t, h, dk), \
        _np(rng, b, t, h, dv)
    lw = -np.abs(_np(rng, b, t, h, dk))
    mod = "repro_torch.models.linear_scan"
    if form == "scalar":
        q2, k2, lw2 = q[:, :, 0], k[:, :, 0], lw[:, :, :, 0]
        args = (q2, k2, v, lw2)
        kw = dict(chunk=8, return_state=True)
        fn = "chunked_scalar_decay_scan"
        want = oracle_jit(lambda *a: LS.chunked_scalar_decay_scan(*a, **kw))(
            *map(jnp.array, args))
    elif form == "step":
        s = _np(rng, b, h, dk, dv)
        u = _np(rng, h, dk, scale=0.3)
        args = (q[:, 0], k[:, 0], v[:, 0], lw[:, 0], s)
        kw = dict(bonus=u, inclusive=False)
        fn = "decay_scan_step"
        want = oracle_jit(lambda *a: LS.decay_scan_step(
            *a, bonus=jnp.array(u), inclusive=False))(*map(jnp.array, args))
    else:
        incl = form == "inclusive"
        u = None if incl else _np(rng, h, dk, scale=0.3)
        args = (q, k, v, lw)
        kw = dict(inclusive=incl, chunk=16, return_state=True,
                  **({} if incl else {"bonus": u}))
        fn = "chunked_decay_scan"
        want = oracle_jit(lambda *a: LS.chunked_decay_scan(
            *a, **{**kw, **({} if incl else {"bonus": jnp.array(u)})}))(
            *map(jnp.array, args))
    got = port.call(mod, fn, *args, **kw)
    for g, w in zip(got, want):
        assert_close(g, w, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("block", ["rwkv", "mamba"])
def test_rwkv_mamba_sequence_and_step_match_jax(port, block):
    """Each block's sequence form and its token-by-token step form against
    the JAX package's, on the same weights (the JAX init with its zeroed
    leaves replaced by small draws)."""
    import jax
    import jax.numpy as jnp

    from repro.models import mamba as M
    from repro.models import rwkv as R

    rng = np.random.default_rng(3)
    d, s, t = 128, 16, 6
    x = _np(rng, 2, t, d, scale=0.1)
    if block == "rwkv":
        p = R.init_rwkv_time_mix(jax.random.PRNGKey(0), d, 0, jnp.float32)
    else:
        p = M.init_mamba(jax.random.PRNGKey(0), d, s, jnp.float32)
    p = {n: np.asarray(a) + (0.05 * rng.standard_normal(a.shape)).astype(
        np.float32) for n, a in p.items()}

    @oracle_jit
    def jax_side(p, x):
        if block == "rwkv":
            seq, _ = R.rwkv_time_mix(p, x, chunk=4)
            st = R.init_rwkv_state(2, d, jnp.float32)
            st = {"shift_t": st["shift_t"], "S": st["S"]}
            step = lambda xt, st: R.rwkv_time_mix_step(p, xt, st)  # noqa
        else:
            seq, _ = M.mamba_mix(p, x, ssm_state=s, chunk=4)
            st = M.init_mamba_state(2, d, s, jnp.float32)
            step = lambda xt, st: M.mamba_mix_step(p, xt, st,  # noqa
                                                   ssm_state=s)
        outs = []
        for i in range(t):
            y, st = step(x[:, i], st)
            outs.append(y)
        return seq, jnp.stack(outs, axis=1)

    want = jax_side(p, jnp.array(x))
    got = (port.rwkv_steps(p, x, 4) if block == "rwkv"
           else port.mamba_steps(p, x, s, 4))
    for g, w in zip(got, want):
        assert_close(g, w)
    assert_close(got[1], got[0], rtol=2e-3, atol=2e-3)


# -------------------------------------------------------------------- MoE

@pytest.mark.parametrize("capacity_factor", [8.0, 0.25])
def test_moe_matches_jax(port, capacity_factor):
    """The sorted dispatch (every assignment's expert, rank, kept flag and
    slot exact; the output within the float tolerance) and the one-hot
    baseline; at 0.25 the capacity drops assignments
    (``tests/test_moe.py::test_capacity_drops``)."""
    import jax
    import jax.numpy as jnp

    from repro.core import segscan
    from repro.core.combiners import get_combiner
    from repro.models import moe as MOE

    e, k, d, f, n = 8, 2, 16, 32, 64
    p = {name: np.asarray(a) for name, a in MOE.init_moe(
        jax.random.PRNGKey(0), d, f, e, jnp.float32).items()}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (n, d)))
    kw = dict(num_experts=e, num_experts_per_tok=k,
              capacity_factor=capacity_factor)

    @oracle_jit
    def jax_side(p, x):
        experts, _, _ = MOE.route(p, x, k)
        se, sperm = jax.lax.sort(
            (experts.reshape(-1), jnp.arange(n * k, dtype=jnp.int32)),
            num_keys=1, is_stable=True)
        cnt = get_combiner("count")
        rank = segscan.segmented_scan(segscan.segment_starts(se),
                                      cnt.lift(se), cnt) - 1
        cap = MOE._capacity(n, e, k, capacity_factor)
        keep = rank < cap
        slot = jnp.where(keep, se * cap + rank, e * cap)
        return (MOE.moe_sorted(p, x, **kw), MOE.moe_onehot(p, x, **kw),
                experts, (se, sperm, rank, keep, slot))

    (ys, ss), (yo, so), experts, disp = jax_side(p, jnp.array(x))
    got = port.moe_parts(p, x, e, k, capacity_factor, "swiglu")
    np.testing.assert_array_equal(got["experts"], experts)
    gd = got["dispatch"]
    for name, w in zip(("experts", "perm", "rank", "keep", "slot"), disp):
        np.testing.assert_array_equal(gd[name], w, err_msg=name)
    for kind, y, st in (("sorted", ys, ss), ("onehot", yo, so)):
        gy, gst = got[kind]
        assert_close(gy, y, name=kind)
        np.testing.assert_array_equal(gst["expert_counts"], st.expert_counts)
        assert_close(gst["aux_loss"], st.aux_loss, name="aux")
        assert_close(gst["dropped"], st.dropped, name="dropped")
    assert (float(ss.dropped) > 0) == (capacity_factor < 1)
    assert int(got["sorted"][1]["expert_counts"].sum()) == n * k


# ----------------------------------------------------- whole architectures

def _forward_oracle(cfg):
    from repro.models import model as MDL

    def run(p, tokens, memory, enc):
        if cfg.is_encoder_decoder:
            memory = MDL.encode(p, cfg, enc)
        logits, aux = MDL.forward(p, cfg, tokens, memory=memory)
        batch = {"tokens": tokens, "labels": tokens}
        if cfg.is_encoder_decoder:
            batch["encoder_embeds"] = enc
        elif memory is not None:
            batch["memory"] = memory
        loss, parts = MDL.loss_fn(p, cfg, batch, ce_chunk=4)
        return logits, aux, loss, parts

    return oracle_jit(run)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(port, arch):
    """Logits, MoE aux loss, the forward-only loss and the prefill step's
    next-token logits of every architecture, reduced, in float32."""
    cfg = llm_config(arch)
    rng = np.random.default_rng(4)
    tree = jax_params(cfg)
    tokens = rng.integers(0, cfg.vocab_size, (B, 8)).astype(np.int32)
    memory, enc = llm_memory(cfg, B, rng)
    logits, aux, loss, parts = _forward_oracle(cfg)(tree, tokens, memory,
                                                    enc)
    got = port.llm_forward(arch, {"dtype": "float32"}, tree, tokens,
                           memory=memory, encoder_embeds=enc)
    assert_close(got["logits"], logits, name="logits")
    assert_close(got["prefill"], np.asarray(logits)[:, -1], name="prefill")
    assert_close(got["aux"], aux, name="aux")
    assert_close(got["loss"], loss, name="loss")
    for name in ("ce", "aux", "zloss"):
        assert_close(got["parts"][name], parts[name], name=name)


def test_bf16_dense_forward_matches_jax(port):
    """One bfloat16 case: the casts inside the blocks put the roundings at
    the same places (rtol = atol = 2e-2)."""
    cfg = llm_config("granite-3-8b", dtype="bfloat16")
    rng = np.random.default_rng(5)
    tree = jax_params(cfg)
    tokens = rng.integers(0, cfg.vocab_size, (B, 8)).astype(np.int32)
    logits, *_ = _forward_oracle(cfg)(tree, tokens, None, None)
    got = port.llm_forward("granite-3-8b", {"dtype": "bfloat16"}, tree,
                           tokens)
    assert_close(got["logits"], logits, rtol=2e-2, atol=2e-2)


def _decode_oracle(cfg):
    from repro.models import model as MDL

    return oracle_jit(lambda p, tok, st: MDL.decode_step(p, cfg, tok, st))


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_jax(port, arch):
    """Ten decode steps of one architecture a family: the port's from its
    own fresh state, and the port's last five from the JAX state after the
    first five (``interop.decode_state_from_numpy``)."""
    import jax

    from repro.models import model as MDL

    cfg = llm_config(arch)
    rng = np.random.default_rng(6)
    tree = jax_params(cfg)
    tokens = rng.integers(0, cfg.vocab_size, (B, 10)).astype(np.int32)
    memory, enc = llm_memory(cfg, B, rng)
    if enc is not None:
        memory = oracle_jit(lambda p, e: MDL.encode(p, cfg, e))(tree, enc)
    state = MDL.init_decode_state(tree, cfg, B, 16, memory=memory)
    if memory is not None:
        state = MDL.precompute_cross_kv(tree, cfg, state, memory)
    step = _decode_oracle(cfg)
    want, mid = [], None
    for t in range(10):
        lg, state = step(tree, tokens[:, t], state)
        want.append(np.asarray(lg))
        if t == 4:
            mid = jax.tree.map(np.asarray, state)
    want = np.stack(want, axis=1)
    got, pos = port.llm_decode(arch, {"dtype": "float32"}, tree, tokens,
                               max_len=16, memory=None if enc is not None
                               else memory, encoder_embeds=enc)
    assert pos == 10
    assert_close(got, want, name="fresh")
    got, pos = port.llm_decode(arch, {"dtype": "float32"}, tree,
                               tokens[:, 5:], max_len=16, state=mid)
    assert pos == 10
    assert_close(got, want[:, 5:], name="continued")


def test_init_model_matches_jax_tree(port):
    """The port's own initialisation lays out the JAX tree: every layer's
    parameters under the JAX names and shapes (the stacks split), and the
    same parameter count and bytes (zamba2's shared block counted once)."""
    import jax

    from repro.models import model as MDL
    from repro.models.params import count_params, param_bytes

    for arch in ARCHS:
        cfg = llm_config(arch, dtype="bfloat16")
        tree = jax.eval_shape(lambda key: MDL.init_model(key, cfg),
                              jax.random.PRNGKey(0))
        shapes, n, nbytes = port.llm_init_tree(arch)
        assert n == count_params(tree), arch
        assert nbytes == param_bytes(tree), arch
        layers = [kind for kind, c in MDL.layer_runs(cfg) for _ in range(c)]
        i = 0
        for run, (kind, count) in zip(tree["runs"], MDL.layer_runs(cfg)):
            flat = jax.tree_util.tree_flatten_with_path(run)[0]
            for j in range(count):
                for path, leaf in flat:
                    name = ".".join(str(q.key) for q in path)
                    assert shapes[f"layers.{i + j}.p.{name}"] == \
                        leaf.shape[1:], (arch, name)
            i += count
        assert i == len(layers)
        assert shapes["embed"] == tree["embed"].shape
