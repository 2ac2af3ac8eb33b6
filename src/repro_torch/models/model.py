"""Model assembly: configs -> parameters -> forward / loss / prefill /
decode (the JAX package's ``repro.models.model``).

A model is a :class:`Model`: an ``nn.Module`` holding the embedding, the
final norm, the LM head and one :class:`Block` a layer, in the order of
:func:`layer_plan`.  Where the JAX package stacks the layers of a *run*
(consecutive layers of one kind) and scans them, the port keeps a module a
layer and loops; the order is the stack's.  zamba2's shared attention
block is one module that every ``mamba_shared`` layer calls.

Layer kinds:
  dense        norm->GQA attn->res ; norm->MLP->res
  moe          norm->GQA attn->res ; norm->MoE(+dense residual)->res
  rwkv         norm->RWKV6 time mix->res ; norm->channel mix->res
  mamba        norm->Mamba2 mix->res
  mamba_shared mamba + the SHARED transformer block (zamba2)
  enc          bidirectional attn + MLP (whisper encoder)
  dec_cross    self attn + cross attn + MLP (whisper decoder)
  dense_cross  gated cross-attn insert (llama-3.2-vision)

Decode states are dicts, one a layer, updated in place where a KV cache is
written (JAX returns new arrays).  A decode step's ``rank_scan`` reaches
the MoE layers' rank scan (:func:`repro_torch.models.moe.rank_in_expert`
by default).
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import mlp as F
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R
from repro_torch.models.params import ParamTree, dense_init, embed_init


# --------------------------------------------------------------------------
# sharding hook
# --------------------------------------------------------------------------

class ShardingCtx:
    """Activation-sharding hook; a no-op on one device."""

    def constrain(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        return x


NULL_CTX = ShardingCtx()


# --------------------------------------------------------------------------
# layer plan
# --------------------------------------------------------------------------

def layer_plan(cfg: ModelConfig) -> list[str]:
    lt = []
    for i in range(cfg.num_layers):
        if cfg.family == "ssm":
            lt.append("rwkv")
        elif cfg.family == "hybrid":
            if cfg.shared_attn_every and (i + 1) % cfg.shared_attn_every == 0:
                lt.append("mamba_shared")
            else:
                lt.append("mamba")
        elif cfg.family == "moe":
            lt.append("moe")
        elif cfg.is_encoder_decoder:
            lt.append("dec_cross")
        elif cfg.cross_attn_every and \
                i % cfg.cross_attn_every == 3 % cfg.cross_attn_every:
            lt.append("dense_cross")
        else:
            lt.append("dense")
    return lt


def layer_runs(cfg: ModelConfig) -> list[tuple[str, int]]:
    runs: list[tuple[str, int]] = []
    for t in layer_plan(cfg):
        if runs and runs[-1][0] == t:
            runs[-1] = (t, runs[-1][1] + 1)
        else:
            runs.append((t, 1))
    return runs


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def _init_layer(gen, cfg: ModelConfig, kind: str, dtype, device) -> dict:
    hd = cfg.resolved_head_dim
    out_scale = 0.02 / max(1, (2 * cfg.num_layers)) ** 0.5
    d = cfg.d_model

    def norm():
        return L.norm_init(cfg.norm_kind, d, dtype, device)

    def attn(bias=False):
        return A.init_attention(gen, d, cfg.num_heads, cfg.num_kv_heads, hd,
                                dtype, device, qkv_bias=bias,
                                out_scale=out_scale)

    def mlp():
        return F.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dtype, device,
                          out_scale=out_scale)

    if kind in ("dense", "enc"):
        return {"ln1": norm(), "attn": attn(cfg.qkv_bias), "ln2": norm(),
                "mlp": mlp()}
    if kind == "moe":
        p = {"ln1": norm(), "attn": attn(cfg.qkv_bias), "ln2": norm(),
             "moe": MOE.init_moe(gen, d, cfg.d_ff, cfg.num_experts, dtype,
                                 device, mlp_kind=cfg.mlp_kind,
                                 out_scale=out_scale)}
        if cfg.moe_dense_residual:
            p["dense_mlp"] = mlp()
        return p
    if kind == "rwkv":
        return {"ln1": norm(),
                "time": R.init_rwkv_time_mix(gen, d, cfg.d_ff, dtype, device),
                "ln2": norm(),
                "chan": R.init_rwkv_channel_mix(gen, d, cfg.d_ff, dtype,
                                                device)}
    if kind in ("mamba", "mamba_shared"):
        return {"ln1": norm(),
                "mix": M.init_mamba(gen, d, cfg.ssm_state, dtype, device)}
    if kind == "dec_cross":
        return {"ln1": norm(), "attn": attn(), "ln2": norm(),
                "xattn": attn(), "ln3": norm(), "mlp": mlp()}
    if kind == "dense_cross":
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return {"ln1": norm(), "xattn": attn(), "gate_attn": zero,
                "ln2": norm(), "mlp": mlp(), "gate_mlp": zero.clone()}
    raise ValueError(kind)


class Block(nn.Module):
    """One layer: its kind, and its parameters under the JAX package's
    names (``p["attn"]["wq"]``, ...)."""

    def __init__(self, kind: str, tree: dict):
        super().__init__()
        self.kind = kind
        self.p = ParamTree(tree)


class Model(nn.Module):
    """A model's parameters: ``embed`` [padded vocab, D], ``final_norm``,
    ``lm_head`` (unless tied), ``layers`` (a :class:`Block` a layer),
    zamba2's ``shared_attn`` block and whisper's ``encoder`` (its blocks
    and final norm).

    ``tree``: the parameters as nested dicts, with ``"layers"`` a list of
    per-layer dicts in plan order (and ``"encoder": {"layers": [...],
    "final_norm": ...}``)."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        plan = layer_plan(cfg)
        if len(tree["layers"]) != len(plan):
            raise ValueError(f"{cfg.name}: {len(plan)} layers planned, "
                             f"{len(tree['layers'])} given")
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.final_norm = ParamTree(tree["final_norm"])
        if "lm_head" in tree:
            self.lm_head = nn.Parameter(tree["lm_head"], requires_grad=False)
        self.layers = nn.ModuleList(Block(kind, t)
                                    for kind, t in zip(plan, tree["layers"]))
        self.shared_attn = (Block("dense", tree["shared_attn"])
                            if "shared_attn" in tree else None)
        self.encoder = None
        if "encoder" in tree:
            enc = tree["encoder"]
            self.encoder = nn.ModuleDict({
                "layers": nn.ModuleList(Block("enc", t)
                                        for t in enc["layers"]),
                "final_norm": ParamTree(enc["final_norm"])})

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Model:
    """A model of ``cfg`` with random weights in ``cfg.dtype``, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``."""
    dtype = getattr(torch, cfg.dtype)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    tree: dict = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                            device),
        "final_norm": L.norm_init(cfg.norm_kind, cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                     dtype, device, scale=0.02)
    tree["layers"] = [_init_layer(gen, cfg, kind, dtype, device)
                      for kind in layer_plan(cfg)]
    if cfg.family == "hybrid":
        tree["shared_attn"] = _init_layer(gen, cfg, "dense", dtype, device)
    if cfg.is_encoder_decoder:
        tree["encoder"] = {
            "layers": [_init_layer(gen, cfg, "enc", dtype, device)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": L.norm_init(cfg.norm_kind, cfg.d_model, dtype,
                                      device)}
    return Model(cfg, tree)


# --------------------------------------------------------------------------
# block bodies (full-sequence)
# --------------------------------------------------------------------------

def _rotary(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim
    return {"standard": hd, "partial": hd // 2, "none": 0}[cfg.rope_style]


def _self_attn(p, cfg: ModelConfig, x, positions, mask_mode, ctx):
    rotary = _rotary(cfg)
    q, k, v = A.project_qkv(
        p, x, x, num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, positions_q=positions,
        positions_kv=positions if rotary else None, rotary_dim=rotary,
        rope_theta=cfg.rope_theta)
    out = A.attend(q, k, v, mode=mask_mode, window=cfg.sliding_window,
                   q_positions=positions, k_positions=positions)
    out = ctx.constrain(out.reshape(x.shape[:2] + (-1,)), "attn_out")
    return out @ p["wo"]


def _cross_attn(p, cfg: ModelConfig, x, memory):
    q, k, v = A.project_qkv(
        p, x, memory, num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, positions_q=None, positions_kv=None,
        rotary_dim=0, rope_theta=cfg.rope_theta)
    out = A.attend(q, k, v, mode="full")
    return out.reshape(x.shape[:2] + (-1,)) @ p["wo"]


def _moe(p, cfg: ModelConfig, h, *, capacity_factor, ctx, rank_scan=None):
    y, stats = MOE.moe_ffn(
        p["moe"], h, num_experts=cfg.num_experts,
        num_experts_per_tok=cfg.num_experts_per_tok,
        capacity_factor=capacity_factor, mlp_kind=cfg.mlp_kind,
        dispatch=cfg.moe_dispatch, ctx=ctx, rank_scan=rank_scan)
    if cfg.moe_dense_residual:
        y = y + F.mlp(p["dense_mlp"], h, cfg.mlp_kind)
    return y, stats


def _apply_block(kind: str, p, cfg: ModelConfig, x, *, positions, ctx,
                 memory=None, shared=None, mask_mode="causal"):
    """Full-sequence block application.  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    nrm = functools.partial(L.apply_norm, cfg.norm_kind)

    if kind in ("dense", "enc"):
        mm = "full" if kind == "enc" else mask_mode
        x = x + _self_attn(p["attn"], cfg, nrm(p["ln1"], x), positions, mm,
                           ctx)
        return x + F.mlp(p["mlp"], nrm(p["ln2"], x), cfg.mlp_kind), aux
    if kind == "moe":
        x = x + _self_attn(p["attn"], cfg, nrm(p["ln1"], x), positions,
                           mask_mode, ctx)
        y, stats = _moe(p, cfg, nrm(p["ln2"], x),
                        capacity_factor=cfg.capacity_factor, ctx=ctx)
        return x + y, aux + stats.aux_loss
    if kind == "rwkv":
        x = x + R.rwkv_time_mix(p["time"], nrm(p["ln1"], x))[0]
        return x + R.rwkv_channel_mix(p["chan"], nrm(p["ln2"], x))[0], aux
    if kind in ("mamba", "mamba_shared"):
        x = x + M.mamba_mix(p["mix"], nrm(p["ln1"], x),
                            ssm_state=cfg.ssm_state)[0]
        if kind == "mamba_shared":
            x, _ = _apply_block("dense", shared, cfg, x, positions=positions,
                                ctx=ctx, mask_mode=mask_mode)
        return x, aux
    if kind == "dec_cross":
        x = x + _self_attn(p["attn"], cfg, nrm(p["ln1"], x), positions,
                           mask_mode, ctx)
        x = x + _cross_attn(p["xattn"], cfg, nrm(p["ln2"], x), memory)
        return x + F.mlp(p["mlp"], nrm(p["ln3"], x), cfg.mlp_kind), aux
    if kind == "dense_cross":
        g_a = torch.tanh(p["gate_attn"]).to(x.dtype)
        x = x + g_a * _cross_attn(p["xattn"], cfg, nrm(p["ln1"], x), memory)
        g_m = torch.tanh(p["gate_mlp"]).to(x.dtype)
        return x + g_m * F.mlp(p["mlp"], nrm(p["ln2"], x), cfg.mlp_kind), aux
    raise ValueError(kind)


def _apply_runs(blocks, runs, cfg: ModelConfig, x, **kw):
    """The blocks in order; each run's aux losses summed from zero before
    they join the total, as the JAX package's scan carries them."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    it = iter(blocks)
    for _, count in runs:
        run_aux = torch.zeros_like(aux)
        for _ in range(count):
            blk = next(it)
            x, a = _apply_block(blk.kind, blk.p, cfg, x, **kw)
            run_aux = run_aux + a
        aux = aux + run_aux
    return x, aux


# --------------------------------------------------------------------------
# full forward (train / prefill-style scoring)
# --------------------------------------------------------------------------

def encode(params: Model, cfg: ModelConfig, encoder_embeds,
           ctx: ShardingCtx = NULL_CTX):
    """Whisper encoder over stub frame embeddings [B, Se, D]."""
    se = encoder_embeds.shape[1]
    dev = encoder_embeds.device
    x = encoder_embeds + L.sinusoidal_positions(
        se, cfg.d_model, dev).to(encoder_embeds.dtype)
    pos = torch.arange(se, dtype=torch.int32, device=dev)
    enc = params.encoder
    x, _ = _apply_runs(enc["layers"], [("enc", len(enc["layers"]))], cfg, x,
                       positions=pos, ctx=ctx, mask_mode="full")
    return L.apply_norm(cfg.norm_kind, enc["final_norm"], x)


def forward_hidden(params: Model, cfg: ModelConfig, tokens, *,
                   ctx: ShardingCtx = NULL_CTX, memory=None, positions=None):
    """tokens [B, T] -> (final-norm hidden [B, T, D], aux_loss).

    ``memory``: encoder states (whisper) or image embeddings (vlm)."""
    x = ctx.constrain(params.embed[tokens], "hidden")
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=x.device)
    if cfg.is_encoder_decoder:
        x = x + L.sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                       x.device).to(x.dtype)
    x, aux = _apply_runs(
        params.layers, layer_runs(cfg), cfg, x, positions=positions, ctx=ctx,
        memory=memory, mask_mode="swa" if cfg.sliding_window else "causal",
        shared=None if params.shared_attn is None else params.shared_attn.p)
    return L.apply_norm(cfg.norm_kind, params.final_norm, x), aux


def lm_head(params: Model, cfg: ModelConfig):
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def forward(params: Model, cfg: ModelConfig, tokens, *,
            ctx: ShardingCtx = NULL_CTX, memory=None, positions=None):
    """Full-logit forward (tests, small models): (logits [B, T, V],
    aux_loss)."""
    x, aux = forward_hidden(params, cfg, tokens, ctx=ctx, memory=memory,
                            positions=positions)
    return ctx.constrain(x @ lm_head(params, cfg), "logits"), aux


def chunked_ce(x, head, labels, mask, *, ctx: ShardingCtx = NULL_CTX,
               chunk: int = 512):
    """Cross-entropy without the [B, T, V] logits: a loop over T-chunks.
    Returns (ce_sum, zloss_sum); the caller normalises."""
    b, t, _ = x.shape
    c = min(chunk, t)
    while t % c:
        c //= 2
    ce = torch.zeros((), dtype=torch.float32, device=x.device)
    zz = torch.zeros_like(ce)
    for i in range(t // c):
        sl = slice(i * c, (i + 1) * c)
        lg32 = ctx.constrain(x[:, sl] @ head, "logits").float()
        lse = torch.logsumexp(lg32, dim=-1)
        ll = torch.gather(lg32, -1, labels[:, sl, None].long())[..., 0]
        ce = ce + torch.sum((lse - ll) * mask[:, sl])
        zz = zz + torch.sum(torch.square(lse) * mask[:, sl])
    return ce, zz


def loss_fn(params: Model, cfg: ModelConfig, batch: dict, *,
            ctx: ShardingCtx = NULL_CTX, aux_weight: float = 0.01,
            z_weight: float = 1e-4, ce_chunk: int = 512):
    """Next-token CE (fp32 softmax, chunked) + MoE aux + z-loss, forward
    only.  Returns (total, {"ce", "aux", "zloss"})."""
    memory = batch.get("memory")
    if cfg.is_encoder_decoder:
        memory = encode(params, cfg, batch["encoder_embeds"], ctx)
    x, aux = forward_hidden(params, cfg, batch["tokens"], ctx=ctx,
                            memory=memory)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=x.device)
    ce_sum, z_sum = chunked_ce(x, lm_head(params, cfg), labels, mask,
                               ctx=ctx, chunk=ce_chunk)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    ce, zloss = ce_sum / denom, z_sum / denom
    total = ce + aux_weight * aux + z_weight * zloss
    return total, {"ce": ce, "aux": aux, "zloss": zloss}


# --------------------------------------------------------------------------
# serving: single-token decode with caches/states
# --------------------------------------------------------------------------

def init_decode_state(params: Model, cfg: ModelConfig, batch: int,
                      max_len: int, *, memory=None,
                      ctx: ShardingCtx = NULL_CTX):
    """Per-layer caches and states.  An attention layer's cache holds
    min(max_len, window) slots: sliding windows decode against a ring."""
    dtype = getattr(torch, cfg.dtype)
    dev = params.device
    hd = cfg.resolved_head_dim
    cache_len = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len

    def cache():
        return A.init_cache(batch, cache_len, cfg.num_kv_heads, hd, dtype,
                            dev)

    def cross():
        t_mem = ((cfg.encoder_seq if cfg.is_encoder_decoder
                  else cfg.num_image_tokens) if memory is None
                 else memory.shape[1])
        z = torch.zeros((batch, t_mem, cfg.num_kv_heads, hd), dtype=dtype,
                        device=dev)
        return {"k": z, "v": z.clone()}

    def state(kind):
        if kind in ("dense", "moe"):
            return cache()
        if kind == "rwkv":
            return R.init_rwkv_state(batch, cfg.d_model, dtype, dev)
        ssm = M.init_mamba_state(batch, cfg.d_model, cfg.ssm_state, dtype,
                                 dev) if kind.startswith("mamba") else None
        if kind == "mamba":
            return ssm
        if kind == "mamba_shared":
            return {"ssm": ssm, "kv": cache()}
        if kind == "dec_cross":
            return {"kv": cache(), "cross": cross()}
        if kind == "dense_cross":
            return {"cross": cross()}
        raise ValueError(kind)

    return {"layers": [state(kind) for kind in layer_plan(cfg)],
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def precompute_cross_kv(params: Model, cfg: ModelConfig, state, memory):
    """Fill each cross-attention layer's KV from encoder states or image
    embeddings."""
    hd = cfg.resolved_head_dim
    b, t = memory.shape[:2]
    layers = []
    for blk, st in zip(params.layers, state["layers"]):
        if blk.kind in ("dec_cross", "dense_cross"):
            xa = blk.p["xattn"]
            st = dict(st, cross={
                "k": (memory @ xa["wk"]).reshape(b, t, cfg.num_kv_heads, hd),
                "v": (memory @ xa["wv"]).reshape(b, t, cfg.num_kv_heads, hd)})
        layers.append(st)
    return {"layers": layers, "pos": state["pos"]}


def _decode_self_attn(p, cfg: ModelConfig, x1, cache, pos, ring: bool):
    rotary = _rotary(cfg)
    posq = pos[None] if pos.dim() == 0 else pos
    q, k, v = A.project_qkv(
        p, x1, x1, num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, positions_q=posq,
        positions_kv=posq if rotary else None, rotary_dim=rotary,
        rope_theta=cfg.rope_theta)
    cache = A.cache_append(cache, k, v, ring=ring)
    out = A.decode_attend(q, cache, mode="causal")
    return out.reshape(x1.shape[:2] + (-1,)) @ p["wo"], cache


def _decode_cross_attn(p, cfg: ModelConfig, x1, cross):
    hd = cfg.resolved_head_dim
    b = x1.shape[0]
    q = (x1 @ p["wq"]).reshape(b, 1, cfg.num_heads, hd)
    if "bq" in p:
        q = q + p["bq"].reshape(1, 1, cfg.num_heads, hd)
    cache = {"k": cross["k"], "v": cross["v"],
             "len": torch.full((), cross["k"].shape[1], dtype=torch.int32,
                               device=x1.device)}
    out = A.decode_attend(q, cache, mode="full")
    return out.reshape(b, 1, -1) @ p["wo"]


def _decode_block(kind, p, cfg: ModelConfig, x1, st, pos, shared,
                  ring: bool, rank_scan=None):
    nrm = functools.partial(L.apply_norm, cfg.norm_kind)
    if kind in ("dense", "moe"):
        y, cache = _decode_self_attn(p["attn"], cfg, nrm(p["ln1"], x1), st,
                                     pos, ring)
        x1 = x1 + y
        h = nrm(p["ln2"], x1)
        if kind == "moe":
            y, _ = _moe(p, cfg, h, capacity_factor=2.0, ctx=None,
                        rank_scan=rank_scan)
        else:
            y = F.mlp(p["mlp"], h, cfg.mlp_kind)
        return x1 + y, cache
    if kind == "rwkv":
        x = x1[:, 0]
        y, st1 = R.rwkv_time_mix_step(
            p["time"], nrm(p["ln1"], x[:, None])[:, 0],
            {"shift_t": st["shift_t"], "S": st["S"]})
        x = x + y
        y, st2 = R.rwkv_channel_mix_step(
            p["chan"], nrm(p["ln2"], x[:, None])[:, 0],
            {"shift_c": st["shift_c"]})
        return (x + y)[:, None], {**st1, **st2}
    if kind in ("mamba", "mamba_shared"):
        ssm = st["ssm"] if kind == "mamba_shared" else st
        x = x1[:, 0]
        y, ssm = M.mamba_mix_step(p["mix"], nrm(p["ln1"], x[:, None])[:, 0],
                                  ssm, ssm_state=cfg.ssm_state)
        x1 = (x + y)[:, None]
        if kind == "mamba_shared":
            y, cache = _decode_self_attn(shared["attn"], cfg,
                                         nrm(shared["ln1"], x1), st["kv"],
                                         pos, ring)
            x1 = x1 + y
            x1 = x1 + F.mlp(shared["mlp"], nrm(shared["ln2"], x1),
                            cfg.mlp_kind)
            return x1, {"ssm": ssm, "kv": cache}
        return x1, ssm
    if kind == "dec_cross":
        y, cache = _decode_self_attn(p["attn"], cfg, nrm(p["ln1"], x1),
                                     st["kv"], pos, ring)
        x1 = x1 + y
        x1 = x1 + _decode_cross_attn(p["xattn"], cfg, nrm(p["ln2"], x1),
                                     st["cross"])
        x1 = x1 + F.mlp(p["mlp"], nrm(p["ln3"], x1), cfg.mlp_kind)
        return x1, {"kv": cache, "cross": st["cross"]}
    if kind == "dense_cross":
        g_a = torch.tanh(p["gate_attn"]).to(x1.dtype)
        x1 = x1 + g_a * _decode_cross_attn(p["xattn"], cfg,
                                           nrm(p["ln1"], x1), st["cross"])
        g_m = torch.tanh(p["gate_mlp"]).to(x1.dtype)
        x1 = x1 + g_m * F.mlp(p["mlp"], nrm(p["ln2"], x1), cfg.mlp_kind)
        return x1, {"cross": st["cross"]}
    raise ValueError(kind)


def decode_step(params: Model, cfg: ModelConfig, token, state, *,
                ctx: ShardingCtx = NULL_CTX, rank_scan=None):
    """One decode step.  token [B] int -> (logits [B, V], new state)."""
    pos = state["pos"]
    x = params.embed[token][:, None, :]             # [B, 1, D]
    if cfg.is_encoder_decoder:
        # the JAX package adds position 0's row at every step
        x = x + L.sinusoidal_positions(1, cfg.d_model, x.device).to(x.dtype)
    x = ctx.constrain(x, "hidden_decode")
    ring = cfg.sliding_window > 0
    shared = None if params.shared_attn is None else params.shared_attn.p
    layers = []
    for blk, st in zip(params.layers, state["layers"]):
        x, st = _decode_block(blk.kind, blk.p, cfg, x, st, pos, shared, ring,
                              rank_scan)
        layers.append(st)
    x = L.apply_norm(cfg.norm_kind, params.final_norm, x)
    logits = ctx.constrain((x @ lm_head(params, cfg))[:, 0], "logits_decode")
    return logits, {"layers": layers, "pos": pos + 1}
