"""Serving-step factories (the JAX package's ``repro.distributed.steps``,
its serving half): the aggregation engine's :func:`make_query_step` and the
LLM path's :func:`make_prefill_step` / :func:`make_decode_step`, on one
device or, for a query, sharded over a mesh.  The training step and the
sharding scheme are not ported yet.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as MDL


def make_query_step(query, *, backend: str | None = None, p_ports: int = 4,
                    mesh=None, data_axis: str = "data", shard: bool = False,
                    device="cuda"):
    """The serving-step factory of the aggregation engine (the counterpart
    of :func:`make_decode_step` for the paper's workload).

    The query is planned **once** (spec validation and the backend's
    capability check up front); the returned step is a closure over the
    plan: ``(groups, keys) -> AggResult`` for a batch query and ``(groups,
    keys, state) -> (AggResult, state)`` for a streaming one, whose state
    (``repro_torch.query.init_stream_state(plan)``) is updated in place
    where the backend can (the JAX step donates it), so pass each step the
    state the last one returned.  Inputs are numpy or torch columns, moved
    to the plan's device.  On the card the step runs the kernels the plan
    chose.

    ``mesh`` is a list of devices.  Without ``shard`` the step is one
    engine replica on the mesh's first device (the JAX step annotates its
    inputs as batch-sharded along ``data_axis``, which gives the same
    answer).  ``shard=True`` runs ONE query two-phase over all of the
    mesh's devices (:mod:`repro_torch.distributed.query_exec`: per-shard
    partial tables, one combine tree).

    Returns ``(step, plan)``."""
    from repro_torch import query as Q

    if shard and mesh is None:
        raise ValueError("shard=True needs a mesh to shard over")
    if mesh is not None:
        device = mesh[0]
    p = Q.plan(query, backend=backend, device=device,
               num_shards=len(mesh) if shard else 1,
               devices=list(mesh) if shard else None)
    run_mesh = mesh if shard else None

    if p.path == "stream":
        raw = Q.stream_fn(p, p_ports=p_ports, mesh=run_mesh, inplace=True)

        def stream_step(groups, keys, state, n_valid=None, timestamps=None):
            g, k, n_valid = Q._prepare_inputs(p.query, groups, keys, n_valid,
                                              p.device)
            extra = () if timestamps is None else (timestamps,)
            (og, values, valid, num, _rr), state = raw(g, k, state, n_valid,
                                                       *extra)
            return Q.AggResult(og, values, valid, num), state

        return stream_step, p

    def batch_step(groups, keys):
        return Q.execute(p, groups, keys, device=p.device, mesh=run_mesh)[0]

    return batch_step, p


def make_prefill_step(cfg: ModelConfig):
    """``(params, batch) -> next-token logits [B, V]``: the full forward of
    ``batch["tokens"]`` (encoder first for whisper, ``batch["memory"]``
    for the vlm), the LM head on the last position only.  Returns
    ``(step, ctx)``."""
    ctx = MDL.NULL_CTX

    def prefill_step(params, batch):
        memory = batch.get("memory")
        if cfg.is_encoder_decoder:
            memory = MDL.encode(params, cfg, batch["encoder_embeds"], ctx)
        x, _ = MDL.forward_hidden(params, cfg, batch["tokens"], ctx=ctx,
                                  memory=memory)
        return x[:, -1] @ MDL.lm_head(params, cfg)

    return prefill_step, ctx


def make_decode_step(cfg: ModelConfig, *, rank_scan=None):
    """``(params, token [B], state) -> (logits [B, V], state)``: one
    decode step (:func:`repro_torch.models.model.decode_step`; its KV
    caches are written in place).  ``rank_scan`` reaches the MoE layers.
    Returns ``(step, ctx)``."""
    ctx = MDL.NULL_CTX

    def serve_step(params, token, state):
        return MDL.decode_step(params, cfg, token, state, ctx=ctx,
                               rank_scan=rank_scan)

    return serve_step, ctx
