"""Serving launcher: batched decode with KV caches / SSM states.

Prompts are prefilled token by token through the decode step (exact; a
fused prefill is a later concern), then generation runs one token a step
for the whole batch — the JAX package's ``repro.launch.serve`` on one
device.  :func:`generate` is the loop, for callers that bring their own
config and weights.

Run: PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
    --reduced --batch 4 --prompt-len 16 --gen 32 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import steps as ST
from repro_torch.kernels.common import require_cuda
from repro_torch.models import model as MDL


class ServeResult(NamedTuple):
    tokens: torch.Tensor    # [B, gen] int32: the sampled tokens
    logits: torch.Tensor    # [B, prompt_len + gen, V]: every step's logits
    step_ms: list           # ms of each decode step, prompt steps first
    prefill_s: float        # seconds of the prompt's steps
    gen_s: float            # seconds of the generated tokens' steps


def generate(cfg, params, prompts, gen: int, *, temperature: float = 0.0,
             seed: int = 0, memory=None, forced=None,
             rank_scan=None) -> ServeResult:
    """Prefill ``prompts`` [B, P] token by token, then generate ``gen``
    tokens a request, greedily (``temperature=0``) or by sampling from a
    ``torch.Generator`` seeded with ``seed``.  ``memory``: encoder states
    (whisper) or image embeddings (vlm).  ``forced`` [B, gen]: tokens fed
    back in place of the sampled ones (teacher forcing; the sampled ones
    are still returned).  Each step is timed between CUDA events on the
    card, by the host clock on the CPU; the device is synchronised once,
    at the end."""
    dev = params.device
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    batch, plen = prompts.shape
    state = MDL.init_decode_state(params, cfg, batch, plen + gen,
                                  memory=memory)
    if memory is not None:
        state = MDL.precompute_cross_kv(params, cfg, state, memory)
    step, _ = ST.make_decode_step(cfg, rank_scan=rank_scan)
    gen_rng = torch.Generator(device=dev).manual_seed(seed)
    on_card = dev.type == "cuda"

    def mark():
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    logits, marks, out = [], [mark()], []
    t0 = time.perf_counter()
    for t in range(plen + gen):
        if t < plen:
            tok = prompts[:, t]
        else:
            lg = logits[-1][:, :cfg.vocab_size].float()
            if temperature > 0:
                probs = torch.softmax(lg / temperature, dim=-1)
                sampled = torch.multinomial(probs, 1, generator=gen_rng)[:, 0]
            else:
                sampled = torch.argmax(lg, dim=-1)
            out.append(sampled.to(torch.int32))
            tok = out[-1] if forced is None else torch.as_tensor(
                forced, dtype=torch.int32, device=dev)[:, t - plen]
        if t == plen:
            if on_card:
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
        lg, state = step(params, tok, state)
        logits.append(lg)
        marks.append(mark())
    if on_card:
        torch.cuda.synchronize(dev)
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    t2 = time.perf_counter()
    if gen == 0:
        t1 = t2
    tokens = (torch.stack(out, dim=1) if out
              else torch.zeros((batch, 0), dtype=torch.int32, device=dev))
    return ServeResult(tokens, torch.stack(logits, dim=1), step_ms,
                       t1 - t0, t2 - t1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = require_cuda(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = MDL.init_model(cfg, seed=args.seed, device=dev)
    dt = getattr(torch, cfg.dtype)
    memory = None
    if cfg.is_encoder_decoder:
        enc_in = torch.zeros((args.batch, cfg.encoder_seq, cfg.d_model),
                             dtype=dt, device=dev)
        memory = MDL.encode(params, cfg, enc_in)
    elif cfg.cross_attn_every:
        memory = torch.zeros((args.batch, cfg.num_image_tokens, cfg.d_model),
                             dtype=dt, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    res = generate(cfg, params, prompts, args.gen,
                   temperature=args.temperature, seed=args.seed,
                   memory=memory)
    tput = args.batch * args.gen / res.gen_s if args.gen else 0.0
    print(f"[serve] {args.arch} on {dev}: prefill {args.prompt_len} tok x "
          f"{args.batch} reqs in {res.prefill_s:.2f}s; generated "
          f"{args.gen} tok/req at {tput:.1f} tok/s aggregate")
    print("[serve] sample continuation:", res.tokens[0, :16].tolist())
    if not torch.isfinite(res.logits.float()).all():
        raise RuntimeError("non-finite logits")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
