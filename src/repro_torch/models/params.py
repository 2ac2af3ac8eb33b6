"""Parameter initialisation and the parameter tree of the port's models.

The JAX package keeps a model's parameters as nested dicts of arrays.  The
port keeps the same names in a :class:`ParamTree`, an ``nn.Module`` whose
children are the sub-dicts and whose parameters are the leaves, so a block
reads ``p["attn"]["wq"]`` as it does there.  Initialisers draw from an
explicit ``torch.Generator``: JAX's keys give other numbers from the same
seed, so the tests carry the JAX parameters across instead
(:func:`repro_torch.interop.model_params_from_numpy`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

#: the standard normal's CDF at -2 and 2: the truncation of the initialisers
_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: each dict value becomes a
    child ``ParamTree``, each tensor a parameter (``requires_grad=False``:
    the port serves, it does not train yet).  ``tree[name]`` and ``name in
    tree`` read it like the JAX package's dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def truncated_normal(gen: torch.Generator, shape, dtype, device, *,
                     std: float) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], times ``std``, drawn in
    float32 and cast to ``dtype`` (``jax.random.truncated_normal``'s
    distribution; the inverse CDF of a uniform draw)."""
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(_LO, _HI, generator=gen)
    w = torch.special.erfinv(u.mul_(2.0).sub_(1.0)).mul_(math.sqrt(2.0))
    return w.clamp_(-2.0, 2.0).mul_(std).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device, *,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (std = scale or 1/sqrt(d_in))."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return truncated_normal(gen, (d_in, d_out), dtype, device, std=std)


def embed_init(gen, vocab: int, d: int, dtype, device) -> torch.Tensor:
    return truncated_normal(gen, (vocab, d), dtype, device, std=0.02)


def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def param_bytes(params: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())
