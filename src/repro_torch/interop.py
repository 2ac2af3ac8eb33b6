"""Data in and results out: seeded streams in numpy, tensors on a device,
and results in the numpy layout of ``repro.query.AggResult`` — so the same
inputs can go through both packages and their full outputs (padded tails
included) be compared.  :func:`make_stream` needs only numpy (torch is
imported by the functions that use it), so a process that holds JAX alone
can make the same inputs."""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from repro_torch.query import AggResult


def make_stream(seed: int, n: int, n_groups: int, key_max: int,
                dtype=np.int32, sorted_by: str | None = None):
    """A stream of ``n`` (group, key) tuples from ``seed``: groups uniform
    in ``[0, n_groups)``, keys uniform in ``[0, key_max)`` (integers for an
    integer ``dtype``, else floats).  ``sorted_by`` is ``None`` (arrival
    order), ``"group"`` (stable by group, what the non-windowed engine
    needs) or ``"group_key"`` (by group then key, what distinct_count and
    median need)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, n_groups, n).astype(np.int32)
    if np.issubdtype(np.dtype(dtype), np.integer):
        k = rng.integers(0, key_max, n).astype(dtype)
    else:
        k = rng.uniform(0, key_max, n).astype(dtype)
    if sorted_by == "group":
        order = np.argsort(g, kind="stable")
    elif sorted_by == "group_key":
        order = np.lexsort((k, g))
    elif sorted_by is None:
        return g, k
    else:
        raise ValueError(f"sorted_by must be None, 'group' or 'group_key', "
                         f"got {sorted_by!r}")
    return g[order], k[order]


def from_numpy(groups, keys, device="cuda"):
    """Two numpy columns as tensors on ``device``."""
    import torch

    return (torch.from_numpy(np.ascontiguousarray(groups)).to(device),
            torch.from_numpy(np.ascontiguousarray(keys)).to(device))


def result_to_numpy(res: AggResult) -> AggResult:
    """A port result with numpy arrays in place of tensors."""
    from repro_torch.query import AggResult

    def np_(x):
        return x.detach().cpu().numpy()

    return AggResult(np_(res.groups),
                     {name: np_(v) for name, v in res.values.items()},
                     np_(res.valid), np_(res.num_groups), res.stats)
