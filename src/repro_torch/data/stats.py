"""Per-domain statistics of a batch through the aggregation engine — the
counterpart of ``repro.data.stats``: (domain, value) tuples sorted once,
then one grouped query, every requested op in one fused engine pass."""
from __future__ import annotations

import torch

from repro_torch.core.sorter import sort_pairs_xla
from repro_torch.query import Query, _as_tensor, canonical_op, execute


def domain_stats(domains, values, ops=("mean", "count", "min", "max"),
                 *, device=None) -> dict:
    """One-shot per-domain aggregate of a batch on the ``reference``
    backend.  Returns ``{op: (groups, values, n)}`` with padded columns
    (the valid prefix of length ``n``).  ``device``: where it runs — the
    device of ``values`` when it is a tensor, else the card."""
    if device is None:
        device = values.device if isinstance(values, torch.Tensor) \
            else "cuda"
    g = _as_tensor(domains, device).to(torch.int32)
    g, v = sort_pairs_xla(g, _as_tensor(values, device), full_width=False)
    res, _ = execute(Query(ops=tuple(ops)), g, v, backend="reference",
                     device=device)
    return {op: (res.groups, res.values[canonical_op(op)], res.num_groups)
            for op in ops}
