"""Public wrapper of the segmented-scan kernel: the counterpart of the JAX
package's ``segmented_scan_tpu`` (``src/repro/kernels/segscan/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.segscan import kernel as _k


def segmented_scan_cuda(flags: torch.Tensor, state, op="sum", *,
                        tile: int = 1024):
    """Segmented inclusive scan of a combiner state along its [N] axis:
    ``state`` is one tensor or the tuple of the combiner's state leaves (in
    the JAX treedef's order), ``flags`` marks segment starts.  The stream
    is padded to whole tiles (padded lanes start segments of their own)
    and the result sliced back.  Returns the state's structure."""
    leaves = state if isinstance(state, tuple) else (state,)
    n = leaves[0].shape[-1]
    flags = flags.to(torch.bool)
    pad = (-n) % tile
    if pad:
        flags = torch.cat([flags, torch.ones((pad,), dtype=torch.bool,
                                             device=flags.device)])
        leaves = tuple(torch.cat([t, torch.zeros((pad,), dtype=t.dtype,
                                                 device=t.device)])
                       for t in leaves)
    out = tuple(o[:n] for o in _k.segscan(flags, leaves, op, tile=tile))
    return out if isinstance(state, tuple) else out[0]
