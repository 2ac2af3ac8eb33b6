"""Public wrapper of the segmented-scan kernel: the counterpart of the JAX
package's ``segmented_scan_tpu`` (``src/repro/kernels/segscan/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.segscan import kernel as _k


def segmented_scan_cuda(flags: torch.Tensor, state, op="sum", *,
                        tile: int = 1024):
    """Segmented inclusive scan of a combiner state along its [N] axis:
    ``state`` is one tensor or the tuple of the combiner's state leaves (in
    the JAX treedef's order), ``flags`` marks segment starts.  A ragged
    last tile is masked by the kernel, with no padded copy of the stream.
    Returns the state's structure."""
    leaves = state if isinstance(state, tuple) else (state,)
    out = _k.segscan(flags.to(torch.bool), leaves, op, tile=tile)
    return out if isinstance(state, tuple) else out[0]
