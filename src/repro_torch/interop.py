"""Data in and results out: seeded streams in numpy, tensors on a device,
results in the numpy layout of ``repro.query.AggResult``, and pane-store
states in the field order of ``repro.core.panestore.PaneStoreState`` — so
the same inputs can go through both packages, their full outputs (padded
tails included) be compared, and a stream begun in one continue in the
other.  :func:`make_stream` needs only numpy (torch is
imported by the functions that use it), so a process that holds JAX alone
can make the same inputs."""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from repro_torch.core.panestore import PaneStoreState
    from repro_torch.query import AggResult

#: the fields of a pane-store state, in order
PANE_STATE_FIELDS = ("owner", "keys", "seqs", "count", "base", "stamp",
                     "clock")


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


def pane_state_from_numpy(state_arrays, device="cuda") -> PaneStoreState:
    """A pane-store state from numpy arrays — a mapping of
    :data:`PANE_STATE_FIELDS` or a sequence in that order (a JAX
    ``PaneStoreState`` converted with ``np.asarray`` field by field) — on
    ``device``, ready for ``swag_per_group(state=...)``."""
    import torch

    from repro_torch.core.panestore import PaneStoreState

    if hasattr(state_arrays, "keys") and callable(state_arrays.keys):
        arrays = [state_arrays[f] for f in PANE_STATE_FIELDS]
    else:
        arrays = list(state_arrays)
    if len(arrays) != len(PANE_STATE_FIELDS):
        raise ValueError(f"a pane-store state has {len(PANE_STATE_FIELDS)} "
                         f"arrays {PANE_STATE_FIELDS}, got {len(arrays)}")
    return PaneStoreState(*(torch.from_numpy(np.array(a)).to(device)
                            for a in arrays))


def pane_state_to_numpy(state: PaneStoreState) -> dict:
    """A pane-store state as ``{field: numpy array}``."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in PANE_STATE_FIELDS}
