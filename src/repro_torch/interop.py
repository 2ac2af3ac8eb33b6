"""Data in and results out: seeded streams in numpy, tensors on a device,
results in the numpy layout of ``repro.query.AggResult``, pane-store
states in the field order of ``repro.core.panestore.PaneStoreState``,
reorder buffers in that of ``repro.core.eventtime.ReorderState``, partial
tables in that of ``repro.core.engine.PartialTable``, and streaming
carries (one ``repro.core.segscan.Carry`` an op, or an event-time
stream's (reorder buffer, pane store) pair, a sharded stream's buffers
stacked with a leading shard axis) in the field order of the JAX
package's, and a model's weights and decode state from the JAX package's
stacked runs — so the same inputs can go through both
packages, their full outputs (padded tails included) be compared, and a
stream begun in one continue in the other.  :func:`make_stream` needs only numpy (torch is
imported by the functions that use it), so a process that holds JAX alone
can make the same inputs."""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from repro_torch.core.engine import PartialTable
    from repro_torch.core.eventtime import ReorderState
    from repro_torch.core.panestore import PaneStoreState
    from repro_torch.query import AggResult

#: the fields of a pane-store state, in order
PANE_STATE_FIELDS = ("owner", "keys", "seqs", "count", "base", "stamp",
                     "clock")
#: the fields of a rolling carry, in order; ``state`` is one array or the
#: tuple of the combiner's state arrays (the JAX treedef's order)
CARRY_FIELDS = ("group", "state", "nonempty", "emitted")
#: the fields of a partial table, in order; ``states`` maps each op name
#: to one array or the tuple of its combiner's state arrays
PARTIAL_TABLE_FIELDS = ("groups", "states", "valid", "num_groups")
#: the fields of a reorder buffer, in order
REORDER_FIELDS = ("ts", "grp", "val", "seq", "occ", "max_ts", "last_emit",
                  "seq_clock", "dropped")


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


def make_time_stream(seed: int, n: int, n_groups: int, key_max: int,
                     density: float, jitter: int):
    """A stream of ``n`` (group, key, timestamp) tuples from ``seed``, in
    arrival order: groups uniform in ``[0, n_groups)``, int32 keys uniform
    in ``[0, key_max)``, and tuple ``i`` stamped ``floor(i / density) +
    U[0, jitter)`` — ``density`` tuples per time unit, out of order within
    ``jitter`` units.  Returns three int32 numpy columns."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, n_groups, n).astype(np.int32)
    k = rng.integers(0, key_max, n).astype(np.int32)
    ts = (np.floor(np.arange(n) / density).astype(np.int64)
          + rng.integers(0, jitter, n)).astype(np.int32)
    return g, k, ts


def from_numpy(groups, keys, device="cuda"):
    """Two numpy columns as tensors on ``device``."""
    import torch

    return (torch.from_numpy(np.ascontiguousarray(groups)).to(device),
            torch.from_numpy(np.ascontiguousarray(keys)).to(device))


def result_to_numpy(res: AggResult) -> AggResult:
    """A port result with numpy arrays in place of tensors (its stats
    too)."""
    from repro_torch.query import AggResult

    def np_(x):
        return x.detach().cpu().numpy()

    return AggResult(np_(res.groups),
                     {name: np_(v) for name, v in res.values.items()},
                     np_(res.valid), np_(res.num_groups),
                     stats_to_numpy(res.stats))


def stats_to_numpy(stats):
    """A stats dict (``collect_stats=True``) with numpy arrays in place of
    tensors (copies; plain numbers kept); ``None`` stays ``None``."""
    if stats is None:
        return None
    return {name: _np_copy(v) if hasattr(v, "detach") else v
            for name, v in stats.items()}


def pane_state_from_numpy(state_arrays, device="cuda") -> PaneStoreState:
    """A pane-store state from numpy arrays — a mapping of
    :data:`PANE_STATE_FIELDS` or a sequence in that order (a JAX
    ``PaneStoreState`` converted with ``np.asarray`` field by field) — on
    ``device``, ready for ``swag_per_group(state=...)``."""
    import torch

    from repro_torch.core.panestore import PaneStoreState

    return PaneStoreState(*(torch.from_numpy(np.array(a)).to(device)
                            for a in _fields(state_arrays, PANE_STATE_FIELDS,
                                             "pane-store state")))


def _np_copy(t):
    """A tensor as a numpy array of its own (a stream updates its pane
    store in place)."""
    return t.detach().to("cpu", copy=True).numpy()


def pane_state_to_numpy(state: PaneStoreState) -> dict:
    """A pane-store state as ``{field: numpy array}`` (copies)."""
    return {f: _np_copy(getattr(state, f)) for f in PANE_STATE_FIELDS}


def _fields(arrays, names, what):
    """A mapping of ``names`` or a sequence in that order, as a list."""
    if hasattr(arrays, "keys") and callable(arrays.keys):
        return [arrays[f] for f in names]
    arrays = list(arrays)
    if len(arrays) != len(names):
        raise ValueError(f"a {what} has {len(names)} arrays {names}, got "
                         f"{len(arrays)}")
    return arrays


def reorder_state_from_numpy(arrays, device="cuda") -> ReorderState:
    """A reorder buffer from numpy arrays — a mapping of
    :data:`REORDER_FIELDS` or a sequence in that order (a JAX
    ``ReorderState`` converted field by field) — on ``device``.  A sharded
    stream's stacked buffers (``[S, C]`` slots, ``[S]`` scalars) keep
    their shard axis."""
    import torch

    from repro_torch.core.eventtime import ReorderState

    return ReorderState(*(torch.from_numpy(np.array(a)).to(device)
                          for a in _fields(arrays, REORDER_FIELDS,
                                           "reorder buffer")))


def reorder_state_to_numpy(state: ReorderState) -> dict:
    """A reorder buffer as ``{field: numpy array}`` (copies)."""
    return {f: _np_copy(getattr(state, f)) for f in REORDER_FIELDS}


def _is_time_pair(carries) -> bool:
    """Whether a streaming state is an event-time stream's (reorder
    buffer, pane store) pair (a rolling carry has 4 fields, a reorder
    buffer 9)."""
    if not isinstance(carries, (tuple, list)) or len(carries) != 2:
        return False
    first = carries[0]
    if hasattr(first, "keys") and callable(first.keys):
        return "occ" in first.keys()
    return len(first) == len(REORDER_FIELDS)


def carries_from_numpy(carries, device="cuda") -> tuple:
    """A streaming state of rolling carries from numpy: one carry an op,
    each a mapping of :data:`CARRY_FIELDS` or a sequence in that order (a
    JAX ``Carry`` converted with ``np.asarray`` leaf by leaf), its
    ``state`` one array or a tuple of arrays.  Returns the tuple of
    :class:`repro_torch.core.segscan.Carry` on ``device`` that
    ``execute(..., state=...)`` continues.  An event-time stream's pair
    ``(reorder buffer, pane store)`` gives the pair of port states (a
    sharded stream's buffers stacked, as the JAX package stacks them)."""
    import torch

    from repro_torch.core.segscan import Carry

    if _is_time_pair(carries):
        return (reorder_state_from_numpy(carries[0], device),
                pane_state_from_numpy(carries[1], device))

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    out = []
    for carry in carries:
        group, state, nonempty, emitted = _fields(carry, CARRY_FIELDS,
                                                  "carry")
        state = (tuple(t(x) for x in state)
                 if isinstance(state, (tuple, list)) else t(state))
        out.append(Carry(t(group), state, t(nonempty), t(emitted)))
    return tuple(out)


def carries_to_numpy(carries) -> tuple:
    """A streaming state of rolling carries as one ``{field: numpy}`` an op
    (a multi-array ``state`` as a tuple of arrays; copies); an event-time
    stream's pair as the pair of ``{field: numpy}``."""
    from repro_torch.core.eventtime import ReorderState

    if isinstance(carries[0], ReorderState):
        return (reorder_state_to_numpy(carries[0]),
                pane_state_to_numpy(carries[1]))
    return tuple({"group": _np_copy(c.group),
                  "state": (tuple(_np_copy(x) for x in c.state)
                            if isinstance(c.state, tuple)
                            else _np_copy(c.state)),
                  "nonempty": _np_copy(c.nonempty),
                  "emitted": _np_copy(c.emitted)} for c in carries)


def partial_table_from_numpy(arrays, device="cuda") -> PartialTable:
    """A partial table from numpy arrays — a mapping of
    :data:`PARTIAL_TABLE_FIELDS` or a sequence in that order (a JAX
    ``PartialTable`` converted leaf by leaf), each op's state one array or
    a tuple of arrays; leading batch axes (shards) kept — on ``device``."""
    import torch

    from repro_torch.core.engine import PartialTable

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    groups, states, valid, num = _fields(arrays, PARTIAL_TABLE_FIELDS,
                                         "partial table")
    return PartialTable(
        t(groups),
        {name: (tuple(t(x) for x in st) if isinstance(st, (tuple, list))
                else t(st)) for name, st in states.items()},
        t(valid), t(num))


def partial_table_to_numpy(table: PartialTable) -> dict:
    """A partial table as ``{field: numpy}`` (``states`` as ``{name:
    array or tuple of arrays}``; copies)."""
    return {"groups": _np_copy(table.groups),
            "states": {name: (tuple(_np_copy(x) for x in st)
                              if isinstance(st, tuple) else _np_copy(st))
                       for name, st in table.states.items()},
            "valid": _np_copy(table.valid),
            "num_groups": _np_copy(table.num_groups)}


# ------------------------------------------------------------ LLM weights

def _tensor(a, device):
    """A numpy array (bfloat16 ones too, as ``ml_dtypes`` holds them) as a
    tensor of the same type on ``device``."""
    import torch

    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tree(tree, fn):
    """``fn`` over the leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


def _unstack(runs, counts) -> list:
    """Stacked runs (leaves ``[count, ...]``) as one tree a layer, in the
    stack's order."""
    return [_tree(run, lambda a, i=i: a[i])
            for run, count in zip(runs, counts) for i in range(count)]


def model_params_from_numpy(cfg, tree, device="cuda"):
    """A :class:`repro_torch.models.model.Model` holding the JAX package's
    parameters of ``cfg`` (``repro.models.model.init_model``'s tree with
    its leaves as numpy arrays): each stacked run split along axis 0 into
    its layers, the padded ``embed`` and ``lm_head`` kept, zamba2's shared
    block one block, whisper's encoder runs its layers."""
    from repro_torch.models import model as MDL

    counts = [count for _, count in MDL.layer_runs(cfg)]
    out = {k: tree[k] for k in ("embed", "final_norm", "lm_head",
                                "shared_attn") if k in tree}
    out["layers"] = _unstack(tree["runs"], counts)
    if "encoder" in tree:
        out["encoder"] = {"layers": _unstack(tree["encoder"]["runs"],
                                             [cfg.encoder_layers]),
                          "final_norm": tree["encoder"]["final_norm"]}
    return MDL.Model(cfg, _tree(out, lambda a: _tensor(a, device)))


def decode_state_from_numpy(cfg, state, device="cuda") -> dict:
    """A decode state of the port from the JAX package's
    (``init_decode_state`` / ``decode_step``'s, leaves as numpy): each
    run's stacked caches and states split into one a layer."""
    from repro_torch.models import model as MDL

    counts = [count for _, count in MDL.layer_runs(cfg)]
    return {"layers": [_tree(st, lambda a: _tensor(a, device))
                       for st in _unstack(state["layers"], counts)],
            "pos": _tensor(state["pos"], device)}
