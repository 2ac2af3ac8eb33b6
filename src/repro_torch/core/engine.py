"""The group-by-aggregate engine — the paper's Fig. 2, five steps, in torch.

    (b) mark last-of-group (entities t)           -> segscan.segment_ends
    (c) rolling segmented prefix scan (entities n) -> segscan.segmented_scan
    (d) finalize + rolling carry (entities n')    -> combiner.finalize + Carry
    (e) round-robin compaction                    -> prefix sum of valid bits
                                                     + one scatter

Outputs are padded to the input length with a ``valid`` mask and a
``num_groups`` count.  Inputs must be sorted by group id.  Every function
works along the last axis; leading axes are a batch (windows, panes).
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from repro_torch.core import segscan
from repro_torch.core.combiners import Combiner, get_combiner, tree_map

#: sentinel group id for padding slots (sorts after every real group id)
PAD_GROUP = torch.iinfo(torch.int32).max


class GroupAggResult(NamedTuple):
    groups: torch.Tensor      # [..., N] int32 — compacted group ids (PAD tail)
    values: torch.Tensor      # [..., N] — aggregate per group (zero tail)
    valid: torch.Tensor       # [..., N] bool
    num_groups: torch.Tensor  # [...] int32


def _resolve(op) -> Combiner:
    return op if isinstance(op, Combiner) else get_combiner(op)


def _prefix_mask(n: int, n_valid, device) -> torch.Tensor:
    """[..., n] mask of the first ``n_valid`` lanes (scalar or per row)."""
    nv = torch.as_tensor(n_valid, device=device)
    return torch.arange(n, device=device) < nv.unsqueeze(-1)


def _scatter_drop(fill_shape, fill, dtype, idx, src, n: int) -> torch.Tensor:
    """Scatter ``src`` to ``idx`` along the last axis into a buffer of
    ``n + 1`` slots filled with ``fill``; slot ``n`` collects dropped lanes."""
    buf = torch.full(fill_shape[:-1] + (n + 1,), fill, dtype=dtype,
                     device=src.device)
    return buf.scatter_(-1, idx, src.to(dtype))[..., :n]


def _compact_layout(groups: torch.Tensor, emit: torch.Tensor):
    """Step (e): the compaction permutation (prefix sum of ``emit``), the
    compacted group column, and the valid mask/count."""
    n = groups.shape[-1]
    perm = segscan.exclusive_prefix_sum(emit)
    scatter_idx = torch.where(emit, perm, n).to(torch.int64)
    out_groups = _scatter_drop(groups.shape, PAD_GROUP, torch.int32,
                               scatter_idx, groups, n)
    num = emit.to(torch.int32).sum(-1, dtype=torch.int32)
    out_valid = _prefix_mask(n, num, groups.device)
    return scatter_idx, out_groups, num, out_valid


def multi_engine_step(groups: torch.Tensor, keys: torch.Tensor, ops, *,
                      carries=None, open_tail: bool = False, n_valid=None,
                      scan=segscan.segmented_scan):
    """One fused engine pass evaluating several combiners over one stream.

    The segment structure (start/end marks, the compaction permutation, the
    valid count) is computed once; each combiner adds its own lift, scan,
    finalize and value scatter.

    Args:
      groups: [..., N] int group ids, sorted ascending along the last axis.
      keys:   [..., N] values to aggregate.
      ops:    tuple of combiner names / :class:`Combiner` objects.
      carries: optional tuple of rolling :class:`segscan.Carry` states
        aligned with ``ops`` (``None`` entries initialise).
      open_tail: if True, the final real group is not emitted.
      n_valid: optional prefix length (scalar or one per row) — only the
        first ``n_valid`` tuples are real.
      scan: step (c), ``(starts, state, combiner) -> scanned`` (the plain
        :func:`segscan.segmented_scan`, or a kernel's wrapper).

    Returns ``((out_groups, values, out_valid, num), new_carries)``.
    """
    combiners = tuple(_resolve(op) for op in ops)
    names = [c.name for c in combiners]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate combiner names in ops: {names}")

    n = groups.shape[-1]
    groups = groups.to(torch.int32)
    in_valid = None
    if n_valid is not None:
        in_valid = _prefix_mask(n, n_valid, groups.device)
        groups = torch.where(in_valid, groups, PAD_GROUP)

    ends = segscan.segment_ends(groups)
    starts = segscan.segment_starts(groups)

    fresh = carries is None
    if fresh:
        carries = (None,) * len(combiners)
    carries = tuple(
        segscan.init_carry(c, keys.dtype, keys.device) if cr is None else cr
        for c, cr in zip(combiners, carries))

    scanneds = []
    for combiner, carry in zip(combiners, carries):
        scanned = scan(starts, combiner.lift(keys), combiner)
        if not fresh:  # a fresh carry is empty: merging it is a no-op
            scanned = segscan.merge_carry(carry, groups, scanned, combiner)
        scanneds.append(scanned)

    emit = ends
    if in_valid is not None:
        emit = emit & (groups != PAD_GROUP)
    if open_tail:
        rev = torch.flip(emit, dims=(-1,)).to(torch.int32)
        last_real = (torch.flip(torch.cumsum(rev, dim=-1), dims=(-1,)) == 1) \
            & emit
        emit = emit & ~last_real

    scatter_idx, out_groups, num, out_valid = _compact_layout(groups, emit)

    values = {}
    new_carries = []
    for combiner, carry, scanned in zip(combiners, carries, scanneds):
        vals = combiner.finalize(scanned)
        values[combiner.name] = _scatter_drop(vals.shape, 0, vals.dtype,
                                              scatter_idx, vals, n)
        new_carry = segscan.update_carry(carry, groups, scanned, emit,
                                         combiner)
        if in_valid is not None:
            # an all-padding batch must not clobber the carry group id
            n_real = in_valid.to(torch.int32).sum(-1)
            any_real = n_real > 0
            tail_idx = torch.clamp(n_real - 1, min=0).unsqueeze(-1).long()
            tail_state = tree_map(
                lambda s: torch.gather(s, -1, tail_idx).squeeze(-1), scanned)
            tail_group = torch.gather(groups, -1, tail_idx).squeeze(-1)
            new_carry = segscan.Carry(
                group=torch.where(any_real, tail_group,
                                  carry.group).to(torch.int32),
                state=tree_map(lambda t, c: torch.where(any_real, t, c),
                               tail_state, carry.state),
                nonempty=carry.nonempty | any_real,
                emitted=(carry.emitted + num).to(torch.int32),
            )
        new_carries.append(new_carry)

    return (out_groups, values, out_valid, num), tuple(new_carries)


class PartialTable(NamedTuple):
    """A compact per-group partial result table: the engine stopped one
    step before ``finalize``, the unit of two-phase (mergeable-state)
    execution.  Each shard or pane reduces its range of the stream to one,
    tables merge with :func:`combine_partial_tables` until one remains,
    which then finalizes.  Rows are ascending unique group ids with a
    ``PAD_GROUP`` tail; invalid rows hold the combiner identity.  Every
    field may carry leading batch axes (shards, windows, panes)."""
    groups: torch.Tensor      # [..., C] int32 — ascending ids (PAD tail)
    states: dict              # {op name: state, each leaf [..., C]}
    valid: torch.Tensor       # [..., C] bool
    num_groups: torch.Tensor  # [...] int32


def _scatter_states(scanned, combiner: Combiner, key_dtype, scatter_idx,
                    n: int):
    """Compact a scanned state by the shared permutation; dropped slots
    hold the combiner identity (cast to each leaf's dtype)."""
    ident = combiner.identity(tuple(scatter_idx.shape[:-1]) + (n + 1,),
                              key_dtype, scatter_idx.device)
    return tree_map(
        lambda buf, leaf: buf.to(leaf.dtype).scatter_(-1, scatter_idx,
                                                      leaf)[..., :n],
        ident, scanned)


def multi_engine_partials(groups: torch.Tensor, keys: torch.Tensor, ops, *,
                          n_valid=None,
                          scan=segscan.segmented_scan) -> PartialTable:
    """The local phase of two-phase execution: one engine pass that stops
    before ``finalize`` and returns the compact per-group partial-state
    table of this range of the stream.  The contract of
    :func:`multi_engine_step` (sorted by group, ``n_valid`` a real prefix,
    ``scan`` its step (c)), without carries."""
    combiners = tuple(_resolve(op) for op in ops)
    names = [c.name for c in combiners]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate combiner names in ops: {names}")
    n = groups.shape[-1]
    groups = groups.to(torch.int32)
    if n_valid is not None:
        groups = torch.where(_prefix_mask(n, n_valid, groups.device), groups,
                             PAD_GROUP)
    starts = segscan.segment_starts(groups)
    emit = segscan.segment_ends(groups) & (groups != PAD_GROUP)
    scatter_idx, out_groups, num, out_valid = _compact_layout(groups, emit)
    states = {c.name: _scatter_states(scan(starts, c.lift(keys), c), c,
                                      keys.dtype, scatter_idx, n)
              for c in combiners}
    return PartialTable(out_groups, states, out_valid, num)


def combine_partial_tables(a: PartialTable, b: PartialTable, ops, *,
                           key_dtype) -> PartialTable:
    """Merge two per-range partial tables (``a`` the earlier range): one
    node of the combine tree.  A stable sort of the concatenated rows by
    group keeps ``a``'s row before ``b``'s within a group (the
    order-sensitive merges, dc's boundary rule and first/last, need it),
    each op's :meth:`Combiner.partial_merge` folds them and the shared
    compaction re-packs the result.  The output is as wide as both inputs
    together.

    Each table holds a group in one row at most, so a live group's rows
    form a run of one or two after the sort: its fold is one merge of a
    row with the row before it, where the segmented scan of the JAX
    package takes log2(width) rounds to the same states (only the runs of
    padding rows, which are dropped, are longer)."""
    combiners = tuple(_resolve(op) for op in ops)
    g = torch.cat([a.groups, b.groups], dim=-1).to(torch.int32)
    order = torch.sort(g, dim=-1, stable=True).indices
    g = torch.gather(g, -1, order)
    n = g.shape[-1]
    second = ~segscan.segment_starts(g)   # a row whose group continues
    emit = segscan.segment_ends(g) & (g != PAD_GROUP)
    scatter_idx, out_groups, num, out_valid = _compact_layout(g, emit)
    states = {}
    for c in combiners:
        joined = tree_map(
            lambda x, y: torch.gather(torch.cat([x, y], dim=-1), -1, order),
            a.states[c.name], b.states[c.name])
        merged = c.partial_merge(
            tree_map(lambda x: torch.roll(x, 1, dims=-1), joined), joined)
        folded = tree_map(lambda m, x: torch.where(second, m, x), merged,
                          joined)
        states[c.name] = _scatter_states(folded, c, key_dtype, scatter_idx,
                                         n)
    return PartialTable(out_groups, states, out_valid, num)


def empty_partial_table(width: int, ops, key_dtype, device="cpu",
                        lead: tuple = ()) -> PartialTable:
    """The identity of :func:`combine_partial_tables`: what an empty shard
    contributes to the combine tree (``lead``: leading batch axes)."""
    shape = tuple(lead) + (width,)
    states = {c.name: c.identity(shape, key_dtype, device)
              for c in (_resolve(op) for op in ops)}
    return PartialTable(
        groups=torch.full(shape, PAD_GROUP, dtype=torch.int32, device=device),
        states=states,
        valid=torch.zeros(shape, dtype=torch.bool, device=device),
        num_groups=torch.zeros(tuple(lead), dtype=torch.int32, device=device))


def finalize_partial_table(table: PartialTable, ops):
    """The last stage of the two-phase pipeline: each op's ``finalize`` on
    the merged table, invalid rows zeroed.  Returns ``(groups, {name:
    values}, valid, num_groups)``."""
    values = {}
    for c in (_resolve(op) for op in ops):
        v = c.finalize(table.states[c.name])
        values[c.name] = torch.where(table.valid, v,
                                     torch.zeros((), dtype=v.dtype,
                                                 device=v.device))
    return table.groups, values, table.valid, table.num_groups


def engine_step(groups: torch.Tensor, keys: torch.Tensor, op, *,
                carry: segscan.Carry | None = None, open_tail: bool = False,
                n_valid=None) -> tuple[GroupAggResult, segscan.Carry]:
    """Single-op case of :func:`multi_engine_step`."""
    combiner = _resolve(op)
    carries = None if carry is None else (carry,)
    (g, values, valid, num), (new_carry,) = multi_engine_step(
        groups, keys, (combiner,), carries=carries, open_tail=open_tail,
        n_valid=n_valid)
    return GroupAggResult(g, values[combiner.name], valid, num), new_carry


def _group_by_aggregate(groups: torch.Tensor, keys: torch.Tensor, op="sum",
                        *, n_valid=None) -> GroupAggResult:
    """Single-shot ``SELECT g, f(k) FROM t GROUP BY g ORDER BY g``."""
    result, _ = engine_step(groups, keys, op, n_valid=n_valid)
    return result


def _deprecated(old: str, hint: str) -> None:
    """One shared deprecation funnel for every legacy entry-point shim."""
    warnings.warn(
        f"{old} is deprecated; build a repro_torch.query.Query ({hint}) and "
        f"call repro_torch.query.execute instead",
        DeprecationWarning, stacklevel=3)


def _device_of(keys):
    """Where a shim runs: the device of ``keys`` when it is a tensor, else
    the card (the entry points' default)."""
    return keys.device if isinstance(keys, torch.Tensor) else "cuda"


def group_by_aggregate(groups, keys, op="sum", *,
                       n_valid=None) -> GroupAggResult:
    """Deprecated: use ``repro_torch.query.Query(ops=(op,))`` +
    ``execute`` (the ``reference`` backend, on the device of ``keys``)."""
    _deprecated("repro_torch.core.group_by_aggregate", "Query(ops=(op,))")
    from repro_torch import query as _q
    name = op.name if isinstance(op, Combiner) else _q.canonical_op(op)
    res, _ = _q.execute(_q.Query(ops=(op,)), groups, keys, n_valid=n_valid,
                        backend="reference", device=_device_of(keys))
    return GroupAggResult(res.groups, res.values[name], res.valid,
                          res.num_groups)


def multi_aggregate(groups, keys, ops, *,
                    n_valid=None) -> dict[str, GroupAggResult]:
    """Deprecated: use ``repro_torch.query.Query(ops=ops)`` + ``execute``
    (which also fuses the shared mark and compaction across ops)."""
    _deprecated("repro_torch.core.multi_aggregate", "Query(ops=ops)")
    from repro_torch import query as _q
    res, _ = _q.execute(_q.Query(ops=tuple(ops)), groups, keys,
                        n_valid=n_valid, backend="reference",
                        device=_device_of(keys))
    return {name: GroupAggResult(res.groups,
                                 res.values[_q.canonical_op(name)],
                                 res.valid, res.num_groups)
            for name in ops}


def rr_ports(result: GroupAggResult, emitted_before, p: int) -> torch.Tensor:
    """Round-robin output port per emitted group — the PRRA's defining
    property.  ``emitted_before`` is ``carry.emitted`` *prior* to this batch.
    """
    idx = torch.arange(result.groups.shape[-1], dtype=torch.int32,
                       device=result.groups.device)
    return torch.where(result.valid, (emitted_before + idx) % p,
                       -1).to(torch.int32)
