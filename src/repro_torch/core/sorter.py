"""Sorters feeding the engine: the bitonic network and a library baseline.

  * :func:`bitonic_sort`     — the network (power-of-two length,
                               multi-operand, lexicographic by the leading
                               ``num_keys`` operands), along the last axis
  * :func:`bitonic_merge`    — merge the two sorted halves (one stage)
  * :func:`merge_presorted`  — multiway merge of n/run presorted runs
                               (log2(n/run) rounds of reverse + clean sweeps)
  * :func:`sort_pairs`       — (group, key) tuples with INT32_MAX padding
  * :func:`sort_pairs_xla`   — two stable ``torch.sort`` passes, the
                               counterpart of the JAX package's ``lax.sort``

Each compare-exchange sweep uses the reshape-pair trick: partners ``i ^ j``
become adjacent on a middle axis ``[..., n/(2j), 2, j]``, so a sweep is a
pure select.  A fully (group, key)-sorted sequence of a multiset is unique,
so the network, the merge and the library sort all give identical output.
"""
from __future__ import annotations

import torch

INT32_MAX = torch.iinfo(torch.int32).max


def _lex_less(a, b) -> torch.Tensor:
    """Strict lexicographic a < b over parallel key tensors."""
    less = torch.zeros_like(a[0], dtype=torch.bool)
    eq = torch.ones_like(a[0], dtype=torch.bool)
    for x, y in zip(a, b):
        less = less | (eq & (x < y))
        eq = eq & (x == y)
    return less


def _sweep(operands, num_keys: int, j: int, up) -> tuple:
    """One compare-exchange sweep at distance ``j``; ``up`` is None (all
    pairs ascending) or a bool tensor ``[n/(2j), 1]`` of ascending pair rows.
    Strict compares: ties never swap."""
    n = operands[0].shape[-1]
    lead = operands[0].shape[:-1]
    m = n // (2 * j)
    ops_r = [x.reshape(lead + (m, 2, j)) for x in operands]
    a = [x[..., 0, :] for x in ops_r]
    b = [x[..., 1, :] for x in ops_r]
    b_less = _lex_less(b[:num_keys], a[:num_keys])
    if up is None:
        swap = b_less
    else:
        swap = torch.where(up, b_less, _lex_less(a[:num_keys],
                                                 b[:num_keys]))
    return tuple(
        torch.stack([torch.where(swap, y, x), torch.where(swap, x, y)],
                    dim=-2).reshape(lead + (n,))
        for x, y in zip(a, b))


def bitonic_sort(operands, num_keys: int = 1) -> tuple:
    """Sort parallel tensors by the leading ``num_keys`` operands
    (ascending) along the last axis; the length must be a power of two."""
    operands = tuple(operands)
    n = operands[0].shape[-1]
    if n & (n - 1):
        raise ValueError(f"bitonic_sort needs power-of-two length, got {n}")
    device = operands[0].device
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            m = n // (2 * j)
            # ascending iff bit k of the element index is 0
            up = ((torch.arange(m, device=device) * 2 * j) & k) == 0
            operands = _sweep(operands, num_keys, j, up.reshape(m, 1))
            j //= 2
        k *= 2
    return operands


def _reverse_odd_runs(x: torch.Tensor, run: int) -> torch.Tensor:
    """Reverse the second ``run``-length run of every ``2*run`` block, so
    two ascending runs become one bitonic sequence."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    xr = x.reshape(lead + (n // (2 * run), 2, run))
    return torch.stack([xr[..., 0, :], torch.flip(xr[..., 1, :], dims=(-1,))],
                       dim=-2).reshape(lead + (n,))


def bitonic_merge(operands, num_keys: int = 1) -> tuple:
    """Merge the two ascending halves of each operand's last axis: one
    merge stage (log2(n) sweeps) instead of the full re-sort.  The length
    must be a power of two."""
    operands = tuple(operands)
    n = operands[0].shape[-1]
    if n & (n - 1):
        raise ValueError(f"bitonic_merge needs power-of-two length, got {n}")
    return merge_presorted(operands, run=n // 2, num_keys=num_keys)


def merge_presorted(operands, *, run: int, num_keys: int = 1) -> tuple:
    """Multiway merge of ``n/run`` presorted ascending runs of length
    ``run`` along the last axis; ``n``, ``run`` and ``n/run`` must be
    powers of two."""
    operands = tuple(operands)
    n = operands[0].shape[-1]
    if n & (n - 1) or run & (run - 1) or run < 1 or n % run:
        raise ValueError(f"merge_presorted needs power-of-two length/run, "
                         f"got n={n} run={run}")
    length = run
    while length < n:
        operands = tuple(_reverse_odd_runs(x, length) for x in operands)
        length *= 2
        j = length // 2
        while j >= 1:
            operands = _sweep(operands, num_keys, j, None)
            j //= 2
    return operands


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def sort_pairs(groups: torch.Tensor, keys: torch.Tensor, *,
               full_width: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort (group, key) tuples with the network, padding to a power of
    two with INT32_MAX groups.  ``full_width`` sorts by (group, key), which
    distinct_count and median need; else by group only."""
    n = groups.shape[-1]
    m = next_pow2(n)
    if m != n:
        lead = groups.shape[:-1]
        groups = torch.cat([groups, torch.full(lead + (m - n,), INT32_MAX,
                                               dtype=groups.dtype,
                                               device=groups.device)], -1)
        keys = torch.cat([keys, torch.zeros(lead + (m - n,), dtype=keys.dtype,
                                            device=keys.device)], -1)
    g, k = bitonic_sort((groups, keys), num_keys=2 if full_width else 1)
    return g[..., :n], k[..., :n]


def sort_pairs_xla(groups: torch.Tensor, keys: torch.Tensor, *,
                   full_width: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Library sort: a stable pass by key, then a stable pass by group —
    the lexicographic (group, key) order of a two-key ``lax.sort``."""
    if full_width:
        order = torch.sort(keys, dim=-1, stable=True).indices
        groups = torch.gather(groups, -1, order)
        keys = torch.gather(keys, -1, order)
    order = torch.sort(groups, dim=-1, stable=True).indices
    return torch.gather(groups, -1, order), torch.gather(keys, -1, order)
