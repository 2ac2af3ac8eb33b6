"""Monoid algebra for the aggregation engine (the paper's ``function_select``).

Each operator is a :class:`Combiner`: an associative monoid over a
per-element *state*, which is one tensor or a tuple of same-shape tensors.
The engine is written once against this algebra.

``lift(key) -> state``            one tuple's key as scan state
``op(a, b) -> state``             combine two adjacent states (``a`` earlier)
``merge_partial(a, b) -> state``  combine two per-range partial states
                                  (``None`` means "same as ``op``")
``finalize(state) -> value``      the last-of-group state as the result
``identity(shape, dtype, device) -> state``  the neutral element

Integer keys accumulate in int32, as the JAX package does with x64 off:
``torch.sum``/``torch.cumsum`` widen int32 to int64, so nothing here uses
them on an accumulator, and int32 adds wrap exactly as JAX's do.

Distinct count carries ``(dc, first, last)`` and merges adjacent sorted
ranges with the paper's rule: equal boundary keys were counted twice, so
subtract one.  It needs keys sorted within each group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

State = Any  # a tensor or a tuple of tensors of one shape


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of one or more same-structure states."""
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


@dataclasses.dataclass(frozen=True)
class Combiner:
    name: str
    lift: Callable[[torch.Tensor], State]
    op: Callable[[State, State], State]
    finalize: Callable[[State], torch.Tensor]
    identity: Callable[..., State]
    #: whether keys must be sorted within each group (paper's dc requirement)
    needs_sorted_keys: bool = False
    #: combine two per-range partial states of one group (None -> ``op``)
    merge_partial: Callable[[State, State], State] | None = None
    #: False when partials cannot be merged across independently-lifted
    #: ranges (argmin/argmax: stream-local positions)
    mergeable: bool = True

    def partial_merge(self, a: State, b: State) -> State:
        """Merge two per-range partial states (``a`` the earlier range)."""
        if not self.mergeable:
            raise ValueError(
                f"combiner {self.name!r} is not mergeable across shards: "
                f"its lifted state is meaningful only relative to the full "
                f"stream it was lifted from")
        fn = self.merge_partial if self.merge_partial is not None else self.op
        return fn(a, b)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Combiner({self.name})"


def partial_combiner(comb: Combiner) -> Combiner:
    """The table-level view of ``comb``: elements are already-aggregated
    per-range partial states (identity lift), folded with
    :meth:`Combiner.partial_merge`."""
    if not comb.mergeable:
        raise ValueError(f"combiner {comb.name!r} has no partial-state "
                         f"merge (mergeable=False)")
    return Combiner(
        name=comb.name,
        lift=lambda state: state,
        op=comb.partial_merge,
        finalize=comb.finalize,
        identity=comb.identity,
        needs_sorted_keys=False,
    )


def is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex \
        and dtype != torch.bool


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: int32 for every integer key (the JAX package's
    x64-off rule), float32 for half-width floats, else the key dtype."""
    if is_integer(dtype):
        return torch.int32
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


def _min_value(dtype: torch.dtype):
    return torch.iinfo(dtype).min if is_integer(dtype) else float("-inf")


def _max_value(dtype: torch.dtype):
    return torch.iinfo(dtype).max if is_integer(dtype) else float("inf")


def _full(shape, value, dtype, device):
    return torch.full(tuple(shape), value, dtype=dtype, device=device)


def _sum() -> Combiner:
    return Combiner(
        name="sum",
        lift=lambda k: k.to(_acc_dtype(k.dtype)),
        op=lambda a, b: a + b,
        finalize=lambda s: s,
        identity=lambda shape, dtype, device="cpu": _full(
            shape, 0, _acc_dtype(dtype), device),
    )


def _min() -> Combiner:
    return Combiner(
        name="min",
        lift=lambda k: k,
        op=torch.minimum,
        finalize=lambda s: s,
        identity=lambda shape, dtype, device="cpu": _full(
            shape, _max_value(dtype), dtype, device),
    )


def _max() -> Combiner:
    return Combiner(
        name="max",
        lift=lambda k: k,
        op=torch.maximum,
        finalize=lambda s: s,
        identity=lambda shape, dtype, device="cpu": _full(
            shape, _min_value(dtype), dtype, device),
    )


def _count() -> Combiner:
    return Combiner(
        name="count",
        lift=lambda k: torch.ones(k.shape, dtype=torch.int32, device=k.device),
        op=lambda a, b: a + b,
        finalize=lambda s: s,
        identity=lambda shape, dtype, device="cpu": _full(
            shape, 0, torch.int32, device),
    )


def _mean_finalize(s):
    total, cnt = s
    # the order of the JAX package: cast both, then one IEEE divide
    return total.to(torch.float32) / torch.clamp(cnt, min=1).to(torch.float32)


def _mean() -> Combiner:
    return Combiner(
        name="mean",
        lift=lambda k: (k.to(_acc_dtype(k.dtype)),
                        torch.ones(k.shape, dtype=torch.int32,
                                   device=k.device)),
        op=lambda a, b: (a[0] + b[0], a[1] + b[1]),
        finalize=_mean_finalize,
        identity=lambda shape, dtype, device="cpu": (
            _full(shape, 0, _acc_dtype(dtype), device),
            _full(shape, 0, torch.int32, device)),
    )


def _dc_op(a, b):
    dca, fa, la = a
    dcb, fb, lb = b
    return (dca + dcb - (la == fb).to(torch.int32), fa, lb)


def _distinct_count() -> Combiner:
    """Paper's "dc" variant: state = (dc, first_key, last_key)."""
    return Combiner(
        name="distinct_count",
        lift=lambda k: (torch.ones(k.shape, dtype=torch.int32,
                                   device=k.device), k, k),
        op=_dc_op,
        finalize=lambda s: s[0],
        identity=lambda shape, dtype, device="cpu": (
            _full(shape, 0, torch.int32, device),
            _full(shape, _max_value(dtype), dtype, device),
            _full(shape, _min_value(dtype), dtype, device)),
        needs_sorted_keys=True,
        merge_partial=_dc_op,
    )


def _first() -> Combiner:
    return Combiner(
        name="first",
        lift=lambda k: k,
        op=lambda a, b: a,
        finalize=lambda s: s,
        identity=lambda shape, dtype, device="cpu": _full(shape, 0, dtype,
                                                          device),
    )


def _last() -> Combiner:
    return Combiner(
        name="last",
        lift=lambda k: k,
        op=lambda a, b: b,
        finalize=lambda s: s,
        identity=lambda shape, dtype, device="cpu": _full(shape, 0, dtype,
                                                          device),
    )


def _variance() -> Combiner:
    """Population variance via the parallel Welford / Chan monoid:
    state = (count, mean, M2)."""

    def lift(k):
        k32 = k.to(torch.float32)
        return (torch.ones(k.shape, dtype=torch.float32, device=k.device),
                k32, torch.zeros_like(k32))

    def op(a, b):
        na, ma, m2a = a
        nb, mb, m2b = b
        n = na + nb
        d = mb - ma
        safe_n = torch.clamp(n, min=1.0)
        mean = ma + d * nb / safe_n
        m2 = m2a + m2b + torch.square(d) * na * nb / safe_n
        return (n, mean, m2)

    def finalize(s):
        n, _, m2 = s
        return m2 / torch.clamp(n, min=1.0)

    def identity(shape, dtype, device="cpu"):
        return tuple(_full(shape, 0, torch.float32, device) for _ in range(3))

    return Combiner("variance", lift, op, finalize, identity)


def _argminmax(mode: str) -> Combiner:
    """Index of the min/max key within the group (first occurrence); the
    positions come from a lift-time iota over this stream slice."""
    better = torch.lt if mode == "argmin" else torch.gt

    def lift(k):
        idx = torch.arange(k.shape[-1], dtype=torch.int32, device=k.device)
        return (k, idx.expand(k.shape).contiguous())

    def op(a, b):
        ka, ia = a
        kb, ib = b
        take_b = better(kb, ka)
        return (torch.where(take_b, kb, ka), torch.where(take_b, ib, ia))

    def identity(shape, dtype, device="cpu"):
        fill = _max_value(dtype) if mode == "argmin" else _min_value(dtype)
        return (_full(shape, fill, dtype, device),
                _full(shape, 0, torch.int32, device))

    return Combiner(mode, lift, op, lambda s: s[1], identity, mergeable=False)


_REGISTRY: dict[str, Callable[[], Combiner]] = {
    "sum": _sum,
    "min": _min,
    "max": _max,
    "count": _count,
    "mean": _mean,
    "distinct_count": _distinct_count,
    "first": _first,
    "last": _last,
    "variance": _variance,
    "argmin": lambda: _argminmax("argmin"),
    "argmax": lambda: _argminmax("argmax"),
}

#: operators supported by the paper's base engine configuration
PAPER_BASE_OPS = ("min", "max", "sum", "count")
#: + the "dc" configuration
PAPER_DC_OPS = PAPER_BASE_OPS + ("distinct_count",)
#: the built-in operators (those the kernels compute; a combiner registered
#: later runs on the reference backend)
ALL_OPS = tuple(_REGISTRY)


def get_combiner(name: str) -> Combiner:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(f"unknown aggregate op {name!r}; have "
                         f"{sorted(_REGISTRY)}") from None


def register_combiner(name: str, factory: Callable[[], Combiner]) -> None:
    """Extension point — the paper's 'adaptable' knob for custom engines:
    ``get_combiner(name)`` then returns ``factory()``, and queries may name
    it (the kernel backends refuse it; ``reference`` runs it)."""
    _REGISTRY[name] = factory


def out_dtype(name: str, key_dtype: torch.dtype) -> torch.dtype:
    """The dtype of ``name``'s finalized value for ``key_dtype`` keys
    (``"median"`` stays in the key domain)."""
    if name == "median":
        return key_dtype
    comb = get_combiner(name)
    probe = torch.zeros((1,), dtype=key_dtype)
    return comb.finalize(comb.lift(probe)).dtype
