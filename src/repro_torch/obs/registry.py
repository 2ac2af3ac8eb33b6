"""Process-wide metrics registry: per-(backend, plan fingerprint) observed
throughput (the counterpart of ``repro.obs.registry``).

This is the table measured-cost routing consults:
:func:`repro_torch.kernels.registry.choose_backend` looks up ``(candidate
backend, query_fingerprint(query))`` here and, once two or more candidates
have measured cells, picks the one the numbers favor.

``execute(..., collect_stats=True)`` records one observation a call,
timed from the call's start to its result being ready on the device.
The fingerprint strings equal the JAX package's for the same query.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class _Cell:
    tuples: float = 0.0
    seconds: float = 0.0
    calls: int = 0

    @property
    def tuples_per_s(self) -> float:
        return self.tuples / self.seconds if self.seconds > 0 else 0.0

    def to_dict(self) -> dict:
        return {"tuples": self.tuples, "seconds": self.seconds,
                "calls": self.calls, "tuples_per_s": self.tuples_per_s}


class MetricsRegistry:
    """Accumulates observed tuples/s keyed by ``(backend, fingerprint)``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cells: Dict[Tuple[str, str], _Cell] = {}

    def observe(self, backend: str, fingerprint: str, *, tuples: float,
                seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            cell = self._cells.setdefault((backend, fingerprint), _Cell())
            cell.tuples += float(tuples)
            cell.seconds += float(seconds)
            cell.calls += 1

    def tuples_per_s(self, backend: str, fingerprint: str) -> Optional[float]:
        with self._lock:
            cell = self._cells.get((backend, fingerprint))
        return None if cell is None else cell.tuples_per_s

    def best_backend(self, fingerprint: str, among=None) -> Optional[str]:
        """The backend with the highest observed tuples/s for this plan
        shape (None: no data yet).  ``among`` restricts the vote to a
        candidate set, so a stale cell of a backend that can no longer run
        the query cannot win."""
        with self._lock:
            candidates = [(cell.tuples_per_s, backend)
                          for (backend, fp), cell in self._cells.items()
                          if fp == fingerprint and cell.seconds > 0
                          and (among is None or backend in among)]
        if not candidates:
            return None
        return max(candidates)[1]

    def snapshot(self) -> dict:
        """{(backend, fingerprint): {tuples, seconds, calls, tuples_per_s}}"""
        with self._lock:
            return {key: cell.to_dict() for key, cell in self._cells.items()}

    def reset(self) -> None:
        with self._lock:
            self._cells.clear()


#: the process-wide registry ``execute(..., collect_stats=True)`` feeds
METRICS = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return METRICS


def query_fingerprint(query, *, path: Optional[str] = None,
                      num_shards: int = 1) -> str:
    """A stable string identifying the *shape* of a query: ops, grouping,
    window framing, path and shard count, everything cost depends on but
    the backend (the other half of the registry key) and the data.
    ``path=None`` derives the path the planner would assign (stream /
    window / engine), so ``choose_backend`` can fingerprint a query before
    a plan exists and land on the key ``execute(..., collect_stats=True)``
    later records under."""
    q = query
    w = q.window
    if path is None:
        path = ("stream" if q.streaming
                else "window" if w is not None else "engine")
    bits = [f"ops={','.join(q.op_names)}",
            f"group_by={int(q.group_by)}",
            f"path={path}",
            f"shards={num_shards}"]
    if w is not None:
        if w.is_time:
            bits.append(f"window=time:r{w.range}:s{w.slide}"
                        f":l{w.max_lateness}:rc{w.reorder_capacity}")
        elif w.per_group:
            bits.append(f"window=pergroup:wa{w.wa}:cap{w.capacity}")
        else:
            bits.append(f"window=count:ws{w.ws}:wa{w.wa}")
    if q.interpolate:
        bits.append("interpolate=1")
    return ";".join(bits)


def plan_fingerprint(plan) -> str:
    """:func:`query_fingerprint` of a plan: its query with the plan's path
    and shard count."""
    return query_fingerprint(plan.query, path=plan.path,
                             num_shards=plan.num_shards)
