"""Host-side nested span tracing for engine stages (the counterpart of
``repro.obs.trace``).

Usage::

    from repro_torch.obs import trace

    with trace.capture() as tr:
        res, _ = execute(q, groups, keys)
    print(tr.report())

Inside the engine, stages are wrapped as::

    with trace.span("dispatch:cuda/engine") as sp:
        res = run(...)
        sp.attach(res)

``span()`` is free when no capture is active: it returns a shared no-op
context manager, so the engine pays one function call and nothing else.
When a capture *is* active, a span's exit waits for the devices of the
tensors ``attach()`` was given before it reads the clock, so the recorded
wall time covers the work the stage queued on the card, not just its
launches: ``torch.cuda.synchronize(device)`` for each CUDA device among
them, nothing for CPU tensors.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Any, Iterator, List, Optional

import torch


@dataclasses.dataclass
class Span:
    name: str
    depth: int
    start_s: float
    duration_s: float = 0.0

    def to_dict(self) -> dict:
        return {"name": self.name, "depth": self.depth,
                "start_s": self.start_s, "duration_s": self.duration_s}


class Tracer:
    """Collects completed spans for one :func:`capture` block."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._depth = 0

    def report(self) -> str:
        lines = []
        for s in self.spans:
            lines.append(f"{'  ' * s.depth}{s.name}: "
                         f"{s.duration_s * 1e3:.3f} ms")
        return "\n".join(lines)

    def to_dicts(self) -> list:
        return [s.to_dict() for s in self.spans]

    def durations(self) -> dict:
        """name -> summed duration in seconds (over all spans of that name)."""
        out: dict = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.duration_s
        return out


_ACTIVE: List[Tracer] = []


@contextmanager
def capture() -> Iterator[Tracer]:
    """Activate a tracer; spans entered inside the block are recorded."""
    tracer = Tracer()
    _ACTIVE.append(tracer)
    try:
        yield tracer
    finally:
        _ACTIVE.remove(tracer)


class _NullSpan:
    __slots__ = ()

    def attach(self, value: Any) -> Any:
        return value

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


class _LiveSpan:
    __slots__ = ("_tracer", "_span", "_payload")

    def __init__(self, tracer: Tracer, name: str) -> None:
        self._tracer = tracer
        self._span = Span(name, tracer._depth, 0.0)
        self._payload: Any = None

    def attach(self, value: Any) -> Any:
        """Register tensors to wait for at exit; returns them unchanged."""
        self._payload = value
        return value

    def __enter__(self) -> "_LiveSpan":
        self._span.depth = self._tracer._depth
        self._tracer._depth += 1
        self._span.start_s = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if exc[0] is None and self._payload is not None:
            synchronize(self._payload)
        self._span.duration_s = time.perf_counter() - self._span.start_s
        self._tracer._depth -= 1
        self._tracer.spans.append(self._span)
        return False


def span(name: str):
    """A context manager timing one engine stage under the active tracer."""
    if not _ACTIVE:
        return _NULL
    return _LiveSpan(_ACTIVE[-1], name)


def tensors(value: Any) -> list:
    """The tensors in ``value`` (nested tuples, lists, dicts and named
    tuples), in order."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in tensors(v)]
    return []


def synchronize(value: Any) -> None:
    """Wait for the work queued on the CUDA devices of the tensors in
    ``value`` (nested tuples, lists, dicts and named tuples); CPU tensors
    need nothing."""
    devices = {t.device for t in tensors(value) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def active() -> Optional[Tracer]:
    """The innermost active tracer, or None."""
    return _ACTIVE[-1] if _ACTIVE else None
