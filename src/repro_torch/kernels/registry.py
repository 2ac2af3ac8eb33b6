"""Backend registry of the port (its own; nothing registers into the JAX
package's registry).

  * ``reference``   — plain torch engine/SWAG in ``repro_torch.core`` (runs
                      on either device; the oracle the kernels are held to)
  * ``cuda``        — the hand-written kernels, each window re-sorted
                      (group-by via the tiled groupagg kernel); the
                      counterpart of ``pallas``
  * ``cuda-panes``  — WA-panes sorted once, windows merged from presorted
                      panes; the counterpart of ``pallas-panes``
  * ``cuda-panestore`` — per-group windows (``Window(ws_per_group=...)``):
                      the placement scan kernel, then the fused push +
                      partials kernel or the replay kernel; the counterpart
                      of ``pallas-panestore``
  * ``auto``        — ``cuda-panestore`` for per-group windows, else
                      ``cuda-panes`` when the window shape allows, else
                      ``cuda``, for tensors on the card; ``reference`` on
                      the CPU

On CPU tensors the kernel backends run each kernel's plain torch version,
which is how the tests reach them without a card.  Capability probes and
their messages follow the JAX package's (``repro/kernels/registry.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.panestore import DIRECT_OPS, partial_path_names
from repro_torch.core.swag import pane_compatible


@dataclasses.dataclass(frozen=True)
class Backend:
    """One engine implementation the planner can lower a Query onto.
    ``supports(query)`` returns a reason when it cannot run the query."""
    name: str
    supports: Callable[[object], str | None]


def _ref_supports(q) -> str | None:
    return None  # the reference path is total — it is the oracle


def _cuda_window_common(q) -> str | None:
    """Window-clause checks shared by both window kernel backends."""
    if q.window.per_group:
        return ("per-group windows replay from the shared pane store — "
                "use the cuda-panestore backend")
    if q.window.ws & (q.window.ws - 1):
        return f"cuda window kernels need power-of-two WS, got {q.window.ws}"
    if q.presorted:
        return "cuda window kernels always sort in shared memory"
    if q.interpolate:
        return "cuda median is lower-median only (interpolate=False)"
    return None


def _cuda_supports(q) -> str | None:
    if q.window is not None:
        reason = _cuda_window_common(q)
        if reason is not None:
            return reason
        if q.window.panes is True and q.window.wa < q.window.ws:
            return ("Window(panes=True) forces the pane path — use the "
                    "cuda-panes backend")
        return None
    if any(op in ("argmin", "argmax") for op in q.op_names):
        return ("position-carrying operators lift a global iota; the tiled "
                "kernel lifts per tile")
    if "median" in q.op_names and q.interpolate:
        return "cuda median is lower-median only (interpolate=False)"
    return None


def _cuda_panes_supports(q) -> str | None:
    if q.window is None:
        return "pane kernels are a windowed-query backend"
    reason = _cuda_window_common(q)
    if reason is not None:
        return reason
    ws, wa = q.window.ws, q.window.wa
    if not (pane_compatible(ws, wa) or (ws == wa and ws & (ws - 1) == 0)):
        return (f"pane path needs power-of-two WS/WA with WA dividing WS, "
                f"got ws={ws} wa={wa}")
    if q.window.panes is False:
        return "Window(panes=False) forces the re-sort path"
    return None


def _cuda_panestore_supports(q) -> str | None:
    if q.window is None or not q.window.per_group:
        return ("the pane-store kernel serves per-group windows "
                "(Window(ws_per_group=...)) only")
    if q.streaming:
        return "streaming pane-store carries are a reference-backend feature"
    if q.interpolate:
        return "cuda median is lower-median only (interpolate=False)"
    bad = sorted(op for op in q.op_names if op not in DIRECT_OPS)
    if bad:
        return (f"the pane-store kernel computes {sorted(DIRECT_OPS)} "
                f"directly (partial-fused for the partial-path ops, "
                f"merge-replay otherwise); {bad} need the reference "
                f"backend's engine-tail fallback")
    return None


def pergroup_kernel_path(query, key_dtype: torch.dtype | None = None) -> str:
    """The regime ``cuda-panestore`` runs a per-group query in:
    ``"partial-fused"`` when every op rides the per-pane partial path, else
    ``"merge-replay"``."""
    psel = partial_path_names(
        list(query.op_names), torch.int32 if key_dtype is None else key_dtype)
    return "partial-fused" if (psel and all(psel)) else "merge-replay"


BACKENDS: dict[str, Backend] = {b.name: b for b in (
    Backend("reference", _ref_supports),
    Backend("cuda", _cuda_supports),
    Backend("cuda-panes", _cuda_panes_supports),
    Backend("cuda-panestore", _cuda_panestore_supports),
)}


def available_backends() -> tuple[str, ...]:
    return tuple(BACKENDS) + ("auto",)


def get_backend(name: str) -> Backend:
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; have {sorted(available_backends())}"
        ) from None


def unsupported_error(name: str, reason: str) -> ValueError:
    """The error for an explicitly requested backend that rejects a query:
    the probe's reason and the alternatives (never a silent fallback)."""
    return ValueError(
        f"backend {name!r} cannot run this query: {reason} "
        f"[available backends: {', '.join(sorted(available_backends()))}]")


def choose_backend(query, device: torch.device) -> str:
    """Resolve ``auto`` for one query on ``device``: the kernels on the
    card (the pane store for per-group windows, panes when the window shape
    allows), the reference on the CPU.  Routing by measured cost comes with
    the port's observability slice."""
    if device.type != "cuda":
        return "reference"
    for name in ("cuda-panestore", "cuda-panes", "cuda"):
        if BACKENDS[name].supports(query) is None:
            return name
    return "reference"
