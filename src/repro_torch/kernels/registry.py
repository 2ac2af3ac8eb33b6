"""Backend registry of the port (its own; nothing registers into the JAX
package's registry).

  * ``reference``   — plain torch engine/SWAG in ``repro_torch.core`` (runs
                      on either device; the oracle the kernels are held to)
  * ``cuda``        — the hand-written kernels, each window re-sorted
                      (group-by via the tiled groupagg kernel; time-range
                      windows via the two-stack flip kernel or the swag
                      kernel over framed windows; non-windowed streams via
                      the segmented-scan kernel, one launch an op a push);
                      the counterpart of ``pallas``
  * ``cuda-panes``  — WA-panes sorted once, windows merged from presorted
                      panes; the counterpart of ``pallas-panes``
  * ``cuda-panestore`` — per-group windows (``Window(ws_per_group=...)``):
                      the placement scan kernel, then the fused push +
                      partials kernel or the replay kernel; the counterpart
                      of ``pallas-panestore``.  Streaming count windows
                      too: a push is one placement scan from the carried
                      store and one replay of the store it leaves; and
                      event-time streams: a push is one reorder launch,
                      one time-mode placement and one replay at the
                      watermark
  * ``auto``        — the fastest capable backend by observed tuples/s
                      (``repro_torch.obs.registry.METRICS``) once two or
                      more have been measured for the query's shape;
                      else ``cuda-panestore`` for per-group and streaming
                      windows, else ``cuda-panes`` when the window shape
                      allows, else ``cuda``, else ``reference``, for
                      tensors on the card; ``reference`` on the CPU

On CPU tensors the kernel backends run each kernel's plain torch version,
which is how the tests reach them without a card.  Capability probes and
their messages follow the JAX package's (``repro/kernels/registry.py``);
every kernel backend refuses a combiner registered with
:func:`repro_torch.core.combiners.register_combiner`.

Selection precedence: the explicit ``backend=`` argument, then the
``REPRO_TORCH_BACKEND`` environment variable, then ``auto``
(:func:`resolve_backend`).  The variable is the port's own: the JAX
package reads ``REPRO_BACKEND``, whose names (``pallas*``) are not the
port's.  New backends register with :func:`register_backend`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch

from repro_torch.core.combiners import ALL_OPS
from repro_torch.core.panestore import DIRECT_OPS, partial_path_names
from repro_torch.core.swag import pane_compatible
from repro_torch.kernels.eventtime.kernel import MAX_REORDER_CAPACITY
from repro_torch.kernels.segscan.kernel import SEGSCAN_OPS
from repro_torch.kernels.swag.kernel import (MAX_ROW, SMEM_BUDGET,
                                             time_scan_smem)

#: environment variable consulted when no explicit backend is passed
BACKEND_ENV = "REPRO_TORCH_BACKEND"

#: the reason every global-window kernel backend gives a streaming window
STREAM_WINDOW = ("streaming windows thread a pane store as their carry — "
                 "use the cuda-panestore backend")


@dataclasses.dataclass(frozen=True)
class Backend:
    """One engine implementation the planner can lower a Query onto.
    ``supports(query)`` returns a reason when it cannot run the query."""
    name: str
    supports: Callable[[object], str | None]


def _ref_supports(q) -> str | None:
    return None  # the reference path is total — it is the oracle


def _registered_ops(q) -> str | None:
    """The kernel backends compute the built-in ops only."""
    custom = sorted(set(q.op_names) - set(ALL_OPS) - {"median"})
    if custom:
        return (f"{custom} are registered combiners, which the kernels do "
                f"not compute — use the reference backend")
    return None


def _kernel_probe(fn):
    """A kernel backend's probe: registered combiners refused first."""
    def supports(q) -> str | None:
        return _registered_ops(q) or fn(q)
    return supports


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
    if q.streaming:
        if q.window is not None:
            return STREAM_WINDOW
        bad = sorted(set(q.op_names) - set(SEGSCAN_OPS))
        if bad:
            return (f"a streaming push scans each op with the segmented-scan "
                    f"kernel, which scans {list(SEGSCAN_OPS)}; {bad} need "
                    f"the reference backend")
        return None
    if q.window is not None and q.window.is_time:
        # both time strategies have kernels: replay frames run the swag
        # kernel, the two-stack the twostack_flip kernel — which strategy a
        # query may take is the planner's check
        if q.interpolate:
            return "cuda median is lower-median only (interpolate=False)"
        return None
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
    if q.window.is_time:
        return ("time-range windows re-frame by timestamp (no shared "
                "count-panes to sort once); use the cuda or reference "
                "backend")
    if q.streaming:
        return STREAM_WINDOW
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


def _event_time_limits(w) -> str | None:
    """What the event-time stream's kernels cannot hold: the reorder
    buffer's warp, the replay's row, the placement's shared memory.  The
    limits hold per shard: a sharded stream runs a warp a shard's buffer
    and places the merged emissions into one store of the same shape."""
    spec = w.store_spec()
    if w.reorder_capacity > MAX_REORDER_CAPACITY:
        return (f"the reorder kernel holds its buffer in one warp, at most "
                f"{MAX_REORDER_CAPACITY} slots; reorder_capacity="
                f"{w.reorder_capacity} needs the reference backend")
    if spec.runs * spec.wa > MAX_ROW:
        return (f"a time-mode replay row spans every slot: "
                f"next_pow2(capacity) * wa = {spec.runs} * {spec.wa} lanes "
                f"exceeds the replay kernel's {MAX_ROW}")
    need = time_scan_smem(spec.capacity, spec.wa)
    if need > SMEM_BUDGET:
        return (f"the time-mode placement keeps its directory in shared "
                f"memory: {need} bytes for capacity={spec.capacity}, "
                f"wa={spec.wa} exceed {SMEM_BUDGET}")
    return None


def _cuda_panestore_supports(q) -> str | None:
    w = q.window
    if w is not None and w.is_time:
        if not q.streaming:
            return ("the pane-store kernels serve per-group windows and "
                    "event-time streams (Query(streaming=True)); batch "
                    "time-range windows re-frame by timestamp — use the "
                    "cuda or reference backend")
        reason = _event_time_limits(w)
        if reason is not None:
            return reason
    elif w is None or not (w.per_group or q.streaming):
        return ("the pane-store kernel serves per-group windows "
                "(Window(ws_per_group=...)), streaming count windows and "
                "event-time streams only")
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
    Backend("cuda", _kernel_probe(_cuda_supports)),
    Backend("cuda-panes", _kernel_probe(_cuda_panes_supports)),
    Backend("cuda-panestore", _kernel_probe(_cuda_panestore_supports)),
)}


def register_backend(backend: Backend) -> None:
    """Extension point: plug a new engine under the fixed Query spec."""
    BACKENDS[backend.name] = backend


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


def resolve_backend(explicit: str | None = None) -> str:
    """The selection precedence: ``explicit``, else :data:`BACKEND_ENV`,
    else ``"auto"`` (which :func:`choose_backend` resolves a query).  Both
    sources are validated here, at plan time: an unknown explicit name and
    an unknown value of the variable each raise with the available
    backends, the latter naming the variable (it is set far from the
    call)."""
    if explicit is not None:
        if explicit != "auto":
            get_backend(explicit)  # validate early
        return explicit
    name = os.environ.get(BACKEND_ENV) or "auto"
    if name != "auto" and name not in BACKENDS:
        raise ValueError(
            f"{BACKEND_ENV}={name!r} names no registered backend "
            f"[available backends: "
            f"{', '.join(sorted(available_backends()))}]")
    return name


def _on_cpu(devices) -> bool:
    """Whether execution lands off the card: the first of ``devices`` (one
    device or a sequence, e.g. a mesh's) is not a CUDA device."""
    if devices is None:
        return not torch.cuda.is_available()
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = list(devices)
    return not devices or torch.device(devices[0]).type != "cuda"


def choose_backend(query, devices=None, num_shards: int = 1) -> str:
    """Resolve ``auto`` for one query: **measured-cost routing** over the
    backends whose probe accepts the query, with the static choice as
    fallback.

    Among the candidates, consult
    :data:`repro_torch.obs.registry.METRICS` for observed tuples/s at this
    query's fingerprint (``num_shards`` included) and pick the fastest,
    but only when **two or more** candidates have measured cells: one cell
    proves nothing about the others (on the CPU it would mostly be the
    reference's own telemetry re-electing itself).  Otherwise the static
    choice: the kernels on the card (the pane store for per-group and
    streaming windows, panes when the window shape allows), the reference
    on the CPU, where the kernel backends run their plain versions.

    ``devices`` (one device, or a sequence such as a mesh's) makes the
    probe answer for the devices the query runs on: CPU devices get
    ``reference``, CUDA devices the kernel backends (a sharded event-time
    stream within :func:`_event_time_limits`: ``cuda-panestore``)."""
    from repro_torch.obs.registry import METRICS, query_fingerprint
    candidates = [name for name in ("cuda-panestore", "cuda-panes", "cuda",
                                    "reference")
                  if BACKENDS[name].supports(query) is None]
    fp = query_fingerprint(query, num_shards=num_shards)
    measured = [name for name in candidates
                if METRICS.tuples_per_s(name, fp)]
    if len(measured) >= 2:
        best = METRICS.best_backend(fp, among=candidates)
        if best is not None:
            return best
    if _on_cpu(devices):
        return "reference"
    return candidates[0]
