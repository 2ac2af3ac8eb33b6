"""Exporters: engine stats and registry snapshots as JSONL or Prometheus
text exposition format (the counterpart of ``repro.obs.export``; the same
text for the same registry and stats).

JSONL: one JSON object per line, append-friendly::

    {"name": "query/fused_multi3", "engine_stats": {"tuples": 65536, ...}}

Prometheus: the text format scrape endpoints serve::

    # TYPE repro_observed_tuples_per_s gauge
    repro_observed_tuples_per_s{backend="reference",plan="ops=sum;..."} 3.1e6
    # TYPE repro_engine_stat gauge
    repro_engine_stat{name="pane_evictions"} 12

Stats tensors may lie on the card or on the CPU; exporting one reads it
back to the host.
"""
from __future__ import annotations

import json
import math
import pathlib
from typing import Iterable, Optional

import numpy as np
import torch


def to_jsonable(value):
    """Recursively convert tensors / arrays / numpy scalars to plain JSON
    values."""
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        return value if math.isfinite(value) else repr(value)
    if isinstance(value, dict):
        return {str(k): to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [to_jsonable(v) for v in value]
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    arr = np.asarray(value)
    if arr.ndim == 0:
        return to_jsonable(arr.item())
    return [to_jsonable(v) for v in arr.tolist()]


def dumps_jsonl(records: Iterable[dict]) -> str:
    """Serialize records as JSON Lines (one compact object per line)."""
    lines = [json.dumps(to_jsonable(r), sort_keys=True) for r in records]
    return "\n".join(lines) + ("\n" if lines else "")


def write_jsonl(records: Iterable[dict], path) -> pathlib.Path:
    path = pathlib.Path(path)
    path.write_text(dumps_jsonl(records))
    return path


def read_jsonl(path) -> list:
    return [json.loads(line)
            for line in pathlib.Path(path).read_text().splitlines()
            if line.strip()]


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_number(value) -> str:
    v = float(value)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def prometheus_metrics(registry=None, stats: Optional[dict] = None,
                       prefix: str = "repro") -> str:
    """Render a registry snapshot and/or one engine-stats dict as
    Prometheus text exposition format.

    ``registry`` defaults to the process-wide
    :data:`repro_torch.obs.registry.METRICS`; pass ``stats`` (an
    ``AggResult.stats`` dict) to export per-run counters.  1-D counter
    tensors get a ``round`` label per element.
    """
    if registry is None:
        from repro_torch.obs.registry import METRICS as registry
    lines = []

    snap = registry.snapshot() if registry is not None else {}
    if snap:
        name = f"{prefix}_observed_tuples_per_s"
        lines.append(f"# HELP {name} Observed engine throughput per "
                     f"(backend, plan fingerprint).")
        lines.append(f"# TYPE {name} gauge")
        for (backend, fp), cell in sorted(snap.items()):
            labels = (f'backend="{_escape_label(backend)}",'
                      f'plan="{_escape_label(fp)}"')
            lines.append(f"{name}{{{labels}}} "
                         f"{_prom_number(cell['tuples_per_s'])}")

    if stats:
        name = f"{prefix}_engine_stat"
        lines.append(f"# HELP {name} Per-run engine counters "
                     f"(collect_stats=True).")
        lines.append(f"# TYPE {name} gauge")
        for stat, value in sorted(stats.items()):
            value = to_jsonable(value)
            if isinstance(value, list):
                for i, v in enumerate(value):
                    lines.append(f'{name}{{name="{_escape_label(stat)}",'
                                 f'round="{i}"}} {_prom_number(v)}')
            else:
                lines.append(f'{name}{{name="{_escape_label(stat)}"}} '
                             f"{_prom_number(value)}")

    return "\n".join(lines) + ("\n" if lines else "")
