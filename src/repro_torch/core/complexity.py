"""The paper's entity-count complexity model (Section III, last paragraph),
the port's own copy of ``repro.core.complexity``.

Abstracting node complexity to 1 for butterfly switches and all other
entities:

    PRRA(P)              = 2*P*log2(P) - P + 1          (scan + butterfly)
    fused engine         = 2*P + PRRA(P)
                         = 2*P*log2(P) + P + 1          (the paper's closed form)
    modular pipeline     = 3*P + 2*PRRA(P)              (Fig. 1: two PRRAs + glue)
"""
from __future__ import annotations

import math


def prra_entities(p: int) -> int:
    _check(p)
    return 2 * p * int(math.log2(p)) - p + 1


def engine_entities(p: int) -> int:
    """Fused group-by-aggregate engine: 2P + PRRA = 2P log2 P + P + 1."""
    _check(p)
    return 2 * p * int(math.log2(p)) + p + 1


def modular_entities(p: int) -> int:
    """Modular pipeline of Fig. 1: 3P + 2 x PRRA."""
    _check(p)
    return 3 * p + 2 * prra_entities(p)


def reduction_ratio(p: int) -> float:
    """modular / fused — the paper's headline hardware saving."""
    return modular_entities(p) / engine_entities(p)


def _check(p: int) -> None:
    if p < 2 or (p & (p - 1)):
        raise ValueError(f"P must be a power of two >= 2, got {p}")
