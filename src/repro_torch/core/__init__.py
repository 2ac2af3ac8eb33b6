"""Plain torch layer of the port — the paper's streaming aggregation engine
(the JAX package's ``repro.core``, with the same public names).

Public surface:
  * combiners:  the function_select algebra (sum/min/max/count/mean/dc/...)
                and ``register_combiner``, its extension point
  * engine:     the 5-step group-by-aggregate over sorted streams
  * streaming:  the rolling multi-batch driver
  * sorter:     the bitonic network and a library-sort baseline
  * swag:       sliding-window aggregation, median included
  * panestore:  the shared, evicting per-group pane store
  * complexity: the paper's entity-count model

``Query`` / ``Window`` / ``AggResult`` / ``Plan`` / ``plan`` /
``execute`` / ``canonical_op`` of :mod:`repro_torch.query` are re-exported
here on first access.  As in the JAX package, ``swag`` and ``swag_median``
here are the (deprecated) functions, which hide the module of that name:
import the module's contents with ``from repro_torch.core.swag import
...``.
"""
from repro_torch.core.combiners import (  # noqa: F401
    ALL_OPS, PAPER_BASE_OPS, PAPER_DC_OPS, Combiner, get_combiner,
    register_combiner)
from repro_torch.core.engine import (  # noqa: F401
    GroupAggResult, PAD_GROUP, engine_step, group_by_aggregate,
    multi_aggregate, multi_engine_step, rr_ports)
from repro_torch.core.segscan import (  # noqa: F401
    Carry, exclusive_prefix_sum, init_carry, segment_ends, segment_starts,
    segmented_scan)
from repro_torch.core.sorter import (  # noqa: F401
    bitonic_merge, bitonic_sort, merge_presorted, next_pow2, sort_pairs,
    sort_pairs_xla)
from repro_torch.core.panestore import (  # noqa: F401
    PaneStoreSpec, PaneStoreState, init_store)
from repro_torch.core.streaming import (  # noqa: F401
    StreamingAggregator, StreamResult, stream_push)
from repro_torch.core.swag import (  # noqa: F401
    frame_panes, frame_windows, num_windows, pane_compatible, swag,
    swag_median, swag_multi, swag_panes, swag_per_group)
from repro_torch.core import complexity  # noqa: F401

_QUERY_NAMES = ("Query", "Window", "AggResult", "Plan", "plan", "execute",
                "canonical_op")


def __getattr__(name):
    # lazy re-export of the query API (repro_torch.query imports the core
    # modules; resolving these on first access keeps imports acyclic)
    if name in _QUERY_NAMES:
        from repro_torch import query
        return getattr(query, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
