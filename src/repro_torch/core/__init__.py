"""Plain torch layer of the port: combiners, scans, sorters, engine, SWAG,
the streaming step and the complexity model.  The deprecated shims
``group_by_aggregate`` and ``multi_aggregate`` are exported here, as the
JAX package exports them; ``swag`` and ``swag_median`` stay in
:mod:`repro_torch.core.swag` (here their names would hide the module)."""
from repro_torch.core.engine import (  # noqa: F401
    GroupAggResult, group_by_aggregate, multi_aggregate, rr_ports)
from repro_torch.core.streaming import (  # noqa: F401
    StreamingAggregator, StreamResult, stream_push)
from repro_torch.core import complexity  # noqa: F401
