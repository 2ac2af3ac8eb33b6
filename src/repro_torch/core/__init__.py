"""Plain torch layer of the port: combiners, scans, sorters, engine, SWAG,
and the streaming step."""
from repro_torch.core.engine import rr_ports  # noqa: F401
from repro_torch.core.streaming import (  # noqa: F401
    StreamingAggregator, StreamResult, stream_push)
