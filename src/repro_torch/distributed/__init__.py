"""Multi-device execution of the port: the two-phase sharded pipeline
(:mod:`repro_torch.distributed.query_exec`)."""
from repro_torch.distributed import query_exec  # noqa: F401
