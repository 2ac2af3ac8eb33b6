"""Data helpers of the port: per-domain statistics through the engine."""
from repro_torch.data.stats import domain_stats  # noqa: F401
