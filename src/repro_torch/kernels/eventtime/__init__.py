"""The event-time stream's reorder buffer on the card (no TPU kernel: it
replaces the JAX package's ``lax.scan`` of the reorder cycle)."""
