"""PyTorch/CUDA port of the Enthuse streaming-aggregation engine.

The JAX package ``repro`` is the reference; this package computes the same
results with plain torch around hand-written CUDA kernels for Hopper
(``csrc/``).  It imports neither ``jax`` nor anything of ``repro``.
"""
