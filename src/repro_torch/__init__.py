"""PyTorch/CUDA port of the Enthuse streaming-aggregation engine.

The JAX package ``repro`` is the reference; this package computes the same
results with plain torch around hand-written CUDA kernels for Hopper
(``csrc/``).  Beside the engine it holds the serving path of the JAX
package's LLM stack (``configs``, ``models``, ``distributed.steps``,
``launch.serve``), whose MoE layers rank their sorted assignments with the
engine's segmented-scan kernel.  It imports neither ``jax`` nor anything
of ``repro``.
"""
