"""Kernels of the port: CUDA sources in ``csrc/``; wrappers and their
plain torch versions here."""
