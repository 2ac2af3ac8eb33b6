"""LM model stack of the port for the assigned architectures (the JAX
package's ``repro.models``): blocks are ``nn.Module``s holding their
parameters under the JAX package's names, the math plain functions on
tensors; ``model.py`` assembles the blocks of a config's layer plan.
"""
