"""PyTorch/CUDA port of the GRAU system (the JAX package `repro` is the
reference it is held against). Imports torch, numpy and the standard library
only; the CUDA kernels under csrc/ build on first use (kernels/build.py)."""
