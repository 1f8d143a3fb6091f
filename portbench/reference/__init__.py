"""The plain reference of the benchmark: float32 PyTorch and NumPy only.

A frozen copy of the port's eager modules, without the CUDA kernel, the
multi-device branches and the port's wrappers. It imports nothing of the
port or of the JAX package, and takes nothing that the port computed: the
benchmark hands it the weights and inputs it drew, and it works out every
derived quantity (ActNorm statistics, spectral vectors, optimizer state)
again.
"""
