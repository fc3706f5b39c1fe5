"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (see ``_build`` for how the CUDA sources are compiled and bound)."""
