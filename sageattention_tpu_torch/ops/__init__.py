"""Kernels (CUDA wrappers with their plain PyTorch versions) and the
reference attention."""
