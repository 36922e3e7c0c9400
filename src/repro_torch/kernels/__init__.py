"""Hopper kernels (CUDA C++ in ``repro_torch/csrc``) with their plain
PyTorch versions: a wrapper takes the plain version only for CPU tensors."""
