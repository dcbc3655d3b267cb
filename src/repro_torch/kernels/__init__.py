"""Attention kernels: CUDA wrappers and their plain PyTorch versions."""
