"""PyTorch port of the Mesh-Attention reproduction, for one NVIDIA H100.

The JAX package ``repro`` beside it is the reference.  This package imports
``torch`` and numpy and nothing of ``repro``; the modules mirror ``repro``'s
names (``repro_torch/kernels/ops.py`` <-> ``repro/kernels/ops.py`` ...).
Every Pallas kernel on a ported path is a CUDA kernel written by hand for
Hopper (``csrc/``), with its plain PyTorch version beside it.
"""
