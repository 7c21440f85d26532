"""bsalign-tpu on PyTorch and CUDA: the port of `bsalign_tpu` to one NVIDIA
H100.

Modules keep the JAX package's names and layout. The banded 8-bit DP and
the bit-parallel edit DP run in hand-written CUDA kernels (csrc/banded8.cu,
csrc/edit.cu) on a CUDA device and in their plain PyTorch versions
(ops/banded8.py, ops/edit.py) on the CPU. This package never imports jax
or bsalign_tpu, and reads no file of it.
"""
