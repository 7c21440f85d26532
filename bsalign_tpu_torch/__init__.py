"""bsalign-tpu on PyTorch and CUDA: the port of `bsalign_tpu` to one NVIDIA
H100.

Modules keep the JAX package's names and layout. The banded 8-bit DP runs
in a hand-written CUDA kernel (csrc/banded8.cu) on a CUDA device and in
its plain PyTorch version (ops/banded8.py) on the CPU. This package never
imports jax or bsalign_tpu.
"""
