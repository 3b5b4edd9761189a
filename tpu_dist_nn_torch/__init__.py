"""PyTorch/CUDA port of :mod:`tpu_dist_nn` for NVIDIA Hopper (H100).

The layout mirrors the JAX package module for module. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; with no visible
GPU they raise instead of carrying on on the CPU. The kernels
(``kernels/``: the dense chains, the fused conv and flash attention)
are CUDA C++ written for ``sm_90a`` and built
from ``kernels/csrc`` at first use; each keeps a plain PyTorch version
beside it that runs for CPU tensors and is the reference the kernel is
held against on the card.

This package imports ``torch`` and numpy only: nothing of JAX and
nothing of :mod:`tpu_dist_nn`.
"""
