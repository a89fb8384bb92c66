"""Ops: plain PyTorch layers (``nn``) and the hand-written CUDA kernel
(``fused_dense``, built by ``_build`` from ``csrc/``)."""
