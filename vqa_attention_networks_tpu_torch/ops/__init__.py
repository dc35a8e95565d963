"""Compute ops of the port: plain PyTorch versions, and the hand-written
Hopper kernels beside them (``csrc/``, built by ``_build``)."""
