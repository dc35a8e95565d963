"""Compute ops of the port: plain PyTorch versions, and the hand-written
Hopper kernels beside them (``csrc/``, built by ``_build``)."""

import os


def kernels_disabled() -> bool:
    """``VQA_DISABLE_PALLAS``, the JAX package's process-wide kill switch
    (``vqa_attention_networks_tpu/config.py:157``), read at each call as
    every JAX dispatch reads it: when set, each kernel dispatch of the port
    takes the composed chain that the JAX dispatch takes instead."""
    return bool(os.environ.get("VQA_DISABLE_PALLAS"))
