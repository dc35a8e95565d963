"""Compute ops of the port: plain PyTorch versions, and the hand-written
Hopper kernels beside them (``csrc/``, built by ``_build``)."""

import os

import torch


def on_card(device):
    """The current device set to ``device`` for a launch through a ctypes
    library: the CUDA runtime launches a kernel, makes its tensor maps and
    sets its attributes in the current device's context, whatever stream
    it is given, so a kernel on another card than the current one (a
    replica of the split engine) must be launched from there."""
    return torch.cuda.device(device)


def kernels_disabled() -> bool:
    """``VQA_DISABLE_PALLAS``, the JAX package's process-wide kill switch
    (``vqa_attention_networks_tpu/config.py:157``), read at each call as
    every JAX dispatch reads it: when set, each kernel dispatch of the port
    takes the composed chain that the JAX dispatch takes instead."""
    return bool(os.environ.get("VQA_DISABLE_PALLAS"))


# the environment switches the ops read at each call to pick a kernel's
# route: the kill switch, K5 (``grid_fusion``), K7 (``attention``) and K2's
# composed chain (``grid_fusion``)
ROUTE_SWITCHES = ("VQA_DISABLE_PALLAS", "VQA_FORCE_PALLAS",
                  "VQA_PALLAS_GLIMPSE", "VQA_COMPOSED_TRAIN_FUSION")


def route_switches() -> tuple:
    """Whether each of ``ROUTE_SWITCHES`` is set, as the ops read it now:
    a forward captured once (``serve.BankGraph``) keeps the routes it was
    captured under, so it is stale when this changes."""
    return tuple(bool(os.environ.get(k)) for k in ROUTE_SWITCHES)
