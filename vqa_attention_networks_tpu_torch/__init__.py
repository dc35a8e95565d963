"""vqa_attention_networks_tpu_torch — the PyTorch / CUDA port of the VQA
framework, for one NVIDIA Hopper card (sm_90a).

The JAX package ``vqa_attention_networks_tpu`` is the reference: every
module here names the JAX function it ports, and ``tests/test_torch_port_*``
hold each against it on the same weights and inputs. The framework-free
modules of the JAX package (``config``, ``data/text``, ``data/feature_store``,
``data/prepare``, ``data/dataset``, ``utils/torch_import``) are imported as
they are, not ported twice.

This package imports ``torch`` and never ``jax``.

Slices ported so far, on one device: bf16 ``mhb_coAtt`` serving, with the
stage-1 fusion + co-attention kernel hand-written in CUDA
(``csrc/stage1_coattention.cu``); and ``mhb_coAtt`` training through
``train/solver.py``, with the training fusion's forward and backward
hand-written in CUDA (``csrc/train_fusion.cu``).
"""

__version__ = "0.1.0"

from vqa_attention_networks_tpu.config import Config  # noqa: F401
