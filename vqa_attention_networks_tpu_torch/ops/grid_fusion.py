"""Inference branches of ``grid_fuse`` (port of
``vqa_attention_networks_tpu/ops/pallas_fusion.py``).

- f32: ``_grid_fuse_reference`` — (img @ W + b) * q, k-pool, signed sqrt,
  all in full f32.
- bf16: the weight-contracted formulation (``ops/fusion.py``), which is what
  the JAX dispatcher runs at bf16 unless ``VQA_FORCE_PALLAS`` is set.

The full-width fusion kernel (K5, ``_grid_fuse_pallas``) and the training
branches wait for later slices.
"""

from __future__ import annotations

import torch

from vqa_attention_networks_tpu_torch.models.layers import signed_sqrt
from vqa_attention_networks_tpu_torch.ops.fusion import (
    grid_fuse_weight_contracted,
    mfb_sumpool,
)


def grid_fuse_reference(img: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        q_proj: torch.Tensor, k: int) -> torch.Tensor:
    """The composed oracle: f32 accumulation, output in f32 (or wider)."""
    acc = torch.promote_types(img.dtype, torch.float32)
    z = torch.matmul(img.to(acc), w.to(img.dtype).to(acc))
    z = (z + b.to(acc)) * q_proj[:, None, :].to(acc)
    return signed_sqrt(mfb_sumpool(z, k))


def grid_fuse(
    img: torch.Tensor,  # [N, L, D]
    w: torch.Tensor,  # [D, F] (JAX layout)
    b: torch.Tensor,  # [F]
    q_proj: torch.Tensor,  # [N, F]
    k: int,
) -> torch.Tensor:
    """Eval dispatch: weight-contracted at bf16, the composed chain else."""
    if img.dtype == torch.bfloat16:
        return grid_fuse_weight_contracted(img, w, b, q_proj, k)
    return grid_fuse_reference(img, w, b, q_proj, k)
