"""``grid_fuse`` (port of ``vqa_attention_networks_tpu/ops/pallas_fusion.py``).

Inference:

- f32: ``_grid_fuse_reference`` — (img @ W + b) * q, k-pool, signed sqrt,
  all in full f32.
- bf16: the weight-contracted formulation (``ops/fusion.py``), which is what
  the JAX dispatcher runs at bf16 unless ``VQA_FORCE_PALLAS`` is set.

Training at ``site="prepool"`` (``pallas_fusion.py:237-260``), with the
dropout mask on the pre-pool product:

- bf16 with ``rate > 0``: K2 (``ops/train_fusion.train_grid_fuse``), the
  kernels on a CUDA tensor and their plain version on a CPU tensor. (The
  JAX dispatch takes the composed chain on the CPU; both compute the same
  function.)
- otherwise: the composed chain with its dropout.

``site="pooled"`` (K3) and the full-width inference kernel (K5,
``_grid_fuse_pallas``) wait for later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from vqa_attention_networks_tpu_torch.models.layers import (
    dropout,
    signed_sqrt,
)
from vqa_attention_networks_tpu_torch.ops import train_fusion
from vqa_attention_networks_tpu_torch.ops.fusion import (
    grid_fuse_weight_contracted,
    mfb_sumpool,
)


def grid_fuse_reference(img: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        q_proj: torch.Tensor, k: int, *, rate: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        ) -> torch.Tensor:
    """The composed oracle: f32 accumulation, output in f32 (or wider);
    with ``rate > 0`` the pre-pool product takes its dropout."""
    acc = torch.promote_types(img.dtype, torch.float32)
    z = torch.matmul(img.to(acc), w.to(img.dtype).to(acc))
    z = (z + b.to(acc)) * q_proj[:, None, :].to(acc)
    z = dropout(z, rate, True, generator)
    return signed_sqrt(mfb_sumpool(z, k))


def grid_fuse(
    img: torch.Tensor,  # [N, L, D]
    w: torch.Tensor,  # [D, F] (JAX layout)
    b: torch.Tensor,  # [F]
    q_proj: torch.Tensor,  # [N, F]
    k: int,
    *,
    train: bool = False,
    rate: float = 0.0,
    site: str = "prepool",
    seed: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    reference_kernel: bool = False,
) -> torch.Tensor:
    """Eval: weight-contracted at bf16, the composed chain else. Training:
    K2 at bf16 with ``rate > 0`` (its mask from ``seed``), the composed
    chain with dropout from ``generator`` else. ``reference_kernel=True``
    runs K2's plain version in place of the kernels on any device, for the
    comparisons of the tests and ``chip_smoke.py`` only."""
    if not train:
        if img.dtype == torch.bfloat16:
            return grid_fuse_weight_contracted(img, w, b, q_proj, k)
        return grid_fuse_reference(img, w, b, q_proj, k)
    if site == "pooled":
        raise NotImplementedError(
            "dropout_site='pooled' training (kernel K3) is not ported yet: "
            "ROADMAP Queue 1 item 8")
    if img.dtype == torch.bfloat16 and rate > 0:
        if seed is None:
            raise ValueError("the K2 training fusion needs a mask seed")
        if reference_kernel:
            return train_fusion.train_grid_fuse_reference(
                img, w, b, q_proj, seed, k, rate)
        return train_fusion.train_grid_fuse(img, w, b, q_proj, seed, k, rate)
    return grid_fuse_reference(img, w, b, q_proj, k, rate=rate,
                               generator=generator)
