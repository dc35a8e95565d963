"""``grid_fuse`` (port of ``vqa_attention_networks_tpu/ops/pallas_fusion.py``),
with the inference fusion kernel K5.

Every kernel branch below reads ``VQA_DISABLE_PALLAS`` at each call
(``ops.kernels_disabled``), as the JAX gates ``pallas_fusion.py:190`` and
``pallas_train_fusion.py:354`` do: with it set, the composed chain runs in
place of K5 and K2. K2's branch also reads ``VQA_COMPOSED_TRAIN_FUSION``
(``pallas_train_fusion.py:356``), which forces the composed chain too.

Inference:

- f32: ``grid_fuse_reference`` — (img @ W + b) * q, k-pool, signed sqrt,
  all in full f32.
- bf16: the weight-contracted formulation (``ops/fusion.py``), unless
  ``VQA_FORCE_PALLAS`` is set (read at each call, as
  ``pallas_fusion.py:267`` reads it). With it set, K5 computes the full
  fusion, f32 [N, L, O], through the custom op ``torch.ops.vqa.
  inference_fusion``, which dispatches by device: on a CUDA tensor the
  hand-written kernel (the K2 forward kernel with its mask compiled out,
  ``csrc/train_fusion.cu`` ``train_fusion_inference_forward``), on a CPU
  tensor its plain version ``grid_fuse_reference``. The op's fake
  implementation gives its output's shape, so ``torch.export`` keeps the
  call as one node. The operands are those of
  ``_grid_fuse_pallas`` (``pallas_fusion.py:106-108``): W rounded to img's
  dtype, b and q exact in f32. The JAX gates ``n % 4`` and ``F % k`` of
  the TPU kernel's blocks do not apply: the port's K5 masks its edges.
  K5 has no autograd path: no caller differentiates the eval forward.

Training at ``site="prepool"`` (``pallas_fusion.py:237-260``), with the
dropout mask on the pre-pool product:

- bf16 with ``rate > 0``: K2 (``ops/train_fusion.train_grid_fuse``), the
  kernels on a CUDA tensor and their plain version on a CPU tensor. (The
  JAX dispatch takes the composed chain on the CPU; both compute the same
  function.) Under a ``layers.GlobalRows`` generator (a rank's slice of
  a data-parallel batch, or its column block of a tensor-parallel
  fusion) K2 draws its mask at the rows' and columns' global indices
  (``row0``, ``col0``, ``f_total``). On the card a shard's width that K2
  does not take (F % 8 != 0) is zero-padded to one it does
  (``ops/fusion.on_padded_columns``), never sent to the composed chain.
- otherwise, or under either switch: the composed chain with its dropout
  from ``generator``.

Training at ``site="pooled"`` (``pallas_fusion.py:230-236``), with the
dropout mask on the pooled output, drawn from ``generator``:
``ops/fusion.grid_fuse_pooled``, which at bf16 runs K3
(``ops/pooled_fusion.py``) whatever the rate and returns bf16.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from vqa_attention_networks_tpu_torch.models.layers import (
    Generator,
    dropout,
    first_column,
    first_row,
    signed_sqrt,
)
from vqa_attention_networks_tpu_torch.ops import (
    kernels_disabled,
    on_card,
    train_fusion,
)
from vqa_attention_networks_tpu_torch.ops.fusion import (
    grid_fuse_pooled,
    grid_fuse_weight_contracted,
    mfb_sumpool,
    on_padded_columns,
)

# K5 launches made by grid_fuse (one per call on a CUDA tensor)
launch_count = 0


def grid_fuse_reference(img: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        q_proj: torch.Tensor, k: int, *, rate: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        ) -> torch.Tensor:
    """The composed oracle and K5's plain version: f32 accumulation, output
    in f32 (or wider); with ``rate > 0`` the pre-pool product takes its
    dropout."""
    acc = torch.promote_types(img.dtype, torch.float32)
    z = torch.matmul(img.to(acc), w.to(img.dtype).to(acc))
    z = (z + b.to(acc)) * q_proj[:, None, :].to(acc)
    z = dropout(z, rate, True, generator)
    return signed_sqrt(mfb_sumpool(z, k))


def inference_fusion_cuda(img: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor, q_proj: torch.Tensor,
                          k: int) -> torch.Tensor:
    """Launch K5 -> f32 [N, L, O]. Raises on an input it does not take and
    on a refused launch."""
    global launch_count
    w_bf16, bf, qf = train_fusion.operands(w, b, q_proj)
    train_fusion.check_inputs(img, w_bf16, bf, qf, k, 0.0)
    n, l, d = img.shape
    f = w_bf16.shape[1]
    out = torch.empty(n, l, f // k, dtype=torch.float32, device=img.device)
    lib = train_fusion.library()
    with on_card(img.device):
        rc = lib.train_fusion_inference_forward(
            img.data_ptr(), w_bf16.data_ptr(), bf.data_ptr(), qf.data_ptr(),
            out.data_ptr(), n, l, d, f, k,
            torch.cuda.current_stream(img.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"train_fusion inference_forward launch failed: CUDA error {rc} "
            f"({lib.train_fusion_error_string(rc).decode()})")
    launch_count += 1
    return out


@torch.library.custom_op("vqa::inference_fusion", mutates_args=(),
                         device_types="cpu")
def inference_fusion_op(img: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        q_proj: torch.Tensor, k: int) -> torch.Tensor:
    """K5 as an op; on a CPU tensor, the plain version."""
    return grid_fuse_reference(img, w, b, q_proj, k)


@inference_fusion_op.register_kernel("cuda")
def _inference_fusion_on_the_card(img, w, b, q_proj, k):
    return inference_fusion_cuda(img, w, b, q_proj, k)


@inference_fusion_op.register_fake
def _inference_fusion_shape(img, w, b, q_proj, k):
    n, l, _ = img.shape
    return img.new_empty((n, l, w.shape[1] // k),
                         dtype=torch.promote_types(img.dtype, torch.float32))


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
    generator: Optional[Generator] = None,
    reference_kernel: bool = False,
) -> torch.Tensor:
    """Eval: at bf16 K5 under ``VQA_FORCE_PALLAS`` and the weight-contracted
    formulation without it, the composed chain else. Training at
    ``site="prepool"``: K2 at bf16 with ``rate > 0`` (its mask from
    ``seed``), the composed chain with dropout from ``generator`` else; at
    ``site="pooled"``: ``grid_fuse_pooled`` (K3 at bf16). Under
    ``VQA_DISABLE_PALLAS`` no kernel runs (see the module's docstring).
    ``reference_kernel=True`` runs K5's, K2's or K3's plain version in place
    of the kernels on any device, for the comparisons of the tests and
    ``chip_smoke.py`` only."""
    if not train:
        if img.dtype != torch.bfloat16:
            return grid_fuse_reference(img, w, b, q_proj, k)
        if not os.environ.get("VQA_FORCE_PALLAS"):
            return grid_fuse_weight_contracted(img, w, b, q_proj, k)
        if kernels_disabled() or reference_kernel:
            return grid_fuse_reference(img, w, b, q_proj, k)
        return inference_fusion_op(img, w, b, q_proj, k)
    if site == "pooled":
        return grid_fuse_pooled(img, w, b, q_proj, k, rate=rate,
                                generator=generator,
                                reference_kernel=reference_kernel)
    if img.dtype == torch.bfloat16 and rate > 0 and not kernels_disabled() \
            and not os.environ.get("VQA_COMPOSED_TRAIN_FUSION"):
        if seed is None:
            raise ValueError("the K2 training fusion needs a mask seed")
        # a rank's block of a data- or tensor-parallel fusion draws K2's
        # mask at its rows' and columns' global indices (layers.GlobalRows)
        place = (first_row(generator), *first_column(generator, w.shape[1]))
        if reference_kernel:
            return train_fusion.train_grid_fuse_reference(
                img, w, b, q_proj, seed, k, rate, *place)
        if img.device.type == "cuda":
            return on_padded_columns(
                lambda w_, b_, q_: train_fusion.train_grid_fuse(
                    img, w_, b_, q_, seed, k, rate, *place), w, b, q_proj, k)
        return train_fusion.train_grid_fuse(img, w, b, q_proj, seed, k, rate,
                                            *place)
    return grid_fuse_reference(img, w, b, q_proj, k, rate=rate,
                               generator=generator)
