"""MFB fusion and glimpse-pool primitives (port of
``vqa_attention_networks_tpu/ops/fusion.py``), with the pooled-site
training fusion ``grid_fuse_pooled``.

The fusion axis is output-major: channel ``c = o*k + j`` of the o*k-wide
product pools into output ``o`` (the reference's permute + view). So a
tensor-parallel rank's block of F/M channels holds whole k-groups, and its
product, dropout (a ``layers.columns`` generator: its block of the one
process's mask), k-pool and signed sqrt are its block of the one
process's (``mfb_fuse_pool`` on a shard, ``parallel/tensor.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from vqa_attention_networks_tpu_torch.models.layers import (
    dropout,
    matmul_f32,
    signed_sqrt,
)
from vqa_attention_networks_tpu_torch.ops import kernels_disabled, pooled_fusion


def refactor_output_major(x: torch.Tensor, o: int, k: int,
                          o_pad: int) -> torch.Tensor:
    """[..., F=o*k] -> [..., k, o_pad]: split the output-major fusion axis
    onto its own k axis and zero-pad O. The layout contract of the stage-1
    kernel (``fusion.py:32-44``)."""
    x3 = x.reshape(*x.shape[:-1], o, k).transpose(-1, -2)
    return F.pad(x3, (0, o_pad - o))


def mfb_sumpool(z: torch.Tensor, k: int) -> torch.Tensor:
    """[..., o*k] -> [..., o]: sum over the k bilinear factors."""
    *lead, d = z.shape
    if d % k:
        raise ValueError(f"fusion dim {d} not divisible by factor {k}")
    return torch.sum(z.reshape(*lead, d // k, k), dim=-1)


def mfb_fuse_pool(a: torch.Tensor, b: torch.Tensor, k: int, *,
                  rate: float = 0.0, train: bool = False,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Hadamard -> dropout (training) -> k-sum-pool -> signed sqrt."""
    z = dropout(a * b, rate, train, generator)
    return signed_sqrt(mfb_sumpool(z, k))


def on_padded_columns(fuse: Callable[..., torch.Tensor], w: torch.Tensor,
                      b: torch.Tensor, q_proj: torch.Tensor,
                      k: int) -> torch.Tensor:
    """``fuse(w, b, q_proj)`` -> [..., O], with W [D, F], b [F] and q
    [N, F] zero-padded to a multiple of lcm(8, k) columns and the output
    trimmed to the O = F/k real outputs. K2 and K3 read rows of W as
    16-byte vectors and refuse F % 8 != 0, which a tensor-parallel shard
    of the 5000-wide fusion can be (2500 at M = 2, 1250 at M = 4). A padded
    column gives z = 0, so its output is signed_sqrt(0) = 0, its gradients
    are 0 (g_pooled's zero rule), and its mask bits are read by nothing.
    A no-op pad when F is already such a multiple."""
    f = w.shape[1]
    pad = -f % math.lcm(8, k)
    if not pad:
        return fuse(w, b, q_proj)
    out = fuse(F.pad(w, (0, pad)), F.pad(b, (0, pad)), F.pad(q_proj, (0, pad)))
    return out[..., :f // k]


def grid_fuse_weight_contracted(
    img: torch.Tensor,  # [N, L, D]
    w: torch.Tensor,  # [D, F] (JAX layout)
    b: torch.Tensor,  # [F]
    q_proj: torch.Tensor,  # [N, F]
    k: int,
) -> torch.Tensor:
    """The bf16 weight-contracted image-grid fusion (``fusion.py:73-124``):
    W, q and the per-sample contracted weights wq all round to bf16, the
    product accumulates in f32, the output is bf16 [N, L, O]."""
    n, _, d = img.shape
    o = w.shape[1] // k
    w3 = w.reshape(d, o, k).to(torch.bfloat16)
    q3 = q_proj.reshape(n, o, k)
    wq = torch.einsum(
        "dok,nok->ndo", w3.float(), q3.to(torch.bfloat16).float()
    ).to(torch.bfloat16)
    bq = torch.einsum("ok,nok->no", b.reshape(o, k).float(), q3.float())
    pooled = matmul_f32(img.to(torch.bfloat16), wq) + bq[:, None, :]
    return signed_sqrt(pooled).to(torch.bfloat16)


def grid_fuse_pooled(
    img: torch.Tensor,  # [N, L, D]
    w: torch.Tensor,  # [D, F] (JAX layout)
    b: torch.Tensor,  # [F]
    q_proj: torch.Tensor,  # [N, F]
    k: int,
    *,
    rate: float,
    generator: Optional[torch.Generator] = None,
    reference_kernel: bool = False,
) -> torch.Tensor:
    """The training fusion with its dropout on the pooled output
    (``fusion.py:127-200`` at ``train=True``; the eval forward takes
    ``grid_fuse``'s eval branches):
    ``dropout(signed_sqrt(k-pool((img@W + b) * q)))`` in img's dtype, the
    mask drawn from ``generator``.

    - bf16: K3 (``ops/pooled_fusion.pooled_grid_fuse``, the kernels on a
      CUDA tensor, the plain version on a CPU tensor or with
      ``reference_kernel=True``), whatever the rate; its f32 map is cast to
      bf16 before the dropout. On the card a width the kernels do not
      take (a tensor-parallel shard's) is zero-padded
      (``on_padded_columns``). Under ``VQA_DISABLE_PALLAS`` (read at each
      call, as the JAX gate ``pallas_pooled_fusion.py:527`` reads it) the
      composed chain runs instead: ``grid_fuse_weight_contracted``, then
      the dropout (``fusion.py:181-200``).
    - f32 and f64: the weight-contracted chain in img's dtype, with bq, the
      pooled map and its signed sqrt in f32, as the JAX function's
      ``preferred_element_type=f32`` gives them (at f64 too: the products
      run in f64 and round to f32); the output is cast back to img's dtype.
    """
    if img.dtype == torch.bfloat16:
        if kernels_disabled():
            fused = grid_fuse_weight_contracted(img, w, b, q_proj, k)
        elif reference_kernel:
            fused = pooled_fusion.pooled_grid_fuse_reference(
                img, w, b, q_proj, k).to(img.dtype)
        elif img.device.type == "cuda":
            fused = on_padded_columns(
                lambda w_, b_, q_: pooled_fusion.pooled_grid_fuse(
                    img, w_, b_, q_, k), w, b, q_proj, k).to(img.dtype)
        else:
            fused = pooled_fusion.pooled_grid_fuse(img, w, b, q_proj,
                                                   k).to(img.dtype)
        return dropout(fused, rate, True, generator)
    n, _, d = img.shape
    o = w.shape[1] // k
    dt = img.dtype
    w3 = w.reshape(d, o, k).to(dt)
    q3 = q_proj.reshape(n, o, k).to(dt)
    wq = torch.einsum("dok,nok->ndo", w3, q3)
    bq = torch.einsum("ok,nok->no", b.reshape(o, k).to(dt), q3).float()
    pooled = torch.matmul(img, wq).float() + bq[:, None, :]
    # the f32 map's signed sqrt, correctly rounded (through f64), as XLA
    # computes it: PyTorch's vectorised f32 sqrt on the CPU is an ulp off
    # on some elements
    fused = signed_sqrt(pooled.double()).float().to(dt)
    return dropout(fused, rate, True, generator)


def two_glimpse_pool(
    att_logits: torch.Tensor,  # [N, P, G]
    values: torch.Tensor,  # [N, P, D]
    *,
    uniform_quirk: bool,
) -> torch.Tensor:
    """Pool ``values`` under G glimpses -> [N, G*D] (glimpse-major). The
    softmax runs in the logits' dtype, the pool in the values' dtype with
    a ``promote_types(values.dtype, f32)`` accumulator: f32 for bf16 and
    f32 values, f64 for f64 values."""
    n, _, g = att_logits.shape
    d = values.shape[-1]
    if uniform_quirk:
        weights = torch.ones_like(att_logits)
    else:
        weights = torch.softmax(att_logits, dim=1)
    weights = weights.to(values.dtype).transpose(1, 2)  # [N, G, P]
    acc = torch.promote_types(values.dtype, torch.float32)
    pooled = torch.matmul(weights.to(acc), values.to(acc))
    return pooled.reshape(n, g * d).to(values.dtype)
