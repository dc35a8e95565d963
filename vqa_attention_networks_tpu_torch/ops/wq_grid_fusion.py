"""Standalone weight-contracted grid fusion + grid-flat L2 (port of
``_wq_grid_fuse_pallas`` and its custom-VJP entry ``_wq_grid_fuse_tpu``,
``vqa_attention_networks_tpu/ops/pallas_wq_fusion.py:88,447-465``), kernel
K6.

Per sample, with F = O*k and channel c = o*k + j:

    wq[d, o] = sum_j bf16(W)[d, c] * bf16(q)[c]     f32, j in order; -> bf16
    bq[o]    = sum_j b[c] * bf16(q)[c]              f32, j in order
    z        = signed_sqrt(img @ bf16(wq) + bq)     [L, O] f32 accumulation
    out      = bf16(z * (1 / max(||z||, eps)))      (norm over the whole grid)

z is K3's forward (``ops/pooled_fusion.py``): the same operands (W and q
rounded to bf16 for wq and bq alike, b f32; K1 keeps W in f32) and the
same rounding points (``pallas_wq_fusion.py:56-85,107-111``). So K6 runs
K3's forward kernel in an instantiation whose epilogue also writes each
sample's sum of squares per 64-output tile, then one launch that adds
them and scales (``pooled_fusion_wq_grid`` in ``csrc/pooled_fusion.cu``),
and its plain version is K3's plain forward and the norm. The TPU kernel
pads O to a multiple of 128; the padded columns are exactly 0, add 0 to
the norm and are sliced off, so neither version here pads.

- ``wq_grid_fuse`` is the entry, an ``autograd.Function``: its forward is
  the kernel on a CUDA tensor, the plain version on a CPU tensor; its
  backward is the VJP of ``composed_reference`` on the saved inputs, with
  the cotangent cast to img's dtype first (``pallas_wq_fusion.py:456-462``).
  Nothing catches an error to fall back.
- ``composed_reference`` is the differentiable composed chain
  (``_composed_reference`` :432-444), which ``ops/fusion``'s
  ``grid_fuse_weight_contracted`` is not (einsum order, an f32 q in bq, no
  L2).
- ``launch_count`` counts the kernel's calls.

No model of the JAX package dispatches K6 (``pallas_wq_fusion.py:763-766``),
and none of the port does.
"""

from __future__ import annotations

import torch

from vqa_attention_networks_tpu_torch.models.layers import (
    l2_normalize,
    signed_sqrt,
)
from vqa_attention_networks_tpu_torch.ops import on_card
from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf
from vqa_attention_networks_tpu_torch.ops.fusion import mfb_sumpool

_REFERENCE_CHUNK = 64  # samples per step of the plain version (memory)

# kernel calls made by wq_grid_fuse (one per call on a CUDA tensor)
launch_count = 0


def wq_grid_fuse_reference(img: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, q_proj: torch.Tensor, k: int,
                           eps: float = 1e-12) -> torch.Tensor:
    """The plain PyTorch version of K6 -> bf16 [N, L, O], on any device."""
    w_bf16, bf, qb = pf.operands(w, b, q_proj)
    outs = []
    for s in range(0, img.shape[0], _REFERENCE_CHUNK):
        z = pf.forward_reference(img[s:s + _REFERENCE_CHUNK].detach(),
                                 w_bf16, bf, qb[s:s + _REFERENCE_CHUNK], k)
        norm = torch.sqrt(torch.sum(z * z, dim=(1, 2), keepdim=True))
        outs.append((z * (1.0 / torch.clamp_min(norm, eps)))
                    .to(torch.bfloat16))
    return torch.cat(outs)


def composed_reference(img: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       q_proj: torch.Tensor, k: int,
                       eps: float = 1e-12) -> torch.Tensor:
    """The composed, differentiable twin -> [N, L, O] in img's dtype: the
    product in img's dtype with a promote_types(img.dtype, f32)
    accumulator, (z + b) * q, the k-pool, the signed sqrt and the grid-flat
    L2 in that accumulator's type."""
    acc = torch.promote_types(img.dtype, torch.float32)
    z = torch.matmul(img.to(acc), w.to(img.dtype).to(acc))
    z = (z + b.to(acc)) * q_proj[:, None, :].to(acc)
    z = signed_sqrt(mfb_sumpool(z, k))
    n = img.shape[0]
    return l2_normalize(z.reshape(n, -1), eps=eps).reshape(z.shape).to(
        img.dtype)


def wq_grid_fuse_cuda(img: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      q_proj: torch.Tensor, k: int,
                      eps: float = 1e-12) -> torch.Tensor:
    """Launch the hand-written kernels -> bf16 [N, L, O]. Raises on an input
    they do not take and on a refused launch."""
    global launch_count
    w_bf16, bf, qb = pf.operands(w, b, q_proj)
    pf.check_inputs(img, w_bf16, bf, qb, k)
    n, l, d = img.shape
    f = w_bf16.shape[1]
    o = f // k
    dev = img.device
    lib = pf.library()
    # scratch: z, and each sample's sums of squares, one per O tile
    z = torch.empty(n, l, o, dtype=torch.float32, device=dev)
    ssq = torch.empty(n, -(-o // lib.pooled_fusion_o_tile()),
                      dtype=torch.float32, device=dev)
    out = torch.empty(n, l, o, dtype=torch.bfloat16, device=dev)
    with on_card(dev):
        rc = lib.pooled_fusion_wq_grid(
            img.data_ptr(), w_bf16.data_ptr(), bf.data_ptr(), qb.data_ptr(),
            z.data_ptr(), ssq.data_ptr(), out.data_ptr(), n, l, d, f, k,
            eps, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"pooled_fusion_wq_grid launch failed: CUDA error {rc} "
            f"({lib.pooled_fusion_error_string(rc).decode()})")
    launch_count += 1
    return out


class WqGridFuse(torch.autograd.Function):
    """K6's forward (the kernel on a CUDA tensor, the plain version on a CPU
    tensor); the backward is the composed chain's VJP."""

    @staticmethod
    def forward(ctx, img, w, b, q_proj, k):
        ctx.save_for_backward(img, w, b, q_proj)
        ctx.k = k
        if img.device.type == "cpu":
            return wq_grid_fuse_reference(img, w, b, q_proj, k)
        return wq_grid_fuse_cuda(img.contiguous(), w, b, q_proj, k)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        wanted = [i for i in range(4) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(i in wanted)
                      for i, t in enumerate(saved)]
            out = composed_reference(*inputs, ctx.k)
            grads = torch.autograd.grad(out, [inputs[i] for i in wanted],
                                        g.to(saved[0].dtype))
        result = [None] * 5
        for i, grad in zip(wanted, grads):
            result[i] = grad
        return tuple(result)


def wq_grid_fuse(img: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 q_proj: torch.Tensor, k: int) -> torch.Tensor:
    """The entry (``_wq_grid_fuse_tpu``) -> bf16 [N, L, O], differentiable in
    img, W, b and q."""
    return WqGridFuse.apply(img, w, b, q_proj, k)
