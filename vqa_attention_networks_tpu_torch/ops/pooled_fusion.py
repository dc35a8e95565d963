"""Pooled-site training grid fusion (port of
``vqa_attention_networks_tpu/ops/pallas_pooled_fusion.py``), kernel K3.

``Config.dropout_site="pooled"`` puts the dropout mask after the k-pool and
the signed sqrt, so the chain up to the mask is the weight-contracted
fusion: q contracts into W first. With F = O*k and channel c = o*k + j:

    wq[n,d,o] = sum_j f32(W[d,c]) * f32(q[n,c])     f32, j in order; -> bf16
    bq[n,o]   = sum_j b[c] * f32(q[n,c])            f32, j in order
    pooled    = bf16(img)[n] @ bf16(wq)[n]  (f32 accumulate) + bq[n]
    out       = sqrt(relu(pooled)) - sqrt(relu(-pooled))      [N, L, O] f32

The backward takes g = d out:

    g_pooled  = g * where(out == 0, 0, 0.5 / max(|out|, 1e-20))
    d_img     = bf16(g_pooled) @ bf16(wq)^T                  f32
    d_wq[n]   = bf16(img[n])^T @ bf16(g_pooled[n])           f32 [N, D, O]
    d_bq[n,o] = sum_l g_pooled[n,l,o]                        f32
    d_W[d,c]  = sum_n d_wq[n,d,o] * f32(q[n,c])
    d_b[c]    = sum_n d_bq[n,o] * f32(q[n,c])
    d_q[n,c]  = sum_d d_wq[n,d,o] * f32(W[d,c]) + d_bq[n,o] * b[c]

W and q round to bf16 (the TPU wrapper casts both to img's dtype), b stays
f32 (``pallas_pooled_fusion.py:97-181``, ``_prep`` :188-202). The zero
branch of g_pooled is the composed chain's gradient at pooled == 0
(relu'(0) = 0). The gradients leave in their inputs' dtypes
(``_pooled_bwd`` :493-499): d_img in img's, d_W and d_b in the parameters',
d_q in q's.

On the card the backward forms g_pooled once, as the bf16 operand gp
[N, L, O8] (O padded to a multiple of 8 with zeros) and the f32 d_bq
[N, O], in ``g_pooled_cuda``; ``d_img_from_gp_cuda`` and
``d_w_from_gp_cuda`` read them. ``d_img_cuda`` and ``d_w_cuda`` are the
build followed by the product. The plain versions are
``g_pooled_reference`` and ``d_img_from_gp_reference``; ``d_img_reference``
and ``d_w_reference`` take g and out.

- ``pooled_grid_fuse`` dispatches: a CPU tensor goes to the plain version,
  a CUDA tensor to the kernels (``csrc/pooled_fusion.cu``), which raise on
  an input they do not take. Nothing catches an error to fall back.
- ``pooled_grid_fuse_reference`` is the plain version: PyTorch ops with the
  rounding points above, as an ``autograd.Function``.
- ``launch_count`` counts the kernel launches, by kernel.

The library also carries K6 (``ops/wq_grid_fusion.py``), whose first
launch is this forward kernel; ``check_inputs`` serves both.

The SPMD wrappers of the TPU module (``custom_partitioning``) are not
ported: multi-GPU is a later item.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from vqa_attention_networks_tpu_torch.models.layers import signed_sqrt
from vqa_attention_networks_tpu_torch.ops import on_card

_MAX_K = 7  # the d_W kernel keeps k accumulators per (d, o) in shared memory
_MAX_ROWS = 208  # L rows a kernel holds (wgmma N; d_img's 13 tiles)
_D_TILE = 64  # D rows per d_W block: d_q's partial sums per D tile

# kernel launches made by PooledGridFuse, by kernel
launch_count: Dict[str, int] = {"forward": 0, "g_pooled": 0, "d_img": 0,
                                "d_w": 0}


def operands(w: torch.Tensor, b: torch.Tensor, q: torch.Tensor):
    """The kernels' operands: (bf16 W [D, F], f32 b, bf16 q), contiguous."""
    return (w.detach().to(torch.bfloat16).contiguous(),
            b.detach().float().contiguous(),
            q.detach().to(torch.bfloat16).contiguous())


def _split_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """[..., O*k] -> f32 [..., O, k]."""
    return x.float().reshape(*x.shape[:-1], -1, k)


def contracted_weights(w_bf16: torch.Tensor, q: torch.Tensor,
                       k: int) -> torch.Tensor:
    """wq [N, D, O] in f32, summed over j in order, before its rounding."""
    w3, q3 = _split_k(w_bf16, k), _split_k(q, k)
    wq = w3[None, :, :, 0] * q3[:, None, :, 0]
    for j in range(1, k):
        wq = wq + w3[None, :, :, j] * q3[:, None, :, j]
    return wq


def contracted_bias(b: torch.Tensor, q: torch.Tensor, k: int) -> torch.Tensor:
    """bq [N, O] in f32, summed over j in order."""
    b3, q3 = _split_k(b, k), _split_k(q, k)
    bq = b3[None, :, 0] * q3[:, :, 0]
    for j in range(1, k):
        bq = bq + b3[None, :, j] * q3[:, :, j]
    return bq


def g_pooled(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """d pooled from d out, exactly 0 where out == 0."""
    return g.float() * torch.where(
        out == 0, torch.zeros_like(out),
        0.5 / torch.clamp_min(out.abs(), 1e-20))


# the plain version of each launch, on the operands ``operands`` makes

def forward_reference(img, w_bf16, b, q, k: int) -> torch.Tensor:
    wq = contracted_weights(w_bf16, q, k).to(torch.bfloat16).float()
    pooled = torch.matmul(img.to(torch.bfloat16).float(), wq)
    return signed_sqrt(pooled + contracted_bias(b, q, k)[:, None, :])


def d_img_reference(g, out, w_bf16, q, k: int) -> torch.Tensor:
    """-> f32 [N, L, D]."""
    wq = contracted_weights(w_bf16, q, k).to(torch.bfloat16).float()
    gp = g_pooled(g, out).to(torch.bfloat16).float()
    return torch.matmul(gp, wq.transpose(1, 2))


def g_pooled_reference(g, out):
    """-> (bf16 gp [N, L, O8], 0 past O; f32 d_bq [N, O] = sum_l g_pooled):
    the g_pooled launch's plain version."""
    gp = g_pooled(g, out)
    o = gp.shape[-1]
    padded = torch.nn.functional.pad(gp, (0, -o % 8)).to(torch.bfloat16)
    return padded, gp.sum(dim=1)


def d_img_from_gp_reference(gp, w_bf16, q, k: int) -> torch.Tensor:
    """d_img from the bf16 operand gp [N, L, >= O] -> f32 [N, L, D]."""
    wq = contracted_weights(w_bf16, q, k).to(torch.bfloat16).float()
    o = w_bf16.shape[1] // k
    return torch.matmul(gp[..., :o].float().contiguous(), wq.transpose(1, 2))


def d_w_reference(g, out, img, w_bf16, b, q, k: int):
    """-> (d_W f32 [D, F], d_b f32 [F], d_q f32 [N, F])."""
    n, _, d = img.shape
    gp = g_pooled(g, out)
    d_wq = torch.matmul(img.to(torch.bfloat16).float().transpose(1, 2),
                        gp.to(torch.bfloat16).float())  # [N, D, O]
    d_bq = gp.sum(dim=1)  # [N, O]
    q3 = _split_k(q, k)
    d_w = torch.einsum("ndo,nok->dok", d_wq, q3).reshape(d, -1)
    d_b = torch.einsum("no,nok->ok", d_bq, q3).reshape(-1)
    d_q = (torch.einsum("ndo,dok->nok", d_wq, _split_k(w_bf16, k))
           + d_bq[..., None] * _split_k(b, k)[None])
    return d_w, d_b, d_q.reshape(n, -1)


class _PooledGridFusePlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, w, b, q, k):
        w_bf16, bf, qb = operands(w, b, q)
        out = forward_reference(img, w_bf16, bf, qb, k)
        ctx.save_for_backward(img, w_bf16, bf, qb, out)
        ctx.k = k
        ctx.dtypes = (w.dtype, b.dtype, q.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        img, w_bf16, bf, qb, out = ctx.saved_tensors
        k = ctx.k
        d_img = None
        if ctx.needs_input_grad[0]:
            d_img = d_img_reference(g, out, w_bf16, qb, k).to(img.dtype)
        d_w, d_b, d_q = d_w_reference(g, out, img, w_bf16, bf, qb, k)
        w_dtype, b_dtype, q_dtype = ctx.dtypes
        return d_img, d_w.to(w_dtype), d_b.to(b_dtype), d_q.to(q_dtype), None


def pooled_grid_fuse_reference(img, w, b, q, k: int) -> torch.Tensor:
    """K3's plain PyTorch version -> [N, L, O] f32, on any device."""
    return _PooledGridFusePlain.apply(img, w, b, q, k)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    from vqa_attention_networks_tpu_torch.ops import _build

    lib = _build.load("pooled_fusion")
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i] * 5 + [p]  # n, l, d, f, k, stream
    lib.pooled_fusion_forward.argtypes = [p] * 5 + tail  # img w b q out
    lib.pooled_fusion_g_pooled.argtypes = [p] * 4 + tail  # g out gp d_bq
    lib.pooled_fusion_d_img.argtypes = [p] * 4 + tail  # gp w q d_img
    # gp d_bq img w b q, d_w d_b d_q, scratch: d_q's partials
    lib.pooled_fusion_d_w.argtypes = [p] * 10 + tail
    # K6 (ops/wq_grid_fusion.py): img w b q, z ssq out, n l d f k, eps, stream
    lib.pooled_fusion_wq_grid.argtypes = (
        [p] * 7 + [i] * 5 + [ctypes.c_float, p])
    lib.pooled_fusion_o_tile.argtypes = []  # K6's ssq: sums per sample
    for name in ("forward", "g_pooled", "d_img", "d_w", "wq_grid", "o_tile"):
        getattr(lib, f"pooled_fusion_{name}").restype = ctypes.c_int
    lib.pooled_fusion_error_string.argtypes = [ctypes.c_int]
    lib.pooled_fusion_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(img, w_bf16, b, q, k: int) -> None:
    """Raise on operands the K3 and K6 kernels do not take."""
    if img.device.type != "cuda":
        raise ValueError(
            f"the K3/K6 kernels need a CUDA tensor, got {img.device}")
    if img.dtype != torch.bfloat16 or w_bf16.dtype != torch.bfloat16 or \
            q.dtype != torch.bfloat16:
        raise TypeError(f"the K3/K6 kernels take bf16 img, W and q, got "
                        f"{img.dtype}, {w_bf16.dtype} and {q.dtype}")
    if b.dtype != torch.float32:
        raise TypeError(f"the K3/K6 kernels take an f32 b, got {b.dtype}")
    if img.dim() != 3 or w_bf16.dim() != 2:
        raise ValueError(f"img must be [N, L, D] and W [D, F], got "
                         f"{tuple(img.shape)} and {tuple(w_bf16.shape)}")
    n, l, d = img.shape
    f = w_bf16.shape[1]
    for name, t in (("img", img), ("W", w_bf16), ("b", b), ("q", q)):
        if t.device != img.device:
            raise ValueError(f"img is on {img.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"the K3/K6 kernels need a contiguous {name}")
    if w_bf16.shape[0] != d or tuple(b.shape) != (f,) or \
            tuple(q.shape) != (n, f):
        raise ValueError(
            f"shapes do not agree: img {tuple(img.shape)}, "
            f"W {tuple(w_bf16.shape)}, b {tuple(b.shape)}, q {tuple(q.shape)}")
    if not 1 <= l <= _MAX_ROWS:
        raise ValueError(
            f"the K3/K6 kernels take 1 <= L <= {_MAX_ROWS}, got {l}")
    if not 1 <= k <= _MAX_K or f % k:
        raise ValueError(f"the K3/K6 kernels take 1 <= k <= {_MAX_K} with "
                         f"F % k == 0, got k={k}, F={f}")
    if d % 8 or f % 8:
        # rows of img and W are read as 16-byte vectors
        raise ValueError(f"the K3/K6 kernels need D % 8 == 0 and F % 8 == 0, "
                         f"got D={d}, F={f}")
    if img.data_ptr() % 16 or w_bf16.data_ptr() % 16:
        raise ValueError("the K3/K6 kernels need img and W 16-byte aligned")
    if not 1 <= n <= 65535 or n * l * max(d, f) >= 2 ** 31:
        raise ValueError(f"N*L*max(D, F) must stay below 2^31, got N={n}, "
                         f"L={l}")


def _check_grad(g, out, img, w_bf16, k: int) -> None:
    n, l, _ = img.shape
    want = (n, l, w_bf16.shape[1] // k)
    for name, t in (("g", g), ("out", out)):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                tuple(t.shape) != want or t.device != img.device:
            raise ValueError(f"{name} must be contiguous f32 {want} on "
                             f"{img.device}")


def _launch(name: str, pointers, dims, device) -> None:
    """Launch ``pooled_fusion_<name>`` on (n, l, d, f, k) = ``dims`` and
    count it; raises on a refused launch."""
    lib = library()
    with on_card(device):
        rc = getattr(lib, f"pooled_fusion_{name}")(
            *pointers, *dims, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"pooled_fusion {name} launch failed: CUDA error {rc} "
            f"({lib.pooled_fusion_error_string(rc).decode()})")
    launch_count[name] += 1


def _dims(img, w_bf16, k: int) -> tuple:
    return (*img.shape, w_bf16.shape[1], k)


# the kernel of each launch: operands as ``operands`` makes them

def forward_cuda(img, w_bf16, b, q, k: int) -> torch.Tensor:
    check_inputs(img, w_bf16, b, q, k)
    n, l, _ = img.shape
    out = torch.empty(n, l, w_bf16.shape[1] // k, dtype=torch.float32,
                      device=img.device)
    _launch("forward", (img.data_ptr(), w_bf16.data_ptr(), b.data_ptr(),
                        q.data_ptr(), out.data_ptr()), _dims(img, w_bf16, k),
            img.device)
    return out


def g_pooled_cuda(g, out, img, w_bf16, b, q, k: int):
    """Launch the g_pooled build -> (bf16 gp [N, L, O8], 0 past O; f32 d_bq
    [N, O]), in scratch allocated here."""
    check_inputs(img, w_bf16, b, q, k)
    _check_grad(g, out, img, w_bf16, k)
    n, l, _ = img.shape
    o = w_bf16.shape[1] // k
    gp = torch.empty(n, l, -(-o // 8) * 8, dtype=torch.bfloat16,
                     device=img.device)
    d_bq = torch.empty(n, o, dtype=torch.float32, device=img.device)
    _launch("g_pooled", (g.data_ptr(), out.data_ptr(), gp.data_ptr(),
                         d_bq.data_ptr()), _dims(img, w_bf16, k), img.device)
    return gp, d_bq


def _check_gp(gp, img, w_bf16, k: int) -> None:
    n, l, _ = img.shape
    want = (n, l, -(-(w_bf16.shape[1] // k) // 8) * 8)
    if gp.dtype != torch.bfloat16 or tuple(gp.shape) != want or \
            not gp.is_contiguous() or gp.device != img.device:
        raise ValueError(f"gp must be contiguous bf16 {want} on {img.device}, "
                         "as g_pooled_cuda makes it")


def d_img_from_gp_cuda(gp, img, w_bf16, b, q, k: int) -> torch.Tensor:
    """Launch the d_img product over ``g_pooled_cuda``'s gp -> f32
    [N, L, D]."""
    check_inputs(img, w_bf16, b, q, k)
    _check_gp(gp, img, w_bf16, k)
    if q.data_ptr() % 16:
        raise ValueError("d_img reads q by TMA: it must be 16-byte aligned")
    d_img = torch.empty(img.shape, dtype=torch.float32, device=img.device)
    _launch("d_img", (gp.data_ptr(), w_bf16.data_ptr(), q.data_ptr(),
                      d_img.data_ptr()), _dims(img, w_bf16, k), img.device)
    return d_img


def d_w_from_gp_cuda(gp, d_bq, img, w_bf16, b, q, k: int):
    """Launch d_W/d_b/d_q over ``g_pooled_cuda``'s gp and d_bq -> (d_W f32
    [D, F], d_b f32 [F], d_q f32 [N, F])."""
    check_inputs(img, w_bf16, b, q, k)
    _check_gp(gp, img, w_bf16, k)
    n, _, d = img.shape
    f = w_bf16.shape[1]
    dev = img.device
    if d_bq.dtype != torch.float32 or tuple(d_bq.shape) != (n, f // k) or \
            not d_bq.is_contiguous() or d_bq.device != dev:
        raise ValueError(f"d_bq must be contiguous f32 [{n}, {f // k}] on "
                         f"{dev}, as g_pooled_cuda makes it")
    d_w = torch.empty(d, f, dtype=torch.float32, device=dev)
    d_b = torch.empty(f, dtype=torch.float32, device=dev)
    d_q = torch.empty(n, f, dtype=torch.float32, device=dev)
    # scratch: d_q's partial sums per D tile, reduced in order by a later
    # launch inside the entry
    parts = torch.empty(-(-d // _D_TILE), n, f, dtype=torch.float32,
                        device=dev)
    _launch("d_w", (gp.data_ptr(), d_bq.data_ptr(), img.data_ptr(),
                    w_bf16.data_ptr(), b.data_ptr(), q.data_ptr(),
                    d_w.data_ptr(), d_b.data_ptr(), d_q.data_ptr(),
                    parts.data_ptr()), _dims(img, w_bf16, k), dev)
    return d_w, d_b, d_q


def d_img_cuda(g, out, img, w_bf16, b, q, k: int) -> torch.Tensor:
    """d_img, f32 [N, L, D]: the g_pooled build, then the product."""
    gp, _ = g_pooled_cuda(g, out, img, w_bf16, b, q, k)
    return d_img_from_gp_cuda(gp, img, w_bf16, b, q, k)


def d_w_cuda(g, out, img, w_bf16, b, q, k: int):
    """-> (d_W f32 [D, F], d_b f32 [F], d_q f32 [N, F]): the g_pooled
    build, then the d_W launch over it."""
    return d_w_from_gp_cuda(*g_pooled_cuda(g, out, img, w_bf16, b, q, k),
                            img, w_bf16, b, q, k)


class PooledGridFuse(torch.autograd.Function):
    """K3 on the card: the forward and each backward product are launches
    of the hand-written kernels. The backward forms g_pooled once, for d_W
    and, only when img needs a gradient (in the training step img is data
    and does not), for d_img."""

    @staticmethod
    def forward(ctx, img, w, b, q, k):
        w_bf16, bf, qb = operands(w, b, q)
        out = forward_cuda(img, w_bf16, bf, qb, k)
        ctx.save_for_backward(img, w_bf16, bf, qb, out)
        ctx.k = k
        ctx.dtypes = (w.dtype, b.dtype, q.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        img, w_bf16, bf, qb, out = ctx.saved_tensors
        k = ctx.k
        gp, d_bq = g_pooled_cuda(g.float().contiguous(), out, img, w_bf16,
                                 bf, qb, k)
        d_img = d_img_from_gp_cuda(gp, img, w_bf16, bf, qb, k).to(img.dtype) \
            if ctx.needs_input_grad[0] else None
        d_w, d_b, d_q = d_w_from_gp_cuda(gp, d_bq, img, w_bf16, bf, qb, k)
        w_dtype, b_dtype, q_dtype = ctx.dtypes
        return d_img, d_w.to(w_dtype), d_b.to(b_dtype), d_q.to(q_dtype), None


def pooled_grid_fuse(img, w, b, q, k: int) -> torch.Tensor:
    """Dispatching entry -> [N, L, O] f32: the plain version for a CPU
    tensor, the kernels for a CUDA tensor."""
    if img.device.type == "cpu":
        return pooled_grid_fuse_reference(img, w, b, q, k)
    return PooledGridFuse.apply(img, w, b, q, k)
