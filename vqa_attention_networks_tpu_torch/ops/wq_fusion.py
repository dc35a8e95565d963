"""Stage-1 fusion + grid L2 + 2-glimpse co-attention (port of
``vqa_attention_networks_tpu/ops/pallas_wq_fusion.py``), kernel K1.

Per sample, with the fusion axis refactored output-major into k factors:

    wq[d, o] = sum_j W[d, o*k+j] * q[o*k+j]      (contract q into W)
    bq[o]    = sum_j b[o*k+j]    * q[o*k+j]
    z        = signed_sqrt(img @ wq + bq)        [L, O_pad]
    zb       = z / max(||z||, eps)               (norm over the whole grid)
    att      = softmax_L(relu(zb @ c1w + c1b) @ c2w + c2b)
    out      = att^T @ img                       [G, D] -> [G*D]

- ``stage1_coattention`` calls the custom op ``torch.ops.vqa.
  stage1_coattention``, which dispatches by device: a CPU tensor goes to
  the plain PyTorch version, a CUDA tensor to the hand-written kernel
  (``csrc/stage1_coattention.cu``), which raises on an input it does not
  take. Nothing catches an error to fall back. Being an op, with a fake
  implementation that gives its output's shape, the call survives
  ``torch.export`` (``aot.export_serving``) as one node, and the exported
  program picks the device's implementation when it runs.
- ``stage1_coattention_reference`` is the plain version. It keeps K1's own
  rounding points (``pallas_wq_fusion.py:165-202``): W and b f32, q rounded
  to bf16; wq built in f32 and rounded to bf16 once; pooled accumulated in
  f32 with bq added in f32; signed sqrt and norm in f32 over the padded
  grid (padded columns are exactly 0); zb bf16; h1 bf16 after the f32 bias
  and relu; logits and softmax f32; att rounded to bf16 before the pool;
  bf16 output.
- ``launch_count`` counts the kernel launches of ``stage1_coattention``.

The layout refactor of the weights (``pallas_wq_fusion.py:232-238``) is done
once by ``prepare_stage1_weights``, when the weights are loaded, not on
every call.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from vqa_attention_networks_tpu_torch.models.layers import signed_sqrt
from vqa_attention_networks_tpu_torch.ops import on_card
from vqa_attention_networks_tpu_torch.ops.fusion import refactor_output_major

_LANE = 128
_MAX_ROWS = 208  # the kernel's wgmma N: the L rows, padded to 8
_MAX_K = 16
_MAX_G = 8
_REFERENCE_CHUNK = 64  # samples per step of the plain version (memory)

# kernel launches made by stage1_coattention (one per call on a CUDA tensor)
launch_count = 0


@dataclass(frozen=True)
class Stage1Weights:
    """The kernel's layout of img_conv1d / co_att_conv1 / co_att_conv2."""

    w3: torch.Tensor  # [k, D, O_pad] f32
    b3: torch.Tensor  # [k, O_pad] f32
    # [O_pad, C_pad] bf16, C_pad = C rounded up to 8 so that each row is a
    # multiple of 16 bytes, as the kernel's TMA loads read it; the padded
    # rows and columns are zero
    c1w: torch.Tensor
    c1b: torch.Tensor  # [C] f32
    c2w: torch.Tensor  # [C, G] bf16
    c2b: torch.Tensor  # [G] f32
    o: int  # real fusion outputs (O <= O_pad)
    k: int  # factor

    @property
    def o_pad(self) -> int:
        return self.w3.shape[2]

    @property
    def c(self) -> int:
        return self.c1b.shape[0]


def prepare_stage1_weights(
    w: torch.Tensor,  # [D, F] (JAX layout)
    b: torch.Tensor,  # [F]
    c1w: torch.Tensor,  # [O, C]
    c1b: torch.Tensor,  # [C]
    c2w: torch.Tensor,  # [C, G]
    c2b: torch.Tensor,  # [G]
    k: int,
) -> Stage1Weights:
    d, f = w.shape
    if f % k:
        raise ValueError(f"fusion dim {f} not divisible by factor {k}")
    o = f // k
    o_pad = -(-o // _LANE) * _LANE
    w3 = refactor_output_major(w.float(), o, k, o_pad)  # [D, k, O_pad]
    b3 = refactor_output_major(b.float().reshape(1, -1), o, k, o_pad)[0]
    return Stage1Weights(
        w3=w3.transpose(0, 1).contiguous(),
        b3=b3.contiguous(),
        c1w=F.pad(c1w, (0, -c1w.shape[1] % 8, 0, o_pad - o)).to(
            torch.bfloat16).contiguous(),
        c1b=c1b.float().contiguous(),
        c2w=c2w.to(torch.bfloat16).contiguous(),
        c2b=c2b.float().contiguous(),
        o=o,
        k=k,
    )


def _refactor_q(q_proj: torch.Tensor, sw: Stage1Weights) -> torch.Tensor:
    """q [N, F] -> [N, k, O_pad] bf16."""
    return refactor_output_major(q_proj, sw.o, sw.k, sw.o_pad).to(
        torch.bfloat16
    )


def stage1_coattention_reference(
    img: torch.Tensor,  # [N, L, D] bf16
    q_proj: torch.Tensor,  # [N, F]
    sw: Stage1Weights,
    eps: float = 1e-12,
    *,
    intermediates: bool = False,
):
    """The plain PyTorch version of K1 -> [N, G*D] bf16. With
    ``intermediates=True`` it returns ``(out, z, h1)``: z [N, L, O_pad] f32
    after the signed sqrt, h1 [N, L, C] bf16, as the kernel's scratch."""
    n, _, d = img.shape
    g = sw.c2w.shape[1]
    q3 = _refactor_q(q_proj, sw).float()
    c1w = sw.c1w[:, :sw.c].float()
    c2w = sw.c2w.float()
    outs, zs, h1s = [], [], []
    for s in range(0, n, _REFERENCE_CHUNK):
        x = img[s:s + _REFERENCE_CHUNK].to(torch.bfloat16).float()
        q = q3[s:s + _REFERENCE_CHUNK]
        wq = torch.zeros(x.shape[0], d, sw.o_pad, device=img.device)
        bq = torch.zeros(x.shape[0], 1, sw.o_pad, device=img.device)
        for j in range(sw.k):
            wq = wq + sw.w3[j][None] * q[:, j, None, :]
            bq = bq + sw.b3[j][None, None, :] * q[:, j, None, :]
        z = signed_sqrt(
            torch.matmul(x, wq.to(torch.bfloat16).float()) + bq
        )  # [n, L, O_pad]
        norm = torch.sqrt(torch.sum(z * z, dim=(1, 2), keepdim=True))
        zb = (z * (1.0 / torch.clamp_min(norm, eps))).to(torch.bfloat16)
        h1 = torch.relu(torch.matmul(zb.float(), c1w) + sw.c1b).to(
            torch.bfloat16
        )
        logits = torch.matmul(h1.float(), c2w) + sw.c2b  # [n, L, G]
        att = torch.exp(logits - torch.amax(logits, dim=1, keepdim=True))
        att = att / torch.sum(att, dim=1, keepdim=True)
        pooled = torch.matmul(
            att.to(torch.bfloat16).float().transpose(1, 2), x
        )  # [n, G, D]
        outs.append(pooled.to(torch.bfloat16).reshape(-1, g * d))
        if intermediates:
            zs.append(z)
            h1s.append(h1)
    if intermediates:
        return torch.cat(outs), torch.cat(zs), torch.cat(h1s)
    return torch.cat(outs)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from vqa_attention_networks_tpu_torch.ops import _build

    lib = _build.load("stage1_coattention")
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.stage1_coattention_launch.argtypes = (
        [p] * 12 + [i] * 8 + [ctypes.c_float, p]
    )
    lib.stage1_coattention_launch.restype = ctypes.c_int
    lib.stage1_o_tile.argtypes = []
    lib.stage1_o_tile.restype = ctypes.c_int
    lib.stage1_error_string.argtypes = [ctypes.c_int]
    lib.stage1_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(img: torch.Tensor, q_proj: torch.Tensor,
                  sw: Stage1Weights) -> None:
    if img.device.type != "cuda":
        raise ValueError(f"the K1 kernel needs a CUDA tensor, got {img.device}")
    if img.dtype != torch.bfloat16:
        raise TypeError(f"the K1 kernel takes bf16 img, got {img.dtype}")
    if img.dim() != 3:
        raise ValueError(f"img must be [N, L, D], got {tuple(img.shape)}")
    n, l, d = img.shape
    if not img.is_contiguous():
        raise ValueError("the K1 kernel needs a contiguous img")
    if d % 8:
        raise ValueError(f"the K1 kernel needs D % 8 == 0, got D={d}")
    if img.data_ptr() % 16:
        # rows of img are read as 16-byte vectors
        raise ValueError("the K1 kernel needs img 16-byte aligned")
    if not 1 <= l <= _MAX_ROWS:
        raise ValueError(f"the K1 kernel takes 1 <= L <= {_MAX_ROWS}, got {l}")
    if n > 65535:
        raise ValueError(f"the K1 kernel takes N <= 65535, got {n}")
    if tuple(q_proj.shape) != (n, sw.o * sw.k):
        raise ValueError(
            f"q_proj must be [{n}, {sw.o * sw.k}], got {tuple(q_proj.shape)}"
        )
    if sw.w3.shape[1] != d:
        raise ValueError(f"weights are for D={sw.w3.shape[1]}, img has D={d}")
    if sw.k > _MAX_K or sw.c2w.shape[1] > _MAX_G:
        raise ValueError(
            f"the K1 kernel takes k <= {_MAX_K} and G <= {_MAX_G}, got "
            f"k={sw.k}, G={sw.c2w.shape[1]}"
        )
    c_pad = sw.c1w.shape[1]
    if sw.c1w.shape[0] != sw.o_pad or c_pad % 8 or c_pad < sw.c:
        raise ValueError(
            f"c1w must be [O_pad, C rounded up to 8] as prepare_stage1_weights "
            f"lays it out, got {tuple(sw.c1w.shape)} for C={sw.c}"
        )
    if sw.w3.data_ptr() % 16 or sw.c1w.data_ptr() % 16:
        # the kernel reads w3 and c1w by TMA
        raise ValueError("the K1 kernel needs w3 and c1w 16-byte aligned")
    expect = {
        "w3": torch.float32, "b3": torch.float32, "c1w": torch.bfloat16,
        "c1b": torch.float32, "c2w": torch.bfloat16, "c2b": torch.float32,
    }
    for name, dtype in expect.items():
        t = getattr(sw, name)
        if t.device != img.device or q_proj.device != img.device:
            raise ValueError(
                f"img is on {img.device} but q_proj is on {q_proj.device} "
                f"and {name} on {t.device}"
            )
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"weight {name} must be contiguous {dtype}, got {t.dtype}"
            )


def stage1_coattention_cuda(img: torch.Tensor, q_proj: torch.Tensor,
                            sw: Stage1Weights,
                            eps: float = 1e-12, *,
                            intermediates: bool = False):
    """Launch the hand-written kernel -> [N, G*D] bf16. Raises on an input
    it does not take and on a refused launch. With ``intermediates=True``
    it also returns its z and h1 scratch, as the plain version does."""
    global launch_count
    _check_inputs(img, q_proj, sw)
    n, l, d = img.shape
    c = sw.c
    g = sw.c2w.shape[1]
    q3 = _refactor_q(q_proj, sw).contiguous()
    lib = _library()
    z = torch.empty(n, l, sw.o_pad, dtype=torch.float32, device=img.device)
    # one sum-of-squares partial per sample and O tile of the kernel
    ssq = torch.empty(n, sw.o_pad // lib.stage1_o_tile(),
                      dtype=torch.float32, device=img.device)
    h1 = torch.empty(n, l, c, dtype=torch.bfloat16, device=img.device)
    out = torch.empty(n, g, d, dtype=torch.bfloat16, device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    with on_card(img.device):
        rc = lib.stage1_coattention_launch(
            img.data_ptr(), sw.w3.data_ptr(), sw.b3.data_ptr(),
            q3.data_ptr(), sw.c1w.data_ptr(), sw.c1b.data_ptr(),
            sw.c2w.data_ptr(), sw.c2b.data_ptr(), z.data_ptr(),
            ssq.data_ptr(), h1.data_ptr(), out.data_ptr(), n, l, d, sw.k,
            sw.o_pad, c, sw.c1w.shape[1], g, eps, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"stage1_coattention launch failed: CUDA error {rc} "
            f"({lib.stage1_error_string(rc).decode()})"
        )
    launch_count += 1
    if intermediates:
        return out.reshape(n, g * d), z, h1
    return out.reshape(n, g * d)


@torch.library.custom_op("vqa::stage1_coattention", mutates_args=(),
                         device_types="cpu")
def stage1_coattention_op(img: torch.Tensor, q_proj: torch.Tensor,
                          w3: torch.Tensor, b3: torch.Tensor,
                          c1w: torch.Tensor, c1b: torch.Tensor,
                          c2w: torch.Tensor, c2b: torch.Tensor, o: int,
                          k: int) -> torch.Tensor:
    """K1 as an op over ``Stage1Weights``' fields; on a CPU tensor, the
    plain version."""
    return stage1_coattention_reference(
        img, q_proj, Stage1Weights(w3, b3, c1w, c1b, c2w, c2b, o, k))


@stage1_coattention_op.register_kernel("cuda")
def _stage1_coattention_on_the_card(img, q_proj, w3, b3, c1w, c1b, c2w,
                                    c2b, o, k):
    return stage1_coattention_cuda(
        img, q_proj, Stage1Weights(w3, b3, c1w, c1b, c2w, c2b, o, k))


@stage1_coattention_op.register_fake
def _stage1_coattention_shape(img, q_proj, w3, b3, c1w, c1b, c2w, c2b, o,
                              k):
    return img.new_empty((img.shape[0], c2w.shape[1] * img.shape[2]),
                         dtype=torch.bfloat16)


def stage1_coattention(img: torch.Tensor, q_proj: torch.Tensor,
                       sw: Stage1Weights) -> torch.Tensor:
    """Dispatching entry -> attended image feature [N, G*D] bf16: the op,
    which runs the plain version on a CPU tensor and the kernel on a CUDA
    tensor."""
    return stage1_coattention_op(img, q_proj, sw.w3, sw.b3, sw.c1w, sw.c1b,
                                 sw.c2w, sw.c2b, sw.o, sw.k)
