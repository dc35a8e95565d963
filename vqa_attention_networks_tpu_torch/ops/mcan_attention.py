"""MCAN's masked multi-head attention before the merge projection,

    out = concat_h softmax(q_h k_h^T / sqrt(d_h), mask -> -1e9) v_h,

with q [N, Lq, d], k and v [N, Lk, d] the projections' outputs, heads h of
width d_h side by side in the last axis and the key mask [N, Lk] true at
padding (mcan-vqa's ``MHAtt.att``, ``core/model/mca.py``): the composed
form and the fused kernel (``csrc/mcan_attention.cu``).

- ``attention_composed``: plain PyTorch, differentiable, with an optional
  ``drop`` on the attention map (training's dropout): the CPU, training,
  f32, the tests' small widths and ``VQA_DISABLE_PALLAS`` run it. In bf16
  it rounds the scores and the map to bf16.
- ``attention``: the custom op ``torch.ops.vqa.mcan_attention`` for heads
  of 64 and at most ``MAX_KEYS`` keys, which runs the composed form on a
  CPU tensor and the kernel on a CUDA tensor (bf16 only; it raises on
  anything else, with no fallback). Being an op with a fake
  implementation, it survives ``torch.export`` and CUDA graph capture as
  one node. The kernel keeps the scores and the softmax in f32 and rounds
  the map once, to bf16, for its product with v: it rounds less than the
  composed form.
- ``key_tile``: the kernel's padded key tile for Lk, the adaptation by
  shape (16 for MCAN's 14 words, 208 for its 196 grid cells).
- ``launch_count`` counts the kernel's launches.

The kernel replaces no TPU kernel: the JAX package has no MCAN. Composed,
one self-attention over MCAN-large's grid writes a [N, 16, 196, 196] bf16
map (315 MB at N = 256) and passes over it four times, besides copying the
heads apart and together; the kernel reads q, k, v and the mask once and
writes out once (``csrc/mcan_attention.cu`` says how).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional

import torch

from vqa_attention_networks_tpu_torch.ops import on_card

HEAD_DIM = 64  # the kernel's head width
MASK_FILL = -1e9  # mcan-vqa's masked_fill value
KEY_TILES = (16, 32, 64, 128, 208, 256)  # the kernel's instances
MAX_KEYS = KEY_TILES[-1]

# kernel launches made by attention (one per call on a CUDA tensor)
launch_count = 0


def attention_composed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor, heads: int,
                       drop: Optional[Callable] = None) -> torch.Tensor:
    """The attention in plain PyTorch, in q's dtype -> [N, Lq, d]; ``drop``
    acts on the attention map."""
    n, lq, d = q.shape
    lk = k.shape[1]
    dh = d // heads

    def split(x, length):
        return x.view(n, length, heads, dh).transpose(1, 2)

    qh = split(q, lq) / math.sqrt(dh)
    scores = torch.matmul(qh, split(k, lk).transpose(-2, -1))
    scores = scores.masked_fill(mask[:, None, None, :], MASK_FILL)
    att = torch.softmax(scores, dim=-1)
    if drop is not None:
        att = drop(att)
    return torch.matmul(att, split(v, lk)).transpose(1, 2).reshape(n, lq, d)


def key_tile(lk: int) -> int:
    """The kernel's key tile for ``lk`` keys: the least instance that holds
    them."""
    for tile in KEY_TILES:
        if lk <= tile:
            return tile
    raise ValueError(f"the attention kernel takes at most {MAX_KEYS} keys, "
                     f"got {lk}")


def supported(head_dim: int, lk: int) -> bool:
    """Whether the op takes heads of ``head_dim`` over ``lk`` keys."""
    return head_dim == HEAD_DIM and 1 <= lk <= MAX_KEYS


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from vqa_attention_networks_tpu_torch.ops import _build

    lib = _build.load("mcan_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mcan_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.mcan_attention_launch.restype = ctypes.c_int
    lib.mcan_attention_error_string.argtypes = [ctypes.c_int]
    lib.mcan_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(
            f"the attention kernel needs a CUDA tensor, got {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the attention kernel takes bf16 q, k and v, "
                            f"got {name} {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be [N, L, d], got "
                             f"{tuple(t.shape)}")
    n, lq, d = q.shape
    lk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != n or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit")
    if d % HEAD_DIM or not supported(HEAD_DIM, lk) or lq < 1:
        raise ValueError(f"the attention kernel takes heads of {HEAD_DIM} "
                         f"(d a multiple of it) over 1 to {MAX_KEYS} keys, "
                         f"got d {d}, Lq {lq}, Lk {lk}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (n, lk):
        raise ValueError(f"mask must be bool [{n}, {lk}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the attention kernel needs {name} contiguous "
                             "and 16-byte aligned")


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Launch the kernel -> bf16 [N, Lq, d]. Raises on an input it does not
    take and on a refused launch."""
    global launch_count
    _check_inputs(q, k, v, mask)
    out = torch.empty_like(q)
    n, lq, d = q.shape
    lk = k.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with on_card(q.device):
        rc = _library().mcan_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), n, lq, lk, d, key_tile(lk), stream)
    if rc != 0:
        raise RuntimeError(
            f"mcan_attention launch failed: CUDA error {rc} "
            f"({_library().mcan_attention_error_string(rc).decode()})")
    launch_count += 1
    return out


@torch.library.custom_op("vqa::mcan_attention", mutates_args=(),
                         device_types="cpu")
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """The attention over heads of 64 as an op; on a CPU tensor, the
    composed form."""
    return attention_composed(q, k, v, mask, q.shape[-1] // HEAD_DIM)


@attention_op.register_kernel("cuda")
def _attention_on_the_card(q, k, v, mask):
    return attention_cuda(q, k, v, mask)


@attention_op.register_fake
def _attention_shape(q, k, v, mask):
    return torch.empty_like(q)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Dispatching entry -> [N, Lq, d]: the op, which runs the composed form
    on a CPU tensor and the kernel on a CUDA tensor."""
    return attention_op(q, k, v, mask)
