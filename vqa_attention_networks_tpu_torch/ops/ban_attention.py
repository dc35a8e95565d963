"""BAN's bilinear attention map (N3), BiAttention's output in ban-vqa
(``attention.py``, ``bc.py``):

    S[n, g, i, j] = sum_c h[g, c] av[n, i, c] aq[n, j, c] + hb[g]
    P[n, g]       = softmax over all (i, j) of S[n, g], with the cells i
                    whose features are all 0 (``mask``) at -inf,

with av [N, L, K] and aq [N, T, K] BiAttention's two ReLU projections
(K = 3 H), h [G, K] the weight-normalised ``h_mat`` and hb [G] its bias:
the composed form and the fused kernel (``csrc/ban_attention.cu``).

- ``attention_map_composed``: plain PyTorch, differentiable: the CPU,
  training, f32, the tests' small widths and ``VQA_DISABLE_PALLAS`` run
  it. It scales the words by h in f32 and rounds them to av's dtype (in
  bf16, ``bf16(h aq)``, as the kernel does), takes S as one batched
  product a sample (the G T scaled words against the L cells: h (x) av is
  never formed), adds hb, and takes the softmax in f32; P comes back in
  av's dtype.
- ``attention_map``: the custom op ``torch.ops.vqa.ban_attention``, which
  runs the composed form on a CPU tensor and the kernel on a CUDA tensor
  (bf16 only, shapes that ``supported`` takes; it raises on anything
  else, with no fallback). Being an op with a fake implementation, it
  survives ``torch.export`` and CUDA graph capture as one node. The kernel
  keeps S in f32 (the composed bf16 form rounds it to bf16) and leaves hb
  out: a constant shift of a glimpse's scores, which the softmax cancels.
- ``launch_count`` counts the kernel's launches.

The kernel replaces no TPU kernel: the JAX package has no BAN. Composed as
ban-vqa writes it, ``einsum('xhyk,bvk,bqk->bhvq')`` forms h (x) av, a
[N, 8, 196, 3840] tensor (3.08 GB in bf16 at N = 256); the kernel reads
av, aq, h and the mask once and writes P once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vqa_attention_networks_tpu_torch.ops import on_card

MAX_CELLS = 200  # the kernel's padded grid (wgmma's N)
MAX_WORDS = 24
MAX_GLIMPSES = 8
MAX_ROWS = 192  # G T: two warpgroups of 64 rows, or three
K_TILE = 64

# kernel launches made by attention_map (one per call on a CUDA tensor)
launch_count = 0


def attention_map_composed(av: torch.Tensor, aq: torch.Tensor,
                           h: torch.Tensor, hb: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """The attention map in plain PyTorch -> P [N, G, L, T] in av's dtype."""
    n, l, k = av.shape
    t, g = aq.shape[1], h.shape[0]
    # h[g, c] aq[n, j, c] in f32, rounded to av's dtype: [N, G T, K]
    a = (aq.float()[:, None] * h.float()[None, :, None, :]).to(av.dtype)
    a = a.reshape(n, g * t, k)
    s = torch.bmm(a, av.transpose(1, 2)).reshape(n, g, t, l)
    s = s.transpose(2, 3) + hb.to(s.dtype)[None, :, None, None]
    s = s.float().masked_fill(mask[:, None, :, None], float("-inf"))
    p = torch.softmax(s.reshape(n, g, l * t), dim=-1)
    return p.reshape(n, g, l, t).to(av.dtype)


def supported(l: int, t: int, g: int, k: int) -> bool:
    """Whether the kernel takes L cells, T words, G glimpses and K = 3 H."""
    return (1 <= l <= MAX_CELLS and 1 <= t <= MAX_WORDS
            and 1 <= g <= MAX_GLIMPSES and g * t <= MAX_ROWS
            and k >= K_TILE and k % K_TILE == 0)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from vqa_attention_networks_tpu_torch.ops import _build

    lib = _build.load("ban_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ban_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.ban_attention_launch.restype = ctypes.c_int
    lib.ban_attention_error_string.argtypes = [ctypes.c_int]
    lib.ban_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(av: torch.Tensor, aq: torch.Tensor, h: torch.Tensor,
                  mask: torch.Tensor) -> None:
    if av.device.type != "cuda":
        raise ValueError(
            f"the attention map kernel needs a CUDA tensor, got {av.device}")
    for name, x in (("av", av), ("aq", aq)):
        if x.dtype != torch.bfloat16 or x.dim() != 3:
            raise TypeError(f"the attention map kernel takes bf16 [N, *, K] "
                            f"{name}, got {x.dtype} {tuple(x.shape)}")
    n, l, k = av.shape
    t = aq.shape[1]
    if aq.shape[0] != n or aq.shape[2] != k:
        raise ValueError(f"av {tuple(av.shape)} and aq {tuple(aq.shape)} do "
                         "not fit")
    if h.dtype != torch.float32 or h.dim() != 2 or h.shape[1] != k:
        raise ValueError(f"h must be f32 [G, {k}], got {h.dtype} "
                         f"{tuple(h.shape)}")
    if not supported(l, t, h.shape[0], k):
        raise ValueError(f"the attention map kernel takes at most "
                         f"{MAX_CELLS} cells, {MAX_WORDS} words, "
                         f"{MAX_GLIMPSES} glimpses, {MAX_ROWS} glimpse "
                         f"words and K a multiple of {K_TILE}: got L {l}, "
                         f"T {t}, G {h.shape[0]}, K {k}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (n, l):
        raise ValueError(f"mask must be bool [{n}, {l}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    for name, x in (("av", av), ("aq", aq), ("h", h), ("mask", mask)):
        if x.device != av.device:
            raise ValueError(f"{name} is on {x.device}, av on {av.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"the attention map kernel needs {name} "
                             "contiguous and 16-byte aligned")


def attention_map_cuda(av: torch.Tensor, aq: torch.Tensor, h: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Launch the kernel -> bf16 P [N, G, L, T]. Raises on an input it does
    not take and on a refused launch."""
    global launch_count
    _check_inputs(av, aq, h, mask)
    n, l, k = av.shape
    t, g = aq.shape[1], h.shape[0]
    out = torch.empty((n, g, l, t), dtype=av.dtype, device=av.device)
    stream = torch.cuda.current_stream(av.device).cuda_stream
    with on_card(av.device):
        rc = _library().ban_attention_launch(
            av.data_ptr(), aq.data_ptr(), h.data_ptr(), mask.data_ptr(),
            out.data_ptr(), n, l, t, g, k, stream)
    if rc != 0:
        raise RuntimeError(
            f"ban_attention launch failed: CUDA error {rc} "
            f"({_library().ban_attention_error_string(rc).decode()})")
    launch_count += 1
    return out


@torch.library.custom_op("vqa::ban_attention", mutates_args=(),
                         device_types="cpu")
def attention_map_op(av: torch.Tensor, aq: torch.Tensor, h: torch.Tensor,
                     hb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The attention map as an op; on a CPU tensor, the composed form."""
    return attention_map_composed(av, aq, h, hb, mask)


@attention_map_op.register_kernel("cuda")
def _attention_map_on_the_card(av, aq, h, hb, mask):
    return attention_map_cuda(av, aq, h, mask)


@attention_map_op.register_fake
def _attention_map_shape(av, aq, h, hb, mask):
    return av.new_empty((av.shape[0], h.shape[0], av.shape[1], aq.shape[1]))


def attention_map(av: torch.Tensor, aq: torch.Tensor, h: torch.Tensor,
                  hb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Dispatching entry -> P [N, G, L, T]: the op, which runs the composed
    form on a CPU tensor and the kernel on a CUDA tensor."""
    return attention_map_op(av, aq, h, hb, mask)
