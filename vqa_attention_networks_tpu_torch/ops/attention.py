"""The 2-glimpse attention block (port of ``glimpse_attention`` in
``vqa_attention_networks_tpu/ops/pallas_attention.py``), with kernel K7:

    a   = relu(x @ W1 + b1) @ W2 + b2      [N, P, G]
    w_g = softmax(a[:, :, g], over P)      (all ones under ``uniform_quirk``)
    out = concat_g(sum_p w_g[p] * v[p])    [N, G*D]

Dispatch (``pallas_attention.py:162-177``): at bf16 with ``VQA_PALLAS_GLIMPSE``
set and ``VQA_DISABLE_PALLAS`` not set (both read at each call, and at
trace time under ``torch.export``) the block runs as K7, the custom op
``torch.ops.vqa.glimpse_attention``, which dispatches by device: on a CUDA
tensor the hand-written kernel (``csrc/glimpse_attention.cu``), on a CPU
tensor its plain version; its fake implementation gives the output's
shape, so ``torch.export`` keeps the call as one node. Otherwise the plain version runs, the math of the composed
twin ``_glimpse_reference`` (``pallas_attention.py:109-128``). The TPU
gate's ``n % 8`` is its block of 8 samples; the port's K7 takes any N.

Rounding points (the kernel and its plain version share them): the MLP
takes x's dtype for x, W1 and W2 with f32 accumulation, adds the f32
biases, and rounds the hidden layer to x's dtype; the logits and the
softmax are f32; the weights are rounded to v's dtype (as
``two_glimpse_pool`` does) and the pool accumulates in f32; the output is
rounded to x's dtype. The TPU kernel pools with f32 weights: one rounding
of each weight apart, within 2^-9 relative.

``launch_count`` counts K7's calls on the card (two launches each: the
MLP with its logits, then the softmax and pool).
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from vqa_attention_networks_tpu_torch.models.layers import matmul_f32
from vqa_attention_networks_tpu_torch.ops import kernels_disabled, on_card
from vqa_attention_networks_tpu_torch.ops.fusion import two_glimpse_pool

_TILE_A = 256  # hidden units per MLP block (glimpse_attention.cu kMlpHidden)
_MAX_G = 4
_MAX_P = 1024

# K7 calls on a CUDA tensor (each launches the MLP and the pool kernels)
launch_count = 0


def glimpse_attention_reference(x, w1, b1, w2, b2, v, *,
                                uniform_quirk: bool) -> torch.Tensor:
    """The plain version -> [N, G*D] in x's dtype. W1 [A, C] and W2 [G, A]
    are in PyTorch's layout."""
    acc = torch.promote_types(x.dtype, torch.float32)
    w1t = w1.to(x.dtype).t()
    w2t = w2.to(x.dtype).t()
    if x.dtype == acc:
        h = torch.relu(torch.matmul(x, w1t) + b1.to(acc))
        logits = torch.matmul(h, w2t) + b2.to(acc)
    else:
        h = torch.relu(matmul_f32(x, w1t) + b1.to(acc)).to(x.dtype)
        logits = matmul_f32(h, w2t) + b2.to(acc)
    out = two_glimpse_pool(logits, v, uniform_quirk=uniform_quirk)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from vqa_attention_networks_tpu_torch.ops import _build

    lib = _build.load("glimpse_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    # x w1 b1 w2 b2 v part out, n p c a g d uniform, stream
    lib.glimpse_attention_launch.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.glimpse_attention_launch.restype = ctypes.c_int
    lib.glimpse_error_string.argtypes = [ctypes.c_int]
    lib.glimpse_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(x, w1, b1, w2, b2, v) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the K7 kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"the K7 kernel takes bf16 x and v, got {x.dtype} "
                        f"and {v.dtype}")
    if x.dim() != 3 or v.dim() != 3 or v.shape[:2] != x.shape[:2]:
        raise ValueError(f"x must be [N, P, C] and v [N, P, D], got "
                         f"{tuple(x.shape)} and {tuple(v.shape)}")
    n, p, c = x.shape
    a, g = w1.shape[0], w2.shape[0]
    if tuple(w1.shape) != (a, c) or tuple(w2.shape) != (g, a) or \
            tuple(b1.shape) != (a,) or tuple(b2.shape) != (g,):
        raise ValueError(f"W1 must be [A, C={c}], b1 [A], W2 [G, A], b2 "
                         f"[G]; got {tuple(w1.shape)}, {tuple(b1.shape)}, "
                         f"{tuple(w2.shape)}, {tuple(b2.shape)}")
    for name, t in (("v", v), ("w1", w1), ("b1", b1), ("w2", w2),
                    ("b2", b2)):
        if t.device != x.device:
            raise ValueError(f"x is on {x.device} but {name} on {t.device}")
    if not x.is_contiguous() or not v.is_contiguous():
        raise ValueError("the K7 kernel needs a contiguous x and v")
    if c % 8 or v.shape[2] % 2:
        # rows of x and W1 are read as 16-byte vectors, v in bf16 pairs
        raise ValueError(f"the K7 kernel needs C % 8 == 0 and D % 2 == 0, "
                         f"got C={c}, D={v.shape[2]}")
    if x.data_ptr() % 16 or v.data_ptr() % 4:
        raise ValueError("the K7 kernel needs x 16-byte and v 4-byte aligned")
    if not 1 <= g <= _MAX_G or not 1 <= p <= _MAX_P:
        raise ValueError(f"the K7 kernel takes 1 <= G <= {_MAX_G} and "
                         f"1 <= P <= {_MAX_P}, got G={g}, P={p}")
    if not 1 <= n <= 65535 or n * p * max(c, v.shape[2]) >= 2 ** 31:
        raise ValueError(f"the K7 kernel takes N <= 65535 and N*P*max(C, "
                         f"D) < 2^31, got N={n}, P={p}")


def glimpse_attention_cuda(x, w1, b1, w2, b2, v, *,
                           uniform_quirk: bool) -> torch.Tensor:
    """Launch K7 -> [N, G*D] in x's dtype, bf16 (the kernel rounds its f32
    sums once, as the JAX dispatcher rounds the TPU kernel's output; and
    W2, taken in f32, as the plain version rounds it). Raises on an input
    it does not take and on a refused launch."""
    global launch_count
    _check_inputs(x, w1, b1, w2, b2, v)
    n, p, c = x.shape
    a, g, d = w1.shape[0], w2.shape[0], v.shape[2]
    w1b = w1.detach().to(torch.bfloat16).contiguous()
    w2f = w2.detach().float().contiguous()
    b1f = b1.detach().float().contiguous()
    b2f = b2.detach().float().contiguous()
    part = torch.empty(-(-a // _TILE_A), n * p, g, dtype=torch.float32,
                       device=x.device)
    out = torch.empty(n, g * d, dtype=torch.bfloat16, device=x.device)
    lib = _library()
    with on_card(x.device):
        rc = lib.glimpse_attention_launch(
            x.data_ptr(), w1b.data_ptr(), b1f.data_ptr(), w2f.data_ptr(),
            b2f.data_ptr(), v.data_ptr(), part.data_ptr(), out.data_ptr(),
            n, p, c, a, g, d, int(uniform_quirk),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"glimpse_attention launch failed: CUDA error {rc} "
            f"({lib.glimpse_error_string(rc).decode()})"
        )
    launch_count += 1
    return out


@torch.library.custom_op("vqa::glimpse_attention", mutates_args=(),
                         device_types="cpu")
def glimpse_attention_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor, v: torch.Tensor,
                         uniform_quirk: bool) -> torch.Tensor:
    """K7 as an op; on a CPU tensor, the plain version."""
    return glimpse_attention_reference(x, w1, b1, w2, b2, v,
                                       uniform_quirk=uniform_quirk)


@glimpse_attention_op.register_kernel("cuda")
def _glimpse_attention_on_the_card(x, w1, b1, w2, b2, v, uniform_quirk):
    return glimpse_attention_cuda(x, w1, b1, w2, b2, v,
                                  uniform_quirk=uniform_quirk)


@glimpse_attention_op.register_fake
def _glimpse_attention_shape(x, w1, b1, w2, b2, v, uniform_quirk):
    return x.new_empty((x.shape[0], w2.shape[0] * v.shape[2]))


def glimpse_attention(
    x: torch.Tensor,  # [N, P, C] features the MLP scores
    w1: torch.Tensor, b1: torch.Tensor,  # [A, C], [A] (PyTorch layout)
    w2: torch.Tensor, b2: torch.Tensor,  # [G, A], [G]
    v: torch.Tensor,  # [N, P, D] values to pool
    *,
    uniform_quirk: bool,
    reference_kernel: bool = False,
) -> torch.Tensor:
    """-> [N, G*D] in x's dtype: K7 at bf16 under ``VQA_PALLAS_GLIMPSE``
    (the op: its plain version on a CPU tensor), the plain version else.
    ``reference_kernel=True`` runs the plain version on any device, for
    the comparisons of the tests and ``chip_smoke.py`` only."""
    use_kernel = (x.dtype == torch.bfloat16
                  and os.environ.get("VQA_PALLAS_GLIMPSE")
                  and not kernels_disabled() and not reference_kernel)
    if use_kernel:
        return glimpse_attention_op(x, w1, b1, w2, b2, v, uniform_quirk)
    return glimpse_attention_reference(x, w1, b1, w2, b2, v,
                                       uniform_quirk=uniform_quirk)
