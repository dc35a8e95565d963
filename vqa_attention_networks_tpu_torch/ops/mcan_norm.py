"""MCAN's LayerNorm after a residual add, ``LN(x + r)``: the composed form
and the fused kernel (``csrc/mcan_layernorm.cu``).

MCAN's LayerNorm (mcan-vqa, ``core/model/net_utils.py``) is

    LN(z) = a * (z - mean) / (std + eps) + b,  eps = 1e-6,

over the last axis, with the *unbiased* standard deviation and eps added to
it, not under the root. ``F.layer_norm`` computes another function (the
biased variance, eps inside the root), so the port computes this one
itself. Both forms share their rounding points: the sum z = x + r rounded
to x's dtype (the residual stream's), the statistics and the affine map in
f32 (the parameters are f32), the output rounded to x's dtype; they differ
only in the order of the f32 sums.

- ``add_layernorm_composed``: plain PyTorch, differentiable: the CPU, the
  training forward and ``VQA_DISABLE_PALLAS`` run it.
- ``add_layernorm``: the custom op ``torch.ops.vqa.mcan_add_layernorm``,
  which runs the composed form on a CPU tensor and the kernel on a CUDA
  tensor (bf16 only; it raises on anything else, with no fallback). Being
  an op with a fake implementation, it survives ``torch.export`` and CUDA
  graph capture as one node.
- ``launch_count`` counts the kernel's launches.

The kernel replaces no TPU kernel: the JAX package has no MCAN. Composed,
one norm over MCAN-large's [50,176, 1024] image stream takes 6-8 launches
and as many passes over 103 MB; the kernel reads x and r once and writes
once (``csrc/mcan_layernorm.cu`` says how).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vqa_attention_networks_tpu_torch.ops import on_card

EPS = 1e-6
_MAX_WIDTH = 4096

# kernel launches made by add_layernorm (one per call on a CUDA tensor)
launch_count = 0


def add_layernorm_composed(x: torch.Tensor, r: torch.Tensor,
                           weight: torch.Tensor, bias: torch.Tensor,
                           eps: float = EPS) -> torch.Tensor:
    """``LN(x + r)`` in plain PyTorch, in x's dtype; statistics and affine
    map in (at least) f32."""
    z = x + r
    acc = torch.promote_types(z.dtype, torch.float32)
    zf = z.to(acc)
    mean = zf.mean(-1, keepdim=True)
    std = zf.std(-1, keepdim=True)  # unbiased, as torch.Tensor.std
    y = weight.to(acc) * (zf - mean) / (std + eps) + bias.to(acc)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from vqa_attention_networks_tpu_torch.ops import _build

    lib = _build.load("mcan_layernorm")
    p = ctypes.c_void_p
    lib.mcan_add_layernorm_launch.argtypes = [
        p, p, p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, p]
    lib.mcan_add_layernorm_launch.restype = ctypes.c_int
    lib.mcan_error_string.argtypes = [ctypes.c_int]
    lib.mcan_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"the norm kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16 or r.dtype != torch.bfloat16:
        raise TypeError(f"the norm kernel takes bf16 x and r, got {x.dtype} "
                        f"and {r.dtype}")
    if x.shape != r.shape:
        raise ValueError(f"x {tuple(x.shape)} and r {tuple(r.shape)} differ")
    d = x.shape[-1]
    if d < 2 or d % 8 or d > _MAX_WIDTH:
        raise ValueError(f"the norm kernel needs a width that is a multiple "
                         f"of 8 in [8, {_MAX_WIDTH}], got {d}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (d,):
            raise ValueError(f"{name} must be f32 [{d}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("x", x), ("r", r), ("weight", weight), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the norm kernel needs {name} contiguous and "
                             "16-byte aligned")


def add_layernorm_cuda(x: torch.Tensor, r: torch.Tensor,
                       weight: torch.Tensor, bias: torch.Tensor,
                       eps: float = EPS) -> torch.Tensor:
    """Launch the kernel -> ``LN(x + r)`` bf16. Raises on an input it does
    not take and on a refused launch."""
    global launch_count
    _check_inputs(x, r, weight, bias)
    out = torch.empty_like(x)
    d = x.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with on_card(x.device):
        rc = _library().mcan_add_layernorm_launch(
            x.data_ptr(), r.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            out.data_ptr(), x.numel() // d, d, eps, stream)
    if rc != 0:
        raise RuntimeError(
            f"mcan_add_layernorm launch failed: CUDA error {rc} "
            f"({_library().mcan_error_string(rc).decode()})")
    launch_count += 1
    return out


@torch.library.custom_op("vqa::mcan_add_layernorm", mutates_args=(),
                         device_types="cpu")
def add_layernorm_op(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``LN(x + r)`` as an op; on a CPU tensor, the composed form."""
    return add_layernorm_composed(x, r, weight, bias, eps)


@add_layernorm_op.register_kernel("cuda")
def _add_layernorm_on_the_card(x, r, weight, bias, eps):
    return add_layernorm_cuda(x, r, weight, bias, eps)


@add_layernorm_op.register_fake
def _add_layernorm_shape(x, r, weight, bias, eps):
    return torch.empty_like(x)


def add_layernorm(x: torch.Tensor, r: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Dispatching entry -> ``LN(x + r)``: the op, which runs the composed
    form on a CPU tensor and the kernel on a CUDA tensor."""
    return add_layernorm_op(x, r, weight, bias, eps)
