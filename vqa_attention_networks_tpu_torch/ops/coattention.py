"""The parallel co-attention core of hieCoAtten (port of
``vqa_attention_networks_tpu/ops/pallas_coattention.py``), kernel K4.

Per sample, with img, cv, img_w [L, E] and que, cq, que_w [T, E]:

    C   = tanh(Cq . Cv^T)                [T, L]   f32, rounded to the inputs'
                                                  dtype
    Hv  = tanh(img_w + C^T . que_w)      [L, E]   f32, rounded
    Hq  = tanh(que_w + C . img_w)        [T, E]   f32, rounded
    av  = softmax_L(Hv . whv)            [L]      f32
    aq  = softmax_T(Hq . whq)            [T]      f32
    v   = av^T . img,  q = aq^T . que    [E]      f32

The products take the input dtype's operands with f32 accumulation. The
biases of ``fc_Whv`` and ``fc_Whq`` are dropped, exactly: each adds one
constant to every position of its softmax, which is shift-invariant.

- ``coattention_core`` calls the custom op ``torch.ops.vqa.
  coattention_core``, which dispatches by device: a CPU tensor goes to the
  plain PyTorch version, a CUDA tensor to the hand-written kernel
  (``csrc/coattention.cu``), which raises on an input it does not take.
  Nothing catches an error to fall back. The op's fake implementation
  gives its outputs' shapes, so ``torch.export`` keeps the call as one
  node (``aot.export_serving``).
- ``coattention_core_reference`` is the plain version, with the kernel's
  rounding points (``pallas_coattention.py:54-82``).
- ``launch_count`` counts the kernel launches.

The TPU kernel's ``n % 8`` gate is its block shape (8 samples per grid
step); this kernel runs one sample per block and takes any N.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from vqa_attention_networks_tpu_torch.ops import on_card

_MAX_T = 32  # the kernel pads T to 32 rows, two m16 tiles of its products
_MAX_L = 1024  # the kernel keeps C [32, L] and the logits in shared memory
_MAX_SMEM = 232448  # bytes of shared memory a block can opt in to
# the kernel's ring (coattention.cu): 4 stages of two [32, 128] bf16 tiles,
# rows padded by 8 elements; 8 warps; phase 4's 4 row groups
_STAGES, _ROWS, _COLS, _LD, _WARPS, _GROUPS = 4, 32, 128, 136, 8, 4
_REFERENCE_CHUNK = 64  # samples per step of the plain version (memory)

# kernel launches made by coattention_core (one per call on a CUDA tensor)
launch_count = 0

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def coattention_core_reference(img, que, cv, cq, img_w, que_w, whv,
                               whq) -> Outputs:
    """The plain PyTorch version -> (v [N, E], q [N, E], av [N, L],
    aq [N, T]), all f32. ``whv`` and ``whq`` hold E values each (any
    shape, e.g. the JAX layout [E, 1])."""
    dt = img.dtype
    f32 = torch.float32
    wv = whv.reshape(-1).to(dt).to(f32)
    wq = whq.reshape(-1).to(dt).to(f32)
    outs = []
    for s in range(0, img.shape[0], _REFERENCE_CHUNK):
        sl = slice(s, s + _REFERENCE_CHUNK)
        cv_, cq_ = cv[sl].to(dt).to(f32), cq[sl].to(dt).to(f32)
        iw, qw = img_w[sl].to(dt).to(f32), que_w[sl].to(dt).to(f32)
        c = torch.tanh(torch.matmul(cq_, cv_.transpose(1, 2))).to(dt).to(f32)
        hv = torch.tanh(iw + torch.matmul(c.transpose(1, 2), qw)).to(dt)
        hq = torch.tanh(qw + torch.matmul(c, iw)).to(dt)
        av = torch.softmax(torch.matmul(hv.to(f32), wv), dim=1)  # [n, L]
        aq = torch.softmax(torch.matmul(hq.to(f32), wq), dim=1)  # [n, T]
        v = torch.sum(av[:, :, None] * img[sl].to(f32), dim=1)
        q = torch.sum(aq[:, :, None] * que[sl].to(f32), dim=1)
        outs.append((v, q, av, aq))
    return tuple(torch.cat(parts) for parts in zip(*outs))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from vqa_attention_networks_tpu_torch.ops import _build

    lib = _build.load("coattention")
    p, i = ctypes.c_void_p, ctypes.c_int
    # img que cv cq img_w que_w whv whq v q av aq, n l t e, stream
    lib.coattention_launch.argtypes = [p] * 12 + [i] * 4 + [p]
    lib.coattention_launch.restype = ctypes.c_int
    lib.coattention_smem_bytes.argtypes = [i]  # l
    lib.coattention_smem_bytes.restype = ctypes.c_int
    lib.coattention_error_string.argtypes = [ctypes.c_int]
    lib.coattention_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(img, que, cv, cq, img_w, que_w, whv, whq) -> None:
    if img.device.type != "cuda":
        raise ValueError(f"the K4 kernel needs a CUDA tensor, got "
                         f"{img.device}")
    if img.dim() != 3 or que.dim() != 3:
        raise ValueError(f"img must be [N, L, E] and que [N, T, E], got "
                         f"{tuple(img.shape)} and {tuple(que.shape)}")
    n, l, e = img.shape
    t = que.shape[1]
    for name, x, shape in (("img", img, (n, l, e)), ("cv", cv, (n, l, e)),
                           ("img_w", img_w, (n, l, e)),
                           ("que", que, (n, t, e)), ("cq", cq, (n, t, e)),
                           ("que_w", que_w, (n, t, e))):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the K4 kernel takes bf16 activations, got "
                            f"{name} {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != img.device:
            raise ValueError(f"img is on {img.device} but {name} on "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"the K4 kernel needs a contiguous {name}")
        if x.data_ptr() % 4:
            # rows are copied 4 or 16 bytes at a time
            raise ValueError(f"the K4 kernel needs {name} 4-byte aligned")
    for name, w in (("whv", whv), ("whq", whq)):
        if w.numel() != e or w.device != img.device:
            raise ValueError(f"{name} must hold E={e} values on "
                             f"{img.device}, got {tuple(w.shape)} on "
                             f"{w.device}")
    check_shape(n, l, t, e)


def smem_bytes(l: int) -> int:
    """Bytes of shared memory a block of the kernel takes at L = l
    (``coattention.cu`` ``smem_bytes``): the ring, C [32, Lp + 8] bf16 and,
    in f32, the logits' partials [Lp, 8] (later the pool's [2, 4, 128] in
    the same place) and [32, 8], av [Lp], aq [32] and the softmax's 8,
    with Lp = L padded to 32. E streams through the ring in slices and
    takes none."""
    lp = -(-l // _ROWS) * _ROWS
    parts = max(lp * _WARPS, 2 * _GROUPS * _COLS)
    return (_STAGES * 2 * _ROWS * _LD * 2 + _MAX_T * (lp + 8) * 2
            + 4 * (parts + _MAX_T * _WARPS + lp + _MAX_T + _WARPS))


def check_shape(n: int, l: int, t: int, e: int) -> None:
    """Raise ValueError on a shape the kernel does not take (the gate of
    ``coattention_launch``): 1 <= N < 2^31, 1 <= L <= 1024, 1 <= T <= 32,
    an even E >= 2, and the block's shared memory within the card's."""
    if e < 2 or e % 2:
        raise ValueError(f"the K4 kernel needs E % 2 == 0, got E={e}")
    if not 1 <= t <= _MAX_T or not 1 <= l <= _MAX_L:
        raise ValueError(f"the K4 kernel takes 1 <= T <= {_MAX_T} and "
                         f"1 <= L <= {_MAX_L}, got T={t}, L={l}")
    if not 1 <= n <= 2 ** 31 - 1:
        raise ValueError(f"the K4 kernel takes 1 <= N < 2^31, got N={n}")
    smem = smem_bytes(l)
    if smem > _MAX_SMEM:
        raise ValueError(f"the K4 kernel needs {smem} bytes of shared "
                         f"memory at L={l}; a block has {_MAX_SMEM}")


def coattention_core_cuda(img, que, cv, cq, img_w, que_w, whv,
                          whq) -> Outputs:
    """Launch the hand-written kernel -> (v, q, av, aq), all f32. Raises on
    an input it does not take and on a refused launch."""
    global launch_count
    _check_inputs(img, que, cv, cq, img_w, que_w, whv, whq)
    n, l, e = img.shape
    t = que.shape[1]
    wv = whv.reshape(-1).to(torch.bfloat16).contiguous()
    wq = whq.reshape(-1).to(torch.bfloat16).contiguous()
    dev = img.device
    v = torch.empty(n, e, dtype=torch.float32, device=dev)
    q = torch.empty(n, e, dtype=torch.float32, device=dev)
    av = torch.empty(n, l, dtype=torch.float32, device=dev)
    aq = torch.empty(n, t, dtype=torch.float32, device=dev)
    lib = _library()
    with on_card(dev):
        rc = lib.coattention_launch(
            img.data_ptr(), que.data_ptr(), cv.data_ptr(), cq.data_ptr(),
            img_w.data_ptr(), que_w.data_ptr(), wv.data_ptr(), wq.data_ptr(),
            v.data_ptr(), q.data_ptr(), av.data_ptr(), aq.data_ptr(),
            n, l, t, e, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"coattention launch failed: CUDA error {rc} "
            f"({lib.coattention_error_string(rc).decode()})"
        )
    launch_count += 1
    return v, q, av, aq


@torch.library.custom_op("vqa::coattention_core", mutates_args=(),
                         device_types="cpu")
def coattention_core_op(img: torch.Tensor, que: torch.Tensor,
                        cv: torch.Tensor, cq: torch.Tensor,
                        img_w: torch.Tensor, que_w: torch.Tensor,
                        whv: torch.Tensor, whq: torch.Tensor,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """K4 as an op; on a CPU tensor, the plain version."""
    return coattention_core_reference(img, que, cv, cq, img_w, que_w, whv,
                                      whq)


@coattention_core_op.register_kernel("cuda")
def _coattention_core_on_the_card(img, que, cv, cq, img_w, que_w, whv,
                                  whq):
    return coattention_core_cuda(img, que, cv, cq, img_w, que_w, whv, whq)


@coattention_core_op.register_fake
def _coattention_core_shapes(img, que, cv, cq, img_w, que_w, whv, whq):
    n, l, e = img.shape
    f32 = torch.float32
    return (img.new_empty((n, e), dtype=f32), img.new_empty((n, e), dtype=f32),
            img.new_empty((n, l), dtype=f32),
            img.new_empty((n, que.shape[1]), dtype=f32))


def coattention_core(img, que, cv, cq, img_w, que_w, whv, whq, *,
                     reference_kernel: bool = False) -> Outputs:
    """Dispatching entry -> (v [N, E], q [N, E], av [N, L], aq [N, T]), all
    f32: the op, which runs the plain version on a CPU tensor and the
    kernel on a CUDA tensor. ``reference_kernel=True`` runs the plain
    version on any device, for the comparisons of the tests and
    ``chip_smoke.py`` only."""
    if reference_kernel:
        return coattention_core_reference(img, que, cv, cq, img_w, que_w,
                                          whv, whq)
    return coattention_core_op(img, que, cv, cq, img_w, que_w, whv, whq)
