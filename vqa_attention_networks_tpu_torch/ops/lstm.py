"""Inference LSTM with the recurrence as one kernel (port of
``vqa_attention_networks_tpu/ops/pallas_lstm.py``), kernel K8.

``lstm_seq`` hoists the input projection out of the recurrence as the JAX
function does (``pallas_lstm.py:137-146``): ``xp = x @ W_ih`` in x's dtype,
then ``+ bf16(b_ih + b_hh)``, a plain ``torch.matmul`` (outside the Pallas
kernel in JAX as well). The scan, gates in PyTorch's order i, f, g, o,
rounds at the TPU kernel's points (``pallas_lstm.py:46-71``):

    gates = f32(bf16(xp[:, t])) + bf16(h) @ bf16(W_hh)^T    f32 accumulate
    c     = sigmoid(f) * c + sigmoid(i) * tanh(g)            f32 carry
    h     = sigmoid(o) * tanh(c)                             bf16 carry
    out   = h in xp's dtype

This is not ``models.layers.lstm``, which keeps the gates and both carries
in the compute dtype (the JAX docstring, ``pallas_lstm.py:25-26``, calls
that composed scan the looser one). Weights are in the layout of
``layers.LSTM``: W_ih [4H, E], W_hh [4H, H].

- ``lstm_scan`` dispatches: a CPU tensor goes to the plain version
  ``lstm_scan_reference``, a CUDA tensor to the hand-written kernel
  (``csrc/lstm_scan.cu``, one launch per time step), which raises on an
  input it does not take. Nothing catches an error to fall back.
- ``supported`` mirrors the JAX gate (``pallas_lstm.py:123-134``): bf16 and
  H % 128 == 0, with a CUDA tensor in place of the TPU target.
- ``launch_count`` counts the kernel's calls (each one launches the step
  kernel T times).

No model of the JAX package dispatches K8 (``pallas_lstm.py:6-15``), and
none of the port does: the models keep ``layers.lstm``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

_LANE = 128
_UNITS = 32  # hidden units per block of the kernel

# kernel calls made by lstm_scan (each launches the step kernel T times)
launch_count = 0


def input_projection(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
                     b_hh: torch.Tensor) -> torch.Tensor:
    """x [N, T, E] -> xp [N, T, 4H] in x's dtype: the product rounded to
    x's dtype, then the two biases, summed first, in that dtype."""
    dtype = x.dtype
    return torch.matmul(x, w_ih.to(dtype).t()) + (b_ih + b_hh).to(dtype)


def lstm_scan_reference(x_proj: torch.Tensor, w_hh: torch.Tensor,
                        h_carry: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The plain PyTorch version of K8: x_proj [N, T, 4H], W_hh [4H, H] ->
    all hidden states [N, T, H] in x_proj's dtype, on any device.

    With ``h_carry`` [N, T, H] (another run's output), step t takes
    bf16(h_carry[:, t-1]) as its h in place of its own: each step of that
    run recomputed from the carry it was given, so that a comparison sees
    one step's rounding, not its growth through the later steps."""
    n, t, four_h = x_proj.shape
    hidden = four_h // 4
    xp = x_proj.to(torch.bfloat16).float()
    w = w_hh.to(torch.bfloat16).float().t()  # [H, 4H]
    h = torch.zeros(n, hidden, device=x_proj.device)  # bf16 values
    c = torch.zeros(n, hidden, device=x_proj.device)
    hs = []
    for step in range(t):
        gates = xp[:, step] + torch.matmul(h, w)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h_new.to(x_proj.dtype))
        if h_carry is not None:
            h_new = h_carry[:, step]
        h = h_new.to(torch.bfloat16).float()
    return torch.stack(hs, dim=1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from vqa_attention_networks_tpu_torch.ops import _build

    lib = _build.load("lstm_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    # xp w_hh c out, n t h, stream
    lib.lstm_scan_launch.argtypes = [p] * 4 + [i] * 3 + [p]
    lib.lstm_scan_launch.restype = ctypes.c_int
    lib.lstm_scan_error_string.argtypes = [ctypes.c_int]
    lib.lstm_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(x_proj: torch.Tensor, w_hh: torch.Tensor) -> None:
    if x_proj.device.type != "cuda":
        raise ValueError(
            f"the K8 kernel needs a CUDA tensor, got {x_proj.device}")
    if x_proj.dtype != torch.bfloat16:
        raise TypeError(f"the K8 kernel takes a bf16 x_proj, got "
                        f"{x_proj.dtype}")
    if x_proj.dim() != 3 or w_hh.dim() != 2:
        raise ValueError(f"x_proj must be [N, T, 4H] and W_hh [4H, H], got "
                         f"{tuple(x_proj.shape)} and {tuple(w_hh.shape)}")
    n, t, four_h = x_proj.shape
    hidden = four_h // 4
    if four_h % 4 or tuple(w_hh.shape) != (four_h, hidden):
        raise ValueError(f"x_proj {tuple(x_proj.shape)} and W_hh "
                         f"{tuple(w_hh.shape)} do not agree")
    if w_hh.device != x_proj.device:
        raise ValueError(f"x_proj is on {x_proj.device} but W_hh on "
                         f"{w_hh.device}")
    if hidden % _UNITS:
        # blocks own 32 hidden units; rows are read as 16-byte vectors
        raise ValueError(f"the K8 kernel needs H % {_UNITS} == 0, got "
                         f"H={hidden}")
    if not 1 <= n <= 65535 * 64 or t < 1:
        raise ValueError(f"the K8 kernel takes 1 <= N <= {65535 * 64} and "
                         f"T >= 1, got N={n}, T={t}")


def lstm_scan_cuda(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Launch the hand-written kernel -> bf16 [N, T, H]. Raises on an input
    it does not take and on a refused launch."""
    global launch_count
    _check_inputs(x_proj, w_hh)
    n, t, four_h = x_proj.shape
    hidden = four_h // 4
    xp = x_proj.contiguous()
    w = w_hh.to(torch.bfloat16).contiguous()
    if xp.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the K8 kernel needs x_proj and W_hh 16-byte aligned")
    c = torch.empty(n, hidden, dtype=torch.float32, device=xp.device)
    out = torch.empty(n, t, hidden, dtype=torch.bfloat16, device=xp.device)
    lib = _library()
    rc = lib.lstm_scan_launch(
        xp.data_ptr(), w.data_ptr(), c.data_ptr(), out.data_ptr(), n, t,
        hidden, torch.cuda.current_stream(xp.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lstm_scan launch failed: CUDA error {rc} "
                           f"({lib.lstm_scan_error_string(rc).decode()})")
    launch_count += 1
    return out


def lstm_scan(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Dispatching scan -> [N, T, H]: the plain version for a CPU tensor,
    the kernel for a CUDA tensor."""
    if x_proj.device.type == "cpu":
        return lstm_scan_reference(x_proj, w_hh)
    return lstm_scan_cuda(x_proj, w_hh)


def supported(x: torch.Tensor, hdim: int) -> bool:
    """Whether ``lstm_seq`` may take x on its kernel: a bf16 CUDA tensor
    and H % 128 == 0."""
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and hdim % _LANE == 0)


def lstm_seq(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
             b_ih: torch.Tensor, b_hh: torch.Tensor,
             nb: Optional[int] = None) -> torch.Tensor:
    """Inference LSTM over x [N, T, E] -> all hidden states [N, T, H], the
    entry of ``pallas_lstm.py`` (callers gate on ``supported``). ``nb`` is
    the TPU kernel's batch tile: an explicit one must divide N, as there;
    the card's kernel tiles the rows itself, which are independent."""
    n = x.shape[0]
    if nb is not None and n % nb:
        raise ValueError(
            f"explicit nb={nb} does not divide batch {n} — a silent "
            "fallback would benchmark a different tile size")
    return lstm_scan(input_projection(x, w_ih, b_ih, b_hh), w_hh)
