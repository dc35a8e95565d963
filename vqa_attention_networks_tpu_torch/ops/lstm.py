"""Inference LSTM with the recurrence as one kernel (port of
``vqa_attention_networks_tpu/ops/pallas_lstm.py``), kernel K8.

``lstm_seq`` hoists the input projection out of the recurrence as the JAX
function does (``pallas_lstm.py:137-146``): ``xp = x @ W_ih`` in x's dtype,
a plain ``torch.matmul`` (outside the Pallas kernel in JAX as well), then
``+ bf16(b_ih + b_hh)`` in x's dtype: on the card the kernel adds the bias
as it reads xp, with the same rounding, which saves a pass over xp. The
scan, gates in PyTorch's order i, f, g, o, rounds at the TPU kernel's
points (``pallas_lstm.py:46-71``):

    gates = f32(bf16(xp[:, t])) + bf16(h) @ bf16(W_hh)^T    f32 accumulate
    c     = sigmoid(f) * c + sigmoid(i) * tanh(g)            f32 carry
    h     = sigmoid(o) * tanh(c)                             bf16 carry
    out   = h in xp's dtype

This is not ``models.layers.lstm``, which keeps the gates and both carries
in the compute dtype (the JAX docstring, ``pallas_lstm.py:25-26``, calls
that composed scan the looser one). Weights are in the layout of
``layers.LSTM``: W_ih [4H, E], W_hh [4H, H].

- ``lstm_seq`` dispatches: a CPU tensor goes to the plain version
  ``lstm_scan_reference``, a CUDA tensor to the hand-written kernel
  ``lstm_scan_cuda`` (``csrc/lstm_scan.cu``: the whole scan in one
  cooperative launch, W_hh's slices kept in shared memory across the
  steps, c beside them where it fits, a barrier over each row group
  between them; the bias of the projection is added in the kernel), which
  raises on an input it does not take. Nothing catches an error to fall back.
- ``geometry`` is the kernel's grid and shared memory, in plain Python. It
  takes any N, and H from 128 to 1280 in steps of 128: W_hh's slices must
  fit in the shared memory of blocks that all run at once (one per SM), and
  at H = 2048 W_hh (32 MB) is more than the whole card's shared memory.
- ``supported`` mirrors the JAX gate (``pallas_lstm.py:123-134``): bf16 and
  H % 128 == 0, with a CUDA tensor in place of the TPU target, and a shape
  that ``geometry`` takes; no kernel under ``VQA_DISABLE_PALLAS``.
- ``launch_count`` counts the kernel's launches, one per call.

No model of the JAX package dispatches K8 (``pallas_lstm.py:6-15``), and
none of the port does: the models keep ``layers.lstm``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from vqa_attention_networks_tpu_torch.ops import kernels_disabled, on_card

_LANE = 128
# the kernel's constants (csrc/lstm_scan.cu): hidden units per block, rows
# per product tile, the h ring's depth, and its least and most stages
UNITS = 16
_TILE_ROWS, _DEPTH = 128, 64
_MIN_STAGES, _MAX_STAGES = 3, 8
SM90_SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block may have
H100_SMS = 132

# kernel launches made by lstm_scan_cuda (one per call)
launch_count = 0


class Geometry(NamedTuple):
    blocks: int  # one per SM at most: (H / UNITS) unit tiles x row groups
    units_per_block: int
    rows_per_block: int
    stages: int  # of the h ring, all but one in flight
    smem_bytes: int  # dynamic shared memory per block
    barriers: int  # per call, each over a row group's blocks: T - 1
    c_in_smem: bool  # c in shared memory, else in an f32 [N, H] scratch


def geometry(n: int, t: int, hdim: int, sms: int = H100_SMS) -> Geometry:
    """The persistent kernel's grid for N rows, T steps and H hidden units
    on a card of ``sms`` SMs. A block owns UNITS hidden units (their 4
    gates' rows of W_hh stay in its shared memory) and a group of rows,
    which it walks in tiles of 128; the row groups are as many as the SMs
    allow, none empty. c takes the block's shared memory where it fits
    beside W_hh and 3 stages of the ring, else an f32 scratch in device
    memory, so N is not bounded. The h ring takes as many stages as the
    shared memory left holds, up to 8. Raises on a shape the kernel does
    not take: H % 128 != 0 (the JAX gate), more unit tiles than SMs, or
    less shared memory than W_hh's slice and 3 stages need (H > 1280)."""
    if hdim < _LANE or hdim % _LANE:
        raise ValueError(f"the K8 kernel needs H % {_LANE} == 0, got "
                         f"H={hdim}")
    if n < 1 or t < 1:
        raise ValueError(f"the K8 kernel takes N >= 1 and T >= 1, got N={n}, "
                         f"T={t}")
    unit_tiles = hdim // UNITS
    if unit_tiles > sms:
        raise ValueError(f"H={hdim} needs {unit_tiles} blocks of {UNITS} "
                         f"units, more than the card's {sms} SMs")
    groups = max(1, min(sms // unit_tiles, -(-n // 32)))
    rows = -(-n // groups)
    groups = -(-n // rows)
    fixed = 4 * UNITS * (hdim + 8) * 2  # W_hh's slice
    stage = _TILE_ROWS * (_DEPTH + 8) * 2
    c_in_smem = (fixed + rows * UNITS * 4 + _MIN_STAGES * stage
                 <= SM90_SMEM_PER_BLOCK)
    if c_in_smem:
        fixed += rows * UNITS * 4
    stages = min(_MAX_STAGES, (SM90_SMEM_PER_BLOCK - fixed) // stage)
    if stages < _MIN_STAGES:
        raise ValueError(
            f"the K8 kernel needs {fixed + _MIN_STAGES * stage} bytes of "
            f"shared memory a block at H={hdim}, more than "
            f"{SM90_SMEM_PER_BLOCK}")
    return Geometry(unit_tiles * groups, UNITS, rows, stages,
                    fixed + stages * stage, t - 1, c_in_smem)


def _aligned(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """x [..., E] and W [4H, E] with E padded by zeros to a multiple of 8."""
    pad = -x.shape[-1] % 8
    return F.pad(x, (0, pad)), F.pad(w, (0, pad))


def _project(x: torch.Tensor, w_ih: torch.Tensor) -> torch.Tensor:
    """x @ W_ih^T in x's dtype. On the card an E that is not a multiple of
    8 (mhb_coAtt's 300) is padded with zeros to one: rows of unaligned
    length keep the library's matrix product off its fast kernels. The
    zeros add nothing; the f32 sums may run in another order."""
    w = w_ih.to(x.dtype)
    if x.device.type == "cuda" and x.shape[-1] % 8:
        x, w = _aligned(x, w)
    return torch.matmul(x, w.t())


def input_projection(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
                     b_hh: torch.Tensor) -> torch.Tensor:
    """x [N, T, E] -> xp [N, T, 4H] in x's dtype: the product rounded to
    x's dtype, then the two biases, summed first, in that dtype."""
    return _project(x, w_ih) + (b_ih + b_hh).to(x.dtype)


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
    # xp bias w_hh out c counter, n t h blocks rows_per_block stages smem,
    # stream
    lib.lstm_scan_launch.argtypes = [p] * 6 + [i] * 7 + [p]
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
    if n * t * four_h >= 2 ** 31:
        raise ValueError(f"N*T*4H must stay below 2^31, got N={n}, T={t}")


def lstm_scan_cuda(x_proj: torch.Tensor, w_hh: torch.Tensor,
                   bias: torch.Tensor,
                   counter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the hand-written kernel -> bf16 [N, T, H]. ``x_proj`` is
    x @ W_ih without the bias, and the kernel adds ``bias`` (bf16 [4H]) in
    bf16 as ``input_projection`` does (one pass over xp fewer). ``counter``
    takes the barriers' arrivals: int32 zeros, one per row group of
    ``geometry``; by default the wrapper makes its own. Raises on an input
    it does not take and on a refused launch (among them
    cudaErrorCooperativeLaunchTooLarge: the blocks do not all fit on the
    card at once)."""
    global launch_count
    _check_inputs(x_proj, w_hh)
    if (bias.dtype != torch.bfloat16 or bias.device != x_proj.device
            or tuple(bias.shape) != (x_proj.shape[2],)):
        raise ValueError(f"bias must be bf16 [{x_proj.shape[2]}] on "
                         f"{x_proj.device}")
    n, t, four_h = x_proj.shape
    hidden = four_h // 4
    geo = geometry(n, t, hidden, torch.cuda.get_device_properties(
        x_proj.device).multi_processor_count)
    groups = geo.blocks // (hidden // UNITS)
    if counter is None:
        counter = torch.zeros(groups, dtype=torch.int32, device=x_proj.device)
    elif (counter.dtype != torch.int32 or tuple(counter.shape) != (groups,)
          or counter.device != x_proj.device):
        raise ValueError(f"counter must be int32 [{groups}] on "
                         f"{x_proj.device}")
    xp = x_proj.contiguous()
    w = w_hh.to(torch.bfloat16).contiguous()
    if xp.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the K8 kernel needs x_proj and W_hh 16-byte aligned")
    out = torch.empty(n, t, hidden, dtype=torch.bfloat16, device=xp.device)
    c = None if geo.c_in_smem else torch.empty(
        n, hidden, dtype=torch.float32, device=xp.device)
    lib = _library()
    with on_card(xp.device):
        rc = lib.lstm_scan_launch(
            xp.data_ptr(), bias.contiguous().data_ptr(), w.data_ptr(),
            out.data_ptr(), None if c is None else c.data_ptr(),
            counter.data_ptr(), n, t, hidden,
            geo.blocks, geo.rows_per_block, geo.stages, geo.smem_bytes,
            torch.cuda.current_stream(xp.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lstm_scan launch failed: CUDA error {rc} "
                           f"({lib.lstm_scan_error_string(rc).decode()})")
    launch_count += 1
    return out


def supported(x: torch.Tensor, hdim: int) -> bool:
    """Whether ``lstm_seq`` may take x [N, T, E] on its kernel: a bf16 CUDA
    tensor, H % 128 == 0 and a shape ``geometry`` takes on x's card, unless
    ``VQA_DISABLE_PALLAS`` is set."""
    if kernels_disabled():
        return False
    if not (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and hdim % _LANE == 0):
        return False
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    try:
        geometry(x.shape[0], x.shape[1], hdim, sms)
    except ValueError:
        return False
    return True


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
    if x.device.type == "cpu":
        return lstm_scan_reference(input_projection(x, w_ih, b_ih, b_hh),
                                   w_hh)
    # on the card the kernel adds the bias, in bf16, as input_projection
    return lstm_scan_cuda(_project(x, w_ih), w_hh,
                          bias=(b_ih + b_hh).to(x.dtype))
