"""The layers the references share, each a plain PyTorch expression.

Every product goes through ``Precision.cast`` on both operands: identity for
the reference (float32), a per-tensor scaled float8 (e4m3) rounding for
the control, the precision below the bfloat16 the configurations serve
and train in, and a bfloat16 rounding for the look at what the
configuration's own precision moves. The rounding passes the gradient
straight through.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

Params = Dict[str, torch.Tensor]  # "layer/leaf" -> tensor, JAX layout [in, out]
FP8_MAX = 448.0  # float8 e4m3's largest finite value


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    """How the operands of every product are rounded."""

    ROUNDINGS = {"float32": None, "bfloat16": _Bf16, "float8": _Fp8}

    def __init__(self, name: str = "float32"):
        if name not in self.ROUNDINGS:
            raise ValueError(f"precision {name!r}: one of "
                             f"{sorted(self.ROUNDINGS)}")
        self.name = name

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        rounding = self.ROUNDINGS[self.name]
        return x if rounding is None else rounding.apply(x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.cast(a), self.cast(b))


FLOAT32 = Precision("float32")


def exact_products() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dense(x: torch.Tensor, p: Params, name: str,
          prec: Precision) -> torch.Tensor:
    return prec.mm(x, p[f"{name}/w"]) + p[f"{name}/b"]


def lstm(x: torch.Tensor, p: Params, name: str,
         prec: Precision) -> torch.Tensor:
    """One-layer LSTM, gates i, f, g, o, zero initial state -> [N, T, H]."""
    n, t, _ = x.shape
    w_hh = p[f"{name}/w_hh"]
    hidden = w_hh.shape[0]
    xp = prec.mm(x, p[f"{name}/w_ih"]) + p[f"{name}/b_ih"] + p[f"{name}/b_hh"]
    h = x.new_zeros(n, hidden)
    c = x.new_zeros(n, hidden)
    out = []
    for s in range(t):
        gates = xp[:, s] + prec.mm(h, w_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=1)


class _SignedSqrt(torch.autograd.Function):
    """sqrt(relu(x)) - sqrt(relu(-x)); gradient g / (2 sqrt|x|), 0 at 0."""

    @staticmethod
    def forward(ctx, x):
        root = torch.sqrt(x.abs())
        ctx.save_for_backward(x, root)
        return torch.sign(x) * root

    @staticmethod
    def backward(ctx, g):
        x, root = ctx.saved_tensors
        return torch.where(x == 0, torch.zeros_like(g), g / (2 * root))


def signed_sqrt(x: torch.Tensor) -> torch.Tensor:
    return _SignedSqrt.apply(x)


@contextlib.contextmanager
def rounded_sqrt_inputs(on: bool = True, seed: int = 99):
    """While it is open (and ``on``), every ``signed_sqrt`` first moves each
    element of its input by a uniform share of up to 2^-8 of itself, about
    bfloat16's rounding, the rest float32: the look at how far rounding
    alone moves what a signed square root near 0 amplifies."""
    global signed_sqrt
    plain = signed_sqrt
    if on:
        def moved(x):
            gen = torch.Generator(device=x.device).manual_seed(seed)
            u = torch.rand(x.shape, generator=gen, device=x.device) * 2 - 1
            return plain(x * (1 + u * 2.0 ** -8))
        signed_sqrt = moved
    try:
        yield
    finally:
        signed_sqrt = plain


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(-1, keepdim=True)).clamp_min(eps)


def sum_pool(z: torch.Tensor, k: int) -> torch.Tensor:
    """[..., O*k] (output-major) -> [..., O]."""
    return z.reshape(*z.shape[:-1], -1, k).sum(-1)


def glimpse_pool(logits: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Softmax over the positions of each glimpse, then the weighted sum:
    logits [N, P, G], values [N, P, D] -> [N, G*D], glimpse-major."""
    weights = torch.softmax(logits, dim=1).transpose(1, 2)
    return torch.matmul(weights, values).reshape(values.shape[0], -1)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout, the mask ``uniform < 1 - rate`` drawn from
    ``generator`` over x's whole shape on x's device."""
    if generator is None or rate <= 0:
        return x
    keep = 1.0 - rate
    noise = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(noise < keep, x / keep, torch.zeros_like(x))


def soft_cross_entropy(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """KL(targets || softmax(logits)), the mean over every element."""
    log_t = torch.log(torch.where(targets > 0, targets,
                                  torch.ones_like(targets)))
    elem = targets * (log_t - torch.log_softmax(logits, dim=-1))
    return elem.sum() / elem.numel()


def dense_soft(idx: torch.Tensor, val: torch.Tensor,
               answers: int) -> torch.Tensor:
    """[N, W] answer ids (-1 padding) and shares -> [N, answers]."""
    out = torch.zeros(idx.shape[0], answers + 1, device=idx.device)
    out.scatter_add_(1, torch.where(idx < 0, answers, idx).long(), val)
    return out[:, :answers]


Forward = Callable[..., torch.Tensor]
