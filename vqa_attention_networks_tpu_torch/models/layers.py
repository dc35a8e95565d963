"""Shared building blocks (port of ``vqa_attention_networks_tpu/models/layers.py``).

Parameters live in PyTorch's layout inside the modules (``weight`` is
``[out, in]``); ``weights.load_jax_params`` transposes the JAX package's
``[in, out]`` leaves into it. The initialisers return the JAX layout, so a
tree they build loads through the same function as a JAX checkpoint.

Rounding points follow the JAX functions exactly:

- ``dense`` rounds the product to the compute dtype, then adds the bias in
  that dtype: two rounding points (``layers.py:60-68``). ``F.linear`` with a
  bf16 bias fuses the add at f32 and would give one.
- ``lstm`` keeps the gates and both carries, h and c, in the compute dtype,
  with the input projection hoisted out of the loop (``layers.py:127-154``).
  ``nn.LSTM`` (cuDNN) is not used: it moves the rounding points.
- f32 compute means full f32 products (the JAX package asks XLA for
  ``Precision.HIGHEST``); a caller comparing at f32 on a card keeps
  ``torch.backends.cuda.matmul.allow_tf32`` False, its default.

``dropout`` draws its mask from an explicit ``torch.Generator`` on x's
device; a ``GlobalRows`` generator stands for some rows of a larger batch,
and the mask is then those rows of the larger batch's. ``BatchNorm``
(``layers.py:201-254``) computes its train-mode statistics in f32 over the
``valid`` rows and returns them raw: the momentum EMA into its
running-stat buffers belongs to the train step (``train/solver.py``
``merge_batch_stats``), never to the layer.

**Data parallelism.** A rank of a data-parallel run holds a slice of the
global batch, and JAX computes over the global batch: a mean over the
sharded axis is global. Two layers here see that: ``BatchNorm``, whose
statistics sum over every rank's rows (a differentiable all-reduce, so the
gradient flows through them as through JAX's global mean), and
``dropout``, whose mask is the rank's rows of the mask one process draws
for the whole batch (``GlobalRows``). Under tensor parallelism a rank also
holds a column block of the fusion activations, and its mask is that
block of the one process's (``columns``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

Params = Dict[str, torch.Tensor]

# Config.compute_dtype -> torch dtype
DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


# --------------------------------------------------------------------------
# initialisers (JAX layout, drawn from an explicit torch.Generator)
# --------------------------------------------------------------------------

def xavier_uniform(
    generator: torch.Generator, shape: Tuple[int, ...], fan_in: int,
    fan_out: int,
) -> torch.Tensor:
    """PyTorch-convention xavier uniform: U(-a, a), a = sqrt(6/(fi+fo))."""
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -a, a, generator=generator
    )


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               bias: bool = True) -> Params:
    p = {"w": xavier_uniform(generator, (d_in, d_out), d_in, d_out)}
    if bias:
        p["b"] = torch.zeros(d_out)
    return p


def embedding_init(generator: torch.Generator, vocab: int, dim: int) -> Params:
    # PyTorch fans for an [V, E] embedding matrix: fan_in=E, fan_out=V
    return {"table": xavier_uniform(generator, (vocab, dim), dim, vocab)}


def layernorm_init(dim: int) -> Params:
    return {"w": torch.ones(dim), "b": torch.zeros(dim)}


def batchnorm_init(dim: int) -> Params:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim),
            "mean": torch.zeros(dim), "var": torch.ones(dim)}


def lstm_init(generator: torch.Generator, d_in: int, hidden: int) -> Params:
    return {
        "w_ih": xavier_uniform(generator, (d_in, 4 * hidden), d_in, 4 * hidden),
        "w_hh": xavier_uniform(generator, (hidden, 4 * hidden), hidden,
                               4 * hidden),
        "b_ih": torch.zeros(4 * hidden),
        "b_hh": torch.zeros(4 * hidden),
    }


# --------------------------------------------------------------------------
# parameter holders (PyTorch layout; filled by weights.load_jax_params)
# --------------------------------------------------------------------------

class Dense(nn.Module):
    """A projection ``x @ W + b``: the reference's Linear and 1x1 convs."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, dim))

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return embed(self.weight, ids, dtype)


class LSTM(nn.Module):
    """One-layer LSTM, gate order i,f,g,o, with ``nn.LSTM``'s parameter
    names (less the ``_l0`` suffix) and its two separate biases."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, d_in))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.empty(4 * hidden))
        self.bias_hh = nn.Parameter(torch.empty(4 * hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lstm(x, self.weight_ih, self.weight_hh, self.bias_ih,
                    self.bias_hh)


class LayerNorm(nn.Module):
    """MCAN's LayerNorm's parameters (mcan-vqa's ``a_2``, ``b_2``): the
    gain ``weight`` and the ``bias``, leaves ``w`` and ``b`` of the tree,
    neither transposed. A port-only layer (the JAX package has no MCAN);
    ``ops/mcan_norm.py`` computes the norm."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))


class WNDense(nn.Module):
    """A weight-normalised projection, ``weight_norm(Linear, dim=None)``:
    the direction ``weight_v`` [out, in], one scalar gain ``weight_g`` for
    the whole matrix and the ``bias``, leaves ``v``, ``g`` and ``b`` of the
    tree. The weight is ``weight_norm(weight_g, weight_v)``. A port-only
    layer (the JAX package has no BAN)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(d_out, d_in))
        self.weight_g = nn.Parameter(torch.empty(()))
        self.bias = nn.Parameter(torch.empty(d_out))


class GRU(nn.Module):
    """One-layer GRU, gates r, z, n, with ``nn.GRU``'s parameter names (less
    the ``_l0`` suffix), leaves ``w_ih``, ``w_hh``, ``b_ih``, ``b_hh`` as
    the LSTM's. A port-only layer (BAN's question encoder); ``gru``
    computes it."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden, d_in))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.empty(3 * hidden))
        self.bias_hh = nn.Parameter(torch.empty(3 * hidden))


class BatchNorm(nn.Module):
    """BatchNorm1d over axis 0: ``scale`` and ``bias`` are parameters,
    ``mean`` and ``var`` f32 buffers of running statistics, leaves of the
    JAX tree like the other two (``batchnorm_init``)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))
        # the ranks whose rows the train-mode statistics span
        # (``span_batch_statistics``); this process's rows by default
        self.ranks = Ranks()

    def forward(self, x: torch.Tensor, train: bool,
                valid: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Params]:
        """-> (y in x's dtype, this batch's statistics). In train mode the
        statistics are the raw batch mean and unbiased variance over the
        rows where ``valid`` is set (all rows without it), computed in at
        least f32, detached; the output normalises by the biased variance.
        In eval mode the running buffers normalise and come back as the
        statistics. The buffers are never written here. Over ranks of
        more than one (``self.ranks``, a data-parallel trainer's data axis)
        the train-mode statistics are the global batch's, summed over them
        (``_global_moments``), the same on every rank whatever its share of
        pad rows."""
        if train:
            xs = x.to(torch.promote_types(x.dtype, torch.float32))
            group = self.ranks.group
            if group is not None and dist.get_world_size(group) > 1:
                mean, var, n = _global_moments(xs, valid, group)
                unbiased = var * (n / torch.clamp_min(n - 1.0, 1.0))
            elif valid is not None:
                w = valid.to(xs.dtype)
                n = torch.clamp_min(w.sum(), 1.0)
                wn = (w / n)[:, None]
                mean = torch.sum(xs * wn, dim=0)
                var = torch.sum(torch.square(xs - mean) * wn, dim=0)
                unbiased = var * (n / torch.clamp_min(n - 1.0, 1.0))
            else:
                mean = torch.mean(xs, dim=0)
                var = torch.var(xs, dim=0, correction=0)
                n = xs.shape[0]
                unbiased = var * (n / max(n - 1, 1))
            stats = {"mean": mean.detach(), "var": unbiased.detach()}
        else:
            mean, var = self.mean, self.var
            stats = {"mean": mean, "var": var}
        y = (x.to(mean.dtype) - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale + self.bias
        return y.to(x.dtype), stats


class Ranks:
    """The process group a batch norm's statistics span (None: this
    process alone), held by reference: a copy of the model
    (``copy.deepcopy``) spans the same ranks, and a process group cannot
    be copied."""

    def __init__(self, group=None):
        self.group = group

    def __deepcopy__(self, memo):
        return self


def span_batch_statistics(model: nn.Module, group) -> None:
    """Make every ``BatchNorm`` of ``model`` take its train-mode statistics
    over the rows of every rank of ``group`` (a trainer's data axis), as
    JAX's mean over a sharded batch axis is global."""
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.ranks = Ranks(group)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of a group, differentiable: a rank's input
    reaches every rank's output, so its gradient is the sum of every
    rank's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _global_moments(xs: torch.Tensor, valid: Optional[torch.Tensor], group):
    """(mean, biased var, n) over the valid rows of every rank of
    ``group``: the single-process expressions (each row weighted by
    valid / n, then summed), with each sum taken over the ranks by a
    differentiable all-reduce (``_AllReduceSum``)."""
    w = (valid.to(xs.dtype) if valid is not None
         else xs.new_ones(xs.shape[0]))
    count = w.sum().detach().clone()
    dist.all_reduce(count, group=group)
    n = torch.clamp_min(count, 1.0)
    wn = (w / n)[:, None]
    mean = _AllReduceSum.apply(torch.sum(xs * wn, dim=0), group)
    var = _AllReduceSum.apply(torch.sum(torch.square(xs - mean) * wn, dim=0),
                              group)
    return mean, var, n


# --------------------------------------------------------------------------
# functions
# --------------------------------------------------------------------------

def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result: JAX's ``preferred_element_type=f32``.
    Products of bf16 values are exact in f32, so only the summation order
    can differ from the JAX function."""
    return torch.matmul(a.float(), b.float())


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T`` rounded to x's dtype, then ``+ bias`` in that dtype."""
    y = torch.matmul(x, weight.to(x.dtype).t())
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def embed(table: torch.Tensor, ids: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return table.to(dtype)[ids.long()]


def lstm_input_projection(x: torch.Tensor, w_ih: torch.Tensor,
                          b_ih: torch.Tensor,
                          b_hh: torch.Tensor) -> torch.Tensor:
    """``x @ W_ih + (b_ih + b_hh)`` in x's dtype, the two biases summed in
    f32 first (``lstm_bias``): the input projection an LSTM hoists out of
    its recurrence, or computes per step for a stacked layer."""
    dtype = x.dtype
    return torch.matmul(x, w_ih.to(dtype).t()) + (b_ih + b_hh).to(dtype)


def lstm_cell(x_proj: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w_hh_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step (``layers.py:105-125``) given the input projection
    [N, 4H]: the gates ``x_proj + h @ W_hh`` and both carries in h's dtype.
    ``w_hh_t`` is W_hh cast to h's dtype and transposed, [H, 4H], so a
    recurrence casts it once, not at every step."""
    gates = x_proj + torch.matmul(h, w_hh_t)
    i, f, g, o = gates.chunk(4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c = f * c + i * g
    return o * torch.tanh(c), c


def lstm(
    x: torch.Tensor,  # [N, T, d_in]
    w_ih: torch.Tensor,  # [4H, d_in]
    w_hh: torch.Tensor,  # [4H, H]
    b_ih: torch.Tensor,
    b_hh: torch.Tensor,
) -> torch.Tensor:
    """All hidden states [N, T, H]; h and c carried in x's dtype."""
    n, t, _ = x.shape
    hidden = w_hh.shape[1]
    dtype = x.dtype
    x_proj = lstm_input_projection(x, w_ih, b_ih, b_hh)  # hoisted
    w_hh_t = w_hh.to(dtype).t()
    h = torch.zeros(n, hidden, dtype=dtype, device=x.device)
    c = torch.zeros(n, hidden, dtype=dtype, device=x.device)
    hs = []
    for step in range(t):
        h, c = lstm_cell(x_proj[:, step], h, c, w_hh_t)
        hs.append(h)
    return torch.stack(hs, dim=1)


def weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``weight_norm(dim=None)``'s weight: ``g v / ||v||_F`` in f32."""
    return v * (g / torch.linalg.vector_norm(v))


def gru(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
        b_ih: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """``nn.GRU``'s recurrence from a zero state -> all hidden states
    [N, T, H] in x's dtype: r = sigmoid(x_r + h_r), z = sigmoid(x_z + h_z),
    n = tanh(x_n + r h_n), h = (1 - z) n + z h, with x_* = x W_ih + b_ih
    (hoisted out of the loop) and h_* = h W_hh + b_hh, each projection's
    bias added before its product is rounded. The weights in x's dtype."""
    n, t, _ = x.shape
    hidden = w_hh.shape[1]
    xp = torch.nn.functional.linear(x, w_ih, b_ih).chunk(3, dim=-1)
    h = x.new_zeros(n, hidden)
    hs = []
    for step in range(t):
        hr, hz, hn = torch.nn.functional.linear(h, w_hh, b_hh).chunk(3, -1)
        r = torch.sigmoid(xp[0][:, step] + hr)
        z = torch.sigmoid(xp[1][:, step] + hz)
        c = torch.tanh(xp[2][:, step] + r * hn)
        h = (1 - z) * c + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


@dataclass(frozen=True)
class GlobalRows:
    """A dropout generator for rows ``[row0, row0 + n)`` of a global batch
    of ``rows`` rows (None: the n rows the layer sees), n being the batch
    the layer sees: a rank's slice of a data-parallel batch; and, with
    ``col_shards`` > 1, for column block ``col_shard`` of ``col_shards``
    of the last axis: a rank's columns of a tensor-parallel activation
    (``columns``). ``dropout`` draws the global array's noise and keeps
    this block, and K2 offsets its mask counter by ``row0`` and the
    block's first column (``ops/grid_fusion.py``), so the ranks draw the
    masks that one process draws for the whole array."""

    generator: torch.Generator
    row0: int = 0
    rows: Optional[int] = None
    col_shard: int = 0
    col_shards: int = 1


Generator = Union[torch.Generator, GlobalRows]


def first_row(generator: Optional[Generator]) -> int:
    """The global index of the batch's first row (0 unless a
    ``GlobalRows``)."""
    return generator.row0 if isinstance(generator, GlobalRows) else 0


def first_column(generator: Optional[Generator],
                 width: int) -> Tuple[int, int]:
    """(global index of the first column, global width) of an activation
    whose last axis, ``width`` wide here, the generator's column block
    stands for: (0, width) unless a ``GlobalRows`` with column shards."""
    if isinstance(generator, GlobalRows):
        return generator.col_shard * width, generator.col_shards * width
    return 0, width


def columns(generator: Optional[Generator], tp) -> Optional[Generator]:
    """The generator for an activation whose last axis is split over the
    model axis ``tp`` (``parallel.tensor.TensorParallel``): this rank's
    column block of it. ``generator`` itself without a model axis."""
    if tp is None or tp.size == 1 or generator is None:
        return generator
    if isinstance(generator, GlobalRows):
        return dataclasses.replace(generator, col_shard=tp.rank,
                                   col_shards=tp.size)
    return GlobalRows(generator, col_shard=tp.rank, col_shards=tp.size)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[Generator] = None) -> torch.Tensor:
    """Inverted dropout, ``where(mask, x / keep, 0)`` with the mask drawn
    from ``generator`` (on x's device); a no-op when ``not train`` or
    ``rate <= 0`` (``layers.py:161-176``). ``keep`` is rounded to x's dtype
    before the division, as JAX rounds a Python scalar: at bf16,
    x / bf16(0.9) and bf16(x / 0.9) differ on a third of the elements.
    Under a ``GlobalRows`` generator the noise is drawn for the global
    batch (dim 0 of x is the batch) and x's rows are taken from it, and,
    with column shards, for the whole last axis, of which x's block is
    taken."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = 1.0 - rate
    if isinstance(generator, GlobalRows):
        rows = x.shape[0] if generator.rows is None else generator.rows
        shape = [rows, *x.shape[1:]]
        width = shape[-1]
        shape[-1] *= generator.col_shards
        noise = torch.rand(shape, generator=generator.generator,
                           device=x.device)
        noise = noise[generator.row0:generator.row0 + x.shape[0]]
        if generator.col_shards > 1:
            c0 = generator.col_shard * width
            noise = noise[..., c0:c0 + width]
    else:
        noise = torch.rand(x.shape, generator=generator, device=x.device)
    mask = noise < keep
    keep_x = torch.tensor(keep, dtype=x.dtype).item()  # on the host
    return torch.where(mask, x / keep_x, torch.zeros_like(x))


class _SignedSqrt(torch.autograd.Function):
    """``signed_sqrt`` with its gradient in one step: g / (2 sqrt|x|), and
    exactly 0 where x == 0, the values autograd gives through the composed
    expression (``grad / (2 * result)`` of each sqrt, masked by its relu),
    bit for bit. Through the composition, each sqrt's backward divides by
    a 0 result on every element (one of the two branches is 0 there), and
    makes an inf or, where the incoming gradient is 0, a NaN that the relu
    then masks; ``torch.autograd.set_detect_anomaly`` (``Config.
    debug_nans``) would stop on that NaN in every training step."""

    @staticmethod
    def forward(ctx, x):
        root = torch.sqrt(torch.abs(x))
        ctx.save_for_backward(x, root)
        return torch.sqrt(torch.relu(x)) - torch.sqrt(torch.relu(-x))

    @staticmethod
    def backward(ctx, g):
        x, root = ctx.saved_tensors
        return torch.where(x == 0, torch.zeros_like(g), g / (2 * root))


def signed_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Power normalisation sqrt(relu(x)) - sqrt(relu(-x)); its gradient
    is 0 where x == 0 (``_SignedSqrt``)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SignedSqrt.apply(x)
    return torch.sqrt(torch.relu(x)) - torch.sqrt(torch.relu(-x))


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize`` semantics with the square-sum in (at least) f32."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xa = x.to(acc)
    norm = torch.sqrt(torch.sum(xa * xa, dim=dim, keepdim=True))
    return (xa / torch.clamp_min(norm, eps)).to(x.dtype)
