"""Tensor parallelism over the mesh's ``model`` axis (port of what GSPMD
does with ``vqa_attention_networks_tpu/parallel/sharding.py``'s
``_leaf_spec``).

JAX column-shards each fusion projection over ``'model'`` and lets XLA
insert the collectives. Here the ranks of one data replica form the
model group (``parallel.mesh``), and the collectives are explicit:

- every rank computes its own columns of the column-sharded projections,
  their Hadamard product, dropout, k-pool and signed sqrt;
- ``gather_columns`` then gathers the pooled output along its last axis
  (forward) and hands each rank its own slice of the gradient (backward:
  what comes after the gather runs replicated, the same on every rank, so
  a sum over the ranks, as ``torch.distributed.nn``'s all-gather takes it,
  would give M times the gradient);
- ``model_input`` is the identity forward and an all-reduce over the model
  group in backward, on the input of every column-sharded projection: a
  rank's columns carry only its share of that input's gradient, and the
  replicated layers before it (the LSTM, the embedding, the attention)
  need the sum, the same on every rank, or they drift apart.

The transport follows the group's backend, never an error: NCCL gathers
with ``all_gather_into_tensor``; gloo, which takes only all-reduce and
broadcast of CUDA tensors, gathers by an all-reduce of zero-padded slices
(exact: each element is one rank's value plus zeros), in f32 for the
16-bit dtypes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True, eq=False)
class TensorParallel:
    """This rank's place on the model axis: the model group, its rank in
    it and the group's size. Held by reference: a copy of a model
    (``copy.deepcopy``) spans the same group, which cannot be copied."""

    group: Any
    rank: int
    size: int

    def __deepcopy__(self, memo):
        return self

    def columns(self, width: int) -> slice:
        """This rank's block of an axis of ``width`` (M divides it)."""
        return slice(self.rank * width // self.size,
                     (self.rank + 1) * width // self.size)


def _gloo(tp: TensorParallel) -> bool:
    return dist.get_backend(tp.group) == "gloo"


def all_reduce(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum of ``x`` over the model group (a new tensor)."""
    wide = _gloo(tp) and x.dtype in (torch.bfloat16, torch.float16)
    y = x.float() if wide else x.clone()
    dist.all_reduce(y, group=tp.group)
    return y.to(x.dtype) if wide else y


def gather(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order, on
    every rank (not differentiable)."""
    dim = dim % x.dim()
    w = x.shape[dim]
    if _gloo(tp):
        shape = list(x.shape)
        shape[dim] = w * tp.size
        full = x.new_zeros(shape, dtype=torch.promote_types(
            x.dtype, torch.float32))
        full.narrow(dim, tp.rank * w, w).copy_(x)
        dist.all_reduce(full, group=tp.group)
        return full.to(x.dtype)
    part = x.movedim(dim, 0).contiguous()
    out = part.new_empty((tp.size * w, *part.shape[1:]))
    dist.all_gather_into_tensor(out, part, group=tp.group)
    return out.movedim(0, dim).contiguous()


class _ModelInput(torch.autograd.Function):
    """Identity forward; the all-reduce of the gradient over the model
    group in backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.tp), None


class _GatherColumns(torch.autograd.Function):
    """All-gather along the last axis forward; this rank's slice of the
    gradient in backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.width = tp, x.shape[-1]
        return gather(x, tp, -1)

    @staticmethod
    def backward(ctx, g):
        m, w = ctx.tp.rank, ctx.width
        return g[..., m * w:(m + 1) * w].contiguous(), None


def sharded(tp: Optional[TensorParallel]) -> bool:
    return tp is not None and tp.size > 1


def model_input(x: torch.Tensor,
                tp: Optional[TensorParallel]) -> torch.Tensor:
    """``x`` as the input of column-sharded projections (see the module's
    docstring); itself without a model axis."""
    return _ModelInput.apply(x, tp) if sharded(tp) else x


def gather_columns(x: torch.Tensor,
                   tp: Optional[TensorParallel]) -> torch.Tensor:
    """The full last axis of a column-sharded activation; itself without a
    model axis."""
    return _GatherColumns.apply(x, tp) if sharded(tp) else x
