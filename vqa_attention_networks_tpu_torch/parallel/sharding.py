"""Which rows of a global batch a rank holds, and which columns of the
fusion projections (port of ``batch_sharding``, ``shard_batch``,
``_leaf_spec``, ``param_shardings`` and ``shard_params`` in
``vqa_attention_networks_tpu/parallel/sharding.py``).

Every rank assembles the same global batch from ``(seed, epoch)``, as
every JAX process does, and keeps its own rows: data rank r of W holds the
contiguous rows ``[r*B/W, (r+1)*B/W)``, JAX's ``P('data')`` split of dim 0.
Under gradient accumulation JAX splits the global batch into a
micro-batches first and shards each of them: the rank's rows are then its
slice of each micro-batch (``step_rows``). A batch is sliced before its
features are gathered or uploaded (``data.dataset.VqaBatches(
feature_rows=...)``): a 196 x 2048 f16 row is 0.8 MB, and a rank moves only
its own. The host fields that the loss's denominator and the full
evaluation read stay global on every rank.

The tensor-parallel rule is JAX's ``_leaf_spec``: a projection whose name
says it is a fusion projection (``FUSION_NAMES``) **and** whose output
width is the fusion width (``cfg.fusion_dim``, 5000) is column-split over
the ``model`` axis; everything else is whole on every rank. The port's
``Dense.weight`` is ``[out, in]``, so JAX's last dim is the port's dim 0,
and the bias splits with it. Model rank m of M holds output columns
``[m*F/M, (m+1)*F/M)``: whole k-groups, since the layout is output-major.
M must divide ``mfb_out`` (GSPMD pads an uneven split; the port refuses
it). ``shard_params`` cuts a model to its rank's shards,
``gather_state_dict`` gathers the full tensors back (checkpoints, the
evaluation's weights), ``local_state_dict`` cuts a full state to a rank's.
Adam runs on the shards: it is elementwise, so a shard's update is the
same elements of the full update.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from vqa_attention_networks_tpu_torch.data.dataset import Batch
from vqa_attention_networks_tpu_torch.parallel.tensor import (
    TensorParallel,
    gather,
    sharded,
)

# the leaves JAX's _leaf_spec scopes the width rule to, by name
FUSION_NAMES = ("ques_proj", "img_proj", "img_conv1d", "linear_q_",
                "linear_i_")


def batch_rows(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a batch of ``n`` rows: ``[r*n/W,
    (r+1)*n/W)``."""
    assert n % world == 0, (
        f"global batch {n} not divisible by {world} processes")
    return slice(rank * n // world, (rank + 1) * n // world)


def step_rows(batch_size: int, accum: int, rank: int,
              world: int) -> np.ndarray:
    """The rows of a training step's global batch that rank ``rank``
    holds, in order: its slice ``batch_rows(m, rank, world)`` of each of
    the ``accum`` micro-batches of m = batch_size / accum rows. With
    ``accum = 1`` the contiguous ``batch_rows``; micro-batch i of the
    rank's local batch is then its slice of the global micro-batch i."""
    m = batch_size // accum
    local = batch_rows(m, rank, world)
    return np.concatenate([np.arange(i * m + local.start, i * m + local.stop)
                           for i in range(accum)])


# the fields a rank gathers for its own rows alone
# (``VqaBatches(feature_rows=...)``)
FEATURE_FIELDS = ("image_features", "feature_scale", "image_rows")


def shard_batch(batch: Batch, rows) -> Batch:
    """This rank's Batch of a global one: every per-row field at ``rows``
    (a slice or an index array), but the features, which the rank
    gathered for those rows alone."""
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[rows]
        for f in dataclasses.fields(batch)
        if f.name not in FEATURE_FIELDS
        and getattr(batch, f.name) is not None})


def param_shardings(model: torch.nn.Module,
                    fusion_dim: Optional[int]) -> Dict[str, Optional[int]]:
    """Each parameter name of ``model`` -> the dim split over the model
    axis (0), or None where the parameter is whole: JAX's ``_leaf_spec``
    by name and width, on the port's layout."""
    out: Dict[str, Optional[int]] = {}
    for name, p in model.named_parameters():
        split = (fusion_dim is not None and p.dim() >= 1
                 and p.shape[0] == fusion_dim
                 and any(n in name for n in FUSION_NAMES))
        out[name] = 0 if split else None
    return out


def check_model_axis(cfg, size: int) -> None:
    """Raise where ``size`` model ranks cannot split ``cfg``'s fusion: M
    must divide ``mfb_out``, so that each rank holds whole k-groups of
    every fusion projection and an equal block of every pooled output."""
    if size > 1 and cfg.mfb_out % size:
        raise ValueError(
            f"model_parallel={size} does not divide mfb_out={cfg.mfb_out}: "
            "a tensor-parallel rank holds mfb_out / model_parallel outputs "
            f"of each fusion (its {cfg.mfb_factor} channels each); choose a "
            "model axis that divides it")


def shard_params(model: torch.nn.Module, tp: TensorParallel,
                 fusion_dim: Optional[int]) -> Dict[str, Optional[int]]:
    """Cut ``model`` in place to this rank's shards (``param_shardings``):
    first every parameter and buffer is broadcast from the model group's
    first rank, so the ranks of one replica start from one model, then
    each split parameter keeps this rank's rows. The model's ``tp`` is set
    where it has one (the families with fusion projections read it);
    returns the shardings, kept as ``model.tp_shardings``."""
    shardings = param_shardings(model, fusion_dim)
    first = dist.get_global_rank(tp.group, 0)
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            dist.broadcast(t, first, group=tp.group)  # gloo takes CUDA
        for name, p in model.named_parameters():
            if shardings[name] is not None:
                p.data = p.data[tp.columns(p.shape[0])].clone()
    if any(v is not None for v in shardings.values()):
        if not hasattr(model, "tp"):
            raise TypeError(f"{type(model).__name__} has fusion projections "
                            "but no tensor-parallel forward")
        model.tp = tp
    model.tp_shardings = shardings
    return shardings


def model_shardings(model: torch.nn.Module):
    """(tp, shardings) of a model ``shard_params`` cut, else (None, {})."""
    tp = getattr(model, "tp", None)
    if not sharded(tp):
        return None, {}
    return tp, {k: v for k, v in model.tp_shardings.items() if v is not None}


def gather_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every split parameter gathered to its
    full tensor (a collective over the model group: every rank of it calls
    this together); the state dict itself for a whole model."""
    state = model.state_dict()
    tp, split = model_shardings(model)
    for name, dim in split.items():
        state[name] = gather(state[name], tp, dim)
    return state


def local_state_dict(model: torch.nn.Module,
                     state: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A full state dict cut to this rank's shards of ``model``."""
    tp, split = model_shardings(model)
    out = dict(state)
    for name, dim in split.items():
        full = state[name]
        out[name] = full.narrow(dim, *_block(full.shape[dim], tp))
    return out


def _block(width: int, tp: TensorParallel):
    cols = tp.columns(width)
    return cols.start, cols.stop - cols.start


def gather_optimizer_state(model: torch.nn.Module, optimizer) -> dict:
    """The optimizer's state dict with the moments of every split
    parameter gathered (its entries are the parameters in
    ``model.parameters()`` order)."""
    state = optimizer.state_dict()
    tp, split = model_shardings(model)
    if not split:
        return state
    names = [n for n, _ in model.named_parameters()]
    for i, entry in state["state"].items():
        if names[i] in split:
            state["state"][i] = {
                k: gather(v, tp, split[names[i]])
                if torch.is_tensor(v) and v.dim() >= 1 else v
                for k, v in entry.items()}
    return state


def local_optimizer_state(model: torch.nn.Module, state: dict) -> dict:
    """A gathered optimizer state dict cut to this rank's shards."""
    tp, split = model_shardings(model)
    if not split:
        return state
    names = [n for n, _ in model.named_parameters()]
    out = dict(state, state=dict(state["state"]))
    for i, entry in state["state"].items():
        dim = split.get(names[i])
        if dim is not None:
            out["state"][i] = {
                k: v.narrow(dim, *_block(v.shape[dim], tp))
                if torch.is_tensor(v) and v.dim() >= 1 else v
                for k, v in entry.items()}
    return out
