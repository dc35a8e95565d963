"""Move a JAX parameter tree into a port module and back.

The JAX package keeps parameters as nested dicts with projections stored
``[in, out]`` (``models/layers.py``); the port keeps PyTorch's ``[out, in]``.
``load_jax_params`` maps one onto the other, strictly: a missing key, an
unexpected key or a wrong shape raises. One leaf may be left out: a
weight-normalised layer's gain ``g``, which then takes ``weight_norm``'s
own first value, its direction's norm (the weight is the direction). It is how the tests hand one set of
weights to both packages, and how ``chip_smoke.py`` loads random weights.
``to_jax_params`` is its inverse: the module's parameters as a tree of
numpy arrays in the JAX layout, so a test can hold the parameters after a
training step against the JAX package's. A batch norm's running
statistics (``mean``, ``var``) are buffers here and leaves of the tree
there, so both directions carry them. A child module that is not a layer
(attentionNet's attention layers) is a level of the tree: its children map
under its name.
Reference ``.pth`` checkpoints reach the same tree through the port's
``utils/torch_import.import_state_dict``.

A tensor-parallel model (``parallel.sharding.shard_params``) holds its
rank's rows of the fusion projections: ``to_jax_params`` gathers them
(every rank of the model group calls it together), so it gives the whole
model's tree.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from vqa_attention_networks_tpu_torch.models import layers as L
from vqa_attention_networks_tpu_torch.parallel.sharding import (
    gather_state_dict,
    model_shardings,
)

# layer class -> {JAX leaf: (attribute, transpose)}
_LEAVES = {
    L.Dense: {"w": ("weight", True), "b": ("bias", False)},
    L.Embedding: {"table": ("weight", False)},
    L.LSTM: {
        "w_ih": ("weight_ih", True),
        "w_hh": ("weight_hh", True),
        "b_ih": ("bias_ih", False),
        "b_hh": ("bias_hh", False),
    },
    L.LayerNorm: {"w": ("weight", False), "b": ("bias", False)},
    L.WNDense: {
        "v": ("weight_v", True),
        "g": ("weight_g", False),
        "b": ("bias", False),
    },
    L.GRU: {
        "w_ih": ("weight_ih", True),
        "w_hh": ("weight_hh", True),
        "b_ih": ("bias_ih", False),
        "b_hh": ("bias_hh", False),
    },
    L.BatchNorm: {
        "scale": ("scale", False),
        "bias": ("bias", False),
        "mean": ("mean", False),
        "var": ("var", False),
    },
}


def _module_leaves(module: nn.Module, prefix: str = "",
                   ) -> Dict[str, Tuple[torch.Tensor, bool]]:
    """JAX key path ("layer/leaf") -> (target tensor, transpose)."""
    out: Dict[str, Tuple[torch.Tensor, bool]] = {}
    own = [name for name, _ in module.named_parameters(recurse=False)]
    if own:
        raise TypeError(
            f"no JAX mapping for parameters {own} held by "
            f"{type(module).__name__} itself"
        )
    for name, child in module.named_children():
        fields = _LEAVES.get(type(child))
        if fields is None:
            out.update(_module_leaves(child, f"{prefix}{name}/"))
            continue
        for leaf, (attr, transpose) in fields.items():
            tensor = getattr(child, attr)
            if tensor is not None:
                out[f"{prefix}{name}/{leaf}"] = (tensor, transpose)
    for name, buf in module.named_buffers(recurse=False):
        if name not in module._non_persistent_buffers_set:
            out[f"{prefix}{name}"] = (buf, False)
    return out


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Iterator[
        Tuple[str, Any]]:
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + "/")
        else:
            yield path, value


def load_jax_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Copy a JAX-layout tree (numpy arrays, or CPU tensors) into
    ``module``'s parameters, on whatever device they live. Then, if the
    module lays out derived weights (``prepare``), it does so once here."""
    targets = _module_leaves(module)
    given = dict(_flatten(params))
    gains = {id(m.weight_g) for m in module.modules()
             if isinstance(m, L.WNDense)}
    for path, (tensor, _) in targets.items():
        layer = path.rpartition("/")[0]
        if (id(tensor) in gains and path not in given
                and f"{layer}/v" in given):
            given[path] = np.linalg.norm(np.asarray(given[f"{layer}/v"],
                                                    np.float64))
    missing = sorted(set(targets) - set(given))
    unexpected = sorted(set(given) - set(targets))
    if missing or unexpected:
        raise ValueError(
            f"{type(module).__name__}: parameter tree mismatch — missing "
            f"{missing}, unexpected {unexpected}"
        )
    with torch.no_grad():
        for path, (tensor, transpose) in targets.items():
            value = np.asarray(given[path])
            if value.dtype != np.float64:
                value = value.astype(np.float32)
            value = torch.as_tensor(value)
            expect = tuple(tensor.t().shape if transpose else tensor.shape)
            if tuple(value.shape) != expect:
                raise ValueError(
                    f"{type(module).__name__}: {path} has shape "
                    f"{tuple(value.shape)}, expected {expect} (JAX layout)"
                )
            tensor.copy_(value.t() if transpose else value)
    if hasattr(module, "prepare"):
        module.prepare()
    return module


def to_jax_params(module: nn.Module) -> Dict[str, Any]:
    """The module's parameters and persistent buffers as a nested dict of
    numpy arrays in the JAX layout (``[in, out]`` projections), in their
    own dtype; a tensor-parallel model's split leaves gathered."""
    tree: Dict[str, Any] = {}
    _, split = model_shardings(module)
    full = {}
    if split:
        state = gather_state_dict(module)
        full = {id(p): state[n] for n, p in module.named_parameters()
                if n in split}
    for path, (tensor, transpose) in _module_leaves(module).items():
        value = full.get(id(tensor), tensor).detach()
        value = (value.t() if transpose else value).cpu().numpy().copy()
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree
