"""Process groups (port of ``vqa_attention_networks_tpu/parallel/
distributed.py``).

JAX joins its processes into one runtime with ``jax.distributed.
initialize`` and then sees every device of the cluster. Here each rank is
one process driving one device, as ``torchrun`` starts them, and the ranks
join a ``torch.distributed`` process group: NCCL between cards, gloo
between CPU processes (or when the caller names it, as two ranks sharing
one card must: NCCL refuses two ranks on one device).

``initialize_distributed`` keeps JAX's rules: a no-op in a single process,
idempotent, and loud on a partial configuration. A run that was meant to
be one of several and went on alone would have every rank write the same
checkpoints and train on the whole batch.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from vqa_attention_networks_tpu_torch.device import cuda_device

# what torchrun sets for every rank; all of them, or none
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def rank_device(device: Union[str, torch.device, None] = None
                ) -> torch.device:
    """The device of this rank: ``device`` as named, but a bare ``cuda`` (or
    None) is ``cuda:LOCAL_RANK``, the card torchrun gives the rank (the
    current card in a single process). Raises when that card does not
    exist; never returns the CPU unless it is named."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda" or device.index is not None:
        return device
    bare = cuda_device()  # raises without a card
    if "LOCAL_RANK" not in os.environ:
        return bare
    local = int(os.environ["LOCAL_RANK"])
    count = torch.cuda.device_count()
    if local >= count:
        raise RuntimeError(
            f"LOCAL_RANK={local} but {count} CUDA device(s) are visible: "
            "start at most one rank a card (torchrun --nproc_per_node N), "
            "or name each rank's device")
    return torch.device("cuda", local)


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
    backend: Optional[str] = None,
) -> torch.device:
    """Join this process to its process group; returns the rank's device
    (``rank_device(device)``).

    With no arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``); with
    none of it set this is a single-process run and nothing happens.
    Explicit ``init_method`` (``tcp://host:port`` or ``file://path``),
    ``world_size`` and ``rank`` override it. A configuration with some of
    these and not the others raises. The backend is NCCL for a CUDA
    device and gloo for the CPU, unless ``backend`` names one. A second
    call returns the device and changes nothing."""
    if dist.is_initialized():
        return rank_device(device)
    explicit = (init_method is not None or world_size is not None
                or rank is not None)
    present = [k for k in _ENV if k in os.environ]
    if not explicit and not present:
        return rank_device(device)
    if explicit:
        missing = [name for name, v in (("init_method", init_method),
                                        ("world_size", world_size),
                                        ("rank", rank)) if v is None]
        if missing and init_method is None and all(
                k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT")):
            missing.remove("init_method")
            init_method = "env://"
    else:
        missing = [k for k in _ENV if k not in os.environ]
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"]) if not missing else None
        rank = int(os.environ["RANK"]) if not missing else None
    if missing:
        raise ValueError(
            f"a multi-process run is configured in part: {missing} not "
            f"given (given: {present or 'arguments'}). Start the ranks "
            "with torchrun --nproc_per_node N, or pass init_method, "
            "world_size and rank together")
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that writes checkpoints, results and metrics."""
    return rank() == 0


def comm_device(like: torch.Tensor, group=None) -> torch.device:
    """Where a collective's tensor lives: the CPU under gloo (which takes
    only all-reduce and broadcast of CUDA tensors), ``like``'s device under
    NCCL."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return like.device


def barrier() -> None:
    """Every rank of the process group meets here (a checkpoint is the
    whole run's: written once, read by every rank)."""
    if is_initialized():
        dist.barrier()


def all_reduce_sum(values: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``values`` over the ranks of ``group`` (the process
    group's when None): a copy; ``values`` itself in a single process."""
    if not is_initialized():
        return values
    t = values.detach().to(comm_device(values, group)).clone()
    dist.all_reduce(t, group=group)
    return t.to(values.device)


def host_fetch(x: torch.Tensor, group=None) -> np.ndarray:
    """Every rank's ``x`` ([B/W, ...], the same shape on every rank of
    ``group``, the process group's when None), concatenated in rank order,
    as numpy on every rank: the global batch's rows of a per-row result
    (JAX's ``process_allgather(x, tiled=True)``). A plain device-to-host
    copy in a single process."""
    if not is_initialized() or dist.get_world_size(group) == 1:
        return x.detach().cpu().numpy()
    t = x.detach().to(comm_device(x, group)).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts).cpu().numpy()
