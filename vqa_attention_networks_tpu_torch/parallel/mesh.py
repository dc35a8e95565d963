"""Device mesh (port of ``vqa_attention_networks_tpu/parallel/mesh.py``):
a ``('data', 'model')`` ``DeviceMesh`` over the ranks of the process
group, one device a rank. The ``data`` axis is what data parallelism
splits the batch over; the ``model`` axis is what tensor parallelism
(ROADMAP Queue 1 item 10b) will split the fusion projections over, and it
is 1 here."""

from __future__ import annotations

from typing import Optional

DATA_AXIS = "data"
MODEL_AXIS = "model"
TENSOR_PARALLEL_ITEM = "ROADMAP Queue 1 item 10b (tensor parallelism)"


def make_mesh(data: Optional[int] = None, model: int = 1,
              device_type: str = "cuda"):
    """The ``(data, model)`` mesh of the process group. ``data=None`` is
    the world size. Needs a process group (``parallel.distributed.
    initialize_distributed``) whose world size is ``data * model``;
    ``model > 1`` raises ``NotImplementedError``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if model > 1:
        raise NotImplementedError(
            f"a model axis of {model} (tensor parallelism) is not ported "
            f"to PyTorch yet: {TENSOR_PARALLEL_ITEM}")
    if not dist.is_initialized():
        raise ValueError(
            "a device mesh spans the ranks of a process group: start the "
            "ranks with torchrun --nproc_per_node N and call "
            "parallel.initialize_distributed() first")
    world = dist.get_world_size()
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
