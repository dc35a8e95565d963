"""Device mesh (port of ``vqa_attention_networks_tpu/parallel/mesh.py``):
a ``('data', 'model')`` ``DeviceMesh`` over the ranks of the process
group, one device a rank. Rank r sits at ``(r // model, r % model)``: the
``data`` axis is what data parallelism splits the batch over, its group
the ranks with the same model coordinate; the ``model`` axis is what
tensor parallelism splits the fusion projections over
(``parallel/tensor.py``), its group the ranks of one data replica."""

from __future__ import annotations

from typing import Optional

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: Optional[int] = None, model: int = 1,
              device_type: str = "cuda"):
    """The ``(data, model)`` mesh of the process group. ``data=None`` is
    the world size over ``model``. Needs a process group (``parallel.
    distributed.initialize_distributed``) whose world size is ``data *
    model``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise ValueError(
            "a device mesh spans the ranks of a process group: start the "
            "ranks with torchrun --nproc_per_node N and call "
            "parallel.initialize_distributed() first")
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"process group's {world} ranks")
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
