"""Data and tensor parallelism over ``torch.distributed`` (port of
``vqa_attention_networks_tpu/parallel/``).

JAX expresses its parallelism as a ``('data', 'model')`` mesh and lets
XLA insert the collectives. Here each rank is one process driving one
device (``torchrun --nproc_per_node N``): the batch splits over the
``data`` axis (``sharding``), ``DistributedDataParallel`` all-reduces the
gradients, and the few global reductions JAX gets from a mean over a
sharded axis (a batch norm's statistics, the loss's valid count, the
evaluation's sums and predictions) are collectives of their own. The
``model`` axis splits the fusion projections by columns
(``sharding.shard_params``) and the training forward gathers each fusion's
pooled block (``tensor``).
"""

from vqa_attention_networks_tpu_torch.parallel.distributed import (  # noqa: F401
    host_fetch,
    initialize_distributed,
    is_primary,
    rank,
    world_size,
)
from vqa_attention_networks_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
)
from vqa_attention_networks_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_rows,
    param_shardings,
    shard_batch,
    shard_params,
    step_rows,
)
