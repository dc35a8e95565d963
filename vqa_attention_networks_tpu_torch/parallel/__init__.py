"""Data parallelism over ``torch.distributed`` (port of
``vqa_attention_networks_tpu/parallel/``).

JAX expresses its parallelism as a ``('data', 'model')`` mesh and lets
XLA insert the collectives. Here each rank is one process driving one
device (``torchrun --nproc_per_node N``): the batch splits over the
``data`` axis (``sharding``), ``DistributedDataParallel`` all-reduces the
gradients, and the few global reductions JAX gets from a mean over a
sharded axis (a batch norm's statistics, the loss's valid count, the
evaluation's sums and predictions) are collectives of their own. The
``model`` axis (tensor parallelism) and the sharded feature banks are
ROADMAP Queue 1 item 10b.
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
    shard_batch,
    step_rows,
)
