"""Which rows of a global batch a rank holds (port of ``batch_sharding``
and ``shard_batch`` in ``vqa_attention_networks_tpu/parallel/sharding.
py``).

Every rank assembles the same global batch from ``(seed, epoch)``, as
every JAX process does, and keeps its own rows: rank r of W holds the
contiguous rows ``[r*B/W, (r+1)*B/W)``, JAX's ``P('data')`` split of dim 0.
Under gradient accumulation JAX splits the global batch into a
micro-batches first and shards each of them: the rank's rows are then its
slice of each micro-batch (``step_rows``). A batch is sliced before its
features are gathered or uploaded (``data.dataset.VqaBatches(
feature_rows=...)``): a 196 x 2048 f16 row is 0.8 MB, and a rank moves only
its own. The host fields that the loss's denominator and the full
evaluation read stay global on every rank.

The tensor-parallel rules (``param_shardings``, ``shard_params``) are
ROADMAP Queue 1 item 10b.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vqa_attention_networks_tpu_torch.data.dataset import Batch


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
