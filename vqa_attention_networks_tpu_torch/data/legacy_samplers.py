"""Legacy manual batch samplers (the port's copy of
``vqa_attention_networks_tpu/data/legacy_samplers.py``).

The reference carries hand-rolled batch assemblers from its fc7/49x1024 era
(``sample_batch_hard`` utils.py:21-35, ``sample_batch_soft`` utils.py:37-57),
unused by its live training path but part of its public surface. These are
the packed-artifact equivalents, with the JAX package's two fixes:

- the reference reads rows out of a freshly allocated *empty* buffer that
  shadows its ``features`` argument (utils.py:27,33,44,55); here the
  source feature bank is read, as intended;
- wrap-around indexing keeps the reference's ``(batch_no*batch_size) %
  len(qa)`` semantics.

Live code uses ``data.dataset.VqaBatches`` (fixed shapes and a ``valid``
mask).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from vqa_attention_networks_tpu_torch.data.prepare import (
    QASplit,
    densify_soft_np,
)


def sample_batch_hard(
    batch_no: int,
    batch_size: int,
    feature_bank: np.ndarray,  # [num_images, ...] feature rows
    image_id_map: Dict[int, int],  # image_id -> feature row
    split: QASplit,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(features, questions, hard answers) for one wrap-around batch."""
    n_total = len(split)
    si = (batch_no * batch_size) % n_total
    ei = min(n_total, si + batch_size)
    idx = np.arange(si, ei)
    rows = np.asarray(
        [image_id_map[int(i)] for i in split.image_ids[idx]], np.int64
    )
    return (
        np.asarray(feature_bank[rows]),
        split.questions[idx].copy(),
        split.answers[idx].copy(),
    )


def sample_batch_soft(
    batch_no: int,
    batch_size: int,
    feature_bank: np.ndarray,
    image_id_map: Dict[int, int],
    split: QASplit,
    num_answers: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(features, questions, dense soft answers, hard answers)."""
    n_total = len(split)
    si = (batch_no * batch_size) % n_total
    ei = min(n_total, si + batch_size)
    idx = np.arange(si, ei)
    rows = np.asarray(
        [image_id_map[int(i)] for i in split.image_ids[idx]], np.int64
    )
    soft = densify_soft_np(
        split.soft_idx[idx], split.soft_val[idx], num_answers
    )
    return (
        np.asarray(feature_bank[rows]),
        split.questions[idx].copy(),
        soft,
        split.answers[idx].copy(),
    )
