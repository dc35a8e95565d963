"""The port's metrics (vqa_attention_networks_tpu_torch/train/losses.py)
against the JAX package's on the same numpy inputs.

``topk_correct_count`` breaks ties as ``lax.top_k`` does, by the lower
index. The input is the one that showed the fault: 4096 rows of 1000
answers drawn from N(0, 0.05^2) and rounded through bf16, so most rows hold
ties near their top, with each label the third entry of a stable
descending sort. JAX counts every row a hit; a top-3 that orders ties
otherwise loses the label on some rows (3955 of 4096 with ``torch.topk``
on this input). The counts are integers and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import torch

from vqa_attention_networks_tpu.train.losses import (
    topk_correct_count as jax_topk_correct_count,
)
from vqa_attention_networks_tpu_torch.train.losses import topk_correct_count


def _tie_heavy(seed=0, rows=4096, answers=1000):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, answers)) * 0.05).astype(np.float32)
    logits = torch.from_numpy(x).to(torch.bfloat16).float()
    labels = torch.sort(logits, dim=-1, descending=True,
                        stable=True).indices[:, 2]
    return logits, labels


def test_topk_correct_count_breaks_ties_as_jax():
    logits, labels = _tie_heavy()
    want = float(jax_topk_correct_count(jnp.asarray(logits.numpy()),
                                        jnp.asarray(labels.numpy()), 3))
    got = topk_correct_count(logits, labels, 3)
    assert got.dtype == torch.float32
    assert want == 4096.0
    assert float(got) == want


def test_topk_correct_count_with_valid_mask_matches_jax():
    logits, labels = _tie_heavy(seed=1, rows=512, answers=100)
    labels = labels.clone()
    labels[::3] = 0  # some misses where answer 0 is not in the top 3
    valid = torch.from_numpy(np.random.default_rng(2).random(512) > 0.25)
    for k in (1, 3, 5):
        want = float(jax_topk_correct_count(
            jnp.asarray(logits.numpy()), jnp.asarray(labels.numpy()), k,
            jnp.asarray(valid.numpy())))
        assert float(topk_correct_count(logits, labels, k, valid)) == want
