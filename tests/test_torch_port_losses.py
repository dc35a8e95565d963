"""The port's metrics (vqa_attention_networks_tpu_torch/train/losses.py)
against the JAX package's on the same numpy inputs.

``topk_correct_count`` breaks ties as ``lax.top_k`` does, by the lower
index. The input is the one that showed the fault: 4096 rows of 1000
answers drawn from N(0, 0.05^2) and rounded through bf16, so most rows hold
ties near their top, with each label the third entry of a stable
descending sort. JAX counts every row a hit; a top-3 that orders ties
otherwise loses the label on some rows (3955 of 4096 with ``torch.topk``
on this input). The counts are integers and must be equal.

``soft_bce`` (``loss_override="soft_bce"``) against JAX's at f32 within
1e-6 relative (the same formula; the two libraries' log_softmax, softmax
and expm1 may round apart by an ulp), with and without a ``valid`` mask,
on logits that include a fully confident class (log p = 0, where the
clamp keeps log(1 - p) finite). ``vqa_consensus_scores`` (numpy on both
sides) equal for every annotator count c = 0..10 of the predicted answer.
"""

import jax.numpy as jnp
import numpy as np
import torch

from vqa_attention_networks_tpu.train.losses import soft_bce as jax_soft_bce
from vqa_attention_networks_tpu.train.losses import (
    topk_correct_count as jax_topk_correct_count,
)
from vqa_attention_networks_tpu.train.losses import (
    vqa_consensus_scores as jax_consensus,
)
from vqa_attention_networks_tpu_torch.train.losses import (
    soft_bce,
    topk_correct_count,
    vqa_consensus_scores,
)


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


def test_soft_bce_matches_jax():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((24, 40)) * 3).astype(np.float32)
    logits[0, 5] = 200.0  # a fully confident row: p = 1 in f32
    labels = np.zeros((24, 40), np.float32)
    labels[np.arange(24), rng.integers(0, 40, 24)] = 0.7
    labels[np.arange(24), rng.integers(0, 40, 24)] += 0.3
    valid = rng.random(24) > 0.3
    for mask in (None, valid):
        want = float(jax_soft_bce(
            jnp.asarray(logits), jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask)))
        got = soft_bce(torch.from_numpy(logits), torch.from_numpy(labels),
                       None if mask is None else torch.from_numpy(mask))
        assert got.dtype == torch.float32 and np.isfinite(float(got))
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_vqa_consensus_scores_match_jax():
    """One row per count c = 0..10 of the predicted answer among 10
    annotators (all in vocab), and rows with out-of-vocab annotators."""
    rows = []
    for c in range(11):
        for n_in in range(max(c, 1), 11):
            rows.append((c, n_in))
    b = len(rows)
    soft_idx = np.full((b, 10), -1, np.int32)
    soft_val = np.zeros((b, 10), np.float32)
    soft_n = np.zeros(b, np.int32)
    preds = np.full(b, 4)
    for i, (c, n_in) in enumerate(rows):
        soft_n[i] = n_in
        if c:
            soft_idx[i, 0], soft_val[i, 0] = 4, c / n_in
        if n_in > c:
            soft_idx[i, 1], soft_val[i, 1] = 7, (n_in - c) / n_in
    got = vqa_consensus_scores(soft_idx, soft_val, preds, soft_n)
    want = jax_consensus(soft_idx, soft_val, preds, soft_n)
    np.testing.assert_array_equal(got, want)
    full = [got[i] for i, (c, n_in) in enumerate(rows) if n_in == 10]
    np.testing.assert_allclose(
        full, [(c * min((c - 1) / 3, 1) + (10 - c) * min(c / 3, 1)) / 10
               for c in range(11)])
    assert full[0] == 0.0 and full[4] == 1.0
