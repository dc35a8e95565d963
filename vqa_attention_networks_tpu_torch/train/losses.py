"""Loss functions and hit counts (port of
``vqa_attention_networks_tpu/train/losses.py``), with the same ``valid``
mask: the pad rows of an epoch's last batch contribute nothing."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def soft_cross_entropy(logits: torch.Tensor, soft_targets: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KLDivLoss(log_softmax(logits), targets) with reduction='mean': the
    mean over all N*A elements of ``t * (log t - log p)``, 0*log0 := 0
    (``losses.py:17-38``)."""
    log_probs = torch.log_softmax(logits, dim=-1)
    t = soft_targets  # promotes with the logits' dtype, as in JAX
    log_t = torch.log(torch.where(t > 0, t, torch.ones_like(t)))
    elem = t * (log_t - log_probs)
    if valid is not None:
        elem = elem * valid[:, None].to(elem.dtype)
        n = torch.clamp_min(valid.to(elem.dtype).sum(), 1.0)
    else:
        n = torch.tensor(float(logits.shape[0]), dtype=elem.dtype,
                         device=elem.device)
    return elem.sum() / (n * logits.shape[-1])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """nn.CrossEntropyLoss semantics: the mean NLL of log_softmax at the
    label."""
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
    if valid is not None:
        nll = nll * valid.to(nll.dtype)
        n = torch.clamp_min(valid.to(nll.dtype).sum(), 1.0)
    else:
        n = torch.tensor(float(logits.shape[0]), dtype=nll.dtype,
                         device=nll.device)
    return nll.sum() / n


def soft_bce(logits: torch.Tensor, soft_labels: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The legacy trainer's 'soft BCE' (train_hfd.py:69-72), as JAX
    ``losses.py:57`` computes it: s = softmax(labels), p = softmax(logits),
    elementwise -s log p - (1-s) log(1-p), summed over answers, mean over
    the batch. log(1-p) is log(-expm1(log p)), with log p clamped below
    -tiny, so a fully confident class gives a finite term."""
    s = torch.softmax(soft_labels, dim=-1)
    log_p = torch.log_softmax(logits, dim=-1)
    eps = torch.finfo(log_p.dtype).tiny
    log_1mp = torch.log(-torch.expm1(torch.clamp_max(log_p, -eps)))
    per_row = (-s * log_p - (1.0 - s) * log_1mp).sum(dim=-1)
    if valid is not None:
        per_row = per_row * valid.to(per_row.dtype)
        n = torch.clamp_min(valid.to(per_row.dtype).sum(), 1.0)
    else:
        n = torch.tensor(float(logits.shape[0]), dtype=per_row.dtype,
                         device=per_row.device)
    return per_row.sum() / n


def correct_count(logits: torch.Tensor, labels: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Number of exact-match argmax predictions, as f32."""
    hit = (logits.argmax(dim=-1) == labels).float()
    if valid is not None:
        hit = hit * valid.float()
    return hit.sum()


def topk_correct_count(logits: torch.Tensor, labels: torch.Tensor, k: int = 3,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-k hit count, as f32. Ties go to the lower answer id, as
    ``lax.top_k`` breaks them (``train/losses.py:101-113`` in the JAX
    package): a stable descending sort, where ``torch.topk`` leaves the
    order of ties open."""
    topk = torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[..., :k]
    hit = (topk == labels[:, None]).any(dim=-1).float()
    if valid is not None:
        hit = hit * valid.float()
    return hit.sum()


def vqa_consensus_scores(soft_idx: np.ndarray, soft_val: np.ndarray,
                         preds: np.ndarray, soft_n: np.ndarray,
                         total_annotators: int = 10) -> np.ndarray:
    """The official VQA accuracy of each sample (host-side numpy, as JAX
    ``losses.py:116``): the mean over the 10-choose-9 annotator subsets of
    min(#matching / 3, 1). The predicted answer's annotator count is
    c = value * soft_n (the artifact stores count / in-vocab count), and
    the subset mean has the closed form
    (c * min((c-1)/3, 1) + (T-c) * min(c/3, 1)) / T. Out-of-vocab annotator
    answers count toward T; a row with no in-vocab answer scores 0."""
    preds = np.asarray(preds)
    val = np.asarray(soft_val, np.float64)
    n = np.asarray(soft_n, np.float64)
    hit = np.asarray(soft_idx) == preds[:, None]  # [B, W]
    c = np.rint((val * hit).sum(axis=1) * n)
    t = float(total_annotators)
    return (c * np.minimum((c - 1) / 3.0, 1.0)
            + (t - c) * np.minimum(c / 3.0, 1.0)) / t
