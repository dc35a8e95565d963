"""Loss functions and hit counts (port of
``vqa_attention_networks_tpu/train/losses.py``), with the same ``valid``
mask: the pad rows of an epoch's last batch contribute nothing."""

from __future__ import annotations

from typing import Optional

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
