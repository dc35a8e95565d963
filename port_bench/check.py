"""The numbers that decide ``correct``: what the timed path produced, held
against the float32 reference (``reference/``) run after the window.

Serving (a sample of the questions answered in the window):

- ``answer_gap``: the widest gap by which the reference's logit of a served
  answer lies below the reference's best logit of its question;
- ``logit_err``: the widest error of the served top-k's logit differences
  (``log p_j - log p_0``, which the served probabilities give exactly)
  against the reference's at the same answers.

Training (the window's own call ran the first steps, and the reference
follows them from the same weights, batches and dropout):

- ``logit_err``: the widest error of the first step's logits (as the
  Solver's loss got them) against the reference's;
- ``support_gap``: by leaf, the relative gap of the number of elements
  the first gradient reached (nonzero in Adam's first moment after one
  step; nonzero in the reference's gradient), the widest over the leaves
  whose first reference gradient is at least a thousandth of the median
  leaf's (the others, a softmax's bias, are round-off);
- ``change_gap``: the parameters' change over the three steps, by leaf the
  gap of the norms over the larger of the leaf's and the median leaf's
  reference change, the median over the same leaves.

Read beside them and not compared (PERF.md has their readings):
``change_worst``, the same gap at the worst leaf, and ``grad_worst`` and
``grad_median``, the first gradient's norms (the program's from Adam's
first moment) by the same measure. A handful of signed-square-root inputs
near 0 set them: their gradient 1 / (2 sqrt|x|) turns a rounding of x
into a large change, and the float32 reference with only those inputs
moved by bfloat16's rounding (the look) reads as far from itself. The
first step's loss is not compared either: neither the control nor a fault
moves it ten times past its rounding.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

QUIET_LEAF = 1e-3  # a leaf under this share of the median gradient is quiet


def serve_numbers(top_ids: np.ndarray, top_probs: np.ndarray,
                  ref_logits: torch.Tensor) -> Dict[str, float]:
    ref = ref_logits.double().cpu()
    ids = torch.from_numpy(np.asarray(top_ids, dtype=np.int64))
    probs = torch.from_numpy(np.asarray(top_probs, dtype=np.float64))
    at = ref.gather(1, ids)
    gap = (ref.max(1).values - at[:, 0]).max()
    served = torch.log(probs.clamp_min(1e-300))
    err = ((served - served[:, :1]) - (at - at[:, :1])).abs().max()
    return {"answer_gap": float(gap), "logit_err": float(err)}


def top_k(logits: torch.Tensor, k: int) -> tuple:
    """(ids, probabilities) of the k most probable answers, as a served
    head gives them."""
    probs = torch.softmax(logits.float(), dim=-1)
    p, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return i[:, :k].cpu().numpy(), p[:, :k].cpu().numpy()


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"logits": the first step's [B, A],
    "support": {leaf: elements}, "grad": {leaf: the first gradient's norm}
    (the reference's also says which leaves are quiet), "change": {leaf:
    norm}}."""
    moving = [k for k in sorted(ref["grad"]) if k not in quiet_leaves(ref)]
    logits = (prog["logits"].double() - ref["logits"].double()).abs().max()

    def gaps(key):
        med = statistics.median(ref[key][k] for k in moving)
        return [abs(prog[key][k] - ref[key][k])
                / max(ref[key][k], med, 1e-30) for k in moving]

    change, grad = gaps("change"), gaps("grad")
    return {"logit_err": float(logits),
            "support_gap": max(abs(prog["support"][k] - ref["support"][k])
                               / max(ref["support"][k], 1) for k in moving),
            "change_gap": statistics.median(change),
            "change_worst": max(change), "grad_worst": max(grad),
            "grad_median": statistics.median(grad)}


def quiet_leaves(ref: Dict) -> List[str]:
    leaves = sorted(ref["grad"])
    med = statistics.median(ref["grad"][k] for k in leaves)
    return [k for k in leaves if ref["grad"][k] < QUIET_LEAF * med]
