"""The one generator of the benchmark's traffic, read from the parameters of
a ``traffic/<name>.json`` file. Every seed gets the same multiset of
question lengths and the same questions per image (a whole number, the
first images one more), in another order, with its own tokens and answers: the same work, other
inputs.

Parameters (keys of the traffic file):

- ``images``: image ids 0..images-1 the questions ask about;
- ``questions_per_image``: questions drawn per image (VQA v2: 5.3 on val,
  5.4 on train); the total is rounded to whole ``batch`` es;
- ``batch``: questions a batch (serving) or a step (training);
- ``length_weights``: {length: weight}, the share of questions of each
  length in tokens (VQA v2's questions run from 3 to 22 words, mean 6.2);
- ``annotators``, ``answer_zipf``: for training, each question's soft
  answer is the shares of ``annotators`` draws from a Zipf law of exponent
  ``answer_zipf`` over the answer vocabulary (VQA collects 10 answers).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _exact_counts(weights: Dict[str, float], total: int) -> Dict[int, int]:
    """Largest-remainder apportionment of ``total`` over ``weights``."""
    keys = sorted(weights, key=int)
    w = np.array([weights[k] for k in keys], dtype=np.float64)
    raw = w / w.sum() * total
    counts = np.floor(raw).astype(np.int64)
    for i in np.argsort(-(raw - counts), kind="stable")[:total
                                                         - counts.sum()]:
        counts[i] += 1
    return {int(k): int(c) for k, c in zip(keys, counts)}


def num_questions(params: Dict) -> int:
    batch = int(params["batch"])
    n = params["images"] * params["questions_per_image"]
    return max(1, int(round(n / batch))) * batch


def questions(params: Dict, q_vocab: int, max_len: int,
              seed: int) -> Dict[str, np.ndarray]:
    """``image_ids`` [Q] int64, ``questions`` [Q, max_len] int32 (0-padded
    token ids in 1..q_vocab-1) and ``ques_length`` [Q] int32."""
    rng = np.random.default_rng([int(seed), 1])
    q = num_questions(params)
    n_img = int(params["images"])
    # every image q // n_img questions, the first q % n_img images one more:
    # the same multiset for every seed
    ids = np.concatenate([np.repeat(np.arange(n_img), q // n_img),
                          np.arange(q % n_img)])
    counts = _exact_counts(params["length_weights"], q)
    lengths = np.repeat(list(counts), list(counts.values()))
    lengths = np.minimum(lengths, max_len).astype(np.int32)
    order = rng.permutation(q)
    ques = rng.integers(1, q_vocab, size=(q, max_len)).astype(np.int32)
    lengths = rng.permutation(lengths)
    ques[np.arange(max_len)[None, :] >= lengths[:, None]] = 0
    return {"image_ids": ids[order].astype(np.int64), "questions": ques,
            "ques_length": lengths}


def soft_answers(params: Dict, q: int, answers: int,
                 seed: int) -> Dict[str, np.ndarray]:
    """Each question's distinct answers and their shares: ``soft_idx``
    [Q, W] int32 (-1 padding), ``soft_val`` [Q, W] float32, ``answers``
    [Q] int32 (the most frequent)."""
    rng = np.random.default_rng([int(seed), 2])
    w = int(params["annotators"])
    p = 1.0 / np.arange(1, answers + 1) ** float(params["answer_zipf"])
    draws = np.sort(rng.choice(answers, size=(q, w), p=p / p.sum()), axis=1)
    first = np.ones_like(draws, dtype=bool)
    first[:, 1:] = draws[:, 1:] != draws[:, :-1]
    run = np.cumsum(first, axis=1) - 1  # which distinct answer
    rows = np.repeat(np.arange(q), w).reshape(q, w)
    counts = np.zeros((q, w), dtype=np.int64)
    np.add.at(counts, (rows, run), 1)
    idx = np.full((q, w), -1, dtype=np.int32)
    idx[rows[first], run[first]] = draws[first]
    val = (counts / w).astype(np.float32)
    best = idx[np.arange(q), counts.argmax(1)]
    return {"soft_idx": idx, "soft_val": val, "answers": best}
