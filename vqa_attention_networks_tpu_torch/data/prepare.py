"""The packed QA data the port trains on (the port's copy of
``vqa_attention_networks_tpu/data/prepare.py``, trimmed to what the port
uses: the ``QASplit`` / ``QAData`` containers, the soft-answer scatter and
the synthetic data of the tests and ``chip_smoke.py``).

Questions, answers, lengths and image ids are dense arrays; soft answers a
fixed-width sparse (idx, val) pair (VQA has 10 annotator answers per
question, so width 10 is exact). Question ids are 1-based with 0 for
padding; UNK is the last id.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

SOFT_WIDTH = 10  # VQA collects 10 human answers per question


def densify_soft_np(soft_idx: np.ndarray, soft_val: np.ndarray,
                    num_answers: int) -> np.ndarray:
    """Scatter [N, W] sparse (idx, val) soft answers to [N, num_answers]
    (-1 marks an empty slot); the NumPy twin of ``native.densify_soft``."""
    n = soft_idx.shape[0]
    dense = np.zeros((n, num_answers), dtype=np.float32)
    rows = np.repeat(np.arange(n), soft_idx.shape[1])
    idx = soft_idx.reshape(-1)
    val = soft_val.reshape(-1)
    keep = idx >= 0
    dense[rows[keep], idx[keep]] = val[keep]
    return dense


@dataclass
class QASplit:
    """One split of the packed QA data."""

    questions: np.ndarray  # [N, max_len] int32, 0-padded token ids
    ques_length: np.ndarray  # [N] int32
    answers: np.ndarray  # [N] int32 hard label (vocab index of the top answer)
    image_ids: np.ndarray  # [N] int64 COCO image id
    soft_idx: np.ndarray  # [N, SOFT_WIDTH] int32, -1 padded
    soft_val: np.ndarray  # [N, SOFT_WIDTH] float32

    def __len__(self) -> int:
        return int(self.questions.shape[0])


@dataclass
class QAData:
    """Both splits and the vocabularies."""

    train: QASplit
    val: QASplit
    answer_vocab: Dict[str, int]
    question_vocab: Dict[str, int]
    max_question_length: int

    @property
    def q_vocab_size(self) -> int:
        # pad(0) + words(1..K) + UNK(K+1)  => K+2 embedding rows
        return self.question_vocab["UNK"] + 1

    @property
    def a_vocab_size(self) -> int:
        return len(self.answer_vocab)


def make_synthetic_qa_data(
    rng: np.random.Generator,
    n_train: int = 256,
    n_val: int = 64,
    q_vocab_words: int = 50,
    num_answers: int = 16,
    max_len: int = 22,
    num_images: int = 8,
) -> QAData:
    """Tiny synthetic QAData for tests and ``chip_smoke.py``; the same
    generator state draws the same arrays as the JAX package's function."""

    def _split(n: int) -> QASplit:
        lengths = rng.integers(3, max_len + 1, size=n).astype(np.int32)
        questions = np.zeros((n, max_len), dtype=np.int32)
        for i, length in enumerate(lengths):
            questions[i, :length] = rng.integers(1, q_vocab_words + 2,
                                                 size=length)
        answers = rng.integers(0, num_answers, size=n).astype(np.int32)
        soft_idx = np.full((n, SOFT_WIDTH), -1, dtype=np.int32)
        soft_val = np.zeros((n, SOFT_WIDTH), dtype=np.float32)
        soft_idx[:, 0] = answers
        soft_val[:, 0] = 0.7
        # a distinct second answer so the sparse entries never collide
        offset = rng.integers(1, num_answers, size=n).astype(np.int32)
        soft_idx[:, 1] = (answers + offset) % num_answers
        soft_val[:, 1] = 0.3
        return QASplit(
            questions=questions,
            ques_length=lengths,
            answers=answers,
            image_ids=rng.integers(0, num_images, size=n).astype(np.int64),
            soft_idx=soft_idx,
            soft_val=soft_val,
        )

    question_vocab = {f"w{i}": i + 1 for i in range(q_vocab_words)}
    question_vocab["UNK"] = q_vocab_words + 1
    answer_vocab = {f"a{i}": i for i in range(num_answers - 1)}
    answer_vocab["UNK"] = num_answers - 1
    return QAData(
        train=_split(n_train),
        val=_split(n_val),
        answer_vocab=answer_vocab,
        question_vocab=question_vocab,
        max_question_length=max_len,
    )
