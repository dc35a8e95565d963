"""Offline GloVe embedding table (the port's copy of
``vqa_attention_networks_tpu/data/glove.py``).

The reference looks up GloVe vectors per training item through spaCy
(``data_loader.py:18-23,47-56``). Here the whole vocabulary is embedded
once, offline, into a frozen ``[q_vocab_size, 300]`` table that the model
gathers rows from on the device (``MHBCoAtt``'s ``glove_table`` buffer).

Row 0 (the pad id) is zero, matching ``data_loader.py:51-52``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

GLOVE_DIM = 300


def build_glove_table(
    question_vocab: Dict[str, int],
    dim: int = GLOVE_DIM,
    spacy_model: str = "en_vectors_web_lg",
) -> np.ndarray:
    """Embed the question vocabulary with spaCy GloVe vectors.

    Requires the spaCy model used by the reference (``data_loader.py:19``).
    Raises ImportError if spaCy / the model is unavailable — callers that only
    need *a* table (tests, smoke runs) should use ``random_glove_table``.
    """
    import spacy  # gated: not part of the baked-in environment

    nlp = spacy.load(spacy_model)
    size = max(question_vocab.values()) + 1
    table = np.zeros((size, dim), dtype=np.float32)
    for word, idx in question_vocab.items():
        table[idx] = nlp(word).vector
    table[0] = 0.0  # pad row
    return table


def build_glove_table_from_text(
    question_vocab: Dict[str, int],
    vectors_path: str,
    dim: int = GLOVE_DIM,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Embed the question vocabulary from a standard GloVe text file
    (``glove.840B.300d.txt``-style: one ``word v1 ... vD`` line per word).

    Capability upgrade over the reference's spaCy-only path
    (data_loader.py:19): the published GloVe distributions work directly,
    no spaCy install needed. Streams the (multi-GB) file once, keeping only
    the vocabulary's rows. Out-of-vocabulary words stay zero — the same
    fallback spaCy gives for unknown tokens. Row 0 (pad) is zero
    (data_loader.py:51-52).
    """
    size = max(question_vocab.values()) + 1
    table = np.zeros((size, dim), dtype=np.float32)
    wanted = {w: i for w, i in question_vocab.items() if i != 0}
    remaining = set(wanted)
    with open(vectors_path, "r", encoding="utf-8") as f:
        for line in f:
            if not remaining:
                break
            # split from the right: GloVe 840B tokens may contain spaces
            parts = line.rstrip("\n").rsplit(" ", dim)
            if len(parts) != dim + 1:
                continue  # malformed line
            word = parts[0]
            if word in remaining:
                table[wanted[word]] = np.asarray(parts[1:], dtype=np.float32)
                remaining.discard(word)
    if stats is not None:
        # exact accounting (a zero-sum heuristic over the table would
        # miscount the pad row, UNK, and legitimately-zero vectors)
        stats["matched"] = len(wanted) - len(remaining)
        stats["vocab_words"] = len(wanted)
        stats["unmatched_words"] = sorted(remaining)
    table[0] = 0.0
    return table


def random_glove_table(
    question_vocab: Dict[str, int], dim: int = GLOVE_DIM, seed: int = 0
) -> np.ndarray:
    """Deterministic random stand-in with the same contract (tests/smoke)."""
    size = max(question_vocab.values()) + 1
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((size, dim)).astype(np.float32) * 0.1
    table[0] = 0.0
    return table


def save_glove_table(table: np.ndarray, path: str) -> None:
    np.save(path, table)


def load_glove_table(path: str) -> Optional[np.ndarray]:
    try:
        return np.load(path)
    except FileNotFoundError:
        return None
