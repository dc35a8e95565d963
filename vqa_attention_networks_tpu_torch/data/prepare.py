"""Offline QA preprocessing: VQA v1/v2 JSON -> the packed QA artifact (the
port's copy of ``vqa_attention_networks_tpu/data/prepare.py``).

Either package writes the same artifact and reads the other's: one
``.npz`` of dense arrays per split (questions, lengths, answers, image ids,
the sparse (idx, val) soft answers of width 10, and the optional
``soft_n``, ``answer_types``, ``question_ids`` and ``question_types``) and
one ``.vocab.json``.

Semantics of the reference's pass (``utils.py:111-310``):
- answer vocab = top-(N-1) answers by frequency over train+val annotations,
  ties broken by answer string, plus ``UNK`` at index N-1 (utils.py:226-248);
- soft answers = per-question fraction of the in-vocab annotator answers
  that hit each vocab entry (utils.py:250-265);
- question vocab ids are 1-based in first-seen order with 0 reserved for
  padding (utils.py:294-308); UNK is the last id;
- questions whose top answer is out of vocab are dropped (utils.py:182);
- ``\\w+`` tokenisation + contraction/number normalisation (``text.py``).

Deviation kept from the JAX package: ``q_vocab_size = UNK id + 1``, so
every id (pad, words, UNK) is in range (the reference sizes its embedding
one short, train_models.py:37).
"""

from __future__ import annotations

import collections
import json
import os
from dataclasses import dataclass
from os.path import join
from typing import Dict, List, Optional, Tuple

import numpy as np

from vqa_attention_networks_tpu_torch.data.text import (
    _WORD_RE,
    normalize_answer,
    normalize_words,
)

ANSWER_TYPES = ("all", "other", "yes/no", "number")
SOFT_WIDTH = 10  # VQA collects 10 human answers per question

# Per-question answer-type codes stored in the artifact (QASplit.answer_types)
# so full eval can report the official per-type accuracy breakdown the VQA
# leaderboard uses (yes/no, number, other). The reference reads the
# annotation field only as a prepare-time *filter* (utils.py:148-160); the
# per-question code is what makes the breakdown possible without re-reading
# the raw JSON at eval time. -1 = annotation carried an unknown type.
ANSWER_TYPE_NAMES = ("yes/no", "number", "other")
ANSWER_TYPE_CODES = {name: i for i, name in enumerate(ANSWER_TYPE_NAMES)}


def json_paths(data_dir: str, version: int, split: str) -> Tuple[str, str]:
    """Question/annotation JSON paths for a split (utils.py:115-126).

    THE path scheme: tools/eda.py reuses this so analysis can never
    silently diverge from the files the training pipeline packs."""
    if version == 1:
        q = join(data_dir, f"vqa/MultipleChoice_mscoco_{split}2014_questions.json")
        a = join(data_dir, f"vqa/mscoco_{split}2014_annotations.json")
    else:
        q = join(data_dir, f"vqa/v2_OpenEnded_mscoco_{split}2014_questions.json")
        a = join(data_dir, f"vqa/v2_mscoco_{split}2014_annotations.json")
    return q, a


def build_answer_vocab(annotations: List[dict], num_ans: int) -> Dict[str, int]:
    """Top-(num_ans-1) answers + UNK (utils.py:226-248).

    Matches the reference's ``top_n = min(num_ans, len(distinct))`` exactly:
    when there are fewer distinct answers than ``num_ans`` the least-frequent
    one is still displaced by UNK, so vocab size and label indices agree with
    the reference for filtered answer_type runs too."""
    freq: collections.Counter = collections.Counter(
        normalize_answer(a["multiple_choice_answer"]) for a in annotations
    )
    ranked = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
    top_n = min(num_ans, len(ranked))
    vocab = {ans: i for i, (ans, _) in enumerate(ranked[: top_n - 1])}
    vocab["UNK"] = top_n - 1
    return vocab


def _check_pairing(q: dict, a: dict) -> None:
    """Questions and annotations are paired by list position (the official
    VQA files are index-aligned); a re-sorted or truncated download would
    silently mislabel the whole dataset without this check."""
    if q.get("question_id") != a.get("question_id"):
        raise ValueError(
            "questions/annotations JSON are not index-aligned: question_id "
            f"{q.get('question_id')} paired with annotation "
            f"{a.get('question_id')} — re-download the official files"
        )


def densify_soft_np(
    soft_idx: np.ndarray, soft_val: np.ndarray, num_answers: int
) -> np.ndarray:
    """Scatter [N, W] sparse (idx, val) soft answers to [N, num_answers]
    (data_loader.py:39-42). THE densification: the batch path's NumPy
    fallback (dataset.py) and the artifact-level helper both call this, so
    the semantics cannot diverge."""
    n = soft_idx.shape[0]
    dense = np.zeros((n, num_answers), dtype=np.float32)
    rows = np.repeat(np.arange(n), soft_idx.shape[1])
    idx = soft_idx.reshape(-1)
    val = soft_val.reshape(-1)
    keep = idx >= 0
    dense[rows[keep], idx[keep]] = val[keep]
    return dense


def build_soft_answers(
    answer_vocab: Dict[str, int], annotations: List[dict]
) -> Tuple[Dict[int, Dict[int, float]], Dict[int, int]]:
    """(dists, counts): question_id -> {answer_index: fraction of the
    IN-VOCAB annotator answers} (utils.py:250-265: the reference divides by
    len(a_list), the in-vocab subset — NOT by the raw 10 — so vectors sum
    to 1 whenever any annotator answer is in vocab), and question_id -> the
    in-vocab annotator count itself. The count is stored in the artifact
    (QASplit.soft_n) because the official VQA consensus metric
    min(raw_count/3, 1) needs raw counts, and the normalized fractions
    alone cannot recover them (a unanimous answer is 1.0 at every n).
    Out-of-vocab answers are dropped."""
    out: Dict[int, Dict[int, float]] = {}
    n_in_vocab: Dict[int, int] = {}
    for a in annotations:
        normalized = (normalize_answer(an["answer"]) for an in a["answers"])
        in_vocab = [w for w in normalized if w in answer_vocab]
        dist: Dict[int, float] = {}
        if in_vocab:
            counts = collections.Counter(in_vocab)
            n = float(len(in_vocab))
            dist = {answer_vocab[w]: c / n for w, c in counts.items()}
        out[a["question_id"]] = dist
        n_in_vocab[a["question_id"]] = len(in_vocab)
    return out, n_in_vocab


def build_question_vocab(
    questions: List[dict],
    annotations: List[dict],
    answer_vocab: Dict[str, int],
) -> Tuple[Dict[str, int], int]:
    """First-seen-order 1-based vocab + max question length
    (utils.py:267-310). Only questions whose answer is in the answer vocab
    contribute (the reference's stale-variable quirk at utils.py:278-289 makes
    it re-count the previous question's words for filtered questions; we count
    each kept question once — the resulting vocab is a superset-equivalent and
    self-consistent with the encoding pass below)."""
    vocab: Dict[str, int] = {}
    max_len = 0
    for q, a in zip(questions, annotations):
        _check_pairing(q, a)
        if normalize_answer(a["multiple_choice_answer"]) not in answer_vocab:
            continue
        words = normalize_words(_WORD_RE.findall(q["question"]))
        for w in words:
            if w not in vocab:
                vocab[w] = len(vocab) + 1  # 0 is the pad id
        max_len = max(max_len, len(words))
    vocab["UNK"] = len(vocab) + 1
    return vocab, max_len


@dataclass
class QASplit:
    """One split of the packed QA artifact."""

    questions: np.ndarray  # [N, max_len] int32, 0-padded token ids
    ques_length: np.ndarray  # [N] int32
    answers: np.ndarray  # [N] int32 hard label (vocab index of the top answer)
    image_ids: np.ndarray  # [N] int64 COCO image id
    soft_idx: np.ndarray  # [N, SOFT_WIDTH] int32, -1 padded
    soft_val: np.ndarray  # [N, SOFT_WIDTH] float32
    # in-vocab annotator count per question (soft_val rows are count/soft_n;
    # the official VQA consensus metric needs the raw counts back). None on
    # artifacts written before this field existed.
    soft_n: Optional[np.ndarray] = None  # [N] int32
    # per-question answer-type code (ANSWER_TYPE_CODES; -1 unknown) for the
    # official per-type eval breakdown. None on artifacts written before the
    # field existed, or when the source annotations lack ``answer_type``.
    answer_types: Optional[np.ndarray] = None  # [N] int32
    # VQA question ids, so full eval can export predictions in the official
    # leaderboard submission schema [{"question_id", "answer"}]. None on
    # artifacts written before the field existed.
    question_ids: Optional[np.ndarray] = None  # [N] int64
    # per-question question-type code into QAData.question_type_names (the
    # official eval's perQuestionType breakdown, ~65 types in VQA v2; -1 =
    # annotation had no/unknown type). None when the source lacks the field.
    question_types: Optional[np.ndarray] = None  # [N] int32

    def __len__(self) -> int:
        return int(self.questions.shape[0])

    def soft_dense(self, num_answers: int) -> np.ndarray:
        """Densify soft answers to [N, num_answers] (data_loader.py:39-42)."""
        return densify_soft_np(self.soft_idx, self.soft_val, num_answers)


@dataclass
class QAData:
    """The full packed artifact: both splits + vocabularies."""

    train: QASplit
    val: QASplit
    answer_vocab: Dict[str, int]
    question_vocab: Dict[str, int]
    max_question_length: int
    # code -> name table for QASplit.question_types (None on old artifacts
    # or sources without the annotation field)
    question_type_names: Optional[List[str]] = None

    @property
    def q_vocab_size(self) -> int:
        # pad(0) + words(1..K) + UNK(K+1)  => K+2 embedding rows
        return self.question_vocab["UNK"] + 1

    @property
    def a_vocab_size(self) -> int:
        return len(self.answer_vocab)


def _encode_split(
    questions: List[dict],
    annotations: List[dict],
    answer_vocab: Dict[str, int],
    soft_answers: Dict[int, Dict[int, float]],
    question_vocab: Dict[str, int],
    max_len: int,
    soft_counts: Optional[Dict[int, int]] = None,
    qtype_codes: Optional[Dict[str, int]] = None,
) -> QASplit:
    """Encode one split into packed arrays (the loop at utils.py:177-196).

    ``soft_counts=None`` yields ``soft_n=None`` (metric unavailable) rather
    than an all-zeros array — zeros would make the consensus metric report
    a plausible-looking 0.0 instead of being absent."""
    unk = question_vocab["UNK"]
    rows_q, rows_len, rows_a, rows_img = [], [], [], []
    rows_sidx, rows_sval, rows_sn, rows_at = [], [], [], []
    rows_qid, rows_qt = [], []
    saw_answer_type = False
    for q, a in zip(questions, annotations):
        _check_pairing(q, a)
        ans = normalize_answer(a["multiple_choice_answer"])
        if ans not in answer_vocab:
            continue
        words = normalize_words(_WORD_RE.findall(q["question"]))[:max_len]
        ids = np.zeros(max_len, dtype=np.int32)
        ids[: len(words)] = [question_vocab.get(w, unk) for w in words]
        rows_q.append(ids)
        rows_len.append(len(words))
        rows_a.append(answer_vocab[ans])
        rows_img.append(a["image_id"])
        soft = soft_answers.get(a["question_id"], {})
        sidx = np.full(SOFT_WIDTH, -1, dtype=np.int32)
        sval = np.zeros(SOFT_WIDTH, dtype=np.float32)
        for j, (k, v) in enumerate(sorted(soft.items())[:SOFT_WIDTH]):
            sidx[j] = k
            sval[j] = v
        rows_sidx.append(sidx)
        rows_sval.append(sval)
        if soft_counts is not None:
            rows_sn.append(soft_counts.get(a["question_id"], 0))
        saw_answer_type |= "answer_type" in a
        rows_at.append(ANSWER_TYPE_CODES.get(a.get("answer_type"), -1))
        rows_qid.append(a["question_id"])
        if qtype_codes is not None:
            rows_qt.append(qtype_codes.get(a.get("question_type"), -1))

    n = len(rows_q)
    return QASplit(
        questions=np.stack(rows_q) if n else np.zeros((0, max_len), np.int32),
        ques_length=np.asarray(rows_len, dtype=np.int32),
        answers=np.asarray(rows_a, dtype=np.int32),
        image_ids=np.asarray(rows_img, dtype=np.int64),
        soft_idx=np.stack(rows_sidx) if n else np.zeros((0, SOFT_WIDTH), np.int32),
        soft_val=np.stack(rows_sval) if n else np.zeros((0, SOFT_WIDTH), np.float32),
        soft_n=(np.asarray(rows_sn, dtype=np.int32)
                if soft_counts is not None else None),
        # None (field absent) rather than all -1 when the source annotations
        # lack answer_type — same absent-vs-sentinel rule as soft_n
        answer_types=(np.asarray(rows_at, dtype=np.int32)
                      if saw_answer_type else None),
        question_ids=np.asarray(rows_qid, dtype=np.int64),
        question_types=(np.asarray(rows_qt, dtype=np.int32)
                        if qtype_codes is not None else None),
    )


def prepare_training_data(
    data_dir: str = "data",
    version: int = 2,
    num_ans: int = 1000,
    answer_type: str = "all",
    out_dir: Optional[str] = None,
) -> QAData:
    """Full preparation pass (utils.py:111-224), returning + saving QAData."""
    assert answer_type in ANSWER_TYPES, f"answer_type must be one of {ANSWER_TYPES}"

    splits = {}
    for split in ("train", "val"):
        q_path, a_path = json_paths(data_dir, version, split)
        with open(q_path) as f:
            qs = json.load(f)["questions"]
        with open(a_path) as f:
            ans = json.load(f)["annotations"]
        splits[split] = (qs, ans)

    # Vocabularies are built over train+val combined (utils.py:148-149).
    all_questions = splits["train"][0] + splits["val"][0]
    all_annotations = splits["train"][1] + splits["val"][1]

    if answer_type != "all":
        keep = {
            a["question_id"]
            for a in all_annotations
            if a["answer_type"] == answer_type
        }
        all_annotations = [a for a in all_annotations if a["question_id"] in keep]
        all_questions = [q for q in all_questions if q["question_id"] in keep]
        splits = {
            s: (
                [q for q in qs if q["question_id"] in keep],
                [a for a in ans if a["question_id"] in keep],
            )
            for s, (qs, ans) in splits.items()
        }

    answer_vocab = build_answer_vocab(all_annotations, num_ans)
    soft_answers, soft_counts = build_soft_answers(
        answer_vocab, all_annotations
    )
    question_vocab, max_len = build_question_vocab(
        all_questions, all_annotations, answer_vocab
    )

    # question-type table (official perQuestionType breakdown): sorted for
    # a deterministic code assignment; None when the source lacks the field
    qtype_names = sorted({
        a["question_type"] for a in all_annotations if "question_type" in a
    }) or None
    qtype_codes = (
        {name: i for i, name in enumerate(qtype_names)}
        if qtype_names else None
    )

    data = QAData(
        train=_encode_split(
            *splits["train"], answer_vocab, soft_answers, question_vocab,
            max_len, soft_counts, qtype_codes
        ),
        val=_encode_split(
            *splits["val"], answer_vocab, soft_answers, question_vocab,
            max_len, soft_counts, qtype_codes
        ),
        answer_vocab=answer_vocab,
        question_vocab=question_vocab,
        max_question_length=max_len,
        question_type_names=qtype_names,
    )

    out_dir = out_dir or data_dir
    save_qa_data(data, qa_artifact_path(out_dir, version, num_ans, answer_type))
    return data


def qa_artifact_path(
    data_dir: str, version: int, num_ans: int, answer_type: str = "all"
) -> str:
    """Artifact base path (naming scheme after utils.py:151-155, without the
    implied rename step)."""
    tag = "yesno" if answer_type == "yes/no" else answer_type
    return join(data_dir, f"qa_v{version}_{num_ans}answers_{tag}")


def save_qa_data(data: QAData, base_path: str) -> None:
    os.makedirs(os.path.dirname(base_path) or ".", exist_ok=True)
    arrays = {}
    for split_name in ("train", "val"):
        split: QASplit = getattr(data, split_name)
        for field in ("questions", "ques_length", "answers", "image_ids",
                      "soft_idx", "soft_val"):
            arrays[f"{split_name}_{field}"] = getattr(split, field)
        if split.soft_n is not None:
            arrays[f"{split_name}_soft_n"] = split.soft_n
        if split.answer_types is not None:
            arrays[f"{split_name}_answer_types"] = split.answer_types
        if split.question_ids is not None:
            arrays[f"{split_name}_question_ids"] = split.question_ids
        if split.question_types is not None:
            arrays[f"{split_name}_question_types"] = split.question_types
    np.savez_compressed(base_path + ".npz", **arrays)
    with open(base_path + ".vocab.json", "w") as f:
        vocab_record = {
            "answer_vocab": data.answer_vocab,
            "question_vocab": data.question_vocab,
            "max_question_length": data.max_question_length,
        }
        if data.question_type_names is not None:
            vocab_record["question_type_names"] = data.question_type_names
        json.dump(vocab_record, f)


def load_qa_data(base_path: str) -> QAData:
    """Load a packed artifact (the counterpart of utils.py:312-326)."""
    arrays = np.load(base_path + ".npz")
    with open(base_path + ".vocab.json") as f:
        vocab = json.load(f)
    splits = {}
    for split_name in ("train", "val"):
        splits[split_name] = QASplit(
            questions=arrays[f"{split_name}_questions"],
            ques_length=arrays[f"{split_name}_ques_length"],
            answers=arrays[f"{split_name}_answers"],
            image_ids=arrays[f"{split_name}_image_ids"],
            soft_idx=arrays[f"{split_name}_soft_idx"],
            soft_val=arrays[f"{split_name}_soft_val"],
            # absent on artifacts written before soft_n existed
            soft_n=(arrays[f"{split_name}_soft_n"]
                    if f"{split_name}_soft_n" in arrays else None),
            answer_types=(arrays[f"{split_name}_answer_types"]
                          if f"{split_name}_answer_types" in arrays else None),
            question_ids=(arrays[f"{split_name}_question_ids"]
                          if f"{split_name}_question_ids" in arrays else None),
            question_types=(arrays[f"{split_name}_question_types"]
                            if f"{split_name}_question_types" in arrays
                            else None),
        )
    return QAData(
        train=splits["train"],
        val=splits["val"],
        answer_vocab=vocab["answer_vocab"],
        question_vocab=vocab["question_vocab"],
        max_question_length=vocab["max_question_length"],
        question_type_names=vocab.get("question_type_names"),
    )


def make_synthetic_qa_data(
    rng: np.random.Generator,
    n_train: int = 256,
    n_val: int = 64,
    q_vocab_words: int = 50,
    num_answers: int = 16,
    max_len: int = 22,
    num_images: int = 8,
) -> QAData:
    """Tiny synthetic QAData for tests and the end-to-end smoke slice."""

    def _split(n: int, qid_start: int = 0) -> QASplit:
        lengths = rng.integers(3, max_len + 1, size=n).astype(np.int32)
        questions = np.zeros((n, max_len), dtype=np.int32)
        for i, l in enumerate(lengths):
            questions[i, :l] = rng.integers(1, q_vocab_words + 2, size=l)
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
            # 0.7/0.3 fractions model 7/3 of 10 in-vocab annotators
            soft_n=np.full(n, 10, dtype=np.int32),
            # deterministic spread over the three official types so the
            # per-type eval breakdown is exercised on synthetic data
            answer_types=(answers % 3).astype(np.int32),
            question_ids=np.arange(qid_start, qid_start + n, dtype=np.int64),
            # and over a few question types for the perQuestionType path
            question_types=(answers % 4).astype(np.int32),
        )

    question_vocab = {f"w{i}": i + 1 for i in range(q_vocab_words)}
    question_vocab["UNK"] = q_vocab_words + 1
    answer_vocab = {f"a{i}": i for i in range(num_answers - 1)}
    answer_vocab["UNK"] = num_answers - 1
    return QAData(
        train=_split(n_train),
        val=_split(n_val, qid_start=n_train),
        answer_vocab=answer_vocab,
        question_vocab=question_vocab,
        max_question_length=max_len,
        question_type_names=["what is", "what color", "how many", "is the"],
    )
