"""Batch pipeline: packed QA arrays + feature store -> host batches (the
port's copy of ``vqa_attention_networks_tpu/data/dataset.py``).

- Batch assembly is fancy indexing: no per-item Python or file I/O.
- Every batch has the same shape: the final partial batch is padded to
  ``batch_size`` by repeating its last row, with a ``valid`` mask.
- ``prefetch`` and ``parallel_epoch`` assemble batches on host threads
  while the device runs the step; the gather and the soft-answer scatter
  run in C with the interpreter lock released (``data/native.py``).
- Three feature feeds: float rows (``feature_dtype`` f16 or f32); the int8
  feed (``feature_dtype=np.int8``: int8 rows in ``image_features`` and
  their f16 scales in ``feature_scale``, ``gather_rows_quantized``); and
  the device-bank feed (``device_bank=True``: no feature gather on the
  host, ``image_rows`` holds each row's dense index into the Solver's
  device-resident table, ``image_features`` is None).
- ``feature_rows``: a rank of a data-parallel run gathers the features (or
  bank rows) of its own rows of each batch only (``parallel/sharding.
  step_rows``); every other field stays the global batch's.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from vqa_attention_networks_tpu_torch.data import native
from vqa_attention_networks_tpu_torch.data.feature_store import FeatureStore
from vqa_attention_networks_tpu_torch.data.prepare import (
    QASplit,
    densify_soft_np,
)


@dataclass
class Batch:
    """One host batch."""

    # [B, 196, 2048] (int8 under the int8 feed); None under the device
    # bank, whose rows the Solver gathers on the device from image_rows.
    # With VqaBatches(feature_rows=...) this, feature_scale and image_rows
    # hold those rows only
    image_features: Optional[np.ndarray]
    questions: np.ndarray  # [B, T] int32
    answers: np.ndarray  # [B] int32 hard labels
    ques_length: np.ndarray  # [B] int32
    valid: np.ndarray  # [B] bool — False on pad rows of the final batch
    soft_answers: Optional[np.ndarray] = None  # [B, A] float32
    # host-only fields of the full evaluation (``Solver.val(full=True)``),
    # None where the artifact lacks them: the sparse annotator data of the
    # VQA consensus metric (raw counts = soft_val * soft_n, attached for
    # every family), the answer-type codes (prepare.ANSWER_TYPE_CODES, -1
    # unknown), the VQA question ids of the leaderboard file, and the
    # question-type codes (QAData.question_type_names)
    soft_idx: Optional[np.ndarray] = None  # [B, W] int32, -1 padded
    soft_val: Optional[np.ndarray] = None  # [B, W] float32
    soft_n: Optional[np.ndarray] = None  # [B] int32
    answer_types: Optional[np.ndarray] = None  # [B] int32
    question_ids: Optional[np.ndarray] = None  # [B] int64
    question_types: Optional[np.ndarray] = None  # [B] int32
    # the int8 feed: the per-(sample, channel) f16 scales of image_features
    feature_scale: Optional[np.ndarray] = None  # [B, C] float16
    # the device-bank feed: dense rows of the Solver's device table
    image_rows: Optional[np.ndarray] = None  # [B] int32

    def __len__(self) -> int:
        return int(self.questions.shape[0])


class VqaBatches:
    """Epoch iterator over one split."""

    def __init__(
        self,
        split: QASplit,
        store: FeatureStore,
        batch_size: int,
        num_answers: int,
        soft_answer: bool,
        shuffle: bool = True,
        seed: int = 0,
        feature_dtype=np.float32,
        device_bank: bool = False,
        feature_rows: Optional[np.ndarray] = None,
    ):
        self.split = split
        self.store = store
        self.batch_size = batch_size
        self.num_answers = num_answers
        self.soft_answer = soft_answer
        self.shuffle = shuffle
        self.feature_dtype = feature_dtype
        self.seed = seed
        # the rows of each batch whose features are gathered (all of them
        # without it)
        self.feature_rows = feature_rows
        self._epoch = 0
        # image_id -> store row once; a batch gather is then integer indexing
        self._rows = store.rows_for(split.image_ids)
        # the device bank's rows are dense positions in [0, n): a combined
        # store's handles ((store << 40) | row) fit no int32 and index no
        # one table
        self._bank_rows = (store.dense_rows(self._rows).astype(np.int32)
                           if device_bank else None)

    def __len__(self) -> int:
        return -(-len(self.split) // self.batch_size)

    def _densify_soft(self, idx: np.ndarray) -> np.ndarray:
        sidx = self.split.soft_idx[idx]
        sval = self.split.soft_val[idx]
        dense = native.densify_soft(sidx, sval, self.num_answers)
        if dense is None:
            dense = densify_soft_np(sidx, sval, self.num_answers)
        return dense

    def _assemble(self, idx: np.ndarray) -> Batch:
        b = len(idx)
        bs = self.batch_size
        valid = np.ones(bs, dtype=bool)
        if b < bs:  # pad the final batch to the same shape
            valid[b:] = False
            idx = np.concatenate([idx, np.broadcast_to(idx[-1:], (bs - b,))])
        split = self.split

        def field(values, dtype):
            return None if values is None else values[idx].astype(dtype)

        has_n = split.soft_n is not None
        feats = scale = rows = None
        fidx = idx if self.feature_rows is None else idx[self.feature_rows]
        if self._bank_rows is not None:
            rows = self._bank_rows[fidx]
        elif np.dtype(self.feature_dtype) == np.int8:
            feats, scale = self.store.gather_rows_quantized(self._rows[fidx])
        else:
            feats = self.store.gather_rows(self._rows[fidx],
                                           dtype=self.feature_dtype)
        return Batch(
            image_features=feats,
            questions=split.questions[idx].astype(np.int32),
            answers=split.answers[idx].astype(np.int32),
            ques_length=split.ques_length[idx].astype(np.int32),
            valid=valid,
            soft_answers=self._densify_soft(idx) if self.soft_answer else None,
            soft_idx=split.soft_idx[idx] if has_n else None,
            soft_val=split.soft_val[idx] if has_n else None,
            soft_n=field(split.soft_n, np.int32),
            answer_types=field(split.answer_types, np.int32),
            question_ids=field(split.question_ids, np.int64),
            question_types=field(split.question_types, np.int32),
            feature_scale=scale,
            image_rows=rows,
        )

    def epoch(self, epoch_index: Optional[int] = None,
              start_batch: int = 0) -> Iterator[Batch]:
        """One epoch of batches. The shuffle is a pure function of
        ``(seed, epoch_index)``, so a resumed run replays the order; without
        an index an internal counter advances per call. ``start_batch``
        skips the first batches without assembling them."""
        for idx in self.epoch_indices(epoch_index, start_batch):
            yield self._assemble(idx)

    def epoch_indices(self, epoch_index: Optional[int] = None,
                      start_batch: int = 0) -> Iterator[np.ndarray]:
        """The epoch's batch-index stream, without assembly."""
        if epoch_index is None:
            epoch_index = self._epoch
        self._epoch = epoch_index + 1
        n = len(self.split)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch_index)).shuffle(order)
        for start in range(start_batch * self.batch_size, n, self.batch_size):
            yield order[start:start + self.batch_size]

    def parallel_epoch(self, epoch_index: Optional[int] = None,
                       start_batch: int = 0, workers: int = 4,
                       depth: Optional[int] = None) -> Iterator[Batch]:
        """``epoch()`` with batch assembly on a thread pool, in order, at
        most ``depth`` batches (default ``workers + 1``) in flight."""
        if workers <= 1:
            yield from self.epoch(epoch_index, start_batch)
            return
        depth = depth or workers + 1
        with ThreadPoolExecutor(max_workers=workers) as ex:
            pending: deque = deque()
            try:
                for idx in self.epoch_indices(epoch_index, start_batch):
                    pending.append(ex.submit(self._assemble, idx))
                    if len(pending) >= depth:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                # an abandoned consumer: drop the queued work so shutdown
                # waits only for the assemblies already running
                for f in pending:
                    f.cancel()


def prefetch(iterator: Iterator[Batch], depth: int = 2) -> Iterator[Batch]:
    """Run ``iterator`` on a background thread, ``depth`` batches ahead."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def producer() -> None:
        try:
            for item in iterator:
                # a bounded put with a stop check: an abandoned consumer
                # would leave a plain put blocked forever
                while True:
                    if stop.is_set():
                        return
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # raised again on the consumer side
            err.append(e)
        finally:
            # the sentinel must arrive while the consumer still listens
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
