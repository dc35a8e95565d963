"""Batch pipeline: packed QA arrays + feature store -> host batches (the
port's copy of ``vqa_attention_networks_tpu/data/dataset.py``, trimmed to
what the port's ``Solver`` uses).

- Batch assembly is fancy indexing: no per-item Python or file I/O.
- Every batch has the same shape: the final partial batch is padded to
  ``batch_size`` with a ``valid`` mask.
- ``prefetch`` and ``parallel_epoch`` assemble batches on host threads
  while the device runs the step; the gather and the soft-answer scatter
  run in C with the interpreter lock released (``data/native.py``).
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

    image_features: np.ndarray  # [B, 196, 2048]
    questions: np.ndarray  # [B, T] int32
    answers: np.ndarray  # [B] int32 hard labels
    ques_length: np.ndarray  # [B] int32
    valid: np.ndarray  # [B] bool — False on pad rows of the final batch
    soft_answers: Optional[np.ndarray] = None  # [B, A] float32

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
    ):
        self.split = split
        self.store = store
        self.batch_size = batch_size
        self.num_answers = num_answers
        self.soft_answer = soft_answer
        self.shuffle = shuffle
        self.feature_dtype = feature_dtype
        self.seed = seed
        self._epoch = 0
        # image_id -> store row once; a batch gather is then integer indexing
        self._rows = store.rows_for(split.image_ids)

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
        return Batch(
            image_features=self.store.gather_rows(self._rows[idx],
                                                  dtype=self.feature_dtype),
            questions=self.split.questions[idx].astype(np.int32),
            answers=self.split.answers[idx].astype(np.int32),
            ques_length=self.split.ques_length[idx].astype(np.int32),
            valid=valid,
            soft_answers=self._densify_soft(idx) if self.soft_answer else None,
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
