"""Batched inference engine on one device (port of ``InferenceEngine`` and
``DeviceFeatureCache`` in ``vqa_attention_networks_tpu/serve.py``).

- Any of the eight families (``models.get_model``), chosen by
  ``cfg.model_name``; each request's question length reaches the model as
  ``ques_length`` (MHB reads it), counted from the non-pad tokens when the
  caller gives none, and clamped at 1.
- One fixed batch size: smaller requests are padded, and the padding is
  dropped from the results.
- bf16 activations and f32 logits; on a CUDA device the family's eval
  forward launches its hand-written kernels (K1 for mhb_coAtt, K4 for
  hieCoAtten; K5 and K7 under their switches, ``ops/grid_fusion.py`` and
  ``ops/attention.py``; mhb, visLstm, iBOWIMG and attentionNet have none,
  as in JAX).
- ``predict_stream`` keeps one batch in flight: PyTorch's launches return
  before the device finishes, so the host assembles batch t+1 while the
  device runs batch t; ``_collect`` is where the results are copied to the
  host, which waits for the device.
- The device feature cache (``attach_feature_cache``,
  ``predict_batch_by_id``, ``predict_stream_by_id``): the int8 rows and f16
  scales of recently served images stay in device memory, and a request
  names its image by id, so a hit ships no feature bytes to the card.
- ``trained_params`` reads the weights ``cli.train`` exported
  (``utils/checkpoint.save_weights``) as the parameter tree the engine
  takes.

Not ported yet (each raises ``NotImplementedError``): serving an exported
artifact (ROADMAP Queue 1 item 14) and ``data_parallel > 1`` with its
sharded bank (item 10).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch import aot
from vqa_attention_networks_tpu_torch.device import cuda_device
from vqa_attention_networks_tpu_torch.models import get_model
from vqa_attention_networks_tpu_torch.utils import checkpoint as ckpt
from vqa_attention_networks_tpu_torch.weights import (
    load_jax_params,
    to_jax_params,
)

_ARTIFACT_ITEM = "ROADMAP Queue 1 item 14 (the exported serving artifact)"
_MULTI_GPU_ITEM = "ROADMAP Queue 1 item 10 (multi-GPU)"

Fetch = Callable[[List[int]], Tuple[np.ndarray, np.ndarray]]


@dataclass
class Prediction:
    answer_id: int
    top_ids: np.ndarray  # [k]
    top_probs: np.ndarray  # [k]


class DeviceFeatureCache:
    """Device-resident int8 feature bank for repeat-image serving.

    VQA traffic asks ~3 questions of each image (the reference loads the
    features of shared images once per question, data_loader.py:27-32),
    and the per-request feed ships every grid over the host link again.
    The bank keeps the int8 rows [C, L, D] and f16 scales [C, D] of the
    hot images on the device; a request names its image by id and the
    serving forward gathers its slot (``aot.serving_forward_banked``).

    - Cost: ``capacity x (L*D int8 + D f16)`` bytes, 396 KB an image at
      196 x 2048: every VQA-val image (~40k, 15.7 GB) fits on an 80 GB card
      beside the ~1 GB model.
    - Eviction is LRU by last-use tick, and never takes an id of the batch
      being assembled; a batch with more distinct ids than the capacity is
      refused.
    - Misses upload in ONE host-to-device copy of their rows and one of
      their scales, then ``index_copy_`` into the bank. (JAX splits them
      into power-of-two chunks only because ``jit`` compiles one program
      per shape; an eager copy takes any count.) On the card the rows go
      through a pinned staging buffer with a ``non_blocking`` copy; before
      the buffer is written again the host waits on the event recorded
      after that copy, so a copy still in flight never reads rows of the
      next batch.
    - The uploads run on the current stream, the stream of the forward.
      ``predict_stream_by_id`` keeps one batch in flight, and a slot that
      batch still gathers from may be evicted and rewritten for the next
      one: stream order puts the rewrite after the in-flight gather. An
      upload moved to a side stream would have to wait on an event
      recorded after the in-flight batch's gather.
    - ``mesh`` (the sharded bank of JAX's data-parallel engine) is
      ROADMAP Queue 1 item 10 and raises ``NotImplementedError``.
    """

    def __init__(self, cfg: Config, capacity: int,
                 num_regions: Optional[int] = None,
                 channels: Optional[int] = None,
                 mesh=None,
                 device: Union[str, torch.device, None] = None):
        if mesh is not None:
            raise NotImplementedError(
                f"a device feature cache sharded over a mesh is not ported "
                f"yet: {_MULTI_GPU_ITEM}")
        # the grid follows the store it is fed from, not the config: models
        # pool over whatever L the grid has
        l = num_regions if num_regions is not None else cfg.img_feature_dim
        d = channels if channels is not None else cfg.img_feature_channel
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError(f"capacity {capacity}: at least 1")
        self.device = torch.device(device) if device is not None \
            else cuda_device()
        self._rows = torch.zeros((self.capacity, l, d), dtype=torch.int8,
                                 device=self.device)
        self._scale = torch.zeros((self.capacity, d), dtype=torch.float16,
                                  device=self.device)
        self._staging: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._staged: Optional[torch.cuda.Event] = None
        self._slot: dict = {}  # image_id -> slot
        self._order: dict = {}  # image_id -> monotone last-use tick (LRU)
        self._tick = 0
        self._free = list(range(self.capacity - 1, -1, -1))
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.uploads = 0  # host-to-device uploads, one per batch of misses

    def reset_stats(self) -> None:
        """Zero the hit/miss/eviction/upload counters (the contents stay):
        after a warm-up, so that the rates are the steady state's."""
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.uploads = 0

    @property
    def rows(self) -> torch.Tensor:
        return self._rows

    @property
    def scale(self) -> torch.Tensor:
        return self._scale

    def _touch(self, image_id) -> None:
        self._tick += 1
        self._order[image_id] = self._tick

    def _take_slot(self, batch_ids: set) -> int:
        if self._free:
            return self._free.pop()
        victim = min(
            (i for i in self._order if i not in batch_ids),
            key=self._order.__getitem__,
        )
        self.evictions += 1
        slot = self._slot.pop(victim)
        del self._order[victim]
        return slot

    def _upload(self, rows: np.ndarray, scale: np.ndarray,
                slots: np.ndarray) -> None:
        """Write ``rows`` [k, L, D] int8 and ``scale`` [k, D] f16 into the
        bank's ``slots``: one copy of each to the device, on the current
        stream."""
        idx = torch.from_numpy(slots.astype(np.int64)).to(self.device)
        if self.device.type != "cuda":
            self._rows.index_copy_(0, idx, torch.from_numpy(rows))
            self._scale.index_copy_(0, idx, torch.from_numpy(scale))
            return
        k = len(slots)
        if self._staging is None or self._staging[0].shape[0] < k:
            if self._staged is not None:
                self._staged.synchronize()
            self._staging = (
                torch.empty((k, *rows.shape[1:]), dtype=torch.int8,
                            pin_memory=True),
                torch.empty((k, scale.shape[1]), dtype=torch.float16,
                            pin_memory=True))
        elif self._staged is not None:
            # the last non_blocking copy may still read the buffer
            self._staged.synchronize()
        host_rows, host_scale = (b[:k] for b in self._staging)
        host_rows.numpy()[...] = rows
        host_scale.numpy()[...] = scale
        self._rows.index_copy_(0, idx,
                               host_rows.to(self.device, non_blocking=True))
        self._scale.index_copy_(0, idx,
                                host_scale.to(self.device, non_blocking=True))
        self._staged = torch.cuda.Event()
        self._staged.record()

    def ensure(self, image_ids: Sequence[int], fetch: Fetch) -> np.ndarray:
        """Slot indices [n] int32 for ``image_ids``, uploading the misses.

        ``fetch(missing_ids) -> (rows [k, L, D] int8, scale [k, D])``, the
        signature of the int8 store's ``gather_quantized``
        (``data/feature_store.py``). The distinct ids of a batch must fit
        the capacity (the cache never evicts the batch it assembles)."""
        ids = [int(i) for i in image_ids]
        batch_ids = set(ids)
        if len(batch_ids) > self.capacity:
            raise ValueError(
                f"batch has {len(batch_ids)} distinct images but the "
                f"device cache holds {self.capacity}"
            )
        missing = sorted({i for i in ids if i not in self._slot})
        if missing:
            rows, scale = fetch(missing)
            rows = np.ascontiguousarray(rows)
            scale = np.ascontiguousarray(scale, dtype=np.float16)
            if rows.dtype != np.int8:
                raise TypeError(f"fetch gave {rows.dtype} rows: the bank "
                                "holds the int8 layout")
            slots = np.empty(len(missing), dtype=np.int32)
            for j, image_id in enumerate(missing):
                slots[j] = self._take_slot(batch_ids)
                self._slot[image_id] = int(slots[j])
                self._touch(image_id)
            self._upload(rows, scale, slots)
            self.uploads += 1
        # hits: requests that needed no upload (a repeat of an id missed in
        # this batch still saves its transfer, so it counts)
        self.misses += len(missing)
        self.hits += len(ids) - len(missing)
        idx = np.empty(len(ids), dtype=np.int32)
        for pos, image_id in enumerate(ids):
            self._touch(image_id)
            idx[pos] = self._slot[image_id]
        return idx


def trained_params(cfg: Config, directory: str):
    """The weights ``cli.train`` exported under ``directory``
    (``<model_dir>/<model_name>``, ``utils/checkpoint.load_weights``) as
    the JAX-layout tree ``InferenceEngine`` takes. The engine loads it with
    ``weights.load_jax_params``, which lays K1's weights out again
    (``MHBCoAtt.prepare``): a layout left from other weights would serve
    answers of the wrong model."""
    model = get_model(cfg.model_name)(cfg)
    model.load_state_dict(ckpt.load_weights(directory))
    return to_jax_params(model)


class InferenceEngine:
    def __init__(
        self,
        cfg: Config,
        params,
        batch_size: int = 256,
        topk: int = 5,
        artifact_dir: Optional[str] = None,
        input_dtype: str = "float16",
        data_parallel: int = 1,
        device: Union[str, torch.device, None] = None,
    ):
        """``params`` is a parameter tree in the JAX layout (numpy arrays),
        the same argument the JAX engine takes. ``device`` defaults to the
        card; the CPU runs only when asked for by name."""
        if artifact_dir is not None:
            raise NotImplementedError(
                f"serving an exported artifact is not ported yet: "
                f"{_ARTIFACT_ITEM}"
            )
        if int(data_parallel) != 1:
            raise NotImplementedError(
                f"data_parallel serving is not ported yet: {_MULTI_GPU_ITEM}"
            )
        if input_dtype not in ("float16", "int8"):
            raise ValueError(f"input_dtype {input_dtype!r}: float16 or int8")
        self.cfg = cfg.replace(compute_dtype="bfloat16")
        self.device = torch.device(device) if device is not None \
            else cuda_device()
        self.batch_size = batch_size
        self.input_dtype = input_dtype
        self.topk = min(topk, cfg.a_vocab_size)
        model = get_model(self.cfg.model_name)(self.cfg).to(self.device)
        self.model = load_jax_params(model, params).eval()
        self._fwd = aot.serving_forward(self.cfg, self.topk, input_dtype)
        self._cache: Optional[DeviceFeatureCache] = None

    def attach_feature_cache(self, capacity: int, fetch: Fetch,
                             num_regions: Optional[int] = None,
                             channels: Optional[int] = None,
                             ) -> DeviceFeatureCache:
        """Enable the device feature bank (``DeviceFeatureCache``, on the
        engine's device) and the ``predict_*_by_id`` entry points.
        ``fetch(missing_ids) -> (int8 rows, scales)``, typically the int8
        store's ``gather_quantized``. Needs the int8 engine: the bank holds
        the quantized layout."""
        if self.input_dtype != "int8":
            raise ValueError(
                "the device feature cache stores the quantized layout — "
                "construct InferenceEngine(input_dtype='int8')"
            )
        self._cache = DeviceFeatureCache(
            self.cfg, capacity, num_regions=num_regions, channels=channels,
            device=self.device,
        )
        self._fetch = fetch
        # held across ensure() and the dispatch: another thread's eviction
        # must not retarget a slot between this batch's ensure() and the
        # enqueue of its gather (stream order then makes the gather read
        # the slots ensure() resolved)
        self._bank_lock = threading.Lock()
        self._fwd_bank = aot.serving_forward_banked(self.cfg, self.topk)
        return self._cache

    def _pad(self, arr: np.ndarray, fill=0) -> Tuple[np.ndarray, int]:
        n = arr.shape[0]
        if n == self.batch_size:
            return arr, n
        if n > self.batch_size:
            raise ValueError(
                f"request of {n} larger than engine batch size "
                f"{self.batch_size}"
            )
        pad = np.full(
            (self.batch_size - n, *arr.shape[1:]), fill, dtype=arr.dtype
        )
        return np.concatenate([arr, pad]), n

    @staticmethod
    def _to_f16(feats: np.ndarray) -> np.ndarray:
        """Overflow-safe f16 cast: |x| > 65504 would become inf and ride the
        forward into NaN logits."""
        if feats.dtype == np.float16:
            return feats
        lim = np.float32(np.finfo(np.float16).max)
        return np.clip(feats, -lim, lim).astype(np.float16)

    def _feature_args(self, image_features, feature_scale):
        if self.input_dtype == "int8":
            if feature_scale is None:
                raise ValueError(
                    "int8 engine needs feature_scale (store.gather_quantized)"
                )
            if image_features.dtype != np.int8:
                raise TypeError(
                    f"int8 engine takes int8 features, got "
                    f"{image_features.dtype}"
                )
            img, n = self._pad(image_features)
            scale, _ = self._pad(feature_scale.astype(np.float16))
            return (img, scale), n
        if feature_scale is not None:
            raise ValueError(
                "feature_scale given to a float16 engine — construct "
                "InferenceEngine(input_dtype='int8') for the quantized feed"
            )
        img, n = self._pad(self._to_f16(image_features))
        return (img,), n

    def _question_args(self, questions, ques_length) -> list:
        """Padded questions and lengths (counted from the non-pad tokens
        when not given, clamped at 1), as host arrays."""
        if ques_length is None:
            ques_length = (questions != 0).sum(axis=1).astype(np.int32)
        ques, _ = self._pad(np.asarray(questions).astype(np.int32))
        qlen, _ = self._pad(
            np.maximum(np.asarray(ques_length).astype(np.int32), 1), fill=1
        )
        return [ques, qlen]

    def _to_device(self, arrays) -> list:
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

    def _dispatch(self, image_features, questions, ques_length,
                  feature_scale):
        """Pad, upload and launch one batch; returns (device results, n)."""
        feats, n = self._feature_args(image_features, feature_scale)
        args = self._to_device(
            [*feats, *self._question_args(questions, ques_length)])
        with torch.inference_mode():
            handles = self._fwd(self.model, *args)
        return handles, n

    def _dispatch_by_id(self, image_ids, questions, ques_length):
        """Resolve the slots (uploading misses) and launch one batch from
        the bank; returns (device results, n)."""
        if self._cache is None:
            raise RuntimeError(
                "call attach_feature_cache() before predict_*_by_id")
        ques, qlen = self._to_device(
            self._question_args(questions, ques_length))
        with self._bank_lock:
            idx = self._cache.ensure(image_ids, self._fetch)
            # padding gathers slot 0: harmless, dropped by n
            idx, n = self._pad(idx.astype(np.int64))
            (idx,) = self._to_device([idx])
            with torch.inference_mode():
                handles = self._fwd_bank(self.model, self._cache.rows,
                                         self._cache.scale, idx, ques, qlen)
        return handles, n

    def predict_batch_by_id(
        self,
        image_ids: Sequence[int],  # [n], n <= batch_size
        questions: np.ndarray,  # [n, T] int32
        ques_length: Optional[np.ndarray] = None,
    ) -> List[Prediction]:
        """``predict_batch`` with the features taken from the device bank
        by image id: a hit ships no feature bytes to the device."""
        return self._collect(*self._dispatch_by_id(image_ids, questions,
                                                   ques_length))

    def predict_stream_by_id(
        self,
        batches: Iterator[Tuple[Sequence[int], np.ndarray,
                                Optional[np.ndarray]]],
    ) -> Iterator[List[Prediction]]:
        """``predict_stream`` over (image_ids, questions, qlen) items
        served from the device bank, one batch in flight: a batch's miss
        uploads are enqueued behind the in-flight batch's forward."""
        pending = None
        for image_ids, questions, ques_length in batches:
            handles = self._dispatch_by_id(image_ids, questions, ques_length)
            if pending is not None:
                yield self._collect(*pending)
            pending = handles
        if pending is not None:
            yield self._collect(*pending)

    def predict_batch(
        self,
        image_features: np.ndarray,  # [n, L, D], n <= batch_size
        questions: np.ndarray,  # [n, T] int32
        ques_length: Optional[np.ndarray] = None,
        feature_scale: Optional[np.ndarray] = None,  # [n, D] f16 (int8 feed)
    ) -> List[Prediction]:
        return self._collect(*self._dispatch(
            image_features, questions, ques_length, feature_scale
        ))

    def predict_stream(
        self,
        batches: Iterator[Sequence],
    ) -> Iterator[List[Prediction]]:
        """Pipelined streaming with one batch in flight. Items are
        (features, questions, qlen) or (features, questions, qlen,
        feature_scale) for the int8 feed."""
        pending = None
        for item in batches:
            feature_scale = item[3] if len(item) > 3 else None
            handles = self._dispatch(item[0], item[1], item[2], feature_scale)
            if pending is not None:
                yield self._collect(*pending)
            pending = handles
        if pending is not None:
            yield self._collect(*pending)

    def _collect(self, handles, n: int) -> List[Prediction]:
        top_i = handles[0][:n].cpu().numpy()
        top_p = handles[1][:n].cpu().numpy()
        return [
            Prediction(int(top_i[i, 0]), top_i[i], top_p[i]) for i in range(n)
        ]
