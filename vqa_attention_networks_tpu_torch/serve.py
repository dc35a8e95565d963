"""Batched inference engine on one device (port of ``InferenceEngine`` in
``vqa_attention_networks_tpu/serve.py``).

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

Not ported yet (each raises ``NotImplementedError``): serving an exported
artifact, ``data_parallel > 1`` and the device feature cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch import aot
from vqa_attention_networks_tpu_torch.device import cuda_device
from vqa_attention_networks_tpu_torch.models import get_model
from vqa_attention_networks_tpu_torch.weights import load_jax_params

_SERVING_SLICE = "ROADMAP Queue 1 item 5 (next serving slice)"


@dataclass
class Prediction:
    answer_id: int
    top_ids: np.ndarray  # [k]
    top_probs: np.ndarray  # [k]


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
                f"{_SERVING_SLICE}"
            )
        if int(data_parallel) != 1:
            raise NotImplementedError(
                "data_parallel serving is not ported yet: ROADMAP Queue 1 "
                "item 10 (multi-GPU)"
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

    def attach_feature_cache(self, *args, **kwargs):
        raise NotImplementedError(
            f"the device feature cache is not ported yet: {_SERVING_SLICE}"
        )

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

    def _dispatch(self, image_features, questions, ques_length,
                  feature_scale):
        """Pad, upload and launch one batch; returns (device results, n)."""
        if ques_length is None:
            ques_length = (questions != 0).sum(axis=1).astype(np.int32)
        feats, n = self._feature_args(image_features, feature_scale)
        ques, _ = self._pad(questions.astype(np.int32))
        qlen, _ = self._pad(
            np.maximum(ques_length.astype(np.int32), 1), fill=1
        )
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (*feats, ques, qlen)]
        with torch.inference_mode():
            handles = self._fwd(self.model, *args)
        return handles, n

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
