"""The serving forward (port of ``serving_forward`` in
``vqa_attention_networks_tpu/aot.py``): model -> softmax -> top-k over one
fixed batch, for the f16 and the int8 feed.

Export and load of a serving artifact (``export_serving``,
``save_serving_artifact``, ``load_serving_artifact``) and the banked
forwards of the device feature cache wait for the next serving slice
(ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.models.layers import DTYPES


def serving_forward(cfg: Config, topk: int,
                    input_dtype: str = "float16") -> Callable[
                        ..., Tuple[torch.Tensor, torch.Tensor]]:
    """THE serving forward of every family. Returns ``fwd(model, img,
    ques, qlen)`` for the f16 feed, ``fwd(model, img_q, scale, ques,
    qlen)`` for the int8 feed; each gives (top ids [N, k] int64, top
    probabilities [N, k] f32). ``qlen`` goes to the model as
    ``ques_length`` (MHB reads it). The top-k is clamped to the answer
    vocab, as in the JAX function."""
    topk = min(topk, cfg.a_vocab_size)

    def _head(logits: torch.Tensor):
        probs = torch.softmax(logits, dim=-1)
        # bf16 logits tie often; a stable sort breaks ties by the lower
        # answer id, as lax.top_k does (torch.topk leaves the order open)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
        return top_i[:, :topk], top_p[:, :topk]

    if input_dtype == "int8":
        # quantized feed: dequantise on the device, one multiply
        def fwd_int8(model, img_q, scale, ques, qlen):
            dt = DTYPES[cfg.compute_dtype]
            img = img_q.to(dt) * scale[:, None, :].to(dt)
            return _head(model(img, ques, qlen))

        return fwd_int8
    if input_dtype != "float16":
        raise ValueError(f"input_dtype {input_dtype!r}: float16 or int8")

    def fwd(model, img, ques, qlen):
        return _head(model(img, ques, qlen))

    return fwd
