"""iBOWIMG, the stacked alternating-attention network, and their attention
primitives (port of ``vqa_attention_networks_tpu/models/ibowimg.py``).

- ``IBOWIMG``: a bag-of-words question (the sum of its embeddings) beside
  the batch-normed projection of the mean-pooled image, then a linear
  classifier. The grid is mean-pooled in the feed's dtype, then cast
  (``ibowimg.py:154-156``).
- ``AttentionNet``: ``cfg.att_num`` alternating additive-attention layers,
  even layers image-guides-question, odd layers question-guides-image;
  the classifier reads the two attention maps concatenated along dim 1
  (the JAX package's fix of the reference's dim-0 concat), and a batch
  norm normalises its f32 logits.
- ``Attention1`` (``attention_1``): additive attention in JAX's decomposed
  form, not the reference's [N, T, L, D] broadcast: the score is
  ``w.f1[l] + w.f2[t] + b`` with the bias counted once, in f1's term.
- ``Attention2`` (``attention_2``): bilinear attention f2 (W f1)^T; its
  ``fc2`` is defined and unused, as upstream.
- ``AttentionLayer`` (``attention_layer``): ReLU, attention, residual +
  ReLU. ``NonlinearLayer`` (``nonlinear_layer``): tanh * sigmoid.

Both families return their batch norm's statistics beside the logits
(``aux=True``: ``{"batch_stats": {layer: {"mean", "var"}}}``, the JAX
``aux["batch_stats"]``); the train step EMAs them into the layer's
buffers. No kernel of the port runs here, as JAX dispatches no Pallas
kernel on these models. Attribute names are the JAX param-tree keys.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.models import layers as L


# ---------------------------------------------------------------------------
# attention primitives
# ---------------------------------------------------------------------------

def attention_1_init(generator: torch.Generator, feature_size: int) -> Dict:
    return {"fc": L.dense_init(generator, feature_size, 1)}


def attention_2_init(generator: torch.Generator, feature_size: int) -> Dict:
    return {
        "fc1": L.dense_init(generator, feature_size, feature_size,
                            bias=False),
        "fc2": L.dense_init(generator, feature_size, 1),
    }


def attention_layer_init(generator: torch.Generator, feature_size: int,
                         att_type: int = 1) -> Dict:
    init = attention_1_init if att_type == 1 else attention_2_init
    return {"att": init(generator, feature_size)}


def nonlinear_layer_init(generator: torch.Generator, f_size: int) -> Dict:
    return {"fc1": L.dense_init(generator, f_size, f_size),
            "fc2": L.dense_init(generator, f_size, f_size)}


class Attention1(nn.Module):
    def __init__(self, feature_size: int):
        super().__init__()
        self.fc = L.Dense(feature_size, 1)

    def forward(self, feature_1: torch.Tensor, feature_2: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feature_1 [N, L, D] (attended over), feature_2 [N, T, D] (the
        queries) -> (f_hat [N, T, D], att [N, T, L])."""
        s1 = self.fc(feature_1)[..., 0]  # [N, L]: w.f1 + b
        s2 = torch.matmul(feature_2, self.fc.weight[0].to(feature_2.dtype))
        att = torch.softmax(s2[:, :, None] + s1[:, None, :], dim=2)
        return torch.matmul(att, feature_1), att


class Attention2(nn.Module):
    def __init__(self, feature_size: int):
        super().__init__()
        self.fc1 = L.Dense(feature_size, feature_size, bias=False)
        self.fc2 = L.Dense(feature_size, 1)  # defined but unused upstream

    def forward(self, feature_1: torch.Tensor, feature_2: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        f1w = self.fc1(feature_1)  # [N, L, D]
        att = torch.softmax(torch.matmul(feature_2, f1w.transpose(1, 2)),
                            dim=2)
        return torch.matmul(att, feature_1), att


class AttentionLayer(nn.Module):
    def __init__(self, feature_size: int, att_type: int = 1):
        super().__init__()
        self.att = (Attention1 if att_type == 1 else Attention2)(feature_size)

    def forward(self, feature_1: torch.Tensor, feature_2: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (relu(f1), relu(relu(f2) + f_hat), att)."""
        f1 = torch.relu(feature_1)
        f2 = torch.relu(feature_2)
        f_hat, att = self.att(f1, f2)
        return f1, torch.relu(f2 + f_hat), att


class NonlinearLayer(nn.Module):
    def __init__(self, f_size: int):
        super().__init__()
        self.fc1 = L.Dense(f_size, f_size)
        self.fc2 = L.Dense(f_size, f_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.fc1(x)) * torch.sigmoid(self.fc2(x))


# ---------------------------------------------------------------------------
# iBOWIMG
# ---------------------------------------------------------------------------

def ibowimg_init_params(cfg: Config, generator: torch.Generator) -> Dict:
    """A random parameter tree in the JAX layout (``_ibow_init``)."""
    e, g = cfg.embed_size, generator
    return {
        "img_emb": L.dense_init(g, cfg.img_feature_channel, e),
        "img_bn": L.batchnorm_init(e),
        "que_emb": L.embedding_init(g, cfg.q_vocab_size, e),
        "fc": L.dense_init(g, 2 * e, cfg.a_vocab_size),
    }


class IBOWIMG(nn.Module):
    """iBOWIMG: (img [N, L, D] or [N, D], ques [N, T]) -> f32 logits
    [N, a_vocab]. Parameters are allocated empty; load them with
    ``weights.load_jax_params``."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_size
        self.img_emb = L.Dense(cfg.img_feature_channel, e)
        self.img_bn = L.BatchNorm(e)
        self.que_emb = L.Embedding(cfg.q_vocab_size, e)
        self.fc = L.Dense(2 * e, cfg.a_vocab_size)

    def forward(self, img: torch.Tensor, ques: torch.Tensor,
                ques_length: Optional[torch.Tensor] = None, *,
                train: bool = False,
                valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                fusion_seed: Optional[int] = None,
                reference_kernels: bool = False, aux: bool = False):
        """-> f32 logits [N, a_vocab]; with ``aux=True``, (logits,
        {"batch_stats": {"img_bn": ...}}). ``train=True`` normalises by
        the statistics of the rows where ``valid`` is set, and draws the
        two dropout masks (image, then question) from ``generator``.
        ``ques_length``, ``fusion_seed`` and ``reference_kernels`` are
        taken for the common signature and not read."""
        cfg = self.cfg
        dtype = L.DTYPES[cfg.compute_dtype]
        rate = cfg.dropout_default
        if img.dim() == 3:  # grid -> vector, in the feed's dtype
            img = torch.mean(img, dim=1)
        x, stats = self.img_bn(self.img_emb(img.to(dtype)), train, valid)
        x = L.dropout(torch.relu(x), rate, train, generator)
        que = L.dropout(self.que_emb(ques, dtype), rate, train, generator)
        que = torch.sum(que, dim=1)  # bag of words
        logits = self.fc(torch.cat([x, que], dim=-1)).float()
        if aux:
            return logits, {"batch_stats": {"img_bn": stats}}
        return logits


# ---------------------------------------------------------------------------
# AttentionNet
# ---------------------------------------------------------------------------

def attention_net_init_params(cfg: Config,
                              generator: torch.Generator) -> Dict:
    """A random parameter tree in the JAX layout (``_attnet_init``); every
    layer is of type 1, as upstream."""
    e, g = cfg.embed_size, generator
    p = {
        "img_emb": L.dense_init(g, cfg.img_feature_channel, e),
        "que_emb": L.embedding_init(g, cfg.q_vocab_size, e),
        "fc": L.dense_init(
            g, 2 * cfg.img_feature_dim * cfg.max_question_length,
            cfg.a_vocab_size),
        "batchnorm": L.batchnorm_init(cfg.a_vocab_size),
    }
    for i in range(cfg.att_num):
        p[f"att{i}"] = attention_layer_init(g, e, att_type=1)
    return p


class AttentionNet(nn.Module):
    """attentionNet: (img [N, 196, D], ques [N, T]) -> f32 logits
    [N, a_vocab], batch-normed. Parameters are allocated empty; load them
    with ``weights.load_jax_params``."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_size
        self.img_emb = L.Dense(cfg.img_feature_channel, e)
        self.que_emb = L.Embedding(cfg.q_vocab_size, e)
        self.fc = L.Dense(2 * cfg.img_feature_dim * cfg.max_question_length,
                          cfg.a_vocab_size)
        self.batchnorm = L.BatchNorm(cfg.a_vocab_size)
        for i in range(cfg.att_num):
            setattr(self, f"att{i}", AttentionLayer(e, att_type=1))

    def forward(self, img: torch.Tensor, ques: torch.Tensor,
                ques_length: Optional[torch.Tensor] = None, *,
                train: bool = False,
                valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                fusion_seed: Optional[int] = None,
                reference_kernels: bool = False, aux: bool = False):
        """-> f32 logits [N, a_vocab]; with ``aux=True``, (logits,
        {"que_att": [N, T, L], "img_att": [N, L, T], "batch_stats":
        {"batchnorm": ...}}). ``train=True`` as ``IBOWIMG``'s; the other
        arguments are taken for the common signature and not read."""
        cfg = self.cfg
        dtype = L.DTYPES[cfg.compute_dtype]
        rate = cfg.dropout_default
        n = ques.shape[0]
        img = L.dropout(torch.relu(self.img_emb(img.to(dtype))), rate, train,
                        generator)  # [N, L, E]
        que = L.dropout(self.que_emb(ques, dtype), rate, train,
                        generator)  # [N, T, E]
        que_att = img_att = None
        for i in range(cfg.att_num):
            layer = getattr(self, f"att{i}")
            if i % 2 == 0:  # the image guides the question
                img, que, que_att = layer(img, que)
            else:  # the question guides the image
                que, img, img_att = layer(que, img)
        x = torch.cat([que_att, img_att.transpose(1, 2)], dim=1).reshape(n, -1)
        x, stats = self.batchnorm(self.fc(x).float(), train, valid)
        if aux:
            return x, {"que_att": que_att, "img_att": img_att,
                       "batch_stats": {"batchnorm": stats}}
        return x
