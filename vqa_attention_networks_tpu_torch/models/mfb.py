"""MFB co-attention and its ``mfb-multilayer`` variant (port of the eval
and training forward of ``vqa_attention_networks_tpu/models/mfb.py``):

  embed(tanh) -> LSTM -> 2-glimpse question attention
  -> MFB fusion with the 196x2048 image grid (``grid_fuse``: project to
     5000, Hadamard, sum-pool k=5 -> 1000, signed sqrt), L2 over the flat grid
  -> 2-glimpse co-attention over the image regions
  -> second MFB fusion -> L2 -> linear -> a_vocab logits

``mfb-multilayer`` inserts an extra 1024->512 projection + ReLU in both
attention stacks (the ``*_multiconv`` layers).

``keep_reference_quirks`` keeps the reference's softmax over a singleton
axis: every attention weight is 1, each glimpse an unweighted sum over
positions. The co-attention logits, and with them the whole stage-1 fusion,
are then value-dead: the logits do not depend on ``grid_fuse``'s output
(``ops/fusion.py:216-218``), and in training gradient-dead too: img_conv1d,
ques_proj1 and co_att_* get exactly zero gradients. The port still computes
that fusion, as the JAX package's eager forward would; under ``jax.jit``
XLA may drop it.

At bf16 ``grid_fuse`` runs the weight-contracted formulation in eval, or K5
under ``VQA_FORCE_PALLAS``; in training K2 at ``dropout_site="prepool"``
(with a dropout rate above 0) and K3 at ``"pooled"``
(``ops/grid_fusion.py``). Attribute names are the JAX param-tree keys
(``weights.load_jax_params``); ``init_params`` draws a tree in the JAX
layout.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.models import layers as L
from vqa_attention_networks_tpu_torch.ops.fusion import (
    mfb_fuse_pool,
    two_glimpse_pool,
)
from vqa_attention_networks_tpu_torch.ops.grid_fusion import grid_fuse


def _is_multilayer(cfg: Config) -> bool:
    return cfg.model_name == "mfb-multilayer"


def init_params(cfg: Config, generator: torch.Generator) -> Dict:
    """A random parameter tree in the JAX layout (``mfb.init``)."""
    h, d_img, fusion, g = (cfg.hidden_dim, cfg.img_feature_channel,
                           cfg.fusion_dim, generator)
    att = 512 if _is_multilayer(cfg) else 1024
    p = {
        "word_embedding": L.embedding_init(g, cfg.q_vocab_size, cfg.emb_dim),
        "lstm": L.lstm_init(g, cfg.emb_dim, h),
        "ques_att_conv1": L.dense_init(g, h, 1024),
        "ques_att_conv2": L.dense_init(g, att, 2),
        "ques_proj1": L.dense_init(g, 2 * h, fusion),
        "img_conv1d": L.dense_init(g, d_img, fusion),
        "co_att_conv1": L.dense_init(g, cfg.mfb_out, 1024),
        "co_att_conv2": L.dense_init(g, att, 2),
        "ques_proj2": L.dense_init(g, 2 * h, fusion),
        "img_proj2": L.dense_init(g, 2 * d_img, fusion),
        "linear_pred": L.dense_init(g, cfg.mfb_out, cfg.a_vocab_size),
    }
    if _is_multilayer(cfg):
        p["ques_att_multiconv"] = L.dense_init(g, 1024, 512)
        p["co_att_multiconv"] = L.dense_init(g, 1024, 512)
    return p


class MFB(nn.Module):
    """Eval forward of mfb / mfb-multilayer: (img [N, L, D], ques [N, T])
    -> f32 logits [N, a_vocab]. Parameters are allocated empty; load them
    with ``weights.load_jax_params``."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        h, d_img = cfg.hidden_dim, cfg.img_feature_channel
        fusion = cfg.fusion_dim
        att = 512 if _is_multilayer(cfg) else 1024
        self.word_embedding = L.Embedding(cfg.q_vocab_size, cfg.emb_dim)
        self.lstm = L.LSTM(cfg.emb_dim, h)
        self.ques_att_conv1 = L.Dense(h, 1024)
        self.ques_att_conv2 = L.Dense(att, 2)
        self.ques_proj1 = L.Dense(2 * h, fusion)
        self.img_conv1d = L.Dense(d_img, fusion)
        self.co_att_conv1 = L.Dense(cfg.mfb_out, 1024)
        self.co_att_conv2 = L.Dense(att, 2)
        self.ques_proj2 = L.Dense(2 * h, fusion)
        self.img_proj2 = L.Dense(2 * d_img, fusion)
        self.linear_pred = L.Dense(cfg.mfb_out, cfg.a_vocab_size)
        if _is_multilayer(cfg):
            self.ques_att_multiconv = L.Dense(1024, 512)
            self.co_att_multiconv = L.Dense(1024, 512)

    def _att_logits(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """conv1x1 -> ReLU [-> conv1x1 -> ReLU] -> conv1x1, in x's dtype."""
        a = torch.relu(getattr(self, f"{name}_conv1")(x))
        if _is_multilayer(self.cfg):
            a = torch.relu(getattr(self, f"{name}_multiconv")(a))
        return getattr(self, f"{name}_conv2")(a)

    def forward(self, img: torch.Tensor, ques: torch.Tensor,
                ques_length: Optional[torch.Tensor] = None, *,
                train: bool = False,
                valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                fusion_seed: Optional[int] = None,
                reference_kernels: bool = False, aux: bool = False):
        """-> f32 logits [N, a_vocab] (``mfb.py:81-140``); with
        ``aux=True``, (logits, {"q_att_logits" [N, T, 2], "co_att_logits"
        [N, L, 2]}), the two glimpses' attention logits, as JAX's ``apply``
        returns them in eval and training. ``ques_length`` and ``valid`` are
        taken for the common signature: mfb reads no lengths and has no
        batch norm.

        ``train=True`` runs the training forward: the dropout masks come
        from ``generator`` (on img's device) in the JAX order (LSTM output,
        the stage-1 fusion when it is composed or at the pooled site, then
        the final MFB fusion), and K2's mask from ``fusion_seed``.

        ``reference_kernels=True`` runs the plain PyTorch version of the
        kernel on the path (K5 in eval, K2 or K3 in training) in place of
        the kernel on any device, for the comparisons of the tests and
        ``chip_smoke.py`` only."""
        cfg = self.cfg
        quirk = cfg.keep_reference_quirks
        dtype = L.DTYPES[cfg.compute_dtype]
        n = ques.shape[0]
        img = img.to(dtype)

        h_seq = self.lstm(torch.tanh(self.word_embedding(ques, dtype)))
        h_seq = L.dropout(h_seq, cfg.dropout_lstm, train, generator)
        q_att_logits = self._att_logits("ques_att", h_seq)  # [N, T, 2]
        q_att = two_glimpse_pool(q_att_logits, h_seq, uniform_quirk=quirk)
        fused = grid_fuse(img, self.img_conv1d.weight.t(),
                          self.img_conv1d.bias, self.ques_proj1(q_att),
                          cfg.mfb_factor, train=train,
                          rate=cfg.dropout_fusion, site=cfg.dropout_site,
                          seed=fusion_seed, generator=generator,
                          reference_kernel=reference_kernels)
        # L2 over the flattened grid; the co-attention MLP computes in
        # fused's dtype (at bf16: f32 out of K5, K2 or the composed chain,
        # bf16 out of the weight-contracted fusion and the pooled site),
        # the pool over the raw image grid
        fused = L.l2_normalize(fused.reshape(n, -1)).reshape(fused.shape)
        co_att_logits = self._att_logits("co_att", fused)  # [N, L, 2]
        v_att = two_glimpse_pool(co_att_logits, img, uniform_quirk=quirk)

        final = L.l2_normalize(mfb_fuse_pool(
            self.ques_proj2(q_att), self.img_proj2(v_att), cfg.mfb_factor,
            rate=cfg.dropout_fusion, train=train, generator=generator))
        logits = self.linear_pred(final).float()
        if aux:
            return logits, {"q_att_logits": q_att_logits,
                            "co_att_logits": co_att_logits}
        return logits
