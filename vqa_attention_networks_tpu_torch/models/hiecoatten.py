"""Hierarchical (parallel) co-attention (port of the eval and training
forward of ``vqa_attention_networks_tpu/models/hiecoatten.py``):

    affinity   C  = tanh(Cq Cv^T)                  [N, T, 196]
    maps       Hv = tanh(Wv v + (Wq q)^T C)        [N, 196, E]
               Hq = tanh(Wq q + (Wv v)^T C^T)      [N, T, E]
    attention  av = softmax(whv Hv) over regions,
               aq = softmax(whq Hq) over words
    answer     fc([av^T v ; aq^T q])

Attribute names are the JAX param-tree keys, so ``weights.load_jax_params``
maps a JAX tree onto the module one to one; ``init_params`` draws a tree in
the JAX layout from a ``torch.Generator``.

Dispatch of the eval forward (``hiecoatten.py:93-104``):

- bf16: the co-attention core runs as one call of
  ``ops/coattention.coattention_core``, which is K4 on the card. The JAX
  gate also asks ``n % 8 == 0``: that is the TPU kernel's block of 8
  samples; the port's K4 runs one sample per block and takes any N.
- f32 / f64, and bf16 under ``VQA_DISABLE_PALLAS`` (read at each call, as
  ``pallas_coattention.py:92`` reads it): the composed chain of
  ``hiecoatten.py:105-136``, each product rounded to the compute dtype as
  its ``preferred_element_type=dtype`` asks (full f32 with TF32 off).

The training forward (``train=True``) is the composed chain at any dtype,
as in JAX (``pallas_coattention.supported`` refuses ``train``), with five
dropouts at ``cfg.dropout_default`` drawn in the JAX order: the image and
question embeddings, C, Hv, Hq. K4's plain version has no dropout inside
it, so it cannot stand in for that chain.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.models import layers as L
from vqa_attention_networks_tpu_torch.ops import kernels_disabled
from vqa_attention_networks_tpu_torch.ops.coattention import coattention_core


def init_params(cfg: Config, generator: torch.Generator) -> Dict:
    """A random parameter tree in the JAX layout (``hiecoatten.init``)."""
    e, g = cfg.embed_size, generator
    return {
        "img_emb": L.dense_init(g, cfg.img_feature_channel, e),
        "que_emb": L.embedding_init(g, cfg.q_vocab_size, e),
        "fc_Wbv": L.dense_init(g, e, e),
        "fc_Wbq": L.dense_init(g, e, e),
        "fc_Wv": L.dense_init(g, e, e),
        "fc_Wq": L.dense_init(g, e, e),
        "fc_Whv": L.dense_init(g, e, 1),
        "fc_Whq": L.dense_init(g, e, 1),
        "fc": L.dense_init(g, 2 * e, cfg.a_vocab_size),
    }


class HieCoAtten(nn.Module):
    """Eval forward of hieCoAtten: (img [N, L, D], ques [N, T]) -> f32
    logits [N, a_vocab]. Parameters are allocated empty; load them with
    ``weights.load_jax_params``."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_size
        self.img_emb = L.Dense(cfg.img_feature_channel, e)
        self.que_emb = L.Embedding(cfg.q_vocab_size, e)
        self.fc_Wbv = L.Dense(e, e)
        self.fc_Wbq = L.Dense(e, e)
        self.fc_Wv = L.Dense(e, e)
        self.fc_Wq = L.Dense(e, e)
        self.fc_Whv = L.Dense(e, 1)
        self.fc_Whq = L.Dense(e, 1)
        self.fc = L.Dense(2 * e, cfg.a_vocab_size)

    def forward(self, img: torch.Tensor, ques: torch.Tensor,
                ques_length: Optional[torch.Tensor] = None, *,
                train: bool = False,
                valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                fusion_seed: Optional[int] = None,
                reference_kernels: bool = False, aux: bool = False):
        """-> f32 logits [N, a_vocab]; with ``aux=True``, (logits, {"av":
        [N, L], "aq": [N, T]}), the attention maps (the JAX ``apply``'s
        second return). ``train=True`` draws the dropout masks from
        ``generator``. ``reference_kernels=True`` runs K4's plain PyTorch
        version in place of the kernel on any device, for the comparisons
        of the tests and ``chip_smoke.py`` only. ``ques_length``,
        ``valid`` and ``fusion_seed`` are taken for the common signature
        and not read."""
        dtype = L.DTYPES[self.cfg.compute_dtype]
        rate = self.cfg.dropout_default
        img = torch.relu(self.img_emb(img.to(dtype)))  # [N, L, E]
        img = L.dropout(img, rate, train, generator)
        que = L.dropout(self.que_emb(ques, dtype), rate, train,
                        generator)  # [N, T, E]
        cv = self.fc_Wbv(img)
        cq = self.fc_Wbq(que)  # Wbq on the question branch (a reference fix)
        if dtype == torch.bfloat16 and not train and not kernels_disabled():
            v, q, av, aq = coattention_core(
                img, que, cv, cq, self.fc_Wv(img), self.fc_Wq(que),
                self.fc_Whv.weight, self.fc_Whq.weight,
                reference_kernel=reference_kernels)
            x = torch.cat([v.to(dtype), q.to(dtype)], dim=-1)
        else:
            c = torch.tanh(torch.matmul(cq, cv.transpose(1, 2)))  # [N, T, L]
            c = L.dropout(c, rate, train, generator)
            img_w = self.fc_Wv(img)
            que_w = self.fc_Wq(que)
            hv = torch.tanh(img_w + torch.matmul(c.transpose(1, 2), que_w))
            hv = L.dropout(hv, rate, train, generator)
            av = torch.softmax(self.fc_Whv(hv), dim=1)[..., 0]  # [N, L]
            v = torch.matmul(av[:, None, :], img)[:, 0]
            hq = torch.tanh(que_w + torch.matmul(c, img_w))
            hq = L.dropout(hq, rate, train, generator)
            aq = torch.softmax(self.fc_Whq(hq), dim=1)[..., 0]  # [N, T]
            q = torch.matmul(aq[:, None, :], que)[:, 0]
            x = torch.cat([v, q], dim=-1)
        logits = self.fc(x).float()
        if aux:
            return logits, {"av": av, "aq": aq}
        return logits
