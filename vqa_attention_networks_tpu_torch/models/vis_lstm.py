"""VIS+LSTM and the per-step-attention LSTM (port of
``vqa_attention_networks_tpu/models/vis_lstm.py``).

``VisLstm``: the image, mean-pooled over the grid and projected into the
word-embedding space, is the first (``cfg.image_first``) or last token of
a 2-layer LSTM stack over the question; layer 2's final hidden state
classifies the answer. The grid is mean-pooled in the feed's dtype, then
cast to the compute dtype (``vis_lstm.py:68-70``). Layer 1's input
projection is hoisted out of the T+1 steps; layer 2's is computed at each
step from layer 1's output (``vis_lstm.py:89-116``). Gates and carries are
in the compute dtype (``layers.lstm_cell``). No kernel of the port runs
here, as JAX dispatches no Pallas kernel on this model.

``LSTMAttention`` (``lstm_attention_init`` / ``lstm_attention_apply``,
which no registry entry uses): a 2-layer LSTM whose step attends layer 1's
hidden state over the image grid and feeds [v_hat ; h1] to layer 2. The
reference's quirk stays: the attention weights are raw dot products, with
no softmax.

Attribute names are the JAX param-tree keys (``weights.load_jax_params``);
``init_params`` draws a tree in the JAX layout from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.models import layers as L


def init_params(cfg: Config, generator: torch.Generator) -> Dict:
    """A random parameter tree in the JAX layout (``vis_lstm.init``)."""
    g, e, h = generator, cfg.emb_dim, cfg.hidden_dim
    return {
        "embedding_ques": L.embedding_init(g, cfg.q_vocab_size, e),
        "embedding_img": L.dense_init(g, cfg.img_feature_channel, e),
        "lstm1": L.lstm_init(g, e, h),
        "lstm2": L.lstm_init(g, h, h),
        "output_layer": L.dense_init(g, h, cfg.a_vocab_size),
    }


def _stacked_lstm(x1_proj: torch.Tensor, lstm1: L.LSTM, lstm2: L.LSTM,
                  layer2_input=None) -> tuple:
    """Run two stacked LSTM layers over the steps of ``x1_proj`` [N, S, 4H]
    (layer 1's hoisted input projection). Layer 2's input at each step is
    ``layer2_input(h1)`` (h1 itself without it), projected at that step.
    -> (layer 2's final h, [N, S, H] of layer 2's states)."""
    n, steps, _ = x1_proj.shape
    dtype = x1_proj.dtype
    hidden = lstm1.weight_hh.shape[1]
    w_hh1 = lstm1.weight_hh.to(dtype).t()
    w_hh2 = lstm2.weight_hh.to(dtype).t()
    h1 = c1 = h2 = c2 = torch.zeros(n, hidden, dtype=dtype,
                                    device=x1_proj.device)
    h2s = []
    for s in range(steps):
        h1, c1 = L.lstm_cell(x1_proj[:, s], h1, c1, w_hh1)
        x2 = h1 if layer2_input is None else layer2_input(h1)
        x2 = L.lstm_input_projection(x2, lstm2.weight_ih, lstm2.bias_ih,
                                     lstm2.bias_hh)
        h2, c2 = L.lstm_cell(x2, h2, c2, w_hh2)
        h2s.append(h2)
    return h2, torch.stack(h2s, dim=1)


class VisLstm(nn.Module):
    """visLstm: (img [N, L, D] or [N, D], ques [N, T]) -> f32 logits
    [N, a_vocab]. Parameters are allocated empty; load them with
    ``weights.load_jax_params``."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        e, h = cfg.emb_dim, cfg.hidden_dim
        self.embedding_ques = L.Embedding(cfg.q_vocab_size, e)
        self.embedding_img = L.Dense(cfg.img_feature_channel, e)
        self.lstm1 = L.LSTM(e, h)
        self.lstm2 = L.LSTM(h, h)
        self.output_layer = L.Dense(h, cfg.a_vocab_size)

    def forward(self, img: torch.Tensor, ques: torch.Tensor,
                ques_length: Optional[torch.Tensor] = None, *,
                train: bool = False,
                valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                fusion_seed: Optional[int] = None,
                reference_kernels: bool = False, aux: bool = False):
        """-> f32 logits [N, a_vocab]; with ``aux=True``, (logits, {}).
        ``train=True`` draws the two dropout masks (question tokens, then
        the image token) from ``generator``. ``ques_length``, ``valid``,
        ``fusion_seed`` and ``reference_kernels`` are taken for the common
        signature and not read."""
        cfg = self.cfg
        dtype = L.DTYPES[cfg.compute_dtype]
        rate = cfg.dropout_default
        if img.dim() == 3:  # grid -> vector, in the feed's dtype
            img = torch.mean(img, dim=1)
        img = img.to(dtype)
        emb_q = L.dropout(self.embedding_ques(ques, dtype), rate, train,
                          generator)  # [N, T, E]
        emb_i = L.dropout(torch.tanh(self.embedding_img(img)), rate, train,
                          generator)[:, None, :]  # [N, 1, E]
        seq = torch.cat([emb_i, emb_q] if cfg.image_first else [emb_q, emb_i],
                        dim=1)  # [N, T+1, E]
        x1_proj = L.lstm_input_projection(
            seq, self.lstm1.weight_ih, self.lstm1.bias_ih, self.lstm1.bias_hh)
        h2, _ = _stacked_lstm(x1_proj, self.lstm1, self.lstm2)
        logits = self.output_layer(h2).float()
        return (logits, {}) if aux else logits


def lstm_attention_init(generator: torch.Generator, vocab_size: int,
                        embed_dim: int = 512, hidden_dim: int = 512) -> Dict:
    """A random parameter tree in the JAX layout
    (``lstm_attention_init``)."""
    g = generator
    return {
        "embedding": L.embedding_init(g, vocab_size, embed_dim),
        "lstm1": L.lstm_init(g, embed_dim, hidden_dim),
        "lstm2": L.lstm_init(g, 2 * hidden_dim, hidden_dim),
        # defined but unused, as in the reference and the JAX tree
        "output_layer": L.dense_init(g, hidden_dim, vocab_size),
    }


class LSTMAttention(nn.Module):
    """(token ids [N, T], img [N, L, H]) -> layer 2's hidden states
    [N, T, H], in img's dtype (``lstm_attention_apply``)."""

    def __init__(self, vocab_size: int, embed_dim: int = 512,
                 hidden_dim: int = 512):
        super().__init__()
        self.embedding = L.Embedding(vocab_size, embed_dim)
        self.lstm1 = L.LSTM(embed_dim, hidden_dim)
        self.lstm2 = L.LSTM(2 * hidden_dim, hidden_dim)
        self.output_layer = L.Dense(hidden_dim, vocab_size)

    def forward(self, inputs: torch.Tensor,
                img: torch.Tensor) -> torch.Tensor:
        dtype = img.dtype
        emb = self.embedding(inputs, dtype)
        x1_proj = L.lstm_input_projection(
            emb, self.lstm1.weight_ih, self.lstm1.bias_ih, self.lstm1.bias_hh)

        def attend(h1):
            # raw dot-product attention, no softmax (the reference's quirk)
            alpha = torch.matmul(img, h1[:, :, None])[..., 0]  # [N, L]
            v_hat = torch.matmul(alpha[:, None, :], img)[:, 0]  # [N, H]
            return torch.cat([v_hat, h1], dim=-1)

        _, h2s = _stacked_lstm(x1_proj, self.lstm1, self.lstm2, attend)
        return h2s
