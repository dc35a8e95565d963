"""mhb_coAtt in plain PyTorch: MFB/MHB co-attention (Yu et al., "Beyond
Bilinear: Generalized Multimodal Factorized High-order Pooling for Visual
Question Answering", arXiv:1708.03619), as klory/vqa-attention-networks
configures it: tanh word embedding, a one-layer LSTM, a two-glimpse
question attention, the MFB fusion of the image grid with the question
(k factors of o outputs, sum-pooled, signed square root, L2 over the whole
grid), a two-glimpse co-attention over the regions, and two cascaded MFB
output fusions (MHB) before the answer classifier.

``forward(p, img, ques, sizes)`` is the serving forward;
``train_forward`` adds the training dropout: on the LSTM's states and on
each output fusion's product from ``generator`` (in that order), and on
the grid fusion's pre-pool product from the pre-pool mask of ``k2_seed``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from port_bench.reference import common as C
from port_bench.reference.k2_mask import prepool_mask


def param_shapes(s: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Leaf -> (shape in the JAX layout, init): ``xavier`` weights,
    ``bias`` vectors, and the co-attention weights drawn ``normal`` (with
    their scale) so that the attention over the regions is peaked."""
    h, e, d = s["hidden_dim"], s["emb_dim"], s["img_feature_channel"]
    f, o = s["mfb_factor"] * s["mfb_out"], s["mfb_out"]
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "word_embedding/table": ((s["q_vocab_size"], e), "xavier"),
        "lstm/w_ih": ((e, 4 * h), "xavier"),
        "lstm/w_hh": ((h, 4 * h), "xavier"),
        "lstm/b_ih": ((4 * h,), "bias"),
        "lstm/b_hh": ((4 * h,), "bias"),
    }
    for name, d_in, d_out, init in (
            ("ques_att_conv1", h, 512, "xavier"),
            ("ques_att_conv2", 512, 2, "xavier"),
            ("ques_proj1", 2 * h, f, "xavier"),
            ("img_conv1d", d, f, "xavier"),
            ("co_att_conv1", o, 512, "normal:1.0"),
            ("co_att_conv2", 512, 2, "normal:3.0"),
            ("ques_proj2", 2 * h, f, "xavier"),
            ("ques_proj3", 2 * h, f, "xavier"),
            ("img_proj2", 2 * d, f, "xavier"),
            ("img_proj3", 2 * d, f, "xavier"),
            ("linear_pred", 2 * o, s["a_vocab_size"], "xavier")):
        out[f"{name}/w"] = ((d_in, d_out), init)
        out[f"{name}/b"] = ((d_out,), "bias")
    return out


def _question(p, ques, prec, generator=None, rate=0.0):
    emb = torch.tanh(p["word_embedding/table"][ques.long()])
    h = C.lstm(emb, p, "lstm", prec)
    h = C.dropout(h, rate, generator)
    hid = torch.relu(C.dense(h, p, "ques_att_conv1", prec))
    return C.glimpse_pool(C.dense(hid, p, "ques_att_conv2", prec), h)


def _coattention(p, img, fused, prec):
    n = fused.shape[0]
    fused = C.l2_normalize(fused.reshape(n, -1)).reshape(fused.shape)
    hid = torch.relu(C.dense(fused, p, "co_att_conv1", prec))
    return C.glimpse_pool(C.dense(hid, p, "co_att_conv2", prec), img)


def _output(p, q_att, v_att, s, prec, generator=None, rate=0.0):
    outs = []
    for stage in ("2", "3"):
        z = (C.dense(q_att, p, f"ques_proj{stage}", prec)
             * C.dense(v_att, p, f"img_proj{stage}", prec))
        z = C.dropout(z, rate, generator)
        outs.append(C.l2_normalize(C.signed_sqrt(
            C.sum_pool(z, s["mfb_factor"]))))
    return C.dense(torch.cat(outs, -1), p, "linear_pred", prec)


def forward(p, img: torch.Tensor, ques: torch.Tensor, s: Dict,
            prec: C.Precision = C.FLOAT32) -> torch.Tensor:
    """Serving forward: float32 img [N, L, D], ques [N, T] -> logits."""
    q_att = _question(p, ques, prec)
    q_proj = C.dense(q_att, p, "ques_proj1", prec)
    z = C.dense(img, p, "img_conv1d", prec) * q_proj[:, None, :]
    fused = C.signed_sqrt(C.sum_pool(z, s["mfb_factor"]))
    v_att = _coattention(p, img, fused, prec)
    return _output(p, q_att, v_att, s, prec)


def train_forward(p, img: torch.Tensor, ques: torch.Tensor, s: Dict,
                  generator: torch.Generator, k2_seed: int,
                  prec: C.Precision = C.FLOAT32) -> torch.Tensor:
    """Training forward, with the dropout at the pre-pool site."""
    q_att = _question(p, ques, prec, generator, s["dropout_lstm"])
    q_proj = C.dense(q_att, p, "ques_proj1", prec)
    z = C.dense(img, p, "img_conv1d", prec) * q_proj[:, None, :]
    rate = s["dropout_fusion"]
    mask = prepool_mask(k2_seed, *z.shape, rate, z.device)
    z = torch.where(mask, z / (1.0 - rate), torch.zeros_like(z))
    fused = C.signed_sqrt(C.sum_pool(z, s["mfb_factor"]))
    v_att = _coattention(p, img, fused, prec)
    return _output(p, q_att, v_att, s, prec, generator, rate)
