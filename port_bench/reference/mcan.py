"""MCAN in plain PyTorch: the deep modular co-attention network of Yu et
al., "Deep Modular Co-Attention Networks for Visual Question Answering"
(arXiv:1906.10770), as mcan-vqa builds it (``core/model/net.py``,
``mca.py``, ``net_utils.py``): a one-layer LSTM over the words, L
self-attention layers over the question, L layers of self-attention and
attention guided by the final question over the image grid, each with
post-norm residuals and MCAN's LayerNorm (unbiased std, eps 1e-6 added to
it), AttFlat over both streams, their sum normed and classified.

- ``forward(p, img, ques, sizes, prec)``: the serving forward, every
  product through ``prec``.
- ``train_forward(p, img, ques, sizes, generator, k2_seed, prec)``: the
  same with every dropout of the model on at ``sizes["dropout_fusion"]``
  (``common.dropout``: each mask drawn from ``generator`` over the tensor's
  whole shape, in the order the forward runs; the attention maps too).
  ``k2_seed`` is unused: MCAN has no fusion kernel.
- ``vqa_scores``, ``loss``: each answer's VQA score from the soft answers
  and the annotator count (mcan-vqa's ``get_score``), and the summed
  sigmoid BCE over them, MCAN's training loss.

Masks are true at padding: tokens 0, grid cells whose features are all 0.
The head width is 64 (one head of the whole width below 64), the FFN 4 d
and the flat output 2 d.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from port_bench.reference import common as C

HEAD_DIM = 64
MASK_FILL = -1e9
EPS = 1e-6
SCORES = (0.0, 0.3, 0.6, 0.9, 1.0)  # get_score of 0, 1, 2, 3, 4+ annotators


def param_shapes(s: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Leaf -> (shape in the JAX layout, init): ``xavier`` weights, ``bias``
    vectors, LayerNorm gains ``normal:1.0`` (so a gain read wrong shows)."""
    d, e, L = s["hidden_dim"], s["emb_dim"], s["att_num"]
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "embedding/table": ((s["q_vocab_size"], e), "xavier"),
        "lstm/w_ih": ((e, 4 * d), "xavier"),
        "lstm/w_hh": ((d, 4 * d), "xavier"),
        "lstm/b_ih": ((4 * d,), "bias"),
        "lstm/b_hh": ((4 * d,), "bias"),
    }

    def dense(name, d_in, d_out):
        out[f"{name}/w"] = ((d_in, d_out), "xavier")
        out[f"{name}/b"] = ((d_out,), "bias")

    def norm(name, dim):
        out[f"{name}/w"] = ((dim,), "normal:1.0")
        out[f"{name}/b"] = ((dim,), "bias")

    dense("img_feat_linear", s["img_feature_channel"], d)
    for i in range(L):
        for part in ("q", "k", "v", "merge"):
            dense(f"enc{i}_mhatt_{part}", d, d)
        dense(f"enc{i}_ffn_fc", d, 4 * d)
        dense(f"enc{i}_ffn_out", 4 * d, d)
        for k in (1, 2):
            norm(f"enc{i}_norm{k}", d)
    for i in range(L):
        for att in ("mhatt1", "mhatt2"):
            for part in ("q", "k", "v", "merge"):
                dense(f"dec{i}_{att}_{part}", d, d)
        dense(f"dec{i}_ffn_fc", d, 4 * d)
        dense(f"dec{i}_ffn_out", 4 * d, d)
        for k in (1, 2, 3):
            norm(f"dec{i}_norm{k}", d)
    for side in ("lang", "img"):
        dense(f"attflat_{side}_fc", d, s["embed_size"])
        dense(f"attflat_{side}_out", s["embed_size"], 1)
        dense(f"attflat_{side}_merge", d, 2 * d)
    norm("proj_norm", 2 * d)
    dense("proj", 2 * d, s["a_vocab_size"])
    return out


def _norm(z, p, name):
    mean = z.mean(-1, keepdim=True)
    std = z.std(-1, keepdim=True)
    return p[f"{name}/w"] * (z - mean) / (std + EPS) + p[f"{name}/b"]


def _attention(p, name, q_in, kv_in, mask, prec, rate, gen):
    n, lq, d = q_in.shape
    h = max(1, d // HEAD_DIM)
    dh = d // h

    def split(x):
        return x.view(n, -1, h, dh).transpose(1, 2)

    v = split(C.dense(kv_in, p, f"{name}_v", prec))
    k = split(C.dense(kv_in, p, f"{name}_k", prec))
    q = split(C.dense(q_in, p, f"{name}_q", prec))
    scores = prec.mm(q, k.transpose(-2, -1)) / dh ** 0.5
    att = torch.softmax(scores.masked_fill(mask[:, None, None, :],
                                           MASK_FILL), dim=-1)
    out = prec.mm(C.dropout(att, rate, gen), v).transpose(1, 2).reshape(
        n, lq, d)
    return C.dense(out, p, f"{name}_merge", prec)


def _ffn(p, name, x, prec, rate, gen):
    hidden = C.dropout(torch.relu(C.dense(x, p, f"{name}_fc", prec)), rate,
                       gen)
    return C.dense(hidden, p, f"{name}_out", prec)


def _flat(p, name, z, mask, prec, rate, gen):
    hidden = C.dropout(torch.relu(C.dense(z, p, f"{name}_fc", prec)), rate,
                       gen)
    att = C.dense(hidden, p, f"{name}_out", prec)
    att = torch.softmax(att.masked_fill(mask[:, :, None], MASK_FILL), dim=1)
    pooled = prec.mm(att.transpose(1, 2), z)[:, 0]
    return C.dense(pooled, p, f"{name}_merge", prec)


def _forward(p, img, ques, s, prec, gen: Optional[torch.Generator]):
    rate = s.get("dropout_fusion", 0.1)
    mask_q = ques == 0
    mask_x = img.abs().sum(-1) == 0

    def residual(x, branch, name):
        return _norm(x + C.dropout(branch, rate, gen), p, name)

    y = C.lstm(p["embedding/table"][ques.long()], p, "lstm", prec)
    for i in range(s["att_num"]):
        e = f"enc{i}"
        y = residual(y, _attention(p, f"{e}_mhatt", y, y, mask_q, prec,
                                   rate, gen), f"{e}_norm1")
        y = residual(y, _ffn(p, f"{e}_ffn", y, prec, rate, gen),
                     f"{e}_norm2")
    x = C.dense(img, p, "img_feat_linear", prec)
    for i in range(s["att_num"]):
        e = f"dec{i}"
        x = residual(x, _attention(p, f"{e}_mhatt1", x, x, mask_x, prec,
                                   rate, gen), f"{e}_norm1")
        x = residual(x, _attention(p, f"{e}_mhatt2", x, y, mask_q, prec,
                                   rate, gen), f"{e}_norm2")
        x = residual(x, _ffn(p, f"{e}_ffn", x, prec, rate, gen),
                     f"{e}_norm3")
    flat = (_flat(p, "attflat_lang", y, mask_q, prec, rate, gen)
            + _flat(p, "attflat_img", x, mask_x, prec, rate, gen))
    return C.dense(_norm(flat, p, "proj_norm"), p, "proj", prec)


def forward(p, img: torch.Tensor, ques: torch.Tensor, s: Dict,
            prec: C.Precision = C.FLOAT32) -> torch.Tensor:
    """Serving forward: float32 img [N, L, D], ques [N, T] -> logits."""
    return _forward(p, img, ques, s, prec, None)


def train_forward(p, img: torch.Tensor, ques: torch.Tensor, s: Dict,
                  generator: torch.Generator, k2_seed: int,
                  prec: C.Precision = C.FLOAT32) -> torch.Tensor:
    """Training forward: every dropout on, drawn from ``generator``."""
    return _forward(p, img, ques, s, prec, generator)


def vqa_scores(soft: torch.Tensor,
               soft_n: Union[int, torch.Tensor] = 10) -> torch.Tensor:
    """get_score(rint(share * annotators)) of every answer [N, A];
    ``soft_n`` the annotators of each row, or of all (VQA's ten)."""
    n = torch.as_tensor(soft_n, device=soft.device).float().reshape(-1, 1)
    count = torch.round(soft * n).clamp(0, 4).long()
    return torch.tensor(SCORES, device=soft.device)[count]


def loss(logits: torch.Tensor, soft: torch.Tensor,
         soft_n: Union[int, torch.Tensor] = 10) -> torch.Tensor:
    """mcan-vqa's BCELoss(reduction='sum') of the sigmoid against the VQA
    scores of the soft answers ``soft`` [N, A], as logits."""
    return F.binary_cross_entropy_with_logits(
        logits, vqa_scores(soft, soft_n), reduction="sum")
