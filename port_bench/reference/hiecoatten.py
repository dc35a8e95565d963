"""hieCoAtten in plain PyTorch: the parallel co-attention of Lu et al.,
"Hierarchical Question-Image Co-Attention for Visual Question Answering"
(arXiv:1606.00061), at the word level, as klory/vqa-attention-networks
builds it: the grid embedded by a ReLU projection, the words by a table,
the affinity C = tanh(Q Wb V^T), the attended image and question
(H = tanh(W x + C-weighted W y), softmax over the positions of H w), and
the classifier on their concatenation.

``forward(p, img, ques, sizes)`` is the serving forward.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from port_bench.reference import common as C


def param_shapes(s: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    e = s["embed_size"]
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "que_emb/table": ((s["q_vocab_size"], e), "xavier")}
    for name, d_in, d_out in (
            ("img_emb", s["img_feature_channel"], e), ("fc_Wbv", e, e),
            ("fc_Wbq", e, e), ("fc_Wv", e, e), ("fc_Wq", e, e),
            ("fc_Whv", e, 1), ("fc_Whq", e, 1),
            ("fc", 2 * e, s["a_vocab_size"])):
        out[f"{name}/w"] = ((d_in, d_out), "xavier")
        out[f"{name}/b"] = ((d_out,), "bias")
    return out


def forward(p, img: torch.Tensor, ques: torch.Tensor, s: Dict,
            prec: C.Precision = C.FLOAT32) -> torch.Tensor:
    """Serving forward: float32 img [N, L, D], ques [N, T] -> logits."""
    v = torch.relu(C.dense(img, p, "img_emb", prec))  # [N, L, E]
    q = p["que_emb/table"][ques.long()]  # [N, T, E]
    cv = C.dense(v, p, "fc_Wbv", prec)
    cq = C.dense(q, p, "fc_Wbq", prec)
    c = torch.tanh(prec.mm(cq, cv.transpose(1, 2)))  # [N, T, L]
    v_w = C.dense(v, p, "fc_Wv", prec)
    q_w = C.dense(q, p, "fc_Wq", prec)
    hv = torch.tanh(v_w + prec.mm(c.transpose(1, 2), q_w))
    hq = torch.tanh(q_w + prec.mm(c, v_w))
    av = torch.softmax(C.dense(hv, p, "fc_Whv", prec), dim=1)  # [N, L, 1]
    aq = torch.softmax(C.dense(hq, p, "fc_Whq", prec), dim=1)  # [N, T, 1]
    x = torch.cat([(av * v).sum(1), (aq * q).sum(1)], dim=-1)
    return C.dense(x, p, "fc", prec)
