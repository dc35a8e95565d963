"""BAN in plain PyTorch: the bilinear attention network of Kim, Jun and
Zhang, "Bilinear Attention Networks" (arXiv:1805.07932), as jnhwkim/ban-vqa
builds it with ``--op c`` (``base_model.py``, ``attention.py``, ``bc.py``,
``fc.py``, ``language_model.py``, ``classifier.py``), without the counting
module: two word tables joined (the second frozen; word 0 embeds to 0), a
one-layer GRU over all T words, BiAttention's low-rank bilinear map (rank
k = 3) softmaxed jointly over cells and words for G glimpses, the G
glimpses' bilinear pools applied in series to the question states, and the
classifier on their sum. Every weight is weight-normalised with one scalar
gain, ``g V / ||V||_F``, formed here from (g, V) on every call. The
benchmark's weights are ban-vqa's as ``weight_norm`` leaves them when it
wraps each layer: a gain equal to its direction's norm, so the tree holds
no ``g`` and each is formed here as ``||V||_F`` (a tree that holds one,
as the port's tests give, is used as it is).

- ``forward(p, img, ques, sizes, prec)``: the serving forward, every
  product through ``prec``.
- ``train_forward(p, img, ques, sizes, generator, k2_seed, prec)``: the
  same with ban-vqa's dropouts on (0.2 before each projection, 0.5 on
  BiAttention's image side and in the classifier), each mask drawn from
  ``generator`` over the tensor's whole shape in the order the forward runs
  (``common.dropout``). ``k2_seed`` is unused.
- ``vqa_scores``, ``loss``: the soft answers' VQA scores and the summed
  sigmoid BCE over them, ban-vqa's training loss (as MCAN's).

Masks: grid cells whose features are all 0 score -inf in the attention.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from port_bench.reference import common as C

RANK = 3
SCORES = (0.0, 0.3, 0.6, 0.9, 1.0)  # get_score of 0, 1, 2, 3, 4+ annotators
FC_DROP, ATT_DROP, CLASSIFIER_DROP = 0.2, 0.5, 0.5


def _layers(s: Dict) -> Dict[str, Tuple[int, int]]:
    h, g = s["hidden_dim"], s["att_num"]
    out = {"v_att_v_net": (s["img_feature_channel"], RANK * h),
           "v_att_q_net": (h, RANK * h), "v_att_h": (RANK * h, g)}
    for i in range(g):
        out[f"b_net{i}_v_net"] = (s["img_feature_channel"], h)
        out[f"b_net{i}_q_net"] = (h, h)
        out[f"q_prj{i}"] = (h, h)
    out["classifier_fc1"] = (h, 2 * h)
    out["classifier_fc2"] = (2 * h, s["a_vocab_size"])
    return out


def param_shapes(s: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Leaf -> (shape in the JAX layout, init). Both word tables N(0, 1),
    as ``nn.Embedding`` draws them (ban-vqa without GloVe); directions
    ``v`` xavier-uniform, and h_mat's direction and its bias N(0, 1), as
    ban-vqa draws h_mat (a peaked map); no gain: each is its direction's
    norm, as ``weight_norm`` sets it (``_wn``), so the logits' scale is
    the same at every seed; the GRU's weights xavier-uniform; biases
    U(-0.02, 0.02)."""
    e, h = s["emb_dim"], s["hidden_dim"]
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "w_emb/table": ((s["q_vocab_size"], e), "normal:1.0"),
        "w_emb_frozen/table": ((s["q_vocab_size"], e), "normal:1.0"),
        "q_emb/w_ih": ((2 * e, 3 * h), "xavier"),
        "q_emb/w_hh": ((h, 3 * h), "xavier"),
        "q_emb/b_ih": ((3 * h,), "bias"),
        "q_emb/b_hh": ((3 * h,), "bias"),
    }
    for name, (d_in, d_out) in _layers(s).items():
        if name == "v_att_h":
            out[f"{name}/v"] = ((d_in, d_out), "normal:1.0")
            out[f"{name}/b"] = ((d_out,), "normal:1.0")
            continue
        out[f"{name}/v"] = ((d_in, d_out), "xavier")
        out[f"{name}/b"] = ((d_out,), "bias")
    return out


def _wn(p, name: str) -> torch.Tensor:
    """``g v / ||v||_F``, [in, out]; where the tree holds no g, g is
    ``weight_norm``'s own first gain, ``||v||_F`` held as a constant (a
    parameter of its own, as ``weight_norm`` keeps it)."""
    v = p[f"{name}/v"]
    norm = torch.sqrt((v * v).sum())
    return p.get(f"{name}/g", norm.detach()) * v / norm


def _dense(x, p, name, prec):
    return prec.mm(x, _wn(p, name)) + p[f"{name}/b"]


def _gru(x, p, prec):
    """One-layer GRU, gates r, z, n, zero initial state -> [N, T, H]."""
    n, t, _ = x.shape
    w_hh = p["q_emb/w_hh"]
    xp = prec.mm(x, p["q_emb/w_ih"]) + p["q_emb/b_ih"]
    h = x.new_zeros(n, w_hh.shape[0])
    out = []
    for s in range(t):
        hp = prec.mm(h, w_hh) + p["q_emb/b_hh"]
        xr, xz, xn = xp[:, s].chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        c = torch.tanh(xn + r * hn)
        h = (1 - z) * c + z * h
        out.append(h)
    return torch.stack(out, dim=1)


def _forward(p, img, ques, s, prec, gen: Optional[torch.Generator]):
    def drop(x, rate):
        return C.dropout(x, rate, gen)

    ids = ques.long()
    keep = (ids != 0).to(img.dtype)[..., None]
    words = torch.cat([p["w_emb/table"][ids],
                       p["w_emb_frozen/table"][ids]], dim=-1) * keep
    q = _gru(words, p, prec)  # [N, T, H]
    mask = img.abs().sum(-1) == 0  # [N, L]
    av = drop(torch.relu(_dense(drop(img, FC_DROP), p, "v_att_v_net", prec)),
              ATT_DROP)
    aq = torch.relu(_dense(drop(q, FC_DROP), p, "v_att_q_net", prec))
    h = _wn(p, "v_att_h").t()  # [G, kH]
    n, l, _ = av.shape
    t, g = aq.shape[1], h.shape[0]
    # S[n, g, i, j] = sum_c h[g, c] av[n, i, c] aq[n, j, c] + hb[g]
    # as the G T scaled word rows against the L cells, a sample at a time
    scaled = (h[None, :, None, :] * aq[:, None]).reshape(n, g * t, -1)
    s_ = prec.mm(scaled, av.transpose(1, 2)).reshape(n, g, t, l)
    s_ = s_.transpose(2, 3) + p["v_att_h/b"][None, :, None, None]
    s_ = s_.masked_fill(mask[:, None, :, None], float("-inf"))
    att = torch.softmax(s_.reshape(n, g, l * t), dim=-1).reshape(n, g, l, t)
    for i in range(s["att_num"]):
        bv = torch.relu(_dense(drop(img, FC_DROP), p, f"b_net{i}_v_net",
                               prec))
        bq = torch.relu(_dense(drop(q, FC_DROP), p, f"b_net{i}_q_net",
                               prec))
        # f[c] = sum_i sum_j bv[i, c] att[i, j] bq[j, c]
        f = (prec.mm(att[:, i].transpose(1, 2), bv) * bq).sum(1)
        q = q + _dense(drop(f, FC_DROP), p, f"q_prj{i}", prec)[:, None, :]
    hidden = drop(torch.relu(_dense(q.sum(1), p, "classifier_fc1", prec)),
                  CLASSIFIER_DROP)
    return _dense(hidden, p, "classifier_fc2", prec)


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
    """get_score(rint(share * annotators)) of every answer [N, A]."""
    n = torch.as_tensor(soft_n, device=soft.device).float().reshape(-1, 1)
    count = torch.round(soft * n).clamp(0, 4).long()
    return torch.tensor(SCORES, device=soft.device)[count]


def loss(logits: torch.Tensor, soft: torch.Tensor,
         soft_n: Union[int, torch.Tensor] = 10) -> torch.Tensor:
    """The summed sigmoid BCE of the logits against the VQA scores of the
    soft answers ``soft`` [N, A]."""
    return F.binary_cross_entropy_with_logits(
        logits, vqa_scores(soft, soft_n), reduction="sum")
