"""MCAN, the deep modular co-attention network (Yu, Yu, Cui, Tao and Tian,
"Deep Modular Co-Attention Networks for Visual Question Answering", CVPR
2019, arXiv:1906.10770), as mcan-vqa's encoder-decoder ``MCA_ED`` builds it
(``core/model/net.py``, ``mca.py``, ``net_utils.py``). A port-only family:
the JAX package has no MCAN.

With d = ``hidden_dim``, h = d / 64 heads, L = ``att_num``, masks true at
padding:

    mask_q = (ques == 0);  mask_x = (sum |img| over channels == 0)
    Y = LSTM(Embed(ques))            all T states, no packing
    X = Linear_2048->d(img)
    MHA(a, b, m) = merge(concat_h softmax(q_h k_h^T / 8, m -> -1e9) v_h)
    LN(z) = w * (z - mean) / (std_unbiased + 1e-6) + b
    FFN(z) = Linear_4d->d(Drop(ReLU(Linear_d->4d(z))))
    encoder, L times:  Y = LN1(Y + Drop(MHA(Y, Y, mask_q)))
                       Y = LN2(Y + Drop(FFN(Y)))
    decoder, L times:  X = LN1(X + Drop(MHA(X, X, mask_x)))
                       X = LN2(X + Drop(MHA(X, Y, mask_q)))   final Y
                       X = LN3(X + Drop(FFN(X)))
    AttFlat(Z, m) = Linear_d->2d(sum_i softmax_i(MLP_d->512->1(Z), m) Z_i)
    logits = Linear_2d->A(LN(AttFlat_q(Y) + AttFlat_x(X)))

Every dropout is ``cfg.dropout_fusion`` (MCAN's DROPOUT_R), the attention
maps' too, drawn from the forward's ``generator`` in the order the forward
runs (a layer's attention map, then its residual branch, then the FFN's
hidden layer, then its residual branch; AttFlat's hidden layer, question
first). The widths: ``hidden_dim`` d, ``emb_dim`` the word embedding,
``att_num`` L, ``embed_size`` AttFlat's MLP; the head width (64), the FFN
(4 d) and the flat output (2 d) are MCAN's fixed ratios at both published
sizes, constants here. Below d = 64 (the tests' small sizes) there is one
head of width d.

Departures from mcan-vqa:

- **Serving head**: the engine's softmax and top-k, as for every family;
  MCAN's own output is a sigmoid, whose top-k order is the same.
- **Image sequence**: the repo's 196-cell ResNet-152 grid, not the paper's
  10-100 bottom-up regions (arXiv:2001.03615 ran MCAN on grids).
- **Initial values** (``init_params``): the port's xavier-uniform weights
  and zero biases, LayerNorm gains 1 and biases 0; mcan-vqa keeps
  PyTorch's default Linear init.
- **Training**: the loss is mcan-vqa's (``train/losses.vqa_score_bce``);
  the optimiser is the Solver's Adam at ``cfg.lr``, not the paper's
  beta2 0.98, eps 1e-9, warm-up and step decay (ROADMAP Queue 6).
- **Rounding** (bf16): each projection is ``F.linear`` with its bias
  added before the product is rounded; q is scaled by 1/8 before its
  product with k (exact at a head width of 64); each residual sum is
  rounded to bf16, and the norm's statistics and affine map are f32. The
  composed attention rounds the scores and the map to bf16; the fused one
  keeps both in f32 and rounds the map once, for its product with v.

Dispatch: in eval at bf16, unless ``VQA_DISABLE_PALLAS`` is set (read at
each call), every residual add and LayerNorm is one call of the op
``vqa.mcan_add_layernorm`` (``ops/mcan_norm.py``), and every attention
whose heads are 64 wide over at most 256 keys one call of the op
``vqa.mcan_attention`` (``ops/mcan_attention.py``), the fused kernels on
the card; training, f32, ``reference_kernels`` and narrower heads run the
composed forms.
Spans ``mcan.encoder`` (embedding, LSTM, encoder), ``mcan.decoder`` (the
image projection and the decoder) and ``mcan.head`` (AttFlat, the norm and
the classifier) record while a profiler records (``utils/trace.py``).

Parameters are flat top-level layers (``enc0_mhatt_q``, ``dec5_ffn_out``,
``attflat_img_merge``, ...), each a leaf group of the JAX-layout tree.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.models import layers as L
from vqa_attention_networks_tpu_torch.ops import kernels_disabled
from vqa_attention_networks_tpu_torch.ops import mcan_attention, mcan_norm
from vqa_attention_networks_tpu_torch.utils import trace

HEAD_DIM = 64  # MCAN's HIDDEN_SIZE_HEAD, at both published sizes
FFN_RATIO = 4  # FF_SIZE = 4 * HIDDEN_SIZE
FLAT_RATIO = 2  # FLAT_OUT_SIZE = 2 * HIDDEN_SIZE


def num_heads(d: int) -> int:
    """d / 64 heads; one head of d below 64."""
    return max(1, d // HEAD_DIM)


def layer_shapes(cfg: Config) -> Dict[str, tuple]:
    """Each layer of the tree -> ("dense", d_in, d_out) or ("norm", dim),
    besides the embedding and the LSTM, in the order of the forward."""
    d, L_ = cfg.hidden_dim, cfg.att_num
    ff, flat = FFN_RATIO * d, FLAT_RATIO * d
    out: Dict[str, tuple] = {
        "img_feat_linear": ("dense", cfg.img_feature_channel, d)}

    def mha(prefix):
        for part in ("q", "k", "v", "merge"):
            out[f"{prefix}_{part}"] = ("dense", d, d)

    def ffn(prefix):
        out[f"{prefix}_fc"] = ("dense", d, ff)
        out[f"{prefix}_out"] = ("dense", ff, d)

    for i in range(L_):
        mha(f"enc{i}_mhatt")
        ffn(f"enc{i}_ffn")
        for k in (1, 2):
            out[f"enc{i}_norm{k}"] = ("norm", d)
    for i in range(L_):
        mha(f"dec{i}_mhatt1")
        mha(f"dec{i}_mhatt2")
        ffn(f"dec{i}_ffn")
        for k in (1, 2, 3):
            out[f"dec{i}_norm{k}"] = ("norm", d)
    for side in ("lang", "img"):
        out[f"attflat_{side}_fc"] = ("dense", d, cfg.embed_size)
        out[f"attflat_{side}_out"] = ("dense", cfg.embed_size, 1)
        out[f"attflat_{side}_merge"] = ("dense", d, flat)
    out["proj_norm"] = ("norm", flat)
    out["proj"] = ("dense", flat, cfg.a_vocab_size)
    return out


def init_params(cfg: Config, generator: torch.Generator) -> Dict:
    """A random parameter tree in the JAX layout: xavier-uniform weights,
    zero biases, LayerNorm gains 1 and biases 0."""
    g = generator
    p = {"embedding": L.embedding_init(g, cfg.q_vocab_size, cfg.emb_dim),
         "lstm": L.lstm_init(g, cfg.emb_dim, cfg.hidden_dim)}
    for name, shape in layer_shapes(cfg).items():
        p[name] = (L.dense_init(g, shape[1], shape[2]) if shape[0] == "dense"
                   else L.layernorm_init(shape[1]))
    return p


class MCAN(nn.Module):
    """MCAN's forward: (img [N, L, D], ques [N, T]) -> f32 logits
    [N, a_vocab]. Parameters are allocated empty; load them with
    ``weights.load_jax_params``."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.embedding = L.Embedding(cfg.q_vocab_size, cfg.emb_dim)
        self.lstm = L.LSTM(cfg.emb_dim, cfg.hidden_dim)
        for name, shape in layer_shapes(cfg).items():
            self.add_module(name, L.Dense(shape[1], shape[2])
                            if shape[0] == "dense" else L.LayerNorm(shape[1]))

    # -- pieces ------------------------------------------------------------

    def _linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name)
        return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))

    def _norm(self, name: str, x: torch.Tensor, r: torch.Tensor,
              fused: bool) -> torch.Tensor:
        """``LN(x + r)``: the op (the kernel on the card) when ``fused``,
        else the composed form."""
        layer = getattr(self, name)
        if fused:
            return mcan_norm.add_layernorm(x, r, layer.weight, layer.bias)
        return mcan_norm.add_layernorm_composed(x, r, layer.weight,
                                                layer.bias)

    def _mha(self, prefix: str, q_in: torch.Tensor, kv_in: torch.Tensor,
             mask: torch.Tensor, drop, fused: bool) -> torch.Tensor:
        """``merge(attention)``: the op (the kernel on the card) when
        ``fused`` and the heads are 64 wide over at most 256 keys, else the
        composed form, with ``drop`` on the attention map."""
        h = num_heads(q_in.shape[-1])
        v = self._linear(f"{prefix}_v", kv_in)
        k = self._linear(f"{prefix}_k", kv_in)
        q = self._linear(f"{prefix}_q", q_in)
        if fused and mcan_attention.supported(q.shape[-1] // h, k.shape[1]):
            out = mcan_attention.attention(q, k, v, mask)
        else:
            out = mcan_attention.attention_composed(q, k, v, mask, h, drop)
        return self._linear(f"{prefix}_merge", out)

    def _ffn(self, prefix: str, x: torch.Tensor, drop) -> torch.Tensor:
        hidden = drop(torch.relu(self._linear(f"{prefix}_fc", x)))
        return self._linear(f"{prefix}_out", hidden)

    def _attflat(self, side: str, z: torch.Tensor, mask: torch.Tensor,
                 drop) -> torch.Tensor:
        p = f"attflat_{side}"
        att = self._linear(f"{p}_out", drop(torch.relu(
            self._linear(f"{p}_fc", z))))  # [N, L, 1]
        att = torch.softmax(att.masked_fill(mask[:, :, None],
                                            mcan_attention.MASK_FILL),
                            dim=1)
        return self._linear(f"{p}_merge", (att * z).sum(1))

    # -- the forward -------------------------------------------------------

    def forward(
        self,
        img: torch.Tensor,  # [N, L, D]
        ques: torch.Tensor,  # [N, T]
        ques_length: Optional[torch.Tensor] = None,  # unused: mask_q
        *,
        train: bool = False,
        valid: Optional[torch.Tensor] = None,  # unused: no batch norm
        generator: Optional[L.Generator] = None,
        fusion_seed: Optional[int] = None,  # unused: no K2
        reference_kernels: bool = False,
        aux: bool = False,
    ):
        """-> f32 logits [N, a_vocab]; with ``aux=True``, (logits, {}).
        ``train=True`` draws every dropout mask from ``generator`` in the
        forward's order; ``reference_kernels=True`` runs the composed norm
        and attention in place of the kernels."""
        cfg = self.cfg
        dtype = L.DTYPES[cfg.compute_dtype]
        rate = cfg.dropout_fusion

        def drop(x):
            return L.dropout(x, rate, train, generator)

        fused = (not train and dtype == torch.bfloat16
                 and not reference_kernels and not kernels_disabled())
        img = img.to(dtype)
        mask_q = ques == 0  # [N, T]
        mask_x = img.abs().sum(-1) == 0  # [N, L]

        with trace.span("mcan.encoder"):
            y = self.lstm(self.embedding(ques, dtype))
            for i in range(cfg.att_num):
                p = f"enc{i}"
                y = self._norm(f"{p}_norm1", y, drop(self._mha(
                    f"{p}_mhatt", y, y, mask_q, drop, fused)), fused)
                y = self._norm(f"{p}_norm2", y,
                               drop(self._ffn(f"{p}_ffn", y, drop)), fused)
        with trace.span("mcan.decoder"):
            x = self._linear("img_feat_linear", img)
            for i in range(cfg.att_num):
                p = f"dec{i}"
                x = self._norm(f"{p}_norm1", x, drop(self._mha(
                    f"{p}_mhatt1", x, x, mask_x, drop, fused)), fused)
                x = self._norm(f"{p}_norm2", x, drop(self._mha(
                    f"{p}_mhatt2", x, y, mask_q, drop, fused)), fused)
                x = self._norm(f"{p}_norm3", x,
                               drop(self._ffn(f"{p}_ffn", x, drop)), fused)
        with trace.span("mcan.head"):
            flat = self._norm("proj_norm",
                              self._attflat("lang", y, mask_q, drop),
                              self._attflat("img", x, mask_x, drop), fused)
            logits = self._linear("proj", flat).float()
        return (logits, {}) if aux else logits
