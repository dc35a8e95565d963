"""BAN-8, the bilinear attention network (Kim, Jun and Zhang, "Bilinear
Attention Networks", NeurIPS 2018, arXiv:1805.07932), as jnhwkim/ban-vqa
builds it (``base_model.py`` ``build_ban`` / ``BanModel.forward``,
``attention.py`` ``BiAttention``, ``bc.py`` ``BCNet``, ``fc.py`` ``FCNet``,
``language_model.py``, ``classifier.py``) with ``--op c``. A port-only
family: the JAX package has no BAN.

With H = ``hidden_dim``, G = ``att_num`` glimpses, k = 3 (BCNet's rank of
BiAttention), E = ``emb_dim``, WN(W) = g V / ||V||_F (``weight_norm`` with
one scalar g a weight, ``layers.weight_norm``) and the grid mask true at
cells whose features are all 0:

    w   = [E(ques) ; E_frozen(ques)]          [N, T, 2E]; word 0 embeds to 0
    Q0  = GRU_2E->H(w)                        all T states, no packing
    Av  = Drop.5(ReLU(WN(Drop.2(img)) 2048->kH))
    Aq  = ReLU(WN(Drop.2(Q0)) H->kH)
    S[n,g,i,j] = sum_c h[g,c] Av[n,i,c] Aq[n,j,c] + hb[g]    h = WN(h_mat)
    P[n,g]     = softmax over all (i, j) of S[n,g], masked cells at -inf
    Q = Q0
    for g in 0..G-1, in series (each on the Q its predecessor left):
        Bv = ReLU(WN_g(Drop.2(img)) 2048->H);  Bq = ReLU(WN_g(Drop.2(Q)) H->H)
        f[c] = sum_i sum_j Bv[i,c] P[n,g,i,j] Bq[j,c]
        Q = Q + WN_g^prj(Drop.2(f))           H->H, broadcast over T
    logits = WN_2(Drop.5(ReLU(WN_1(sum_t Q[:, t])))) H->2H->A

The dropouts are ban-vqa's constants (FCNet's 0.2 before each projection,
BCNet's 0.5 on BiAttention's Av, 0.5 in the classifier), drawn from the
forward's ``generator`` in the order above; the embeddings and the GRU have
none. k = 3 and the classifier's 2 H are BAN's constants; ``hidden_dim``
is H, ``emb_dim`` the width of one table, ``att_num`` G.

Departures from ban-vqa:

- **No counter**: ``counting.py`` (arXiv:1802.05766) and ``c_prj`` are
  left out. The counter de-duplicates overlapping object boxes, and the
  grid's cells do not overlap: it has nothing to act on.
- **Image sequence**: the repo's 196-cell ResNet-152 grid, not the paper's
  10-100 bottom-up regions; the mask is ban-vqa's (cells all 0).
- **Words**: the port's vocabulary with 0 as padding (ban-vqa pads with
  the last row, ``padding_idx = ntoken``), at the end as ban-vqa pads;
  row 0 of both tables is masked to 0 in the forward, so it takes no
  gradient. Both tables are random (no GloVe); the frozen one takes no
  gradient (``requires_grad`` False).
- **Initial values** (``init_params``): both tables N(0, 1), as
  ``nn.Embedding`` draws them (no GloVe); xavier-uniform directions with g
  = ||V|| (the weight is V, as ``weight_norm`` starts), zero biases; h_mat
  and h_bias N(0, 1) with g = ||h_mat||, as ban-vqa draws them. A tree
  without a layer's ``g`` loads it as ||V|| (``weights.load_jax_params``).
- **Serving head**: the engine's softmax and top-k; ban-vqa trains with a
  sigmoid, whose top-k order is the same.
- **Training**: the loss is ban-vqa's BCE over soft scores
  (``train/losses.vqa_score_bce``, MCAN's); the optimiser is the Solver's
  Adam at ``cfg.lr``, not ban-vqa's Adamax with warm-up and decay.
- **Rounding** (bf16, MCAN's rules): parameters f32, activations bf16;
  each projection is ``F.linear`` with its bias added before the product
  is rounded; the GRU's state is carried in bf16; the glimpse's pool f is
  summed in f32 and rounded once. The composed attention map scales the
  words by h in f32 and rounds them to bf16, rounds S to bf16 and takes the
  softmax in f32; the fused one keeps S in f32 and leaves hb out (a shift
  the softmax cancels).

Weights: in eval, every weight is formed (WN, the two tables joined with
row 0 at 0) and cast to the compute dtype once, by ``prepare`` at load and
again whenever a parameter was written since (``_derived_state``), into
non-persistent ``folded_*`` buffers: a captured graph (``serve.BankGraph``)
replays every op of the forward, and forming 88 M parameters there would
cost a pass over them a batch. Training forms them in every forward, with
their gradients.

Dispatch: in eval at bf16, unless ``VQA_DISABLE_PALLAS`` is set (read at
each call), the attention map is one call of the op ``vqa.ban_attention``
(``ops/ban_attention.py``, N3 on the card, which raises on a shape it
does not take); training, f32 and ``reference_kernels`` run the composed
form.
Spans ``ban.question`` (the embedding and the GRU), ``ban.attention``
(BiAttention's projections and the map), ``ban.glimpses`` and
``ban.head`` record while a profiler records (``utils/trace.py``).

Parameters are flat top-level layers (``w_emb``, ``q_emb``,
``v_att_v_net``, ``b_net3_q_net``, ``q_prj7``, ``classifier_fc2``, ...),
each a leaf group of the JAX-layout tree.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.models import layers as L
from vqa_attention_networks_tpu_torch.ops import (
    ban_attention,
    kernels_disabled,
)
from vqa_attention_networks_tpu_torch.utils import trace

RANK = 3  # BiAttention's BCNet k
CLASSIFIER_RATIO = 2  # the classifier's hidden width, 2 H
FC_DROP = 0.2  # FCNet's dropout before each projection
ATT_DROP = 0.5  # BCNet's dropout on BiAttention's Av
CLASSIFIER_DROP = 0.5


def layer_shapes(cfg: Config) -> Dict[str, tuple]:
    """Each weight-normalised layer -> (d_in, d_out), in the order of the
    forward; ``v_att_h`` is h_mat (kH -> G) with h_bias as its bias."""
    h, kh, g = cfg.hidden_dim, RANK * cfg.hidden_dim, cfg.att_num
    out = {"v_att_v_net": (cfg.img_feature_channel, kh),
           "v_att_q_net": (h, kh), "v_att_h": (kh, g)}
    for i in range(g):
        out[f"b_net{i}_v_net"] = (cfg.img_feature_channel, h)
        out[f"b_net{i}_q_net"] = (h, h)
        out[f"q_prj{i}"] = (h, h)
    out["classifier_fc1"] = (h, CLASSIFIER_RATIO * h)
    out["classifier_fc2"] = (CLASSIFIER_RATIO * h, cfg.a_vocab_size)
    return out


def init_params(cfg: Config, generator: torch.Generator) -> Dict:
    """A random parameter tree in the JAX layout (see the departures)."""
    g = generator
    h = cfg.hidden_dim
    p = {name: {"table": torch.empty(cfg.q_vocab_size, cfg.emb_dim)
                .normal_(generator=g)} for name in ("w_emb", "w_emb_frozen")}
    p["q_emb"] = {
        "w_ih": L.xavier_uniform(g, (2 * cfg.emb_dim, 3 * h),
                                 2 * cfg.emb_dim, 3 * h),
        "w_hh": L.xavier_uniform(g, (h, 3 * h), h, 3 * h),
        "b_ih": torch.zeros(3 * h), "b_hh": torch.zeros(3 * h)}
    for name, (d_in, d_out) in layer_shapes(cfg).items():
        if name == "v_att_h":
            v = torch.empty(d_in, d_out).normal_(generator=g)
            b = torch.empty(d_out).normal_(generator=g)
        else:
            v = L.xavier_uniform(g, (d_in, d_out), d_in, d_out)
            b = torch.zeros(d_out)
        p[name] = {"v": v, "g": torch.linalg.vector_norm(v), "b": b}
    return p


class BAN(nn.Module):
    """BAN's forward: (img [N, L, D], ques [N, T]) -> f32 logits
    [N, a_vocab]. Parameters are allocated empty; load them with
    ``weights.load_jax_params``, which also forms the eval weights."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.w_emb = L.Embedding(cfg.q_vocab_size, cfg.emb_dim)
        self.w_emb_frozen = L.Embedding(cfg.q_vocab_size, cfg.emb_dim)
        self.w_emb_frozen.weight.requires_grad_(False)
        self.q_emb = L.GRU(2 * cfg.emb_dim, cfg.hidden_dim)
        for name, (d_in, d_out) in layer_shapes(cfg).items():
            self.add_module(name, L.WNDense(d_in, d_out))
        self._folded_key: Optional[tuple] = None  # the parameters it saw

    # -- the weights ---------------------------------------------------------

    def _derived_state(self) -> tuple:
        """What identifies the parameters' values and the compute dtype:
        each parameter's version counter (bumped by every in-place write,
        as an optimizer step or a load makes) and its storage."""
        return (self.cfg.compute_dtype,) + tuple(
            (p._version, p.data_ptr()) for p in self.parameters())

    def _form(self) -> Dict[str, torch.Tensor]:
        """Every weight the forward uses, formed from the parameters in the
        compute dtype (h and hb in f32, as N3 takes them)."""
        dtype = L.DTYPES[self.cfg.compute_dtype]
        table = torch.cat([self.w_emb.weight,
                           self.w_emb_frozen.weight.detach()], dim=1)
        keep = torch.arange(table.shape[0], device=table.device) != 0
        out = {"words": (table * keep[:, None]).to(dtype)}
        for leaf in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
            out[f"q_emb_{leaf}"] = getattr(self.q_emb, leaf).to(dtype)
        for name in layer_shapes(self.cfg):
            layer = getattr(self, name)
            w = L.weight_norm(layer.weight_g, layer.weight_v)
            if name == "v_att_h":
                out["h"], out["hb"] = w, layer.bias
            else:
                out[f"{name}_w"] = w.to(dtype)
                out[f"{name}_b"] = layer.bias.to(dtype)
        return out

    def prepare(self) -> None:
        """Form the eval weights into the ``folded_*`` buffers (at load, and
        again whenever a parameter was written since). The buffers move
        with the module."""
        with torch.no_grad():
            formed = self._form()
        for key, value in formed.items():
            self.register_buffer(f"folded_{key}", value.contiguous(),
                                 persistent=False)
        self._folded_key = self._derived_state()

    def _weights(self, train: bool) -> Dict[str, torch.Tensor]:
        if train:
            return self._form()
        # under torch.export the parameters and buffers are the program's
        # inputs, traced tensors with no storage to compare: the program
        # takes the buffers as they are
        if self._folded_key is None or (
                not torch.compiler.is_exporting()
                and self._derived_state() != self._folded_key):
            self.prepare()
        return {name[len("folded_"):]: buf
                for name, buf in self.named_buffers()
                if name.startswith("folded_")}

    # -- the forward ---------------------------------------------------------

    def forward(
        self,
        img: torch.Tensor,  # [N, L, D]
        ques: torch.Tensor,  # [N, T]
        ques_length: Optional[torch.Tensor] = None,  # unused: no packing
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
        forward's order; ``reference_kernels=True`` runs the composed
        attention map in place of N3."""
        cfg = self.cfg
        dtype = L.DTYPES[cfg.compute_dtype]
        w = self._weights(train)

        def drop(x, rate):
            return L.dropout(x, rate, train, generator)

        def linear(name, x):
            return F.linear(x, w[f"{name}_w"], w[f"{name}_b"])

        img = img.to(dtype)
        mask = img.abs().sum(-1) == 0  # [N, L]
        with trace.span("ban.question"):
            q = L.gru(w["words"][ques.long()], w["q_emb_weight_ih"],
                      w["q_emb_weight_hh"], w["q_emb_bias_ih"],
                      w["q_emb_bias_hh"])  # [N, T, H]
        with trace.span("ban.attention"):
            av = drop(torch.relu(linear("v_att_v_net", drop(img, FC_DROP))),
                      ATT_DROP)
            aq = torch.relu(linear("v_att_q_net", drop(q, FC_DROP)))
            fused = (not train and dtype == torch.bfloat16
                     and not reference_kernels and not kernels_disabled())
            att = (ban_attention.attention_map if fused
                   else ban_attention.attention_map_composed)(
                av, aq, w["h"], w["hb"], mask)  # [N, G, L, T]
        with trace.span("ban.glimpses"):
            for g in range(cfg.att_num):
                bv = torch.relu(linear(f"b_net{g}_v_net", drop(img, FC_DROP)))
                bq = torch.relu(linear(f"b_net{g}_q_net", drop(q, FC_DROP)))
                pv = torch.bmm(att[:, g].transpose(1, 2), bv)  # [N, T, H]
                f = (pv.float() * bq.float()).sum(1).to(dtype)
                q = q + linear(f"q_prj{g}", drop(f, FC_DROP))[:, None, :]
        with trace.span("ban.head"):
            hidden = drop(torch.relu(linear("classifier_fc1", q.sum(1))),
                          CLASSIFIER_DROP)
            logits = linear("classifier_fc2", hidden).float()
        return (logits, {}) if aux else logits
