"""MHB + co-attention, the flagship (port of the eval and training forward
of ``vqa_attention_networks_tpu/models/mhb_coatt.py``).

Attribute names are the JAX param-tree keys, so ``weights.load_jax_params``
maps a JAX tree onto the module one to one. ``init_params`` draws a tree in
the JAX layout from a ``torch.Generator`` (xavier-uniform weights, zero
biases, as the JAX ``init``).

Dispatch rule (``mhb_coatt.py:155-160``): at bf16 with
``cfg.fast_path != "composed"``, unless ``VQA_DISABLE_PALLAS`` is set (read
at each call, as ``pallas_wq_fusion.py:747`` reads it), the stage-1 fusion
and co-attention run as one call of K1 (``ops/wq_fusion.stage1_coattention``) — "auto", "pallas" and
"pallas_pair" all take the one kernel; otherwise the composed chain runs
(the weight-contracted fusion at bf16, or K5 under ``VQA_FORCE_PALLAS``;
the exact f32 chain at f32). The two glimpse blocks of the eval forward,
over the question and (composed) over the fused grid, run as K7 at bf16
under ``VQA_PALLAS_GLIMPSE`` (``ops/attention.py``).

The training forward (``train=True``) runs the stage-1 fusion through
``grid_fuse`` at ``cfg.dropout_site``: K2 at the pre-pool site, K3 at the
pooled site (bf16).

``MHB`` (``mhb_coatt.py:209-279``) is the plain model with no attention:
the mean-pooled grid, the LSTM's state at the last question token (it
reads ``ques_length``), and two cascaded MFB fusions. It runs no kernel of
the port, as the JAX function runs no Pallas kernel.

**Tensor parallelism** (``tp``, set by ``parallel.sharding.shard_params``):
the fusion projections hold their rank's block of output columns, and the
training forward computes its block of each fusion (projection, Hadamard
product, dropout, k-pool, signed sqrt; K2 or K3 on the shard), then
gathers the pooled output (``parallel.tensor.gather_columns``) before the
L2 norms, the co-attention and the classifier, which run replicated. The
inputs of the sharded projections pass ``parallel.tensor.model_input``, so
the replicated layers before them take the whole gradient. The eval
forward needs whole rows (the grid L2, K1): a tensor-parallel trainer
evaluates a model on the gathered weights (``train/solver.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.models import layers as L
from vqa_attention_networks_tpu_torch.ops.attention import glimpse_attention
from vqa_attention_networks_tpu_torch.ops.fusion import (
    mfb_fuse_pool,
    mfb_sumpool,
    two_glimpse_pool,
)
from vqa_attention_networks_tpu_torch.ops.grid_fusion import grid_fuse
from vqa_attention_networks_tpu_torch.ops import kernels_disabled
from vqa_attention_networks_tpu_torch.ops import wq_fusion as wqf
from vqa_attention_networks_tpu_torch.parallel.tensor import (
    gather_columns,
    model_input,
    sharded,
)


def refuse_sharded_eval(model: nn.Module) -> None:
    """The eval forward of a tensor-parallel shard raises."""
    if sharded(model.tp):
        raise RuntimeError(
            f"{type(model).__name__}: the eval forward of a tensor-parallel "
            "shard needs the whole fusion width; evaluate the gathered "
            "weights (train.solver.Solver.eval_model)")

_STAGE1_FIELDS = ("w3", "b3", "c1w", "c1b", "c2w", "c2b")


def init_params(cfg: Config, generator: torch.Generator) -> Dict:
    """A random parameter tree in the JAX layout (``mhb_coatt.init``)."""
    h, d_img, fusion = cfg.hidden_dim, cfg.img_feature_channel, cfg.fusion_dim
    g = generator
    p = {
        "word_embedding": L.embedding_init(g, cfg.q_vocab_size, cfg.emb_dim),
        "lstm": L.lstm_init(g, cfg.lstm_input_dim, h),
        "ques_att_conv1": L.dense_init(g, h, 512),
        "ques_att_conv2": L.dense_init(g, 512, 2),
        "ques_proj1": L.dense_init(g, 2 * h, fusion),
        "img_conv1d": L.dense_init(g, d_img, fusion),
        "co_att_conv1": L.dense_init(g, cfg.mfb_out, 512),
        "co_att_conv2": L.dense_init(g, 512, 2),
        "ques_proj2": L.dense_init(g, 2 * h, fusion),
        "ques_proj3": L.dense_init(g, 2 * h, fusion),
        "img_proj2": L.dense_init(g, 2 * d_img, fusion),
        "img_proj3": L.dense_init(g, 2 * d_img, fusion),
        "linear_pred": L.dense_init(g, 2 * cfg.mfb_out, cfg.a_vocab_size),
    }
    if cfg.glove:
        # placeholder table, as the JAX init; real runs load the offline one
        p["glove_table"] = torch.zeros(cfg.q_vocab_size, cfg.emb_dim)
    return p


class MHBCoAtt(nn.Module):
    """Eval forward of mhb_coAtt: (img [N, L, D], ques [N, T]) -> f32
    logits [N, a_vocab]. Parameters are allocated empty; load them with
    ``weights.load_jax_params``, which also lays out the K1 weights."""

    tp = None  # the model axis (parallel.sharding.shard_params)

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        h, d_img, fusion = cfg.hidden_dim, cfg.img_feature_channel, cfg.fusion_dim
        self.word_embedding = L.Embedding(cfg.q_vocab_size, cfg.emb_dim)
        self.lstm = L.LSTM(cfg.lstm_input_dim, h)
        self.ques_att_conv1 = L.Dense(h, 512)
        self.ques_att_conv2 = L.Dense(512, 2)
        self.ques_proj1 = L.Dense(2 * h, fusion)
        self.img_conv1d = L.Dense(d_img, fusion)
        self.co_att_conv1 = L.Dense(cfg.mfb_out, 512)
        self.co_att_conv2 = L.Dense(512, 2)
        self.ques_proj2 = L.Dense(2 * h, fusion)
        self.ques_proj3 = L.Dense(2 * h, fusion)
        self.img_proj2 = L.Dense(2 * d_img, fusion)
        self.img_proj3 = L.Dense(2 * d_img, fusion)
        self.linear_pred = L.Dense(2 * cfg.mfb_out, cfg.a_vocab_size)
        if cfg.glove:
            self.register_buffer(
                "glove_table", torch.empty(cfg.q_vocab_size, cfg.emb_dim)
            )
        self._stage1_o: Optional[int] = None  # set by prepare()
        self._stage1_key: Optional[tuple] = None  # the parameters it saw

    def _stage1_params(self) -> tuple:
        return (self.img_conv1d.weight, self.img_conv1d.bias,
                self.co_att_conv1.weight, self.co_att_conv1.bias,
                self.co_att_conv2.weight, self.co_att_conv2.bias)

    def _stage1_state(self) -> tuple:
        """What identifies the parameters' values: each one's version
        counter (bumped by every in-place write, as an optimizer step or a
        load makes) and its storage."""
        return tuple((p._version, p.data_ptr())
                     for p in self._stage1_params())

    # what serve.BankGraph compares to know the layout stale
    _derived_state = _stage1_state

    def prepare(self) -> None:
        """Lay out img_conv1d / co_att_conv1 / co_att_conv2 for K1 (the JAX
        wrapper redoes this on every call; in eager PyTorch that would copy
        42 MB per batch). Called at load, and again by ``stage1_weights``
        whenever the parameters changed since. The buffers move with the
        module. A tensor-parallel shard has no layout (its eval forward
        refuses)."""
        if sharded(self.tp):
            return
        with torch.no_grad():
            sw = wqf.prepare_stage1_weights(
                self.img_conv1d.weight.t(), self.img_conv1d.bias,
                self.co_att_conv1.weight.t(), self.co_att_conv1.bias,
                self.co_att_conv2.weight.t(), self.co_att_conv2.bias,
                self.cfg.mfb_factor,
            )
        for field in _STAGE1_FIELDS:
            self.register_buffer(f"stage1_{field}", getattr(sw, field),
                                 persistent=False)
        self._stage1_o = sw.o
        self._stage1_key = self._stage1_state()

    def stage1_weights(self) -> wqf.Stage1Weights:
        if self._stage1_o is None:
            raise RuntimeError(
                "K1 weights are not laid out: load the weights with "
                "weights.load_jax_params (or call prepare())"
            )
        # under torch.export (aot.export_serving) the parameters and the
        # laid-out buffers are the program's inputs, traced tensors with no
        # storage to compare: the program takes the buffers as they are,
        # and the engine lays them out once, at load
        if not torch.compiler.is_exporting() and \
                self._stage1_state() != self._stage1_key:
            self.prepare()
        return wqf.Stage1Weights(
            **{f: getattr(self, f"stage1_{f}") for f in _STAGE1_FIELDS},
            o=self._stage1_o, k=self.cfg.mfb_factor,
        )

    def _output_fusion(self, stage: str, q_att: torch.Tensor,
                       v_att: torch.Tensor, train: bool = False,
                       generator: Optional[L.Generator] = None,
                       ) -> torch.Tensor:
        """Under tensor parallelism q_att and v_att have passed
        ``model_input`` and ``generator`` is the column block's; the
        pooled block is gathered before the L2 norm."""
        q_proj = getattr(self, f"ques_proj{stage}")(q_att)
        v_proj = getattr(self, f"img_proj{stage}")(v_att)
        return L.l2_normalize(gather_columns(mfb_fuse_pool(
            q_proj, v_proj, self.cfg.mfb_factor, rate=self.cfg.dropout_fusion,
            train=train, generator=generator), self.tp))

    def forward(
        self,
        img: torch.Tensor,  # [N, L, D]
        ques: torch.Tensor,  # [N, T]
        ques_length: Optional[torch.Tensor] = None,  # unused
        *,
        train: bool = False,
        valid: Optional[torch.Tensor] = None,  # unused: no batch norm
        generator: Optional[torch.Generator] = None,
        fusion_seed: Optional[int] = None,
        reference_kernels: bool = False,
        aux: bool = False,
    ):
        """-> f32 logits [N, a_vocab]; with ``aux=True``, (logits, {}).

        ``train=True`` runs the training forward: the dropout masks come
        from ``generator`` (on img's device) in the JAX order (LSTM output,
        stage-1 fusion when it is composed or at the pooled site, output
        fusion 2, then 3), and K2's mask from ``fusion_seed``.

        ``reference_kernels=True`` runs the plain PyTorch version of every
        kernel on the path (K1, K5 and K7 in eval, K2 or K3 in training) in
        place of the kernel on any device — for the comparisons of the
        tests and ``chip_smoke.py`` only."""
        cfg = self.cfg
        dtype = L.DTYPES[cfg.compute_dtype]
        n = ques.shape[0]
        img = img.to(dtype)

        emb = torch.tanh(self.word_embedding(ques, dtype))
        if cfg.glove:
            emb = torch.cat([emb, L.embed(self.glove_table, ques, dtype)], -1)
        h_seq = self.lstm(emb)  # [N, T, H]
        if train:
            logits = self._train_forward(img, h_seq, generator, fusion_seed,
                                         reference_kernels)
            return (logits, {}) if aux else logits
        refuse_sharded_eval(self)
        q_att = glimpse_attention(
            h_seq, self.ques_att_conv1.weight, self.ques_att_conv1.bias,
            self.ques_att_conv2.weight, self.ques_att_conv2.bias, h_seq,
            uniform_quirk=False, reference_kernel=reference_kernels,
        )
        q_proj = self.ques_proj1(q_att)

        if dtype == torch.bfloat16 and cfg.fast_path != "composed" \
                and not kernels_disabled():
            sw = self.stage1_weights()
            if reference_kernels:
                v_att = wqf.stage1_coattention_reference(img, q_proj, sw)
            else:
                v_att = wqf.stage1_coattention(img, q_proj, sw)
        else:
            fused = grid_fuse(img, self.img_conv1d.weight.t(),
                              self.img_conv1d.bias, q_proj, cfg.mfb_factor,
                              reference_kernel=reference_kernels)
            fused = L.l2_normalize(fused.reshape(n, -1)).reshape(fused.shape)
            v_att = glimpse_attention(
                fused.to(img.dtype),
                self.co_att_conv1.weight, self.co_att_conv1.bias,
                self.co_att_conv2.weight, self.co_att_conv2.bias, img,
                uniform_quirk=False, reference_kernel=reference_kernels,
            )

        out2 = self._output_fusion("2", q_att, v_att)
        out3 = self._output_fusion("3", q_att, v_att)
        logits = self.linear_pred(torch.cat([out2, out3], dim=-1)).float()
        return (logits, {}) if aux else logits

    def _train_forward(self, img: torch.Tensor, h_seq: torch.Tensor,
                       generator: Optional[torch.Generator],
                       fusion_seed: Optional[int],
                       reference_kernel: bool) -> torch.Tensor:
        """``mhb_coatt.py:127-202`` at ``train=True``; under tensor
        parallelism each fusion is the rank's column block, gathered after
        its signed sqrt."""
        cfg = self.cfg
        n = h_seq.shape[0]
        h_seq = L.dropout(h_seq, cfg.dropout_lstm, True, generator)
        # the question glimpse composed, not glimpse_attention (:132-138)
        q_logits = self.ques_att_conv2(torch.relu(self.ques_att_conv1(h_seq)))
        q_att = model_input(two_glimpse_pool(q_logits, h_seq,
                                             uniform_quirk=False), self.tp)
        q_proj = self.ques_proj1(q_att)
        block = L.columns(generator, self.tp)

        fused = gather_columns(grid_fuse(
            img, self.img_conv1d.weight.t(), self.img_conv1d.bias, q_proj,
            cfg.mfb_factor, train=True, rate=cfg.dropout_fusion,
            site=cfg.dropout_site, seed=fusion_seed, generator=block,
            reference_kernel=reference_kernel,
        ), self.tp)
        fused = L.l2_normalize(fused.reshape(n, -1)).reshape(fused.shape)
        # the convs compute in fused's dtype (:181-188): at bf16 that is f32
        # at the pre-pool site (K2 and the composed chain return f32) and
        # bf16 at the pooled site (grid_fuse_pooled casts to img's dtype)
        co_logits = self.co_att_conv2(torch.relu(self.co_att_conv1(fused)))
        v_att = model_input(two_glimpse_pool(co_logits, img,
                                             uniform_quirk=False), self.tp)

        out2 = self._output_fusion("2", q_att, v_att, True, block)
        out3 = self._output_fusion("3", q_att, v_att, True, block)
        return self.linear_pred(torch.cat([out2, out3], dim=-1)).float()


# ---------------------------------------------------------------------------
# MHB (no attention)
# ---------------------------------------------------------------------------

def mhb_init_params(cfg: Config, generator: torch.Generator) -> Dict:
    """A random parameter tree in the JAX layout (``_mhb_init``)."""
    h, d_img, fusion, g = (cfg.hidden_dim, cfg.img_feature_channel,
                           cfg.fusion_dim, generator)
    return {
        "embedding": L.embedding_init(g, cfg.q_vocab_size, cfg.emb_dim),
        "lstm": L.lstm_init(g, cfg.emb_dim, h),
        "linear_q_1": L.dense_init(g, h, fusion),
        "linear_q_2": L.dense_init(g, h, fusion),
        "linear_i_1": L.dense_init(g, d_img, fusion),
        "linear_i_2": L.dense_init(g, d_img, fusion),
        "linear_out": L.dense_init(g, 2 * cfg.mfb_out, cfg.a_vocab_size),
    }


class MHB(nn.Module):
    """MHB: (img [N, L, D], ques [N, T], ques_length [N]) -> f32 logits
    [N, a_vocab]. Parameters are allocated empty; load them with
    ``weights.load_jax_params``."""

    tp = None  # the model axis (parallel.sharding.shard_params)

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        h, d_img, fusion = cfg.hidden_dim, cfg.img_feature_channel, cfg.fusion_dim
        self.embedding = L.Embedding(cfg.q_vocab_size, cfg.emb_dim)
        self.lstm = L.LSTM(cfg.emb_dim, h)
        self.linear_q_1 = L.Dense(h, fusion)
        self.linear_q_2 = L.Dense(h, fusion)
        self.linear_i_1 = L.Dense(d_img, fusion)
        self.linear_i_2 = L.Dense(d_img, fusion)
        self.linear_out = L.Dense(2 * cfg.mfb_out, cfg.a_vocab_size)

    def forward(
        self,
        img: torch.Tensor,  # [N, L, D]
        ques: torch.Tensor,  # [N, T]
        ques_length: Optional[torch.Tensor] = None,  # [N], required
        *,
        train: bool = False,
        valid: Optional[torch.Tensor] = None,  # unused: no batch norm
        generator: Optional[torch.Generator] = None,
        fusion_seed: Optional[int] = None,  # unused: no K2
        reference_kernels: bool = False,  # unused: no kernel
        aux: bool = False,
    ):
        """-> f32 logits [N, a_vocab]; with ``aux=True``, (logits, {}).
        ``train=True`` draws the three dropout masks from ``generator`` in
        the JAX order: the LSTM state, then stage 1's product, then stage
        2's."""
        if ques_length is None:
            raise ValueError("MHB gathers the last valid LSTM step: it "
                             "needs ques_length")
        cfg = self.cfg
        dtype = L.DTYPES[cfg.compute_dtype]
        n, t = ques.shape
        k = cfg.mfb_factor
        # the grid cast first, then mean-pooled (mhb_coatt.py:246)
        img_pooled = torch.mean(img.to(dtype), dim=1)  # [N, D]
        # no tanh on the embedding in MHB
        h_seq = self.lstm(self.embedding(ques, dtype))  # [N, T, H]
        # the last valid step; a zero-length question reads step 0, and a
        # length past T the last step, as JAX's clamping gather does
        last = torch.clamp(ques_length.long(), 1, t) - 1
        h_last = h_seq[torch.arange(n, device=h_seq.device), last]
        h_last = L.dropout(h_last, cfg.dropout_lstm, train, generator)
        if not train:
            refuse_sharded_eval(self)
        # under tensor parallelism: the rank's column block of each fusion
        # (the projections' inputs pass model_input), gathered after its
        # signed sqrt
        h_last = model_input(h_last, self.tp)
        img_pooled = model_input(img_pooled, self.tp)
        block = L.columns(generator, self.tp)

        z1 = self.linear_q_1(h_last) * self.linear_i_1(img_pooled)
        z1_dropped = L.dropout(z1, cfg.dropout_fusion, train, block)
        m1 = L.l2_normalize(gather_columns(
            L.signed_sqrt(mfb_sumpool(z1_dropped, k)), self.tp))
        # stage 2 re-multiplies stage 1's dropped pre-pool product
        z2 = self.linear_q_2(h_last) * self.linear_i_2(img_pooled)
        z2 = L.dropout(z2 * z1_dropped, cfg.dropout_fusion, train, block)
        m2 = L.l2_normalize(gather_columns(
            L.signed_sqrt(mfb_sumpool(z2, k)), self.tp))
        logits = self.linear_out(torch.cat([m1, m2], dim=-1)).float()
        return (logits, {}) if aux else logits
