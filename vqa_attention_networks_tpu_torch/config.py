"""Frozen run configuration (the port's copy of ``Config`` in
``vqa_attention_networks_tpu/config.py``).

The same fields, defaults, ``validate()`` and ``replace()`` as the JAX
package's ``Config``, so a configuration written for one package means the
same run in the other (``tests/test_torch_port_config.py`` holds the two
together). Fields of switches the port does not run yet are kept: the port
refuses them by name (``train/solver.py``) instead of silently ignoring
them.

Defaults mirror the reference's (``cfg.py``): hidden 1024, emb 300, lr 7e-4,
batch 64, 18 epochs, lr decay x0.5 every 40k steps, ResNet-152 grid 196x2048.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

MODEL_NAMES = (
    "mfb",
    "mfb-multilayer",
    "mhb",
    "mhb_coAtt",
    "hieCoAtten",
    "visLstm",
    "iBOWIMG",
    "attentionNet",
)

# Models trained with soft answer distributions + soft cross-entropy
# (the reference's train_models.py:30-33, solver.py:26-29).
SOFT_ANSWER_MODELS = ("mhb", "mhb_coAtt")

# The families the port has and the JAX package has not, after the shared
# eight: MCAN-large (Yu et al., "Deep Modular Co-Attention Networks for
# VQA", arXiv:1906.10770; ``models/mcan.py``) and BAN (Kim et al.,
# "Bilinear Attention Networks", arXiv:1805.07932; ``models/ban.py``: H is
# ``hidden_dim``, a word table ``emb_dim`` wide, G glimpses ``att_num``).
# ``MODEL_NAMES`` stays the JAX
# package's tuple, so a configuration of the eight means the same run in
# both; ``Config.validate``, the registry and the Solver take these too.
PORT_MODEL_NAMES = MODEL_NAMES + ("mcan", "ban")

# Models trained on VQA scores (min(annotator count, 4) -> 0, .3, .6, .9,
# 1) under a summed sigmoid BCE (``train/losses.vqa_score_bce``): MCAN's
# recipe, and ban-vqa's. They read the soft answers too.
SCORE_MODELS = ("mcan", "ban")


@dataclass(frozen=True)
class Config:
    # --- model selection ---------------------------------------------------
    model_name: str = "mhb_coAtt"

    # --- vocab sizes (filled from the prepared dataset) --------------------
    q_vocab_size: int = 15881
    a_vocab_size: int = 1000

    # --- network -----------------------------------------------------------
    hidden_dim: int = 1024
    emb_dim: int = 300
    num_layers: int = 1
    glove: bool = False

    # MFB/MHB bilinear-fusion factorisation: k * o = 5000, k = 5
    mfb_factor: int = 5
    mfb_out: int = 1000

    # hieCoAtten / iBOWIMG / attentionNet embed width; mcan: the width of
    # AttFlat's MLP (FLAT_MLP_SIZE, 512 in both published sizes)
    embed_size: int = 512
    # attentionNet: its alternating attention layers; mcan: L, the depth of
    # the encoder and of the decoder (6 each). mcan's head width (64), FFN
    # width (4 x hidden_dim) and flat output (2 x hidden_dim) are fixed
    # ratios of hidden_dim (its d), constants of models/mcan.py
    att_num: int = 6

    # --- image features ----------------------------------------------------
    img_feature_channel: int = 2048
    img_feature_dim: int = 196  # 14*14 regions
    feature_type: str = "resnet152"
    max_question_length: int = 22
    image_first: bool = True

    # --- training ----------------------------------------------------------
    batch_size: int = 64
    lr: float = 7e-4
    num_epoch: int = 18
    lr_decay: bool = True
    decay_rate: float = 0.5
    decay_step: int = 40000
    shuffle: bool = True
    early_stopping: bool = False
    patience: int = 10
    seed: int = 0
    # host batch-assembly threads (data/dataset.py parallel_epoch)
    prefetch_workers: int = 4

    # dropout rates
    dropout_lstm: float = 0.3
    # mcan: DROPOUT_R, every dropout of the model (attention maps, the
    # residual branches, the FFN's and AttFlat's hidden layers)
    dropout_fusion: float = 0.1
    dropout_default: float = 0.5

    # where the grid-fusion dropout lands in training: "prepool" (the
    # reference's site, on the [N, 196, 5000] pre-pool product) or "pooled"
    # (on the pooled [N, 196, 1000] output, a different regulariser)
    dropout_site: str = "prepool"

    # --- numerics ----------------------------------------------------------
    # parameters stay f32; compute_dtype applies to the activations
    compute_dtype: str = "float32"
    grad_accum_steps: int = 1
    remat: bool = False
    rng_impl: str = "threefry2x32"

    # --- bf16 inference fast-path policy -----------------------------------
    # mhb_coAtt's bf16 eval forward: "auto", "pallas" and "pallas_pair" take
    # the stage-1 + co-attention kernel; "composed" the composed chain (the
    # accuracy reference at this dtype).
    fast_path: str = "auto"

    # --- training feed policy ----------------------------------------------
    device_feature_bank: bool = False
    device_feature_bank_budget: int = 8 << 30
    device_feature_bank_shard: bool = False

    # --- reference-bug policy ----------------------------------------------
    # The reference's semantically valid quirks (MFB's softmax over a
    # singleton axis; LSTM_Attention's unnormalised attention) are kept
    # exactly unless this flag is False.
    keep_reference_quirks: bool = True

    # --- parallelism -------------------------------------------------------
    data_parallel: int = 1
    model_parallel: int = 1

    # --- paths -------------------------------------------------------------
    data_dir: str = "data"
    out_dir: str = "./models"
    results_dir: str = "./results"

    # --- run mode ----------------------------------------------------------
    mode: str = "training"  # training | testing

    # --- legacy-trainer knobs ----------------------------------------------
    loss_override: str = ""
    early_stop_metric: str = "loss"

    # --- aux subsystems ----------------------------------------------------
    debug_nans: bool = False
    profile_steps: int = 0
    profile_dir: str = "runs/profile"

    # --- checkpointing -----------------------------------------------------
    checkpoint_every_steps: int = 2000
    keep_checkpoints: int = 3

    @property
    def soft_answer(self) -> bool:
        # soft_bce consumes soft targets whatever the model
        return (
            self.model_name in SOFT_ANSWER_MODELS + SCORE_MODELS
            or self.loss_override == "soft_bce"
        )

    @property
    def fusion_dim(self) -> int:
        return self.mfb_factor * self.mfb_out  # 5000

    @property
    def lstm_input_dim(self) -> int:
        # the GloVe concat doubles the LSTM input
        return self.emb_dim * 2 if self.glove else self.emb_dim

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def validate(self) -> "Config":
        if self.model_name not in PORT_MODEL_NAMES:
            raise ValueError(
                f"model {self.model_name!r} not supported; choose from "
                f"{PORT_MODEL_NAMES}"
            )
        if self.img_feature_dim != 196:
            raise ValueError("img_feature_dim must be 196 (14x14 ResNet grid)")
        if self.model_name == "attentionNet" and self.att_num < 2:
            raise ValueError(
                f"att_num={self.att_num}: attentionNet needs >= 2 "
                "alternating layers (one per guiding direction, "
                "networks.py:58-62)"
            )
        if self.grad_accum_steps < 1 or (
            self.batch_size % self.grad_accum_steps
        ):
            raise ValueError(
                f"grad_accum_steps={self.grad_accum_steps} must be >=1 and "
                f"divide batch_size={self.batch_size}"
            )
        if self.prefetch_workers < 1:
            raise ValueError(
                f"prefetch_workers={self.prefetch_workers} must be >= 1"
            )
        for field, value, allowed in (
            ("early_stop_metric", self.early_stop_metric, ("loss", "acc")),
            ("mode", self.mode, ("training", "testing")),
            ("compute_dtype", self.compute_dtype,
             ("float32", "float64", "bfloat16")),
            ("rng_impl", self.rng_impl, ("threefry2x32", "rbg")),
            ("loss_override", self.loss_override, ("", "soft_bce")),
            ("fast_path", self.fast_path,
             ("auto", "pallas", "pallas_pair", "composed")),
            ("dropout_site", self.dropout_site, ("prepool", "pooled")),
        ):
            if value not in allowed:
                raise ValueError(
                    f"{field}={value!r} not supported; choose from {allowed}"
                )
        return self
