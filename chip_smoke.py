"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and the exit code is not 0):

1. the device: torch's name for it, and nvidia-smi's name and power limit;
2. build the hand-written kernels from ``vqa_attention_networks_tpu_torch/
   csrc`` into ``build/kernels/`` and print the seconds it took;
3. K1 (stage-1 fusion + co-attention) against its plain PyTorch version on
   the card at production shapes, N = 8, 256 and 1024: max and mean |diff|,
   failing past the tolerance of ``within``; the kernel's z and h1 scratch
   against the plain version's; and a control: the inputs peak the
   attention over the 196 regions, and the check must reject the uniform
   mean of img on most elements, since that is what a kernel with a dead
   fusion or hidden stage would give;
4. full-width bf16 mhb_coAtt (``Config()`` defaults, random weights from a
   seed; the co-attention weights drawn at a scale that peaks the
   attention) served by ``InferenceEngine.predict_stream`` at batch 256
   over 8 batches (2048 requests) of features gathered from a synthetic
   feature store: the K1 launch count of that run, and top-1 flips against
   the same forward with the plain K1, at most 0.1% (``flips``); a control
   that the gate counts the answers of a uniform attention as flips; and,
   for information only, flips against ``fast_path="composed"``;
5. times: K1 and its plain version at N = 256 and 1024 (CUDA events after
   warm-up), at N = 256 each of K1's three launches apart (device time,
   ``torch.profiler``), and the end-to-end qa-pairs/s of step 4;
6. K2 (the training fusion with pre-pool dropout, forward and backward)
   against its plain PyTorch version at production widths (L=196, D=2048,
   F=5000, k=5), N = 8 and 64, rate 0.1 and 0: each launch (forward, the
   g_prod build and the d_img and d_W/d_b products over it, d_q) on the
   same inputs as its plain version, the backward launches on the kernel's
   own forward output, the bf16 g_prod bit for bit; bit-equal reruns, finite
   values, the count of out == 0 (all k factors dropped); and controls:
   the plain output with another mask seed, and d_W with the zero rule of
   g_pooled removed or with the mask off, must be rejected;
7. training: the port's ``Solver`` on ``Config(compute_dtype="bfloat16")``
   at full width, batch 64, 20 steps through ``Solver.train`` with K2, the
   same 20 steps with K2's plain version, and 20 steps on one repeated
   batch: per-step losses (finite, the two runs agreeing over the first
   steps, the repeated batch's falling), K2's launch counts in the kernel
   run, and ``val()`` against a model freshly loaded with the trained
   weights;
8. times: each K2 launch and its plain version at N = 64 (d_img and
   d_W/d_b as the product alone and with the g_prod build, d_W/d_b's two
   launches' shares, and beside d_img ``torch.matmul`` on the bare
   product), the forward, backward and forward + backward through the
   autograd functions, and ms per training step and training qa-pairs/s of
   the kernel and plain runs; then one pre-pool training step under
   ``torch.profiler``: the device's busy share of the step and its five
   longest kernels;
9. K3 (the pooled-site training fusion: forward, the g_pooled build, and
   the d_img and d_W/d_b/d_q products over it) against its plain PyTorch
   version at production widths (L=196, D=2048, O=1000, k=5), N = 8 and
   64: each launch on the same inputs as its plain version, the backward
   launches on the kernel's own forward output, the bf16 g_pooled equal;
   bit-equal reruns, finite values, the forced zeros of pooled (a zero
   image row with zero bias, and outputs with zero weights and bias) zero
   in both; and controls that must be rejected: the plain forward with q
   permuted across samples, d_W with another sample's q, and d_W, d_b and
   d_img with the zero rule of g_pooled removed;
10. pooled-site training: the port's ``Solver`` on
    ``Config(compute_dtype="bfloat16", dropout_site="pooled")`` at full
    width, batch 64, 20 steps with K3, the same 20 steps with its plain
    version and 20 on one repeated batch, with the gates of phase 7 and
    K3's launch counts (forward, g_pooled and d_W once a step, d_img
    never);
11. mfb training, ``keep_reference_quirks=False`` (with the quirk the
    stage-1 fusion is gradient-dead): mfb at the pre-pool site (K2), mfb
    and mfb-multilayer at the pooled site (K3), 10 steps each with the
    same runs and gates; then one quirk-on mfb step, in which no gradient
    reaches ``img_conv1d`` or ``ques_proj1`` and K3's backward never
    launches;
12. times: each K3 launch and its plain version at N = 64 (d_img as the
    product alone and with the build, and ``torch.bmm`` on the bare
    product beside it), and the device time of each of d_W/d_b/d_q's four
    launches, the build included (``torch.profiler``; each
    training run of phases 7, 10 and 11 prints its ms per step and
    training qa-pairs/s, kernel and plain, as it ends);
13. K4 (hieCoAtten's co-attention core) against its plain version at
    N = 8 and 256, L = 196, T = 22, E = 512, on v, q, av and aq, with inputs
    that peak both softmaxes (the largest av well above 1/196) and a
    control: the plain outputs with whv and whq zeroed (uniform maps) must
    be rejected on most elements;
14. full-width bf16 hieCoAtten served through ``predict_stream`` (batch
    256, 2048 requests): K4's launch count, flips against the same forward
    with K4's plain version (at most 0.1%), and a control: the answers of
    the model with whv and whq zeroed must count as flips;
15. K5 (the inference fusion, the K2 forward kernel with the mask compiled
    out) against its plain version at production widths, N = 8 and 256,
    bit-equal reruns, and a control: the plain output with q permuted
    across samples must be rejected;
16. full-width bf16 mfb and mfb-multilayer served with ``VQA_FORCE_PALLAS``
    and ``keep_reference_quirks=False`` (with the quirk the stage-1 fusion
    is value-dead and a broken K5 would pass unseen): K5's launch count,
    flips against K5's plain version, and a control (the fusion's weights
    zeroed must flip the answers); then, with the quirk on, the logits are
    bit-equal whether or not K5's output is zeroed: the dead fusion;
17. K7 (the glimpse block) against its plain version at its two call
    shapes (the question glimpse, N = 256, P = 22, C = 1024, A = 512,
    D = 1024; the co-attention, P = 196, C = 1000, D = 2048), in both
    ``uniform_quirk`` modes, with a control: a uniform pool must be
    rejected;
18. full-width bf16 mhb_coAtt served with ``VQA_PALLAS_GLIMPSE`` (K1 and K7)
    and with ``fast_path="composed"`` plus both switches (K5 and K7): the
    launch counts and flips against the plain versions;
19. full-width mhb, visLstm, iBOWIMG and attentionNet (random weights,
    no kernel on their paths, as in JAX) served through ``predict_stream``
    at batch 256 (2048 requests, each with its question length): qa-pairs/s,
    the device forward's ms per batch and its share of the wall time, and
    the gate that every served answer is the top of the same forward (one
    bf16 ulp, ``flips``); for MHB the lengths used, and a control: with
    every length set to T the answers must change (the lengths reach it);
20. training of hieCoAtten (the composed chain with its five dropouts),
    mhb, visLstm, iBOWIMG and attentionNet through ``Solver.train``:
    full width, bf16, batch 64, 10 steps, then 10 on one repeated batch:
    ms per step and qa-pairs/s, finite losses, the repeated batch's loss
    falling, ``val()`` equal to a fresh load's, the batch norms' running
    statistics moved (iBOWIMG, attentionNet), no training kernel launched;
21. ``families_agree``: the f32 forward of each of those four families
    (eval, and training with dropout 0 and pad rows in ``valid``) and
    hieCoAtten's training forward, full width, N = 8, on the card and on
    the CPU (TF32 off), each against the same forward at f64 on the CPU:
    the card within 1e-5 of the largest |logit| (the bound of the CPU
    tests against JAX) or within 4x the CPU's own f32 error;
22. times: K4, K5 and K7 against their plain versions at N = 256 (K4's
    device time, by events queued behind a spin; K7's two launches and
    its wrapper's cast apart, by the profiler), and
    beside K5, for information, ``torch.matmul`` on the bare product
    img @ bf16(W) (``matmul_ms``), which no path of the port calls;
23. K6 (the standalone wq fusion + grid-flat L2) against its plain version
    at production widths (L=196, D=2048, F=5000, k=5), N = 8, 256 and 1024,
    held as pooled = out * |out|, bit-equal reruns, and two controls that
    must be rejected on most elements: the plain output with q permuted
    across samples, and with a per-row L2 norm in place of the grid-flat
    one;
24. K6's path, its entry ``wq_grid_fuse`` forward and backward at N = 64
    (the launch count set to 0 just before): finite gradients of img, W, b
    and q, equal to ``composed_reference``'s on the card;
25. K8 (the LSTM scan, one persistent launch a call) against its plain
    version at mhb_coAtt's serving shape (T=22, E=300, H=1024), N = 8, 256,
    1024 and 2048 (past 1,408 rows c leaves shared memory for device
    memory), fed as ``lstm_seq`` feeds it (the projection without its
    bias, and the bias, which the kernel adds), on inputs whose gate
    pre-activations lie mostly off the sigmoid's flat tails (the share is
    printed and gated), the share of bit-equal elements, bit-equal reruns,
    the launch's blocks, shared memory and barriers (every block arrives
    at each), and two controls
    that must be rejected: W_hh with its i and f blocks swapped, and the
    output shifted by one step; then K8's path, its entry ``lstm_seq`` at
    N = 256 (the launch count set to 0 just before: one launch), with the
    port's composed ``layers.lstm`` on the same weights beside it for
    information;
26. times: K6 and its plain version at N = 256 and 1024, with the torch
    composed weight-contracted chain + L2 for information, and at N = 256
    the device time of each of K6's two launches (the forward with its
    sums of squares, and the scale launch); K8's scan and
    the whole ``lstm_seq`` against their plain versions at N = 256, and
    ``torch.nn.LSTM`` (cuDNN, input projection included) on the same
    weights and input: K8's library time, and the device times of both
    calls (``torch.profiler``) in K8_ROUNDS interleaved rounds;
27. ``cli``: the command line from corpus to results files, in process, in
    a temporary workspace: ``tools/gen_corpus.py`` (640 train and 192 val
    questions, a subprocess), the port's ``cli.prepare_data`` with
    ``--num_answer 1000`` (the corpus has fewer answers: the vocabulary
    size is printed, and prepare drops the questions whose answer the UNK
    slot displaces), synthetic f16 stores at 196 x 2048 as
    ``resnet152_train`` and ``resnet152_val`` (``CombinedFeatureStore``),
    then ``cli.train`` of bf16 mhb_coAtt at ``Config()`` widths, batch 64,
    2 epochs (20 steps), a checkpoint every 4 steps: finite losses, K2 once
    a step (forward, g_prod, d_W and d_q; d_img never), ``step_12``,
    ``step_16`` and ``step_20`` kept and the ``weights`` export; a
    ``cli.train --resume`` in a second workspace from ``step_12`` (inside
    epoch 2) to step 20: every parameter and Adam moment and the final
    loss bit-equal to the straight run's; ``cli.evaluate``: K1 once per
    val batch, ``results/mhb_coAtt.txt``, ``.json`` (num_examples the
    prepared val split, accuracies in [0, 1], the per-type counts summing
    to it) and ``_predictions.json`` (one row per val question id); for
    information the same evaluation under ``VQA_DISABLE_PALLAS=1`` (the
    share of predictions that differ, both accuracies); and the seconds of
    ``prepare_data``, ms per training step and training qa-pairs/s through
    the CLI (its last epoch), evaluation qa-pairs/s and the device share of
    an evaluated batch;
28. ``serve_bank``: full-width bf16 mhb_coAtt (phase 4's weights) served
    by id from the device feature cache (``predict_stream_by_id``) over
    8 batches of 256 from an int8 store of 1,024 synthetic images
    (``quantize_store`` of an f16 store), each image asked ~3 questions:
    at capacity 512 (the eviction regime) and at 1,024 (after a warm-up
    pass and ``reset_stats``, every request a hit). Gates: the top-k ids
    and probabilities bit-equal to ``predict_stream`` with the
    per-request int8 feed; K1 once a batch; hits + misses = requests,
    and the counts and slots equal those of the same id sequence through
    a second ``DeviceFeatureCache`` on the CPU; a control: the first
    batch's slots swapped in pairs on the card must flip its answers
    (``flips``) and swapping back restores them bit for bit; hieCoAtten
    by id, K4 once a batch, bit-equal to its int8 feed. Times:
    qa-pairs/s and the device share of a batch for the f16 feed, the
    int8 feed and both by-id runs; the cost of a miss upload from pinned
    host memory, fitted as a + bytes / BW over 1 to 256 misses;
29. ``serve_http``: the port's ``cli.serve`` in process
    (``build_service`` + ``ThreadingHTTPServer`` on 127.0.0.1, a free
    port): the same weights saved by ``checkpoint.save_weights`` and
    loaded back, a vocab of ``Config()``'s sizes, the int8 store with
    ``device_cache_images``, batch 256, ``max_wait_ms`` 5; 2,048
    questions from 64 concurrent clients, half as single /predict
    requests and half as bulk calls of 16. Gates: every answer within
    ``flips`` of the int8 forward (the share bit-equal to
    ``predict_batch_by_id`` of a second engine printed), /healthz and
    /metrics counting the requests and the bank's hits and misses, an
    unknown image id 400, K1 launches equal to the engine calls. Times:
    HTTP qa-pairs/s, p50/p99 request latency (``LatencyStats``), batch
    occupancy;
30. ``backbone``: ResNet-152 at full depth at 448 and VGG-19's pool4 tap
    at 224, random weights from a seed, f32 on the card (TF32 off)
    against f32 on the CPU at N = 2 (relative error < 1e-4), and each
    extractor at bf16 on a batch of 32 (images/s); if PIL imports, one
    PNG through /predict_image and through ``cli.predict`` (bf16, K1
    once), each answer the top of the forward on that image's grid, and
    8 PNGs through ``cli.extract_features``, whose store rows equal
    ``GridExtractor.from_bytes`` of each image to one f16 rounding
    (without PIL: ``"pil": false``, and the trunks take uint8 arrays);

then a JSON line of the kernels (each with its bound: the larger of its
inputs and outputs moved once at 3.35 TB/s and its operations at the
card's peak rate for their type, from this run's shapes; K2's and K3's
d_img with the bare product's library time), nvidia-smi's
line, and as the last line ``{"ok": true, "device": {...}}``. A switch
(``VQA_FORCE_PALLAS``, ``VQA_PALLAS_GLIMPSE``) is set only inside the
phase that needs it. With no card it exits non-zero before phase 2.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vqa_attention_networks_tpu_torch.cli import evaluate as cli_evaluate
from vqa_attention_networks_tpu_torch.cli import extract_features as cli_extract
from vqa_attention_networks_tpu_torch.cli import predict as cli_predict
from vqa_attention_networks_tpu_torch.cli import prepare_data
from vqa_attention_networks_tpu_torch.cli import serve as serve_cli
from vqa_attention_networks_tpu_torch.cli import train as cli_train
from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.data.feature_store import (
    FeatureStore,
    FeatureStoreWriter,
    make_synthetic_feature_store,
    quantize_features,
    quantize_store,
)
from vqa_attention_networks_tpu_torch.data.prepare import (
    load_qa_data,
    make_synthetic_qa_data,
    qa_artifact_path,
)
from vqa_attention_networks_tpu_torch.models import get_model
from vqa_attention_networks_tpu_torch.models import hiecoatten, mfb
from vqa_attention_networks_tpu_torch.models import layers, resnet, vgg
from vqa_attention_networks_tpu_torch.models.extractor import GridExtractor
from vqa_attention_networks_tpu_torch.ops import _build
from vqa_attention_networks_tpu_torch.ops import attention as att
from vqa_attention_networks_tpu_torch.ops import coattention as co
from vqa_attention_networks_tpu_torch.ops import fusion
from vqa_attention_networks_tpu_torch.ops import grid_fusion as gf
from vqa_attention_networks_tpu_torch.ops import lstm as k8
from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf
from vqa_attention_networks_tpu_torch.ops import train_fusion as tf
from vqa_attention_networks_tpu_torch.ops import wq_fusion as wqf
from vqa_attention_networks_tpu_torch.ops import wq_grid_fusion as wqg
from vqa_attention_networks_tpu_torch.serve import (
    DeviceFeatureCache,
    InferenceEngine,
)
from vqa_attention_networks_tpu_torch.train.solver import Solver, init_params
from vqa_attention_networks_tpu_torch.utils import checkpoint as ckpt
from vqa_attention_networks_tpu_torch.weights import (
    load_jax_params,
    to_jax_params,
)

# K1's output against its plain version, per glimpse row of D outputs:
# |diff| <= ATOL + RTOL_ROW * max |row|. The two share their rounding points
# and differ only in the order of their f32 sums, so ~0.7% of h1 lands one
# bf16 ulp apart. Through c2w such a flip moves the logits, and with them
# the (peaked) attention, which moves every output of the row by up to
# ~1.2% of the row's largest magnitude: an output near 0 from cancellation
# moves as much as a large one. RTOL_ROW is four bf16 ulps (2^-5).
ATOL, RTOL_ROW = 2e-3, 2.0 ** -5
# the kernel's scratch: z is held before its signed sqrt (z * |z| is
# img @ wq + bq, f32; near 0 the sqrt would turn an f32 summation-order
# difference e into sqrt(e)); h1 (bf16) to one bf16 ulp plus H1_ATOL: the
# two norms of z differ by an f32 ulp (another summation order), so a zb
# at a bf16 rounding boundary rounds apart, and each such flip moves h1 by
# |c1w| * ulp(zb), about 1.2e-4 at most at these inputs
POOLED_ATOL, POOLED_RTOL = 1e-4, 1e-4
H1_ATOL, H1_RTOL = 5e-4, 2.0 ** -7
MAX_FLIP_RATE = 1e-3
BATCH, N_BATCHES, N_IMAGES = 256, 8, 256
K1_SOURCE = "vqa_attention_networks_tpu_torch/csrc/stage1_coattention.cu"
K1_REPLACES = "vqa_attention_networks_tpu/ops/pallas_wq_fusion.py:205"
K2_SOURCE = "vqa_attention_networks_tpu_torch/csrc/train_fusion.cu"
# the Pallas kernel each K2 launch replaces (pallas_train_fusion.py)
K2_REPLACES = {
    "forward": "vqa_attention_networks_tpu/ops/pallas_train_fusion.py:67",
    "d_img": "vqa_attention_networks_tpu/ops/pallas_train_fusion.py:95",
    # _bwd_w_kernel's d_W/d_b: the g_prod build, then the product over it
    "g_prod": "vqa_attention_networks_tpu/ops/pallas_train_fusion.py:140",
    "d_w": "vqa_attention_networks_tpu/ops/pallas_train_fusion.py:140",
    "d_q": "vqa_attention_networks_tpu/ops/pallas_train_fusion.py:140",
}
K2_RATES, K2_NS, K2_K = (0.1, 0.0), (8, 64), 5
K2_FORCED_ZEROS = 100  # outputs of region 0 of sample 0 that pool to 0
# K2 against its plain version, per tensor: |diff| <= RTOL * max |plain|.
# The two share every rounding point and differ only in the order of
# their f32 sums: the forward's D=2048 contraction, d_W's and d_b's sums
# over N*L rows, d_q's over L rows and its recomputed z0. Those orders
# move a result by a few f32 ulps of the largest terms, far below 1e-4 of
# the tensor's largest value. The forward is held as pooled = out * |out|
# (before the signed sqrt, which turns an f32 difference e near 0 into
# sqrt(e)). d_img is bf16: a summation-order difference can move an
# element across a bf16 rounding boundary, one bf16 ulp (2^-8 relative),
# so its bound is 2^-7 of the largest |d_img|.
K2_RTOL = {"forward": 1e-4, "d_w": 1e-4, "d_b": 1e-4, "d_q": 1e-4,
           "d_img": 2.0 ** -7, "d_b_partials": 1e-4}
# d_W/d_b at N=64, rate 0.1: the most the two launches may take together
K2_DW_TARGET_MS = 3.0
TRAIN_STEPS, TRAIN_BATCH = 20, 64
# the kernel and plain training runs see the same weights, batches and
# masks and differ in the order of K2's f32 sums; bf16 roundings
# downstream and Adam's sign-like first steps amplify that, so their
# losses are held over the first steps only
TRAIN_AGREE_STEPS, TRAIN_LOSS_RTOL = 5, 1e-3
K4_SOURCE = "vqa_attention_networks_tpu_torch/csrc/coattention.cu"
K4_REPLACES = "vqa_attention_networks_tpu/ops/pallas_coattention.py:106"
K5_SOURCE = K2_SOURCE  # train_fusion_inference_forward
K5_REPLACES = "vqa_attention_networks_tpu/ops/pallas_fusion.py:85"
K7_SOURCE = "vqa_attention_networks_tpu_torch/csrc/glimpse_attention.cu"
K7_REPLACES = "vqa_attention_networks_tpu/ops/pallas_attention.py:67"
# K4 and K7 against their plain versions: the two share their rounding
# points and differ in the order of their f32 sums, which can move an
# element of C, Hv or Hq (K4), or of the hidden layer or the bf16 output
# (K7), across a bf16 rounding boundary (2^-8 relative) and with it a
# logit of a peaked softmax by ~2^-8 |whv| ~ 1.5e-3. 2^-7 of the largest
# value bounds what that does to K4's pooled v and q and to each glimpse
# row of K7. K4's maps are held element by element, at 2^-6 of each
# value (a logit shift d moves av[l] by at most ~2 d av[l]) plus 1e-6:
# held at 2^-7 of the largest value instead, a uniform map would pass on
# most elements of a peaked one. K5 is the K2 forward without the mask:
# pooled = out * |out| within K2's 1e-4.
K4_RTOL = K7_RTOL_ROW = 2.0 ** -7
K4_MAP_RTOL, K4_MAP_ATOL = 2.0 ** -6, 1e-6
K5_RTOL = K2_RTOL["forward"]
K4_SHAPE = dict(l=196, t=22, e=512)
# (N, P, C, A, D) of K7's two call shapes on mhb_coAtt's eval path
K7_SHAPES = {"question": (256, 22, 1024, 512, 1024),
             "co_attention": (256, 196, 1000, 512, 2048)}
K3_SOURCE = "vqa_attention_networks_tpu_torch/csrc/pooled_fusion.cu"
# the pallas_call each K3 launch replaces (pallas_pooled_fusion.py)
K3_REPLACES = {
    "forward": "vqa_attention_networks_tpu/ops/pallas_pooled_fusion.py:218",
    # g_pooled, formed once for d_img and d_W/d_b/d_q (both TPU kernels
    # form it in VMEM; it feeds the d_W product of every training step)
    "g_pooled": "vqa_attention_networks_tpu/ops/pallas_pooled_fusion.py:295",
    "d_img": "vqa_attention_networks_tpu/ops/pallas_pooled_fusion.py:257",
    "d_w": "vqa_attention_networks_tpu/ops/pallas_pooled_fusion.py:295",
}
K3_NS = (8, 64)
# K3 against its plain version, per tensor: |diff| <= K3_RTOL * max |plain|.
# The two share every rounding point (wq's f32 sum over j in order and its
# bf16 rounding, bf16 g_pooled, f32 products) and differ only in the order
# of their f32 sums: the D=2048 contraction of the forward, the O=1000 of
# d_img, the L=196 of d_wq, and d_W's, d_b's and d_q's sums over N and D.
# That moves a result by a few f32 ulps of its largest terms, far below 1e-4
# of the tensor's largest value; the forward is held as pooled = out * |out|.
# d_img stays f32 here (the autograd function casts it to img's dtype).
K3_RTOL = 1e-4
K3_DEAD_OUTPUTS = 3  # outputs with zero weights and bias in k3_check
# the training runs of each training fusion's path: mfb is trained with the
# quirk off (with it the stage-1 fusion is gradient-dead, and K2's or K3's
# backward never runs); MFB_TRAIN_STEPS steps each
MFB_TRAIN_STEPS = 10
MFB_TRAIN_RUNS = (("mfb", "prepool", "K2"), ("mfb", "pooled", "K3"),
                  ("mfb-multilayer", "pooled", "K3"))
# launch counters of the training fusions, by kernel
TRAIN_COUNTERS = {"K2": tf.launch_count, "K3": pf.launch_count}
# the families no kernel of the port serves or trains: MHB, visLstm,
# iBOWIMG and attentionNet served and trained, hieCoAtten's training
# forward (the composed chain, as in JAX)
FAMILIES_SERVED = ("mhb", "visLstm", "iBOWIMG", "attentionNet")
FAMILIES_TRAINED = ("hieCoAtten",) + FAMILIES_SERVED
FAMILY_TRAIN_STEPS = 10
# MHB served with every length set to T instead of the question's: at
# least this share of the answers must change (the length reaches it)
MHB_QLEN_CONTROL_SHARE = 0.01
# the card's and the CPU's f32 forwards (TF32 off) against an f64 run on
# the CPU, at batch AGREE_N: the card's error within the CPU tests' bound
# against JAX, 1e-5 of the largest |logit|, or AGREE_MARGIN times the
# CPU's own (``families_agree``)
AGREE_N, AGREE_RTOL, AGREE_MARGIN = 8, 1e-5, 4.0
K6_SOURCE = K3_SOURCE  # pooled_fusion_wq_grid: K3's forward, then the norm
K6_REPLACES = "vqa_attention_networks_tpu/ops/pallas_wq_fusion.py:88"
K8_SOURCE = "vqa_attention_networks_tpu_torch/csrc/lstm_scan.cu"
K8_REPLACES = "vqa_attention_networks_tpu/ops/pallas_lstm.py:74"
K6_NS = (8, 256, 1024)
K8_NS = (8, 256, 1024, 2048)
K6_TIME_NS = (BATCH, 1024)
# K6 against its plain version, per element of pooled = out * |out|: the
# two share their rounding points and differ in the order of their f32
# sums (the D=2048 contraction and the norm over 196,000 values), which
# can move an element of the bf16 output across a rounding boundary: one
# ulp, at most 2^-7 of its value, 2^-6 once squared. K6_ATOL of the
# largest value covers the f32 difference of a pooled value near 0. The
# backward is the composed chain's VJP on the same inputs, on the same
# card, in both runs: held at K6_GRAD_RTOL of each gradient's largest value.
K6_RTOL, K6_ATOL = 2.0 ** -6, 1e-4
K6_GRAD_N, K6_GRAD_RTOL = 64, 1e-6
# K8 against its plain version. Each step is held on its own: the plain
# recurrence fed the kernel's own h carry (``h_carry``) must give the
# kernel's output within one bf16 ulp plus K8_STEP_ATOL. The two share their
# rounding points (bf16 xp and h, f32 gates and c) and differ in the order
# of the recurrent product's f32 sums (H=1024) and in the last bits of
# expf/tanhf: a few f32 ulps of a gate, which can round an h the other way
# at a bf16 boundary. Run free, the two scans drift further apart, because
# such a flip feeds the later steps through W_hh (2^-8 at most over 22
# steps on an H100, on ~12% of the outputs), so the free-running
# outputs are held at K8_FREE_ATOL only. The check's inputs keep the gate
# pre-activations off the sigmoid's flat tails (|x| < K8_LIVE on at least
# K8_LIVE_SHARE of them), where a wrong gate would be invisible.
K8_STEP_ATOL, K8_FREE_ATOL = 1e-6, 2.0 ** -6
K8_LIVE, K8_LIVE_SHARE = 3.0, 0.5
K8_SHAPE = dict(t=22, e=300, h=1024)  # mhb_coAtt: T, emb_dim, hidden_dim
K8_ROUNDS = 5  # of the device times of lstm_seq and cuDNN's nn.LSTM
# the cli phase: tools/gen_corpus.py's questions (train, val), prepare's
# --num_answer (more than the corpus's answers), 2 epochs of batch
# TRAIN_BATCH with a checkpoint every CLI_EVERY steps, and the mid-epoch
# checkpoint a second workspace resumes from
CLI_CORPUS, CLI_NUM_ANSWER = (640, 192), 1000
CLI_EPOCHS, CLI_EVERY, CLI_RESUME_STEP = 2, 4, 12
# serving by id (phase 28) and over HTTP (29): BANK_IMAGES synthetic images
# at 196 x 2048 in an int8 store, each asked ~BANK_REUSE questions; the
# eviction regime's capacity; the miss counts the upload cost is fitted
# over, each the median of MISS_REPS; HTTP_CLIENTS concurrent clients, bulk
# calls of HTTP_BULK items, the batching window
BANK_IMAGES, BANK_REUSE, BANK_SMALL = 1024, 3, 512
MISS_COUNTS, MISS_REPS = tuple(2 ** i for i in range(9)), 5
HTTP_CLIENTS, HTTP_BULK, HTTP_WAIT_MS = 64, 16, 5.0
# the backbones (30): images on the card at f32 against the CPU, the bound
# of tests/test_torch_parity.py, the extractor's batch, the PNGs through the
# CLIs, and one f16 rounding of an f32 grid (the extracted store)
BACKBONE_N, BACKBONE_REL_ERR, EXTRACT_BATCH, N_PNG = 2, 1e-4, 32, 8
STORE_RTOL = 2.0 ** -10
# the HTTP load of phase 29, a stdlib script run in a process of its own:
# argv[1] names a JSON spec (url, items, the singles' count, the bulk calls'
# item positions, the clients); it writes <spec>.out with every result in
# the items' order, the seconds of the load, the client-side latency
# percentiles and the failed requests
HTTP_LOAD = r"""
import json, sys, time, urllib.error, urllib.request
from concurrent.futures import ThreadPoolExecutor

with open(sys.argv[1]) as f:
    spec = json.load(f)
url, items, clients = spec["url"], spec["items"], spec["clients"]
out, latency, errors = [None] * len(items), [], []


def post(payload):
    req = urllib.request.Request(url + "/predict", json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            body = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        errors.append([e.code, e.read().decode(errors="replace")[:200]])
        return None
    except OSError as e:  # a refused or reset connection
        errors.append([type(e).__name__, str(e)])
        return None
    latency.append(time.perf_counter() - t0)
    return body


def client(c):
    for pos in range(c, spec["n_single"], clients):
        out[pos] = post(items[pos])
    for chunk in spec["bulks"][c::clients]:
        body = post({"requests": [items[p] for p in chunk]})
        for pos, result in zip(chunk, body["results"] if body else []):
            out[pos] = result


t0 = time.perf_counter()
with ThreadPoolExecutor(clients) as pool:
    list(pool.map(client, range(clients)))
seconds = time.perf_counter() - t0
ms = sorted(x * 1e3 for x in latency)
pct = {f"p{q}_ms": ms[min(len(ms) - 1, int(q / 100 * len(ms)))]
       for q in (50, 99)} if ms else {}
if any(r is None for r in out):
    errors.append("missing results")
with open(sys.argv[1] + ".out", "w") as f:
    json.dump({"out": out, "seconds": seconds, "latency_ms": pct,
               "errors": errors}, f)
"""
# the card's rates for the bounds (H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def card() -> tuple:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs an "
              "NVIDIA card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(0), smi


def k1_inputs(n: int, seed: int, cfg: Config, device) -> tuple:
    """Random production-shape K1 inputs: bf16 img, f32 q and weights."""
    rng = np.random.default_rng(seed)
    d, f = cfg.img_feature_channel, cfg.fusion_dim
    o, c = cfg.mfb_out, 512

    def t(shape, scale):
        x = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(x).to(device)

    img = t((n, cfg.img_feature_dim, d), 0.5).to(torch.bfloat16)
    q = t((n, f), 0.5)
    # after the grid-flat L2 norm zb is ~2.5e-3 per element: c1w ~ N(0, 1)
    # with no bias and c2w ~ 3 N(0, 1) make the logits span several units
    # over the 196 regions, so the attention is peaked
    sw = wqf.prepare_stage1_weights(
        t((d, f), 0.02), t((f,), 0.05), t((o, c), 1.0), t((c,), 0.0),
        t((c, 2), 3.0), t((2,), 0.05), cfg.mfb_factor,
    )
    return img, q, sw


def within(got: torch.Tensor, want: torch.Tensor, d: int) -> torch.Tensor:
    """Elementwise: is ``got`` within the tolerance of ``want`` [N, G*D]?"""
    got = got.float().reshape(got.shape[0], -1, d)
    want = want.float().reshape(got.shape)
    scale = want.abs().amax(-1, keepdim=True)
    return (got - want).abs() <= ATOL + RTOL_ROW * scale


def uniform_rejected(img: torch.Tensor, out: torch.Tensor) -> float:
    """Control: the share of a uniform-attention output (the mean of img
    over L) that the check rejects against ``out``. It fails under 0.5: with
    a near-uniform attention the check cannot see the stages before it."""
    n, _, d = img.shape
    g = out.numel() // (n * d)
    uniform = img.float().mean(1, keepdim=True).expand(n, g, d)
    share = 1.0 - float(within(uniform, out, d).float().mean())
    if share < 0.5:
        raise AssertionError(
            f"the check rejects only {share:.3f} of a uniform-attention "
            "output: it would not see a fault upstream of the softmax")
    return share


def flips(logits: torch.Tensor, answers: torch.Tensor) -> int:
    """Answers that ``logits`` rank more than one bf16 ulp of the top logit
    below the top. The model's logits are bf16; two answers within one ulp
    tie at that resolution, and another f32 summation order upstream may
    break the tie either way."""
    top = logits.max(-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(1e-30))) - 7)
    return int((logits.gather(-1, answers[:, None])[:, 0] < top - ulp).sum())


def scratch_diff(got, want, atol, rtol) -> tuple:
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool(torch.all(diff <= atol + rtol * want.abs()))
    return ok, float(diff.max()), float((diff == 0).float().mean())


def time_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def k2_inputs(n: int, seed: int, cfg: Config, device) -> tuple:
    """Random production-width K2 inputs: bf16 img and q (q_proj is bf16
    in the bf16 model), f32 W and b, and an f32 cotangent g. Region 0 of
    sample 0 is all zeros and the bias of the first K2_FORCED_ZEROS outputs
    is 0 (the model's initial bias), so those outputs pool to exactly 0
    with the mask on: where pooled is 0 because all k factors were dropped
    the mask zeroes g_prod anyway, and only these show g_pooled's zero
    rule (in d_b and d_img)."""
    rng = np.random.default_rng(seed)
    d, f = cfg.img_feature_channel, cfg.fusion_dim

    def t(shape, scale):
        x = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(x).to(device)

    img = t((n, cfg.img_feature_dim, d), 0.5)
    img[0, 0] = 0.0
    b = t((f,), 0.05)
    b[:K2_FORCED_ZEROS * cfg.mfb_factor] = 0.0
    q = t((n, f), 0.5).to(torch.bfloat16)
    g = t((n, cfg.img_feature_dim, cfg.mfb_out), 1.0)
    return img.to(torch.bfloat16), t((d, f), 0.02), b, q, g


def k2_view(name: str, x: torch.Tensor) -> torch.Tensor:
    """What the check compares: f32, and the forward as pooled =
    out * |out|."""
    x = x.float()
    return x * x.abs() if name == "forward" else x


def k2_within(name: str, got: torch.Tensor,
              want: torch.Tensor) -> torch.Tensor:
    """Elementwise: is ``got`` within K2_RTOL[name] of ``want``'s largest
    magnitude?"""
    got, want = k2_view(name, got), k2_view(name, want)
    return (got - want).abs() <= K2_RTOL[name] * want.abs().max()


def k2_launches(img, w_bf16, b, q, g, seed, rate) -> dict:
    """Every K2 launch once; the backward ones on the kernel's own forward
    output, d_img and d_W/d_b over one g_prod build, as the backward runs
    them."""
    got = {"forward": tf.forward_cuda(img, w_bf16, b, q, seed, K2_K, rate)}
    args = (g, got["forward"], img, w_bf16, b, q, seed, K2_K, rate)
    got["g_prod"], got["d_b_partials"] = tf.g_prod_cuda(*args)
    got["d_img"] = tf.d_img_from_operand_cuda(got["g_prod"], w_bf16,
                                              *img.shape[:2])
    got["d_w"], got["d_b"] = tf.d_w_from_operand_cuda(
        img, got["g_prod"], got["d_b_partials"])
    got["d_q"] = tf.d_q_cuda(*args)
    return got


def k2_plain(img, w_bf16, b, q, g, out, keep) -> dict:
    """The plain version of every K2 launch; the backward ones on ``out``."""
    want = {"forward": tf.forward_reference(img, w_bf16, b, q, K2_K, keep),
            "d_img": tf.d_img_reference(g, out, w_bf16, q, K2_K, keep)}
    want["g_prod"], want["d_b_partials"] = tf.g_prod_reference(
        g, out, q, K2_K, keep)
    want["d_w"], want["d_b"] = tf.d_w_reference(g, out, img, q, K2_K, keep)
    want["d_q"] = tf.d_q_reference(g, out, img, w_bf16, b, K2_K, keep)
    return want


def k2_check(n: int, rate: float, cfg: Config, device) -> dict:
    """K2 at production widths against its plain version, with controls;
    raises on a failure. Returns max |diff| per launch."""
    img, w, b, q, g = k2_inputs(n, 100 + n, cfg, device)
    l, f = img.shape[1], w.shape[1]
    seed = 1234 + n
    w_bf16, bf, qf = tf.operands(w, b, q)
    mask = tf.dropout_mask(seed, n, l, f, rate, device) if rate > 0 else None
    keep = tf.keep_scale(mask, rate)
    got = k2_launches(img, w_bf16, bf, qf, g, seed, rate)
    again = k2_launches(img, w_bf16, bf, qf, g, seed, rate)
    out = got["forward"]
    want = k2_plain(img, w_bf16, bf, qf, g, out, keep)
    torch.cuda.synchronize()
    fields, max_abs, failed = {}, {}, []
    # d_W's operand, bit for bit (as int16: a -0 is not a +0), and its rerun
    g_prod, g_prod_again = got.pop("g_prod"), again.pop("g_prod")
    g_prod_plain = want.pop("g_prod")
    max_abs["g_prod"] = float((g_prod.float() - g_prod_plain.float()).abs()
                              .max())
    fields["g_prod"] = {
        "bit_equal": bool(torch.equal(g_prod.view(torch.int16),
                                      g_prod_plain.view(torch.int16))),
        "max_abs_diff": max_abs["g_prod"],
        "rerun_bit_equal": bool(torch.equal(g_prod, g_prod_again)),
        "bytes": g_prod.numel() * g_prod.element_size()}
    if not all(fields["g_prod"][key] for key in ("bit_equal",
                                                  "rerun_bit_equal")):
        failed.append("g_prod")
    del g_prod, g_prod_again, g_prod_plain
    for name in got:
        ok = bool(k2_within(name, got[name], want[name]).all())
        max_abs[name] = float((got[name].float() - want[name].float())
                              .abs().max())
        diff = k2_view(name, got[name]) - k2_view(name, want[name])
        fields[name] = {
            "max_abs_diff": max_abs[name],
            "max_rel_diff_checked": float(diff.abs().max()) / float(
                k2_view(name, want[name]).abs().max()),
            "within_tolerance": ok,
            "rerun_bit_equal": bool(torch.equal(got[name], again[name])),
            "finite": bool(torch.isfinite(got[name].float()).all()),
        }
        if not all(fields[name][key] for key in
                   ("within_tolerance", "rerun_bit_equal", "finite")):
            failed.append(name)
    # pooled is exactly 0 where the mask dropped all k factors of an
    # output (rate^k of the N*L*O outputs) and at the forced zeros, in
    # both; elsewhere an f32 sum may cancel to exactly 0 on one side only
    # (seen once: true pooled -3.9e-7 from terms of +-0.1)
    zero = torch.zeros_like(out, dtype=torch.bool)
    if mask is not None:
        zero |= ~mask.reshape(*out.shape, K2_K).any(-1)
    zero[0, 0, :K2_FORCED_ZEROS] = True
    dropped = int(zero.sum())
    forced = min(K2_FORCED_ZEROS, out.shape[-1])
    expect = rate ** K2_K * (out.numel() - forced) + forced
    in_both = bool((out[zero] == 0).all() and (want["forward"][zero] == 0)
                   .all())
    fields["zeros"] = {"kernel": int((out == 0).sum()),
                       "plain": int((want["forward"] == 0).sum()),
                       "dropped_or_forced": dropped, "expected": expect,
                       "zero_there_in_both": in_both}
    if not in_both or abs(dropped - expect) > 5 * expect ** 0.5 + 1:
        failed.append("zeros")
    # controls: the check sees a backward without the zero rule (out == 0
    # taken as 1e-20, the clamp alone), and at rate > 0 a mask that does
    # not replay and a backward without the mask
    clamped = torch.where(out == 0, torch.full_like(out, 1e-20), out)
    no_rule_w, no_rule_b = tf.d_w_reference(g, clamped, img, qf, K2_K, keep)
    no_rule_img = tf.d_img_reference(g, clamped, w_bf16, qf, K2_K, keep)
    controls = {
        "d_w_d_b_without_zero_rule_rejected": not bool(
            k2_within("d_w", no_rule_w, want["d_w"]).all()
            and k2_within("d_b", no_rule_b, want["d_b"]).all()),
        "d_img_without_zero_rule_rejected": not bool(
            k2_within("d_img", no_rule_img, want["d_img"]).all()),
    }
    if rate > 0:
        other = tf.forward_reference(img, w_bf16, bf, qf, K2_K, tf.keep_scale(
            tf.dropout_mask(seed + 1, n, l, f, rate, device), rate))
        controls["other_seed_rejected_share"] = 1.0 - float(
            k2_within("forward", other, want["forward"]).float().mean())
        no_mask = tf.d_w_reference(g, out, img, qf, K2_K, None)[0]
        controls["d_w_without_mask_rejected"] = not bool(
            k2_within("d_w", no_mask, want["d_w"]).all())
    fields["controls"] = controls
    if controls.get("other_seed_rejected_share", 1.0) < 0.5 or not all(
            v for k, v in controls.items() if k.endswith("_rejected")):
        failed.append("controls")
    say("k2_check", n=n, rate=rate, **fields)
    if failed:
        raise AssertionError(f"K2 fails {failed} at N={n}, rate={rate}")
    return max_abs


def device_ms(fn, iters: int = 5) -> dict:
    """The card's kernel time per call of ``fn`` from one torch.profiler
    trace of ``iters`` calls after a warm-up, without the host's time
    between launches, by two formulas: ``ms``, all the device time the
    trace recorded over ``iters``, and ``ms_per_launch``, each kernel's
    mean time per recorded launch times its launches per call
    (round(count / iters)), which a launch the trace did not record does
    not lower. ``unrecorded`` names the kernels whose recorded launches
    are not a multiple of ``iters``: where it is empty the two agree. The
    times are None where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    total_us = sum(e.self_device_time_total for e in events)
    scaled_us = sum(e.self_device_time_total / e.count
                    * max(1, round(e.count / iters)) for e in events)
    return {"ms": total_us / iters / 1e3 if total_us > 0 else None,
            "ms_per_launch": scaled_us / 1e3 if scaled_us > 0 else None,
            "unrecorded": [e.key[:60] for e in events if e.count % iters]}


def device_ms_by_kernel(fn, iters: int = 5) -> dict:
    """Each kernel's device time per call of ``fn`` (ms) from one
    torch.profiler trace of ``iters`` calls after a warm-up, by kernel
    name (its first 60 characters; kernels whose names agree that far are
    summed): the time of each launch of a multi-launch kernel, apart.
    Late in a long run the profiler can drop records, so each kernel's
    time is its mean per recorded launch times its launches per call
    (round(count / iters)), as ``device_ms``'s ``ms_per_launch``; it can
    also drop every record of a kernel, which then is missing. A call's
    whole device time comes from ``launch_ms``, which needs no profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if getattr(e, "self_device_time_total", 0) > 0:
            key = e.key[:60]
            times[key] = times.get(key, 0.0) + (
                e.self_device_time_total / e.count
                * max(1, round(e.count / iters)) / 1e3)
    return times


def launch_ms(fn, iters: int = 10) -> float:
    """The device ms of one call of ``fn`` (all its launches): CUDA events
    around each call, both queued behind a spin on the card so that the
    host's enqueue falls outside the interval, averaged over ``iters``
    calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / iters


def interleaved_ms(kernel, plain, iters: int = 3) -> tuple:
    """kernel/plain/plain/kernel after one warm-up call of each -> (kernel
    ms, plain ms, all four runs)."""
    kernel(), plain()
    plain_a = time_ms(plain, iters)
    kernel_a = time_ms(kernel, iters)
    kernel_b = time_ms(kernel, iters)
    plain_b = time_ms(plain, iters)
    return ((kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2,
            [kernel_a, kernel_b], [plain_a, plain_b])


def k2_time(cfg: Config, device, smi: str, rate: float = 0.1) -> tuple:
    """Each K2 launch against its plain version at N=64 (the plain
    backward is handed the mask, as the kernel replays it), d_img and
    d_W/d_b each as the product over the g_prod operand and with the build
    (``d_img_total``, ``d_w_total``), d_W/d_b's two launches' shares, then
    forward, backward (d_W + d_b + d_q) and both through the autograd
    functions, where the plain forward draws its mask. Beside d_img, for
    information, ``torch.matmul(g_prod, bf16(W)^T)`` with bf16 out, the
    bare product, which the port never calls. Returns (times, bounds,
    library ms) by launch; a bound counts the launch's product (2 N L D F
    operations in bf16; the g_prod build's 4 f32 operations an element) and
    its operands and results, not the mask's integer work."""
    n, seed = TRAIN_BATCH, 7
    img, w, b, q, g = k2_inputs(n, 3, cfg, device)
    w_bf16, bf, qf = tf.operands(w, b, q)
    keep = tf.keep_scale(tf.dropout_mask(seed, n, img.shape[1], w.shape[1],
                                         rate, device), rate)
    out = tf.forward_cuda(img, w_bf16, bf, qf, seed, K2_K, rate)
    args = (g, out, img, w_bf16, bf, qf, seed, K2_K, rate)
    g_prod, parts = tf.g_prod_cuda(*args)
    pairs = {
        "forward": (lambda: tf.forward_cuda(img, w_bf16, bf, qf, seed, K2_K,
                                            rate),
                    lambda: tf.forward_reference(img, w_bf16, bf, qf, K2_K,
                                                 keep)),
        "d_img": (lambda: tf.d_img_from_operand_cuda(g_prod, w_bf16, n,
                                                     img.shape[1]),
                  lambda: tf.d_img_from_operand_reference(g_prod, w_bf16, n,
                                                          img.shape[1])),
        "d_img_total": (lambda: tf.d_img_cuda(*args),
                        lambda: tf.d_img_reference(g, out, w_bf16, qf, K2_K,
                                                   keep)),
        "g_prod": (lambda: tf.g_prod_cuda(*args),
                   lambda: tf.g_prod_reference(g, out, qf, K2_K, keep)),
        "d_w": (lambda: tf.d_w_from_operand_cuda(img, g_prod, parts),
                lambda: (tf.d_w_from_operand_reference(img, g_prod),
                         parts.sum(0))),
        "d_w_total": (lambda: tf.d_w_cuda(*args),
                      lambda: tf.d_w_reference(g, out, img, qf, K2_K, keep)),
        "d_q": (lambda: tf.d_q_cuda(*args),
                lambda: tf.d_q_reference(g, out, img, w_bf16, bf, K2_K,
                                         keep)),
    }
    l, d = img.shape[1:]
    f = w.shape[1]
    ops = {"bf16": 2 * n * l * d * f}
    bounds = {
        "forward": bound(nbytes(img, w_bf16, bf, qf, out), ops),
        "d_img": bound(nbytes(g_prod, w_bf16, img), ops),  # d_img ~ img
        "d_img_total": bound(nbytes(g, out, w_bf16, qf, img), ops),
        "g_prod": bound(nbytes(g, out, qf, g_prod, parts),
                        {"f32": 4 * n * l * f}),
        "d_w": bound(nbytes(img, g_prod, parts) + 4 * (d * f + f), ops),
        "d_w_total": bound(nbytes(g, out, img, qf) + 4 * (d * f + f), ops),
        "d_q": bound(nbytes(g, out, img, w_bf16, bf) + 4 * n * f, ops),
    }
    times = {}
    for name, (kernel, plain) in pairs.items():
        times[name] = interleaved_ms(kernel, plain)
        say("k2_time", launch=name, n=n, rate=rate, kernel_ms=times[name][0],
            plain_ms=times[name][1], kernel_runs_ms=times[name][2],
            plain_runs_ms=times[name][3], bound_ms=bounds[name][0],
            bound_by=bounds[name][1], card=smi)
    # d_W/d_b: the two launches timed one by one, and their sum
    parts_ms = {key: times[key][0] for key in ("g_prod", "d_w")}
    say("k2_time", launch="d_w/d_b", n=n, rate=rate,
        kernel_ms_sum_of_launches=sum(parts_ms.values()),
        kernel_ms_both_in_one_call=times["d_w_total"][0],
        share_by_launch={key: v / sum(parts_ms.values())
                         for key, v in parts_ms.items()},
        plain_ms=times["d_w_total"][1], bound_ms=bounds["d_w_total"][0],
        target_ms=K2_DW_TARGET_MS, card=smi)
    w_t = w_bf16.t()
    torch.matmul(g_prod, w_t)  # warm-up
    library = {"d_img": time_ms(lambda: torch.matmul(g_prod, w_t), 10)}
    say("k2_time", launch="d_img", library="torch.matmul(g_prod, bf16(W)^T)",
        library_ms=library["d_img"], kernel_ms=times["d_img"][0], card=smi)
    del g_prod, parts, w_t

    wr, br, qr = (x.clone().requires_grad_(True) for x in (w, b, q))
    fns = {"kernel": tf.TrainGridFuse.apply,
           "plain": tf.train_grid_fuse_reference}
    outs = {k: fn(img, wr, br, qr, seed, K2_K, rate) for k, fn in fns.items()}

    def fwd(k):
        return lambda: fns[k](img, wr, br, qr, seed, K2_K, rate)

    def bwd(k):
        return lambda: torch.autograd.grad(outs[k], (wr, br, qr), g,
                                           retain_graph=True)

    def both(k):
        return lambda: torch.autograd.grad(fwd(k)(), (wr, br, qr), g)

    for name, make in (("forward", fwd), ("backward", bwd),
                       ("forward+backward", both)):
        k_ms, p_ms, k_runs, p_runs = interleaved_ms(make("kernel"),
                                                    make("plain"))
        say("k2_time", autograd=name, n=n, rate=rate, kernel_ms=k_ms,
            plain_ms=p_ms, kernel_runs_ms=k_runs, plain_runs_ms=p_runs,
            card=smi)
    return times, bounds, library


def train_profile(cfg: Config, params, store, smi: str) -> None:
    """One pre-pool training step of full-width bf16 mhb_coAtt at batch
    TRAIN_BATCH, after two warm-up steps, under torch.profiler: the
    device's busy share of the step (the time of its kernels and copies
    over the step's wall time, synchronised at both ends; the batches are
    gathered on the host beforehand) and the five device kernels that took
    longest, by name."""
    from torch.profiler import ProfilerActivity, profile

    cfg = cfg.replace(num_epoch=1, batch_size=TRAIN_BATCH)
    qa, _ = train_data(cfg, 3)
    solver = Solver(cfg, qa, store, params=params)
    batches = list(solver.batches["train"].epoch(0))
    for batch in batches[:2]:
        solver._train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, _ = solver._train_step(batches[2])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    say("train_profile", model=cfg.model_name, dropout_site=cfg.dropout_site,
        batch=TRAIN_BATCH, loss=float(loss), step_wall_ms=wall_ms,
        device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
        top_kernels=[{"name": e.key[:120], "calls": e.count,
                      "device_ms": e.self_device_time_total / 1e3}
                     for e in top], card=smi)
    if not np.isfinite(float(loss)) or busy_ms <= 0:
        raise AssertionError("train_profile: the profiled step is not "
                             "finite or recorded no device time")
    del solver


def k3_launches(img, w_bf16, b, q, g) -> dict:
    """Every K3 launch once; the backward ones on the kernel's own forward
    output, d_img and d_W/d_b/d_q over one g_pooled build, as the backward
    runs them."""
    got = {"forward": pf.forward_cuda(img, w_bf16, b, q, K2_K)}
    args = (g, got["forward"], img, w_bf16, b, q, K2_K)
    got["g_pooled"], got["d_bq"] = pf.g_pooled_cuda(*args)
    got["d_img"] = pf.d_img_from_gp_cuda(got["g_pooled"], img, w_bf16, b, q,
                                         K2_K)
    got["d_w"], got["d_b"], got["d_q"] = pf.d_w_from_gp_cuda(
        got["g_pooled"], got["d_bq"], img, w_bf16, b, q, K2_K)
    return got


def k3_plain(img, w_bf16, b, q, g, out) -> dict:
    """The plain version of every K3 launch; the backward ones on ``out``."""
    want = {"forward": pf.forward_reference(img, w_bf16, b, q, K2_K),
            "d_img": pf.d_img_reference(g, out, w_bf16, q, K2_K)}
    want["g_pooled"], want["d_bq"] = pf.g_pooled_reference(g, out)
    want["d_w"], want["d_b"], want["d_q"] = pf.d_w_reference(
        g, out, img, w_bf16, b, q, K2_K)
    return want


def k3_within(name: str, got: torch.Tensor,
              want: torch.Tensor) -> torch.Tensor:
    """Elementwise: is ``got`` within K3_RTOL of ``want``'s largest
    magnitude (the forward as pooled = out * |out|)?"""
    got, want = k2_view(name, got), k2_view(name, want)
    return (got - want).abs() <= K3_RTOL * want.abs().max()


def k3_check(n: int, cfg: Config, device) -> dict:
    """K3 at production widths against its plain version, with controls;
    raises on a failure. Returns max |diff| per launch. The inputs are
    K2's (region 0 of sample 0 is all zeros and the bias of the first
    K2_FORCED_ZEROS outputs is 0, so those outputs pool to exactly 0 in
    that row), and the last K3_DEAD_OUTPUTS outputs, at the ragged edge of
    every O tile, have zero weights and bias, so they pool to exactly 0 in
    every row: the places where g_pooled's zero rule acts."""
    img, w, b, q, g = k2_inputs(n, 300 + n, cfg, device)
    dead = slice(w.shape[1] - K3_DEAD_OUTPUTS * K2_K, None)
    w[:, dead] = 0.0
    b[dead] = 0.0
    w_bf16, bf, qb = pf.operands(w, b, q)
    got = k3_launches(img, w_bf16, bf, qb, g)
    again = k3_launches(img, w_bf16, bf, qb, g)
    out = got["forward"]
    want = k3_plain(img, w_bf16, bf, qb, g, out)
    torch.cuda.synchronize()
    fields, max_abs, failed = {}, {}, []
    # the bf16 operand, bit for bit (as int16; its zeros are +0 in both
    # but where g is -0 or the plain version's g * 0 gives -0: compared as
    # values there), and its rerun
    gp, gp_again = got.pop("g_pooled"), again.pop("g_pooled")
    gp_plain = want.pop("g_pooled")
    fields["g_pooled"] = {
        "equal": bool(torch.equal(gp, gp_plain)),
        "bit_equal_share": float((gp.view(torch.int16) == gp_plain.view(
            torch.int16)).float().mean()),
        "rerun_bit_equal": bool(torch.equal(gp.view(torch.int16),
                                            gp_again.view(torch.int16))),
        "bytes": gp.numel() * gp.element_size()}
    max_abs["g_pooled"] = float((gp.float() - gp_plain.float()).abs().max())
    if not (fields["g_pooled"]["equal"]
            and fields["g_pooled"]["rerun_bit_equal"]):
        failed.append("g_pooled")
    del gp, gp_again, gp_plain
    for name in got:
        diff = k2_view(name, got[name]) - k2_view(name, want[name])
        max_abs[name] = float((got[name] - want[name]).abs().max())
        fields[name] = {
            "max_abs_diff": max_abs[name],
            "max_rel_diff_checked": float(diff.abs().max()) / float(
                k2_view(name, want[name]).abs().max()),
            "within_tolerance": bool(k3_within(name, got[name],
                                               want[name]).all()),
            "rerun_bit_equal": bool(torch.equal(got[name], again[name])),
            "finite": bool(torch.isfinite(got[name]).all()),
        }
        if not all(fields[name][key] for key in
                   ("within_tolerance", "rerun_bit_equal", "finite")):
            failed.append(name)
    forced = torch.zeros_like(out, dtype=torch.bool)
    forced[0, 0, :K2_FORCED_ZEROS] = True
    forced[..., -K3_DEAD_OUTPUTS:] = True
    fields["zeros"] = {
        "kernel": int((out == 0).sum()),
        "plain": int((want["forward"] == 0).sum()),
        "forced": int(forced.sum()),
        "forced_zero_in_both": bool((out[forced] == 0).all() and (
            want["forward"][forced] == 0).all())}
    if not fields["zeros"]["forced_zero_in_both"]:
        failed.append("zeros")
    # controls: q permuted across samples in the forward, another sample's
    # q in d_W, and g_pooled without its zero rule (out == 0 taken as
    # 1e-20, the clamp alone): d_W and d_b see it at the dead outputs
    # (img is not 0 there), d_img at the zero region (wq is not 0 there)
    perm = pf.forward_reference(img, w_bf16, bf, qb.roll(1, 0), K2_K)
    other_q = pf.d_w_reference(g, out, img, w_bf16, bf, qb.roll(1, 0),
                               K2_K)[0]
    clamped = torch.where(out == 0, torch.full_like(out, 1e-20), out)
    no_rule_w, no_rule_b, _ = pf.d_w_reference(g, clamped, img, w_bf16, bf,
                                               qb, K2_K)
    no_rule_img = pf.d_img_reference(g, clamped, w_bf16, qb, K2_K)
    controls = {
        "permuted_q_rejected_share": 1.0 - float(
            k3_within("forward", perm, want["forward"]).float().mean()),
        "d_w_with_another_samples_q_rejected": not bool(
            k3_within("d_w", other_q, want["d_w"]).all()),
        "d_w_without_zero_rule_rejected": not bool(
            k3_within("d_w", no_rule_w, want["d_w"]).all()),
        "d_b_without_zero_rule_rejected": not bool(
            k3_within("d_b", no_rule_b, want["d_b"]).all()),
        "d_img_without_zero_rule_rejected": not bool(
            k3_within("d_img", no_rule_img, want["d_img"]).all()),
    }
    del perm, other_q, no_rule_w, no_rule_b, no_rule_img
    fields["controls"] = controls
    if controls["permuted_q_rejected_share"] < 0.5 or not all(
            v for key, v in controls.items() if key.endswith("_rejected")):
        failed.append("controls")
    say("k3_check", n=n, **fields)
    if failed:
        raise AssertionError(f"K3 fails {failed} at N={n}")
    return max_abs


def k3_time(cfg: Config, device, smi: str) -> tuple:
    """Each K3 launch against its plain version at N=64 (CUDA events after
    warm-up, kernel/plain/plain/kernel): the forward, the g_pooled build,
    d_img as the product over its operand and with the build
    (``d_img_total``), and d_W/d_b/d_q with the build (the four launches it
    took before the build was its own entry) with each launch's device
    time. Beside d_img, for information, ``torch.bmm`` of bf16 g_pooled
    [N, L, O] against a materialised bf16 wq^T [N, O, D] with bf16 out,
    the bare product without the wq build, which the port never calls.
    Returns (times, bounds, library ms) by launch: a bound counts the
    launch's product (2 N L D O operations in bf16), its f32 elementwise
    work (the wq build, 2 N k D O, in the forward and d_img; d_W's and
    d_q's contractions with q and W, 4 N D F, in d_W; the zero rule's 3
    operations an element in g_pooled) and its operands and results moved
    once."""
    n = TRAIN_BATCH
    img, w, b, q, g = k2_inputs(n, 3, cfg, device)
    w_bf16, bf, qb = pf.operands(w, b, q)
    out = pf.forward_cuda(img, w_bf16, bf, qb, K2_K)
    args = (g, out, img, w_bf16, bf, qb, K2_K)
    gp, d_bq = pf.g_pooled_cuda(*args)
    pairs = {
        "forward": (lambda: pf.forward_cuda(img, w_bf16, bf, qb, K2_K),
                    lambda: pf.forward_reference(img, w_bf16, bf, qb, K2_K)),
        "g_pooled": (lambda: pf.g_pooled_cuda(*args),
                     lambda: pf.g_pooled_reference(g, out)),
        "d_img": (lambda: pf.d_img_from_gp_cuda(gp, img, w_bf16, bf, qb,
                                                K2_K),
                  lambda: pf.d_img_from_gp_reference(gp, w_bf16, qb, K2_K)),
        "d_img_total": (lambda: pf.d_img_cuda(*args),
                        lambda: pf.d_img_reference(g, out, w_bf16, qb,
                                                   K2_K)),
        "d_w": (lambda: pf.d_w_cuda(*args),
                lambda: pf.d_w_reference(g, out, img, w_bf16, bf, qb, K2_K)),
    }
    l, d = img.shape[1:]
    f = w.shape[1]
    prod = {"bf16": 2 * n * l * d * (f // K2_K)}
    build = dict(prod, f32=2 * n * d * f)  # 2 N k D O = 2 N D F
    bounds = {
        "forward": bound(nbytes(img, w_bf16, bf, qb, out), build),
        "g_pooled": bound(nbytes(g, out, gp, d_bq), {"f32": 3 * g.numel()}),
        "d_img": bound(nbytes(gp, w_bf16, qb) + 4 * img.numel(), build),
        "d_img_total": bound(nbytes(g, out, w_bf16, qb) + 4 * img.numel(),
                             build),
        "d_w": bound(nbytes(g, out, img, w_bf16, bf, qb)
                     + 4 * (d * f + f + n * f), dict(prod, f32=4 * n * d * f)),
    }
    times = {}
    for name, (kernel, plain) in pairs.items():
        times[name] = interleaved_ms(kernel, plain)
        # d_W/d_b/d_q is four launches: each one's device time apart
        by_launch = device_ms_by_kernel(kernel) if name == "d_w" else None
        say("k3_time", launch=name, n=n, kernel_ms=times[name][0],
            plain_ms=times[name][1], kernel_runs_ms=times[name][2],
            plain_runs_ms=times[name][3], bound_ms=bounds[name][0],
            bound_by=bounds[name][1], device_ms_by_launch=by_launch,
            card=smi)
    gp_o = gp[..., :f // K2_K].contiguous()
    wq_t = pf.contracted_weights(w_bf16, qb, K2_K).to(
        torch.bfloat16).transpose(1, 2).contiguous()
    torch.bmm(gp_o, wq_t)  # warm-up
    library = {"d_img": time_ms(lambda: torch.bmm(gp_o, wq_t), 10)}
    say("k3_time", launch="d_img",
        library="torch.bmm(bf16 g_pooled, bf16 wq^T), not the kernel's "
                "function (no wq build, bf16 out)",
        library_ms=library["d_img"], kernel_ms=times["d_img"][0], card=smi)
    return times, bounds, library


def nbytes(*tensors) -> int:
    """Bytes of the distinct tensors given (a tensor passed twice, as the
    question glimpse passes h_seq as x and v, is read once)."""
    seen = {t.data_ptr(): t for t in tensors}
    return sum(t.numel() * t.element_size() for t in seen.values())


def bound(moved: int, ops: dict) -> tuple:
    """(ms, "bytes" or "operations"): the least time this card could take
    for work that moves ``moved`` bytes (each input read once, each output
    written once) and does ``ops`` operations by type, each type at its
    peak rate."""
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()) * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


@contextlib.contextmanager
def switches(**env):
    """Set dispatch switches for one phase and restore them after."""
    old = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for key, value in old.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def traffic(cfg: Config) -> tuple:
    """Presampled requests (image ids, questions): each image backs several
    questions, as in VQA."""
    rng = np.random.default_rng(0)
    n_req = BATCH * N_BATCHES
    image_ids = rng.integers(0, N_IMAGES, n_req)
    lengths = rng.integers(4, cfg.max_question_length + 1, n_req)
    ques = rng.integers(1, cfg.q_vocab_size,
                        (n_req, cfg.max_question_length)).astype(np.int32)
    ques[np.arange(cfg.max_question_length)[None, :] >= lengths[:, None]] = 0
    return image_ids, ques


def serve_phase(phase: str, cfg: Config, params, store, counters: dict,
                dev, smi: str, control=None, info=None) -> dict:
    """Serve BATCH * N_BATCHES requests of full-width ``cfg`` through
    ``InferenceEngine.predict_stream`` (after a warm-up pass). Each module
    of ``counters`` (name -> module with a ``launch_count``) is set to 0
    just before the measured pass and read just after. Then the served
    answers against the same forward with every kernel's plain version
    (``reference_kernels=True``): at most MAX_FLIP_RATE flips; with
    ``control`` (a parameter tree that blinds the kernel's stage), the
    control's answers must count as flips at 10x that rate; ``info`` maps
    a label to a Config whose forward is compared for information only.
    Raises on a failed gate."""
    engine = InferenceEngine(cfg, params, batch_size=BATCH, topk=5)
    image_ids, ques = traffic(cfg)
    n_req = len(ques)

    def batches():
        for s in range(0, n_req, BATCH):
            feats = store.gather(image_ids[s:s + BATCH], np.float16)
            yield feats, ques[s:s + BATCH], None

    list(engine.predict_stream(batches()))  # warm-up pass
    torch.cuda.synchronize()
    for module in counters.values():
        module.launch_count = 0
    t0 = time.perf_counter()
    preds = [p for batch in engine.predict_stream(batches()) for p in batch]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: module.launch_count for name, module in counters.items()}
    answers = np.array([p.answer_id for p in preds])
    probs = np.stack([p.top_probs for p in preds])
    if len(preds) != n_req or not np.isfinite(probs).all() or (
            probs.sum(-1) > 1.0 + 1e-3).any():
        raise AssertionError(f"{phase}: served predictions are malformed")

    def load(c: Config, tree):
        return load_jax_params(get_model(c.model_name)(c).to(dev), tree).eval()

    others = {label: load(c, params) for label, c in (info or {}).items()}
    blind = load(engine.cfg, control) if control is not None else None
    n_flips = n_argmax = n_blind = 0
    info_flips = dict.fromkeys(others, 0)
    for s, (feats, qs, _) in zip(range(0, n_req, BATCH), batches()):
        img = torch.from_numpy(feats).to(dev)
        qt = torch.from_numpy(qs).to(dev)
        served = torch.from_numpy(answers[s:s + BATCH]).to(dev)
        with torch.inference_mode():
            plain = engine.model(img, qt, reference_kernels=True)
            n_flips += flips(plain, served)
            n_argmax += int((plain.argmax(-1) != served).sum())
            for label, model in others.items():
                info_flips[label] += flips(model(img, qt), served)
            if blind is not None:
                n_blind += flips(plain, blind(img, qt, reference_kernels=True)
                                 .argmax(-1))
    del others, blind
    # the device's share of the run: one batch's forward, already on the
    # device, timed with CUDA events, against the wall time per batch
    with torch.inference_mode():
        forward_ms = time_ms(lambda: engine.model(img, qt), 3)
    fields = dict(model=cfg.model_name, requests=n_req, batch=BATCH,
                  launches=launches, flips_vs_plain=n_flips,
                  flip_rate=n_flips / n_req,
                  argmax_differs_info_only=n_argmax,
                  distinct_answers=int(len(np.unique(answers))),
                  qa_pairs_per_s=n_req / seconds, seconds=seconds,
                  wall_ms_per_batch=seconds * 1e3 / N_BATCHES,
                  device_forward_ms_per_batch=forward_ms, card=smi)
    if control is not None:
        fields["control_flip_rate"] = n_blind / n_req
    for label, n in info_flips.items():
        fields[f"flip_rate_vs_{label}_info_only"] = n / n_req
    say(phase, **fields)
    if any(n < N_BATCHES for n in launches.values()):
        raise AssertionError(f"{phase}: kernel launches {launches} in the "
                             f"run of {N_BATCHES} batches")
    if control is not None and n_blind / n_req < 10 * MAX_FLIP_RATE:
        raise AssertionError(f"{phase}: the flip gate does not see the "
                             "control")
    if n_flips / n_req > MAX_FLIP_RATE:
        raise AssertionError(f"{phase}: {n_flips} top-1 flips against the "
                             "plain versions")
    return {"launches": launches, "qa_pairs_per_s": n_req / seconds}


def randn(rng, shape, scale, device, dtype=torch.float32) -> torch.Tensor:
    x = rng.standard_normal(shape, dtype=np.float32) * scale
    return torch.from_numpy(x).to(device).to(dtype)


def k4_inputs(n: int, seed: int, device) -> tuple:
    """bf16 K4 inputs whose two softmaxes are peaked."""
    rng = np.random.default_rng(seed)
    l, t, e = K4_SHAPE["l"], K4_SHAPE["t"], K4_SHAPE["e"]
    bf = torch.bfloat16
    return (randn(rng, (n, l, e), 0.5, device, bf),
            randn(rng, (n, t, e), 0.5, device, bf),
            randn(rng, (n, l, e), 0.3, device, bf),
            randn(rng, (n, t, e), 0.3, device, bf),
            randn(rng, (n, l, e), 0.5, device, bf),
            randn(rng, (n, t, e), 0.5, device, bf),
            randn(rng, (e, 1), 0.4, device, bf),
            randn(rng, (e, 1), 0.4, device, bf))


def k4_within(name: str, got: torch.Tensor,
              want: torch.Tensor) -> torch.Tensor:
    """Elementwise: is K4's output ``name`` within its tolerance?"""
    if name in ("av", "aq"):
        return (got - want).abs() <= K4_MAP_RTOL * want.abs() + K4_MAP_ATOL
    return (got - want).abs() <= K4_RTOL * want.abs().max()


def k4_check(n: int, dev) -> float:
    """K4 against its plain version with its controls; raises on a
    failure. Returns the largest |diff| over (v, q, av, aq)."""
    args = k4_inputs(n, 40 + n, dev)
    got = co.coattention_core_cuda(*args)
    again = co.coattention_core_cuda(*args)
    want = co.coattention_core_reference(*args)
    flat = co.coattention_core_reference(*args[:6], torch.zeros_like(args[6]),
                                         torch.zeros_like(args[7]))
    torch.cuda.synchronize()
    fields, failed, max_abs = {}, [], 0.0
    for i, name in enumerate(("v", "q", "av", "aq")):
        diff = (got[i] - want[i]).abs()
        rec = {"max_abs_diff": float(diff.max()),
               "max_rel_diff": float(diff.max() / want[i].abs().max()),
               "within_tolerance": bool(k4_within(name, got[i],
                                                  want[i]).all()),
               "rerun_bit_equal": bool(torch.equal(got[i], again[i])),
               "finite": bool(torch.isfinite(got[i]).all()),
               "uniform_control_rejected_share": 1.0 - float(
                   k4_within(name, flat[i], want[i]).float().mean())}
        fields[name] = rec
        max_abs = max(max_abs, rec["max_abs_diff"])
        if not (rec["within_tolerance"] and rec["rerun_bit_equal"]
                and rec["finite"]):
            failed.append(name)
    av_peak = float(got[2].max(1).values.mean())
    say("k4_check", n=n, **K4_SHAPE, av_max_mean=av_peak,
        uniform_av=1.0 / K4_SHAPE["l"], **fields)
    if failed:
        raise AssertionError(f"K4 disagrees with its plain version on "
                             f"{failed} at N={n}")
    if av_peak < 10.0 / K4_SHAPE["l"]:
        raise AssertionError("the K4 inputs do not peak the region softmax")
    if min(rec["uniform_control_rejected_share"] for rec in fields.values()
           if isinstance(rec, dict)) < 0.5:
        raise AssertionError("the K4 check does not reject uniform maps")
    return max_abs


def k5_inputs(n: int, seed: int, cfg: Config, device) -> tuple:
    """Production-width K5 inputs: bf16 img and q, f32 W and b."""
    rng = np.random.default_rng(seed)
    d, f = cfg.img_feature_channel, cfg.fusion_dim
    return (randn(rng, (n, cfg.img_feature_dim, d), 0.5, device,
                  torch.bfloat16),
            randn(rng, (d, f), 0.02, device), randn(rng, (f,), 0.05, device),
            randn(rng, (n, f), 0.5, device, torch.bfloat16))


def k5_check(n: int, cfg: Config, dev) -> float:
    """K5 against grid_fuse_reference, bit-equal reruns, and the control
    (q permuted across samples); raises on a failure. Returns max |diff|
    of the output."""
    img, w, b, q = k5_inputs(n, 50 + n, cfg, dev)
    k = cfg.mfb_factor
    got = gf.inference_fusion_cuda(img, w, b, q, k)
    again = gf.inference_fusion_cuda(img, w, b, q, k)
    want = gf.grid_fuse_reference(img, w, b, q, k)
    torch.cuda.synchronize()
    pooled, want_pooled = got * got.abs(), want * want.abs()
    tol = K5_RTOL * want_pooled.abs().max()
    ok = bool(((pooled - want_pooled).abs() <= tol).all())
    perm = gf.grid_fuse_reference(img, w, b, q.roll(1, 0), k)
    rejected = float(((perm * perm.abs() - want_pooled).abs() > tol)
                     .float().mean())
    del perm
    max_abs = float((got - want).abs().max())
    fields = dict(n=n, max_abs_diff=max_abs, max_rel_diff_pooled=float(
        (pooled - want_pooled).abs().max() / want_pooled.abs().max()),
        within_tolerance=ok, rerun_bit_equal=bool(torch.equal(got, again)),
        finite=bool(torch.isfinite(got).all()),
        permuted_q_rejected_share=rejected)
    say("k5_check", **fields)
    if not (ok and fields["rerun_bit_equal"] and fields["finite"]):
        raise AssertionError(f"K5 disagrees with its plain version at N={n}")
    if rejected < 0.5:
        raise AssertionError("the K5 check does not reject a permuted q")
    return max_abs


def k7_inputs(shape: tuple, seed: int, device) -> tuple:
    """K7 inputs at one call shape, with the softmax over P peaked: bf16 x
    and v (the question glimpse pools x itself, as mhb_coAtt pools h_seq),
    f32 W1 [A, C], b1, W2 [G=2, A], b2."""
    n, p, c, a, d = shape
    rng = np.random.default_rng(seed)
    x = randn(rng, (n, p, c), 1.0, device, torch.bfloat16)
    v = x if d == c else randn(rng, (n, p, d), 0.5, device, torch.bfloat16)
    return (x, randn(rng, (a, c), 2.0 / c ** 0.5, device),
            randn(rng, (a,), 0.1, device), randn(rng, (2, a), 0.2, device),
            randn(rng, (2,), 0.1, device), v)


def k7_within(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Elementwise, per glimpse row [N, 2, D]: is K7's ``got`` within
    K7_RTOL_ROW of the row's largest |value| in ``want``?"""
    n = got.shape[0]
    g, w = got.float().reshape(n, 2, -1), want.float().reshape(n, 2, -1)
    return (g - w).abs() <= K7_RTOL_ROW * w.abs().amax(-1, keepdim=True)


def k7_check(shape_name: str, quirk: bool, dev) -> float:
    """K7 against its plain version at one call shape and quirk mode, with
    the uniform-pool control; raises on a failure. Returns max |diff|."""
    shape = K7_SHAPES[shape_name]
    n, _, _, _, d = shape
    args = k7_inputs(shape, 70, dev)
    got = att.glimpse_attention_cuda(*args, uniform_quirk=quirk)
    again = att.glimpse_attention_cuda(*args, uniform_quirk=quirk)
    want = att.glimpse_attention_reference(*args, uniform_quirk=quirk)
    torch.cuda.synchronize()
    g, w = got.float().reshape(n, 2, d), want.float().reshape(n, 2, d)
    tol = K7_RTOL_ROW * w.abs().amax(-1, keepdim=True)
    ok = bool(k7_within(got, want).all())
    fields = dict(shape=shape_name, n=n, uniform_quirk=quirk,
                  max_abs_diff=float((g - w).abs().max()),
                  within_tolerance=ok,
                  rerun_bit_equal=bool(torch.equal(got, again)),
                  finite=bool(torch.isfinite(g).all()))
    if not quirk:
        uniform = args[5].float().mean(1, keepdim=True).expand(n, 2, d)
        fields["uniform_pool_rejected_share"] = float(
            ((uniform - w).abs() > tol).float().mean())
    say("k7_check", **fields)
    if not (ok and fields["rerun_bit_equal"] and fields["finite"]):
        raise AssertionError(f"K7 disagrees with its plain version at "
                             f"{shape_name}, uniform_quirk={quirk}")
    if fields.get("uniform_pool_rejected_share", 1.0) < 0.5:
        raise AssertionError("the K7 check does not reject a uniform pool")
    return fields["max_abs_diff"]


def dead_fusion_check(cfg: Config, params, store, dev) -> None:
    """With the reference quirk the co-attention weights are all 1, so the
    logits must be bit-equal whether or not K5's output is zeroed (its
    weights zeroed): the value-dead stage-1 fusion. K5 must still launch."""
    quirky = cfg.replace(keep_reference_quirks=True, compute_dtype="bfloat16")
    zero = dict(params, img_conv1d={
        "w": torch.zeros_like(params["img_conv1d"]["w"]),
        "b": torch.zeros_like(params["img_conv1d"]["b"])})
    model = load_jax_params(mfb.MFB(quirky).to(dev), params).eval()
    dead = load_jax_params(mfb.MFB(quirky).to(dev), zero).eval()
    image_ids, ques = traffic(cfg)
    img = torch.from_numpy(store.gather(image_ids[:BATCH], np.float16)).to(dev)
    qt = torch.from_numpy(ques[:BATCH]).to(dev)
    gf.launch_count = 0
    with torch.inference_mode():
        live = model(img, qt)
        zeroed = dead(img, qt)
    launches = gf.launch_count
    equal = bool(torch.equal(live, zeroed))
    say("mfb_quirk_dead_fusion", model=cfg.model_name, k5_launches=launches,
        logits_bit_equal_with_k5_output_zeroed=equal)
    if launches != 2 or not equal:
        raise AssertionError("with the quirk on, the logits depend on K5's "
                             "output, or K5 did not launch")


def train_run(cfg: Config, qa, store, params, **solver_kw) -> dict:
    """``Solver.train`` from ``params``: per-step losses, ms per step over
    steps 4..last (synchronised at both ends), the launch counts of K2 and
    K3 in the run (each set to 0 just before it), and the solver."""
    solver = Solver(cfg, qa, store, params=params, **solver_kw)
    losses, marks = [], {}
    steps = cfg.num_epoch * len(solver.batches["train"])

    def on_step(step, loss):
        losses.append(loss)
        if step in (4, steps - 1):
            torch.cuda.synchronize()
            marks[step] = time.perf_counter()

    for counts in TRAIN_COUNTERS.values():
        for name in counts:
            counts[name] = 0
    metrics = solver.train(on_step=on_step)
    ms = (marks[steps - 1] - marks[4]) * 1e3 / (steps - 5)
    return {"losses": [float(x) for x in losses], "ms_per_step": ms,
            "qa_pairs_per_s": cfg.batch_size * 1e3 / ms,
            "launches": {k: dict(v) for k, v in TRAIN_COUNTERS.items()},
            "metrics": metrics, "solver": solver}


def train_data(cfg: Config, steps: int) -> tuple:
    """Synthetic QA data at the config's vocabularies: ``steps`` batches of
    TRAIN_BATCH training questions, and one batch to repeat."""
    rng = np.random.default_rng(0)
    kw = dict(n_val=TRAIN_BATCH, q_vocab_words=cfg.q_vocab_size - 2,
              num_answers=cfg.a_vocab_size, max_len=cfg.max_question_length,
              num_images=N_IMAGES)
    qa = make_synthetic_qa_data(rng, n_train=steps * TRAIN_BATCH, **kw)
    one = make_synthetic_qa_data(rng, n_train=TRAIN_BATCH, **kw)
    assert (qa.q_vocab_size, qa.a_vocab_size) == (cfg.q_vocab_size,
                                                  cfg.a_vocab_size)
    return qa, one


def train_phase(phase: str, cfg: Config, params, store, smi: str,
                steps: int, kernel: str) -> dict:
    """The port's Solver at full width, bf16, batch TRAIN_BATCH, ``steps``
    steps: kernel run, plain run (``reference_kernels=True``), repeated-batch
    run and the val() check; ``kernel`` ("K2" or "K3") is the training
    fusion the path must launch, forward and d_W once a step and d_img
    never (img is data: it needs no gradient), and the other must not
    launch. Raises on a failure; returns the kernel run."""
    cfg = cfg.replace(num_epoch=1, batch_size=TRAIN_BATCH)
    qa, one = train_data(cfg, steps)
    run = train_run(cfg, qa, store, params)
    trained = run.pop("solver")
    val = trained.val()
    fresh = Solver(cfg, qa, store, params=to_jax_params(trained.model))
    untrained = Solver(cfg, qa, store, params=params)
    val_fresh, val_untrained = fresh.val(), untrained.val()
    del trained, fresh, untrained
    plain = train_run(cfg, qa, store, params, reference_kernels=True)
    del plain["solver"]
    repeated = train_run(cfg.replace(num_epoch=steps), one, store, params)
    del repeated["solver"]
    torch.cuda.empty_cache()
    k_loss, p_loss = np.array(run["losses"]), np.array(plain["losses"])
    rel = np.abs(k_loss - p_loss) / np.abs(p_loss)
    r_loss = repeated["losses"]
    want = {name: {key: 0 for key in counts}
            for name, counts in TRAIN_COUNTERS.items()}
    want[kernel].update(forward=steps, d_w=steps)
    if kernel == "K2":
        want[kernel].update(g_prod=steps, d_q=steps)
    else:
        want[kernel].update(g_pooled=steps)
    say(phase, model=cfg.model_name, dropout_site=cfg.dropout_site,
        keep_reference_quirks=cfg.keep_reference_quirks, steps=steps,
        batch=TRAIN_BATCH, kernel_losses=run["losses"],
        plain_losses=plain["losses"], rel_diff_by_step=rel.tolist(),
        repeated_batch_losses=r_loss, launches=run["launches"],
        launches_note="d_img stays at 0: img is data, it needs no "
                      "gradient, so the backward never launches it",
        plain_run_launches=plain["launches"],
        val_after_training=val, val_fresh_load=val_fresh,
        val_untrained_info=val_untrained,
        peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    if not (np.isfinite(k_loss).all() and np.isfinite(p_loss).all()):
        raise AssertionError(f"{phase}: a training loss is not finite")
    if (rel[:TRAIN_AGREE_STEPS] > TRAIN_LOSS_RTOL).any():
        raise AssertionError(f"{phase}: the kernel and plain training runs "
                             "disagree")
    no_launch = {name: {key: 0 for key in counts}
                 for name, counts in TRAIN_COUNTERS.items()}
    if run["launches"] != want or plain["launches"] != no_launch:
        raise AssertionError(f"{phase}: launches {run['launches']} in the "
                             f"kernel run, {plain['launches']} in the plain")
    if not r_loss[-1] < r_loss[0]:
        raise AssertionError(f"{phase}: the loss on a repeated batch does "
                             "not fall")
    if val != val_fresh or val == val_untrained:
        raise AssertionError(f"{phase}: val() after training does not score "
                             "the trained weights")
    for name, r in (("kernel", run), ("plain", plain)):
        say(f"{phase}_time", run=name, model=cfg.model_name,
            dropout_site=cfg.dropout_site, ms_per_step=r["ms_per_step"],
            qa_pairs_per_s=r["qa_pairs_per_s"], steps_timed=f"4..{steps - 1}",
            batch=TRAIN_BATCH, epoch_qa_pairs_per_s_info=r["metrics"]["qps"],
            card=smi)
    return run


def dead_gradient_check(cfg: Config, params, store) -> None:
    """With the reference quirk on, mfb's stage-1 fusion is gradient-dead:
    after one training step img_conv1d has no gradient (None: autograd never
    reaches it, where JAX gives exactly 0), and K3's backward never
    launches though its forward does."""
    cfg = cfg.replace(keep_reference_quirks=True, num_epoch=1,
                      batch_size=TRAIN_BATCH)
    qa, _ = train_data(cfg, 1)
    solver = Solver(cfg, qa, store, params=params)
    for name in pf.launch_count:
        pf.launch_count[name] = 0
    loss, _ = solver._train_step(next(solver.batches["train"].epoch(0)))
    torch.cuda.synchronize()
    grads = {name: solver.model.get_submodule(name).weight.grad
             for name in ("img_conv1d", "ques_proj1", "ques_proj2")}
    dead = {name: g is None or not bool(g.any()) for name, g in grads.items()}
    say("mfb_quirk_dead_gradient", model=cfg.model_name,
        dropout_site=cfg.dropout_site, loss=float(loss),
        k3_launches=dict(pf.launch_count),
        gradient_is_none_or_zero=dead,
        img_conv1d_grad_is_none=grads["img_conv1d"] is None)
    if not (dead["img_conv1d"] and dead["ques_proj1"]) or dead["ques_proj2"]:
        raise AssertionError("with the quirk on, the stage-1 fusion gets a "
                             "gradient, or the rest of the model none")
    if pf.launch_count != {"forward": 1, "g_pooled": 0, "d_img": 0,
                           "d_w": 0}:
        raise AssertionError(f"K3 launches {pf.launch_count} in a quirk-on "
                             "step")
    del solver


def serve_family(name: str, store, dev, smi: str) -> dict:
    """A family with no kernel on its path, served at full width through
    ``predict_stream`` (batch BATCH, BATCH * N_BATCHES requests, after a
    warm-up pass), each request with its question length. Gates: well
    formed; each served answer is the top of the same model's forward on
    the batch with those lengths (within one bf16 ulp, ``flips``); for MHB,
    the lengths reach the model: all set to T, the answers change."""
    cfg = Config(model_name=name)
    params = init_params(cfg, torch.Generator().manual_seed(5))
    engine = InferenceEngine(cfg, params, batch_size=BATCH, topk=5)
    image_ids, ques = traffic(cfg)
    qlen = (ques != 0).sum(1).astype(np.int32)
    n_req = len(ques)

    def batches(lengths):
        for s in range(0, n_req, BATCH):
            feats = store.gather(image_ids[s:s + BATCH], np.float16)
            yield feats, ques[s:s + BATCH], lengths[s:s + BATCH]

    list(engine.predict_stream(batches(qlen)))  # warm-up pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = [p for b in engine.predict_stream(batches(qlen)) for p in b]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    answers = np.array([p.answer_id for p in preds])
    probs = np.stack([p.top_probs for p in preds])
    if len(preds) != n_req or not np.isfinite(probs).all() or (
            probs.sum(-1) > 1.0 + 1e-3).any():
        raise AssertionError(f"serve_{name}: served predictions are "
                             "malformed")
    n_flips = 0
    for s, (feats, qs, ls) in zip(range(0, n_req, BATCH), batches(qlen)):
        args = [torch.from_numpy(a).to(dev) for a in (feats, qs, ls)]
        served = torch.from_numpy(answers[s:s + BATCH]).to(dev)
        with torch.inference_mode():
            n_flips += flips(engine.model(*args), served)
    with torch.inference_mode():
        forward_ms = time_ms(lambda: engine.model(*args), 3)
    fields = dict(model=name, requests=n_req, batch=BATCH,
                  kernels_on_path="none", flips_vs_direct_forward=n_flips,
                  distinct_answers=int(len(np.unique(answers))),
                  qa_pairs_per_s=n_req / seconds, seconds=seconds,
                  wall_ms_per_batch=seconds * 1e3 / N_BATCHES,
                  device_forward_ms_per_batch=forward_ms,
                  device_share=forward_ms * N_BATCHES / (seconds * 1e3))
    if name == "mhb":
        full = np.full_like(qlen, cfg.max_question_length)
        changed = np.array([p.answer_id for b in engine.predict_stream(
            batches(full)) for p in b]) != answers
        fields.update(qlen_used={"min": int(qlen.min()),
                                 "max": int(qlen.max()),
                                 "mean": float(qlen.mean())},
                      answers_changed_with_qlen_T_share=float(
                          changed.mean()))
    say(f"serve_{name}", **fields, card=smi)
    if n_flips:
        raise AssertionError(f"serve_{name}: {n_flips} served answers are "
                             "not the forward's")
    if name == "mhb" and fields["answers_changed_with_qlen_T_share"] < \
            MHB_QLEN_CONTROL_SHARE:
        raise AssertionError("serve_mhb: the answers do not depend on the "
                             "question lengths")
    del engine
    torch.cuda.empty_cache()
    return {"qa_pairs_per_s": n_req / seconds,
            "device_forward_ms": forward_ms}


def train_family(name: str, store, smi: str) -> dict:
    """``Solver.train`` of a family with no kernel on its path: full width,
    bf16, batch TRAIN_BATCH, FAMILY_TRAIN_STEPS steps, then as many on one
    repeated batch. Gates: finite losses; the repeated batch's loss falls;
    ``val()`` equals a fresh load's of the trained weights (running
    statistics included); a batch norm's running statistics moved; no
    training kernel launched."""
    steps = FAMILY_TRAIN_STEPS
    cfg = Config(model_name=name, compute_dtype="bfloat16", num_epoch=1,
                 batch_size=TRAIN_BATCH)
    qa, one = train_data(cfg, steps)
    params = init_params(cfg, torch.Generator().manual_seed(6))
    run = train_run(cfg, qa, store, params)
    trained = run.pop("solver")
    val = trained.val()
    tree = to_jax_params(trained.model)
    val_fresh = Solver(cfg, qa, store, params=tree).val()
    del trained
    stats = {f"{layer}/{key}": float(np.abs(
        tree[layer][key] - params[layer][key].numpy()).max())
        for layer in ("img_bn", "batchnorm") if layer in tree
        for key in ("mean", "var")}
    repeated = train_run(cfg.replace(num_epoch=steps), one, store, params)
    del repeated["solver"]
    torch.cuda.empty_cache()
    losses, r_loss = np.array(run["losses"]), repeated["losses"]
    no_launch = {k: {key: 0 for key in counts}
                 for k, counts in TRAIN_COUNTERS.items()}
    say(f"train_{name}_time", model=name, steps=steps, batch=TRAIN_BATCH,
        compute_dtype="bfloat16", ms_per_step=run["ms_per_step"],
        qa_pairs_per_s=run["qa_pairs_per_s"], steps_timed=f"4..{steps - 1}",
        losses=run["losses"], repeated_batch_losses=r_loss,
        val_after_training=val, val_fresh_load=val_fresh,
        running_stats_moved_max=stats, launches=run["launches"],
        peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20, card=smi)
    if not (np.isfinite(losses).all() and np.isfinite(r_loss).all()):
        raise AssertionError(f"train_{name}: a training loss is not finite")
    if not r_loss[-1] < r_loss[0]:
        raise AssertionError(f"train_{name}: the loss on a repeated batch "
                             "does not fall")
    if val != val_fresh:
        raise AssertionError(f"train_{name}: val() after training differs "
                             "from a fresh load's")
    if not all(v > 0 for v in stats.values()) or (
            name in ("iBOWIMG", "attentionNet")) != bool(stats):
        raise AssertionError(f"train_{name}: the running statistics did "
                             f"not move: {stats}")
    if run["launches"] != no_launch:
        raise AssertionError(f"train_{name}: training kernels launched: "
                             f"{run['launches']}")
    return run


def families_agree(dev) -> None:
    """Each family of FAMILIES_SERVED (eval and training forward, dropout
    0, pad rows in ``valid``) and hieCoAtten's training forward at f32,
    full width, batch AGREE_N, on the card and on the CPU, each held
    against the same forward at f64 on the CPU: the card's largest |error|
    within AGREE_RTOL of the largest |logit|, or within AGREE_MARGIN times
    the CPU's own f32 error. At full width f32 summation order alone can
    pass AGREE_RTOL where the forward amplifies it: MHB's signed sqrt turns
    an error e of a pooled value near 0 into sqrt(e), and attentionNet's
    training batch norm divides by the spread of each logit over 6 rows;
    the two f32 runs share those amplifications."""
    rng = np.random.default_rng(8)
    rows = [(name, train) for name in FAMILIES_SERVED
            for train in (False, True)] + [("hieCoAtten", True)]
    results = {}
    for name, train in rows:
        cfg = Config(model_name=name, dropout_default=0.0, dropout_lstm=0.0,
                     dropout_fusion=0.0)
        params = init_params(cfg, torch.Generator().manual_seed(9))
        img = torch.from_numpy(rng.standard_normal(
            (AGREE_N, cfg.img_feature_dim, cfg.img_feature_channel),
            dtype=np.float32) * 0.5)
        ques = torch.from_numpy(rng.integers(
            1, cfg.q_vocab_size, (AGREE_N, cfg.max_question_length)))
        ques[0, 4:] = 0
        qlen = (ques != 0).sum(1)
        valid = torch.arange(AGREE_N) < AGREE_N - 2
        logits = {}
        for label, where, dtype in (("f64", "cpu", "float64"),
                                    ("cpu", "cpu", "float32"),
                                    ("card", dev, "float32")):
            c = cfg.replace(compute_dtype=dtype)
            model = get_model(name)(c).to(where)
            if dtype == "float64":
                model = model.double()
            model = load_jax_params(model, params)
            x = img.to(where).to(layers.DTYPES[dtype])
            with torch.no_grad():
                logits[label] = model(
                    x, ques.to(where), qlen.to(where), train=train,
                    valid=valid.to(where),
                    generator=torch.Generator(device=where)).double().cpu()
        ref = logits["f64"]
        row = {label: float((logits[label] - ref).abs().max()
                            / ref.abs().max()) for label in ("cpu", "card")}
        row["card_vs_cpu"] = float((logits["card"] - logits["cpu"]).abs().max()
                                   / ref.abs().max())
        results[f"{name}{'_train' if train else ''}"] = row
        if not (torch.isfinite(logits["card"]).all() and row["card"] <= max(
                AGREE_RTOL, AGREE_MARGIN * row["cpu"])):
            say("families_agree", rel_err_vs_f64=results, failed=name,
                train=train)
            raise AssertionError(f"families_agree: {name} (train={train}) "
                                 f"on the card: {row}")
    say("families_agree", n=AGREE_N, compute_dtype="float32",
        rel_err_vs_f64=results, bound=AGREE_RTOL, margin=AGREE_MARGIN)


def k6_inputs(n: int, seed: int, cfg: Config, dev) -> tuple:
    """Production-width K6 inputs, drawn on the card from a seeded
    generator (N=1024's img is 411M values, seconds of a host draw): bf16
    img, f32 W, b and q."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, f = cfg.img_feature_channel, cfg.fusion_dim

    def t(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return (t((n, cfg.img_feature_dim, d), 0.5).to(torch.bfloat16),
            t((d, f), 0.02), t((f,), 0.05), t((n, f), 0.5))


def k6_within(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Elementwise: is K6's ``got`` within the tolerance of ``want``, held
    as pooled = out * |out|?"""
    got, want = got.float(), want.float()
    got, want = got * got.abs(), want * want.abs()
    return (got - want).abs() <= K6_RTOL * want.abs() + \
        K6_ATOL * want.abs().max()


def k6_check(n: int, cfg: Config, dev) -> float:
    """K6 at production widths against its plain version, with its two
    controls; raises on a failure. Returns max |diff| of the output."""
    img, w, b, q = k6_inputs(n, 60 + n, cfg, dev)
    k = cfg.mfb_factor
    got = wqg.wq_grid_fuse_cuda(img, w, b, q, k)
    again = wqg.wq_grid_fuse_cuda(img, w, b, q, k)
    want = wqg.wq_grid_fuse_reference(img, w, b, q, k)
    torch.cuda.synchronize()
    ok = bool(k6_within(got, want).all())
    perm = wqg.wq_grid_fuse_reference(img, w, b, q.roll(1, 0), k)
    perm_rejected = 1.0 - float(k6_within(perm, want).float().mean())
    del perm
    wf = want.float()
    row = wf / wf.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    row_rejected = 1.0 - float(k6_within(row, want).float().mean())
    del row
    norms = wf.pow(2).sum((1, 2)).sqrt()
    pooled, want_pooled = got.float() * got.float().abs(), wf * wf.abs()
    max_abs = float((got.float() - wf).abs().max())
    fields = dict(
        n=n, max_abs_diff=max_abs,
        max_rel_diff_pooled=float((pooled - want_pooled).abs().max()
                                  / want_pooled.abs().max()),
        bit_equal_share=float((got == want).float().mean()),
        within_tolerance=ok, rerun_bit_equal=bool(torch.equal(got, again)),
        finite=bool(torch.isfinite(got.float()).all()),
        grid_norm_of_plain_output=[float(norms.min()), float(norms.max())],
        permuted_q_rejected_share=perm_rejected,
        per_row_norm_rejected_share=row_rejected)
    say("k6_check", **fields)
    if not (ok and fields["rerun_bit_equal"] and fields["finite"]):
        raise AssertionError(f"K6 disagrees with its plain version at N={n}")
    if min(perm_rejected, row_rejected) < 0.5:
        raise AssertionError("the K6 check does not reject a permuted q or a "
                             "per-row norm")
    return max_abs


def k6_path(cfg: Config, dev) -> int:
    """K6's path: its entry ``wq_grid_fuse``, forward (the kernel) and
    backward (the composed chain's VJP), at N = K6_GRAD_N, with its launch
    count set to 0 just before; the gradients against
    ``composed_reference``'s on the card. Raises on a failure; returns the
    launches."""
    img, w, b, q = k6_inputs(K6_GRAD_N, 61, cfg, dev)
    args = [x.float().requires_grad_(True) if i else x.requires_grad_(True)
            for i, x in enumerate((img, w, b, q))]
    k = cfg.mfb_factor
    rng = np.random.default_rng(62)
    g = randn(rng, (K6_GRAD_N, img.shape[1], w.shape[1] // k), 1.0, dev,
              torch.bfloat16)
    wqg.launch_count = 0
    grads = torch.autograd.grad(wqg.wq_grid_fuse(*args, k), args, g)
    torch.cuda.synchronize()
    launches = wqg.launch_count
    want = torch.autograd.grad(wqg.composed_reference(*args, k), args, g)
    fields, ok = {}, True
    for name, got, ref, x in zip(("img", "W", "b", "q"), grads, want, args):
        dtype, got, ref = got.dtype, got.float(), ref.float()
        rel = float((got - ref).abs().max() / ref.abs().max())
        fields[name] = {"max_rel_diff": rel, "dtype": str(dtype),
                        "finite": bool(torch.isfinite(got).all()),
                        "nonzero_share": float((got != 0).float().mean())}
        ok &= (rel <= K6_GRAD_RTOL and fields[name]["finite"]
               and dtype == x.dtype)
    say("k6_path", entry="wq_grid_fuse", n=K6_GRAD_N, launches=launches,
        gradients=fields)
    if launches != 1:
        raise AssertionError(f"K6 launched {launches} times on its path")
    if not ok:
        raise AssertionError("K6's backward disagrees with the composed "
                             "chain's VJP")
    return launches


def k8_inputs(n: int, seed: int, dev) -> tuple:
    """x [n, T, E] bf16 and the LSTM's weights in layers.LSTM's layout
    (f32): xp ~ N(0, 1) and W_hh ~ N(0, 4/H), so that h @ W_hh^T is about
    half a unit: the gates stay off the sigmoid's flat tails, and W_hh's
    blocks matter (its i and f blocks swapped move most outputs)."""
    t, e, h = K8_SHAPE["t"], K8_SHAPE["e"], K8_SHAPE["h"]
    rng = np.random.default_rng(seed)
    return (randn(rng, (n, t, e), 1.0, dev, torch.bfloat16),
            randn(rng, (4 * h, e), e ** -0.5, dev),
            randn(rng, (4 * h, h), 2.0 * h ** -0.5, dev),
            randn(rng, (4 * h,), 0.1, dev), randn(rng, (4 * h,), 0.1, dev))


def k8_within(got: torch.Tensor, forced: torch.Tensor) -> torch.Tensor:
    """Elementwise: is each step of ``got`` within one bf16 ulp plus
    K8_STEP_ATOL of ``forced``, the plain steps fed ``got``'s carry?"""
    got, forced = got.float(), forced.float()
    ulp = torch.exp2(torch.floor(torch.log2(forced.abs().clamp_min(1e-30)))
                     - 7)
    return (got - forced).abs() <= ulp + K8_STEP_ATOL


def k8_steps_rejected(out: torch.Tensor, xp: torch.Tensor,
                      w_hh: torch.Tensor) -> float:
    """Control: the share of ``out`` (a faulty scan's output) whose steps
    the check rejects."""
    forced = k8.lstm_scan_reference(xp, w_hh, h_carry=out)
    return 1.0 - float(k8_within(out, forced).float().mean())


def k8_check(n: int, dev) -> float:
    """K8's scan against its plain version, step by step and run free, with
    its controls; raises on a failure. Returns the free-running max |diff|."""
    x, w_ih, w_hh, b_ih, b_hh = k8_inputs(n, 80 + n, dev)
    # the kernel's inputs as lstm_seq gives them: the projection without
    # its bias, and the bias, which the kernel adds; the plain version
    # takes the whole input projection
    xp = k8.input_projection(x, w_ih, b_ih, b_hh)
    bias = (b_ih + b_hh).to(torch.bfloat16)
    geo, counter = k8_geometry(n)
    got = k8.lstm_scan_cuda(k8._project(x, w_ih), w_hh, bias, counter)
    again = k8.lstm_scan_cuda(k8._project(x, w_ih), w_hh, bias)
    torch.cuda.synchronize()
    arrivals = int(counter.sum())
    want = k8.lstm_scan_reference(xp, w_hh)
    forced = k8.lstm_scan_reference(xp, w_hh, h_carry=got)
    torch.cuda.synchronize()
    max_abs = float((got.float() - want.float()).abs().max())
    ok = bool(k8_within(got, forced).all()) and max_abs <= K8_FREE_ATOL
    # the pre-activations the plain run saw: its h carry is its bf16 output
    h_prev = torch.cat([torch.zeros_like(want[:, :1]), want[:, :-1]], 1)
    pre = xp.float() + h_prev.float() @ w_hh.to(torch.bfloat16).float().t()
    live = float((pre.abs() < K8_LIVE).float().mean())
    del pre
    h = K8_SHAPE["h"]
    swapped = k8.lstm_scan_reference(
        xp, torch.cat([w_hh[h:2 * h], w_hh[:h], w_hh[2 * h:]]))
    controls = {
        "i_f_swapped_rejected_share": k8_steps_rejected(swapped, xp, w_hh),
        "shifted_one_step_rejected_share": k8_steps_rejected(h_prev, xp,
                                                             w_hh)}
    del swapped, h_prev
    say("k8_check", n=n, **K8_SHAPE, blocks=geo.blocks,
        smem_bytes_per_block=geo.smem_bytes, c_in_smem=geo.c_in_smem,
        ring_stages=geo.stages,
        barriers=geo.barriers, barrier_arrivals=arrivals,
        max_abs_diff=max_abs,
        bit_equal_share=float((got == want).float().mean()),
        step_max_abs_diff=float((got.float() - forced.float()).abs().max()),
        step_bit_equal_share=float((got == forced).float().mean()),
        within_tolerance=ok, rerun_bit_equal=bool(torch.equal(got, again)),
        finite=bool(torch.isfinite(got.float()).all()),
        gate_preactivations_below_3_share=live, **controls)
    if not (ok and torch.equal(got, again)
            and torch.isfinite(got.float()).all()):
        raise AssertionError(f"K8 disagrees with its plain version at N={n}")
    if arrivals != geo.barriers * geo.blocks:
        raise AssertionError(f"K8's barriers took {arrivals} arrivals at "
                             f"N={n}")
    if live < K8_LIVE_SHARE:
        raise AssertionError("the K8 inputs saturate the gates")
    if min(controls.values()) < 0.5:
        raise AssertionError("the K8 check does not reject its controls")
    return max_abs


def k8_path(dev) -> int:
    """K8's path: its entry ``lstm_seq`` at N = BATCH, with its launch count
    set to 0 just before; held against the plain version as ``k8_check``
    holds it, and, for information only, against the port's composed
    ``layers.lstm`` on the same weights (gates and c in bf16). Raises on a
    failure; returns the launches."""
    args = k8_inputs(BATCH, 90, dev)
    k8.launch_count = 0
    with torch.inference_mode():
        got = k8.lstm_seq(*args)
    torch.cuda.synchronize()
    launches = k8.launch_count
    geo, _ = k8_geometry(BATCH)
    with torch.inference_mode():
        xp = k8.input_projection(args[0], args[1], args[3], args[4])
        want = k8.lstm_scan_reference(xp, args[2])
        forced = k8.lstm_scan_reference(xp, args[2], h_carry=got)
        composed = layers.lstm(*args)
    max_abs = float((got.float() - want.float()).abs().max())
    ok = bool(k8_within(got, forced).all()) and max_abs <= K8_FREE_ATOL
    say("k8_path", entry="lstm_seq", n=BATCH, **K8_SHAPE, launches=launches,
        blocks=geo.blocks, smem_bytes_per_block=geo.smem_bytes,
        c_in_smem=geo.c_in_smem, ring_stages=geo.stages,
        barriers=geo.barriers, within_tolerance=ok,
        max_abs_diff=max_abs,
        composed_layers_lstm_max_abs_diff_info=float(
            (composed.float() - got.float()).abs().max()),
        composed_layers_lstm_differs_share_info=float(
            (composed != got).float().mean()))
    if launches != 1 or not ok:
        raise AssertionError(f"K8's path: {launches} launches, within "
                             f"tolerance {ok}")
    return launches


def k8_geometry(n: int) -> tuple:
    """K8's geometry at N = n on this card, and zeroed barrier counters
    for a launch to count its arrivals in (every block at every barrier:
    barriers x blocks)."""
    geo = k8.geometry(n, K8_SHAPE["t"], K8_SHAPE["h"],
                      torch.cuda.get_device_properties(0)
                      .multi_processor_count)
    groups = geo.blocks // (K8_SHAPE["h"] // geo.units_per_block)
    return geo, torch.zeros(groups, dtype=torch.int32, device="cuda")


def k6_time(cfg: Config, dev, smi: str) -> tuple:
    """K6 against its plain version at N = BATCH and 1024 (kernel/plain/
    plain/kernel), with the torch composed weight-contracted chain + grid
    L2 for information. Returns (times at BATCH, bound at BATCH): the
    product (2 N L D O, bf16) and the f32 wq build (2 N k D O) counted at
    their peak rates, img, W, b, q and the bf16 output moved once."""
    k = cfg.mfb_factor
    for n in K6_TIME_NS:
        img, w, b, q = k6_inputs(n, 6, cfg, dev)
        _, l, d = img.shape
        o = w.shape[1] // k

        def composed():
            z = fusion.grid_fuse_weight_contracted(img, w, b, q, k)
            return layers.l2_normalize(z.reshape(n, -1)).reshape(z.shape)

        run = interleaved_ms(lambda: wqg.wq_grid_fuse_cuda(img, w, b, q, k),
                             lambda: wqg.wq_grid_fuse_reference(img, w, b, q,
                                                                k))
        # the forward and the scale launch apart, at N = BATCH
        by_launch = device_ms_by_kernel(
            lambda: wqg.wq_grid_fuse_cuda(img, w, b, q, k)) \
            if n == BATCH else None
        composed()
        composed_ms = time_ms(composed, 3)
        bnd = bound(nbytes(img, *pf.operands(w, b, q)) + 2 * n * l * o,
                    {"bf16": 2 * n * l * d * o, "f32": 2 * n * k * d * o})
        say("k6_time", n=n, kernel_ms=run[0], plain_ms=run[1],
            kernel_runs_ms=run[2], plain_runs_ms=run[3], bound_ms=bnd[0],
            bound_by=bnd[1], composed_chain_ms_info=composed_ms,
            device_ms_by_launch=by_launch, card=smi)
        if n == BATCH:
            times, k6_bound = run, bnd
        del img, w, b, q
        torch.cuda.empty_cache()
    return times, k6_bound


def k8_time(dev, smi: str) -> tuple:
    """K8's scan and the whole ``lstm_seq`` against their plain versions at
    N = BATCH, and ``torch.nn.LSTM`` (cuDNN) on the same weights and input,
    at bf16 if cuDNN takes bf16, else at f16. Returns (scan times, scan
    bound, cuDNN ms): the bound counts the recurrent products (2 N T H 4H,
    bf16) and xp, W_hh and the output moved once; the 22 dependent steps
    are a latency floor it does not count.

    The device times of ``lstm_seq`` and cuDNN's call are taken in
    K8_ROUNDS rounds, the order of the two alternating, each time by both
    of ``device_ms``'s formulas from one trace. ``lstm_seq`` is called as
    a caller holding layers.LSTM's f32 weights calls it (its W_ih is cast
    to bf16 inside the call), and, for information, with W_ih already in
    bf16 as the library holds it."""
    x, w_ih, w_hh, b_ih, b_hh = k8_inputs(BATCH, 9, dev)
    w_bf16, w_ih_bf16 = w_hh.to(torch.bfloat16), w_ih.to(torch.bfloat16)
    xp = k8._project(x, w_ih)
    bias = (b_ih + b_hh).to(torch.bfloat16)
    n, t, h = BATCH, K8_SHAPE["t"], K8_SHAPE["h"]
    scan = interleaved_ms(lambda: k8.lstm_scan_cuda(xp, w_bf16, bias),
                          lambda: k8.lstm_scan_reference(xp + bias, w_bf16),
                          10)
    seq = interleaved_ms(
        lambda: k8.lstm_seq(x, w_ih, w_bf16, b_ih, b_hh),
        lambda: k8.lstm_scan_reference(
            k8.input_projection(x, w_ih, b_ih, b_hh), w_bf16), 10)
    scan_bound = bound(nbytes(xp, w_bf16) + 2 * n * t * h,
                       {"bf16": 2 * n * t * h * 4 * h})
    # the yardstick: one PyTorch call for the same function; at::lstm takes
    # cuDNN only for a dtype torch.cudnn_is_acceptable accepts
    dtype = (torch.bfloat16 if torch.cudnn_is_acceptable(x)
             else torch.float16)
    net = torch.nn.LSTM(K8_SHAPE["e"], h, batch_first=True).to(dev, dtype)
    with torch.no_grad():
        for name, value in (("weight_ih_l0", w_ih), ("weight_hh_l0", w_hh),
                            ("bias_ih_l0", b_ih), ("bias_hh_l0", b_hh)):
            getattr(net, name).copy_(value)
    net.flatten_parameters()
    x_lib = x.to(dtype)
    with torch.inference_mode():
        lib_out = net(x_lib)[0]
        library_ms = time_ms(lambda: net(x_lib), 10)
        want = k8.lstm_seq(x, w_ih, w_bf16, b_ih, b_hh)
        # the device time alone of cuDNN's call and of K8's entry (the
        # call's time above includes the host's, and at bf16 nn.LSTM
        # compacts its weights on every call: its flatten_parameters()
        # skips a dtype that torch.backends.cudnn.is_acceptable does not
        # list)
        calls = {"cudnn": lambda: net(x_lib),
                 "lstm_seq": lambda: k8.lstm_seq(x, w_ih, w_bf16, b_ih,
                                                 b_hh),
                 "lstm_seq_bf16_w_ih_info": lambda: k8.lstm_seq(
                     x, w_ih_bf16, w_bf16, b_ih, b_hh)}
        rounds = []
        for r in range(K8_ROUNDS):
            names = list(calls) if r % 2 == 0 else list(calls)[::-1]
            rounds.append({name: device_ms(calls[name], 10)
                           for name in names})
        # for information: the scan alone, the input projection as
        # lstm_seq's plain path runs it (E padded to a multiple of 8) and
        # unpadded, and cuDNN at f16, where the weights stay flattened
        device = {"scan": device_ms(lambda: k8.lstm_scan_cuda(xp, w_bf16,
                                                              bias), 10),
                  "projection": device_ms(
                      lambda: k8.input_projection(x, w_ih, b_ih, b_hh), 10),
                  "projection_unpadded": device_ms(
                      lambda: torch.matmul(x, w_ih.to(x.dtype).t())
                      + (b_ih + b_hh).to(x.dtype), 10)}
        net16, x16 = net.half(), x.half()
        net16.flatten_parameters()
        net16(x16)
        f16_ms = time_ms(lambda: net16(x16), 10)
        device["cudnn_f16"] = device_ms(lambda: net16(x16))

    def ratios(formula, name="lstm_seq"):
        got = [r[name][formula] / r["cudnn"][formula] for r in rounds
               if r[name][formula] and r["cudnn"][formula]]
        return got if len(got) == len(rounds) else None

    say("k8_time", n=n, **K8_SHAPE, scan_kernel_ms=scan[0],
        scan_plain_ms=scan[1], scan_kernel_runs_ms=scan[2],
        scan_plain_runs_ms=scan[3], lstm_seq_kernel_ms=seq[0],
        lstm_seq_plain_ms=seq[1], lstm_seq_kernel_runs_ms=seq[2],
        lstm_seq_plain_runs_ms=seq[3], bound_ms=scan_bound[0],
        bound_by=scan_bound[1],
        bound_note="the 22 dependent steps are a latency floor the bound "
                   "does not count",
        cudnn_lstm_ms=library_ms, cudnn_dtype=str(dtype),
        cudnn_lstm_f16_ms_info=f16_ms, device_ms_rounds=rounds,
        device_ms_info=device,
        lstm_seq_over_cudnn_device_by_round=ratios("ms"),
        lstm_seq_over_cudnn_device_by_round_per_launch_formula=ratios(
            "ms_per_launch"),
        lstm_seq_bf16_w_ih_over_cudnn_device_by_round_info=ratios(
            "ms", "lstm_seq_bf16_w_ih_info"),
        cudnn_includes_input_projection=True,
        cudnn_vs_kernel_max_abs_diff_info=float(
            (lib_out.float() - want.float()).abs().max()), card=smi)
    return scan, scan_bound, library_ms


def cli_counts() -> dict:
    """Every launch counter of the CLI phase's kernels, as a dict."""
    return {"K1": wqf.launch_count, "K2": dict(tf.launch_count),
            "K3": dict(pf.launch_count)}


def cli_run(fn, argv) -> tuple:
    """Call a CLI's ``main(argv)`` with every counter of ``cli_counts`` set
    to 0 just before -> (its counts just after, seconds)."""
    wqf.launch_count = 0
    for counts in TRAIN_COUNTERS.values():
        for name in counts:
            counts[name] = 0
    t0 = time.perf_counter()
    fn(argv)
    torch.cuda.synchronize()
    return cli_counts(), time.perf_counter() - t0


def events(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def cli_results(model: str) -> tuple:
    with open(f"results/{model}.txt") as f:
        txt = f.read()
    with open(f"results/{model}.json") as f:
        record = json.load(f)
    with open(f"results/{model}_predictions.json") as f:
        preds = json.load(f)
    return txt, record, preds


def cli_phase(smi: str) -> dict:
    """The command line from corpus to results files, on the card, in a
    temporary workspace: ``tools/gen_corpus.py`` (a subprocess), the port's
    ``prepare_data``, synthetic f16 stores at the production grid
    (``resnet152_train`` + ``resnet152_val``, read through
    ``CombinedFeatureStore``), ``cli.train`` of bf16 mhb_coAtt at
    ``Config()`` widths (K2), a ``--resume`` from the mid-epoch
    ``step_<CLI_RESUME_STEP>`` in a second workspace, and ``cli.evaluate``
    (K1). Raises on a failed gate; returns the launches of the phase's
    runs."""
    model = "mhb_coAtt"
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as ws, contextlib.chdir(ws):
        data = os.path.join(ws, "data")
        subprocess.run([sys.executable,
                        os.path.join(root, "tools", "gen_corpus.py"), data,
                        "--n_train", str(CLI_CORPUS[0]), "--n_val",
                        str(CLI_CORPUS[1])],
                       check=True, capture_output=True, timeout=300)
        t0 = time.perf_counter()
        prepare_data.main(["--data_dir", data, "--num_answer",
                           str(CLI_NUM_ANSWER)])
        prepare_s = time.perf_counter() - t0
        qa = load_qa_data(qa_artifact_path(data, 2, CLI_NUM_ANSWER))
        train_ids = sorted(set(qa.train.image_ids.tolist()))
        val_ids = sorted(set(qa.val.image_ids.tolist()) - set(train_ids))
        t0 = time.perf_counter()
        for split, ids in (("train", train_ids), ("val", val_ids)):
            make_synthetic_feature_store(
                os.path.join(data, f"resnet152_{split}"), ids,
                seed=len(split))
        store_s = time.perf_counter() - t0
        if not qa.a_vocab_size < CLI_NUM_ANSWER:
            raise AssertionError("cli: the corpus has no fewer answers than "
                                 "--num_answer")
        flags = ["--model_name", model, "--data_dir", data, "--num_answer",
                 str(CLI_NUM_ANSWER), "--compute_dtype", "bfloat16",
                 "--batch_size", str(TRAIN_BATCH)]
        train_flags = flags + ["--num_epoch", str(CLI_EPOCHS),
                               "--checkpoint_every_steps", str(CLI_EVERY)]
        iters = -(-len(qa.train) // TRAIN_BATCH)
        steps = CLI_EPOCHS * iters
        val_batches = -(-len(qa.val) // TRAIN_BATCH)

        # the straight run
        trained, train_s = cli_run(cli_train.main, train_flags)
        run_events = events(f"runs/{model}/events.jsonl")
        losses = {e["step"]: (e["train loss"], e["val loss"])
                  for e in run_events if e["tag"] == f"{model}/loss"}
        qps = [e["value"] for e in run_events
               if e["tag"] == f"{model}/qa_pairs_per_sec"]
        kept = ckpt.all_steps(f"models/{model}")

        # the mid-epoch resume, in a second workspace holding only the
        # straight run's step_<CLI_RESUME_STEP>
        resume_ws = os.path.join(ws, "resume")
        shutil.copytree(f"models/{model}/step_{CLI_RESUME_STEP}",
                        os.path.join(resume_ws, "models", model,
                                     f"step_{CLI_RESUME_STEP}"))
        with contextlib.chdir(resume_ws):
            resumed, resume_s = cli_run(cli_train.main,
                                        train_flags + ["--resume"])
            resume_events = events(f"runs/{model}/events.jsonl")
            got = ckpt.restore_checkpoint(f"models/{model}", steps)
        want = ckpt.restore_checkpoint(f"models/{model}", steps)
        shutil.rmtree(resume_ws)
        resume_loss = [e["train loss"] for e in resume_events
                       if e["tag"] == f"{model}/loss"][-1]
        differ = [k for k, v in want["model"].items()
                  if not torch.equal(v, got["model"][k])]
        adam_differ = [
            f"{i}/{k}" for i, s in want["optimizer"]["state"].items()
            for k, v in s.items()
            if not torch.equal(v, got["optimizer"]["state"][i][k])]
        del got, want

        # the evaluation, then for information without the kernels
        evaluated, evaluate_s = cli_run(cli_evaluate.main, flags)
        txt, record, preds = cli_results(model)
        with switches(VQA_DISABLE_PALLAS="1"):
            plain_counts, _ = cli_run(cli_evaluate.main, flags)
        _, plain_record, plain_preds = cli_results(model)

        # the evaluation's rate: the CLI's own Solver, restored, one full
        # sweep timed; the device share: one val batch's forward, on the
        # device, against the wall time per batch
        solver = cli_train.build_solver(cli_train.parse_args(
            flags + ["--mode", "testing"]))
        solver.restore()
        t0 = time.perf_counter()
        solver.val(full=True)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        # one checkpoint write of the restored state, as train() makes it
        t0 = time.perf_counter()
        path = solver.save_checkpoint()
        checkpoint_s = time.perf_counter() - t0
        checkpoint_mb = os.path.getsize(
            os.path.join(path, ckpt.STATE_FILE)) / 2 ** 20
        batch = next(iter(solver.batches["val"].epoch()))
        img, ques, qlen = solver._device_batch(batch)[:3]
        with torch.inference_mode():
            solver.model(img, ques, qlen)
            forward_ms = time_ms(lambda: solver.model(img, ques, qlen), 3)
        solver.close()
        del solver, img, ques, qlen
        torch.cuda.empty_cache()

    n_val = len(qa.val)
    k2_want = {"forward": 1, "g_prod": 1, "d_w": 1, "d_q": 1, "d_img": 0}
    k3_zero = {name: 0 for name in pf.launch_count}
    qids = qa.val.question_ids.tolist()
    differ_share = float(np.mean([p["answer"] != q["answer"]
                                  for p, q in zip(preds, plain_preds)]))
    train_ms = 1e3 * len(qa.train) / qps[-1] / iters
    say("cli", model=model, corpus=list(CLI_CORPUS),
        prepared_questions=[len(qa.train), len(qa.val)],
        prepared_note="prepare drops the questions whose answer the UNK "
                      "slot displaces (the corpus's least frequent answer)",
        answer_vocab=qa.a_vocab_size, num_answer_flag=CLI_NUM_ANSWER,
        images=[len(train_ids), len(val_ids)], prepare_s=prepare_s,
        store_s=store_s, steps=steps, iters_per_epoch=iters,
        train_launches=trained, resume_launches=resumed,
        evaluate_launches=evaluated, plain_evaluate_launches=plain_counts,
        epoch_losses=losses, checkpoints_kept=kept,
        resume_from=CLI_RESUME_STEP, resume_final_loss=resume_loss,
        straight_final_loss=losses[steps][0], params_differ=differ,
        adam_differ=adam_differ, results_txt=txt,
        num_examples=record["num_examples"],
        accuracy=record["accuracy"],
        vqa_consensus_accuracy=record["vqa_consensus_accuracy"],
        plain_accuracy_info=plain_record["accuracy"],
        plain_vqa_consensus_accuracy_info=plain_record[
            "vqa_consensus_accuracy"],
        predictions_differ_share_info=differ_share, card=smi)
    say("cli_time", train_wall_s=train_s, resume_wall_s=resume_s,
        evaluate_wall_s=evaluate_s,
        train_ms_per_step=train_ms,
        train_qa_pairs_per_s=qps[-1], epoch_qa_pairs_per_s=qps,
        timed="the last epoch's steps, checkpoints included, through "
              "cli.train",
        checkpoint_write_s=checkpoint_s, checkpoint_mib=checkpoint_mb,
        checkpoints_in_last_epoch=len([s for s in range(iters + 1, steps + 1)
                                       if s % CLI_EVERY == 0]),
        evaluate_qa_pairs_per_s=n_val / sweep_s,
        evaluate_wall_ms_per_batch=sweep_s * 1e3 / val_batches,
        device_forward_ms_per_batch=forward_ms,
        device_share=forward_ms / (sweep_s * 1e3 / val_batches),
        batch=TRAIN_BATCH, card=smi)
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError("cli: a training loss is not finite")
    if (trained["K2"] != {k: steps * v for k, v in k2_want.items()}
            or resumed["K2"] != {k: (steps - CLI_RESUME_STEP) * v
                                 for k, v in k2_want.items()}
            or trained["K3"] != k3_zero):
        raise AssertionError(f"cli: K2 launches {trained['K2']} in the "
                             f"straight run, {resumed['K2']} resumed")
    if kept != list(range(steps, 0, -CLI_EVERY))[:3][::-1]:
        raise AssertionError(f"cli: checkpoints {kept} kept")
    if differ or adam_differ or resume_loss != losses[steps][0]:
        raise AssertionError(f"cli: the resumed run differs from the "
                             f"straight one in {differ + adam_differ}")
    if evaluated["K1"] != val_batches or plain_counts["K1"] != 0:
        raise AssertionError(f"cli: K1 launches {evaluated['K1']} in the "
                             f"evaluation of {val_batches} batches")
    shares = [record[k] for k in ("accuracy", "top3_accuracy",
                                  "vqa_consensus_accuracy",
                                  "accuracy_reference_denominator")]
    if (not txt.startswith("Evaluation accuracy: ")
            or record["num_examples"] != n_val
            or not all(0.0 <= s <= 1.0 for s in shares)
            or any(sum(v["num_examples"] for v in record[b].values())
                   != n_val for b in ("per_answer_type",
                                      "per_question_type"))
            or [p["question_id"] for p in preds] != qids):
        raise AssertionError("cli: the results files are malformed")
    return {"K1": trained["K1"] + resumed["K1"] + evaluated["K1"],
            "K2": {k: trained["K2"][k] + resumed["K2"][k]
                   for k in k2_want}}


# ---------------------------------------------------------------------------
# phases 28-30: serving by id, the HTTP server, the image backbones
# ---------------------------------------------------------------------------

def bank_traffic(cfg: Config) -> tuple:
    """BATCH * N_BATCHES requests over BANK_IMAGES images, each image asked
    BANK_REUSE questions (VQA asks ~3 of each image), in random order:
    (image ids, questions)."""
    rng = np.random.default_rng(28)
    n_req = BATCH * N_BATCHES
    pool = rng.choice(BANK_IMAGES, -(-n_req // BANK_REUSE), replace=False)
    image_ids = rng.permutation(np.repeat(pool, BANK_REUSE))[:n_req]
    return image_ids, traffic(cfg)[1]


def bank_stores(data_dir: str, cfg: Config) -> tuple:
    """A synthetic f16 store of BANK_IMAGES images at the config's grid
    (``resnet152_f16``; N(0, 0.5^2) features drawn in bulk from a seed) and
    its int8 twin by ``quantize_store`` (``resnet152_all``, what
    ``cli.serve --device_cache_images`` reads)."""
    rng = np.random.default_rng(29)
    shape = (cfg.img_feature_dim, cfg.img_feature_channel)
    f16_dir = os.path.join(data_dir, "resnet152_f16")
    with FeatureStoreWriter(f16_dir, *shape) as writer:
        for s in range(0, BANK_IMAGES, BATCH):
            ids = list(range(s, min(s + BATCH, BANK_IMAGES)))
            writer.append_batch(ids, rng.standard_normal(
                (len(ids), *shape), dtype=np.float32) * 0.5)
    int8 = quantize_store(f16_dir, os.path.join(data_dir, "resnet152_all"))
    return FeatureStore(f16_dir), int8


def int8_logits(engine, store, image_ids, ques) -> torch.Tensor:
    """The engine's model on the int8 feed of ``image_ids`` (dequantised on
    the card as ``aot.serving_forward`` does), with the lengths the engine
    counts: the logits the served answers are held against."""
    rows, scale = store.gather_quantized(image_ids)
    qs, qlen = engine._question_args(ques, None)
    n = len(image_ids)
    rows, scale, qs, qlen = engine._to_device([rows, scale, qs[:n], qlen[:n]])
    with torch.inference_mode():
        img = rows.to(torch.bfloat16) * scale[:, None, :].to(torch.bfloat16)
        return engine.model(img, qs, qlen)


def stream(engine, batches, counters: dict, after_warm_up=None) -> tuple:
    """One measured pass of ``batches`` (a function returning the stream)
    after a warm-up pass and ``after_warm_up()``: (predictions, seconds,
    launches). Each counter module is set to 0 just before the measured
    pass and read just after."""
    list(batches())
    torch.cuda.synchronize()
    if after_warm_up is not None:
        after_warm_up()
    for module in counters.values():
        module.launch_count = 0
    t0 = time.perf_counter()
    preds = [p for batch in batches() for p in batch]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return preds, seconds, {k: m.launch_count for k, m in counters.items()}


def bit_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(x.top_ids, y.top_ids)
        and np.array_equal(x.top_probs, y.top_probs) for x, y in zip(a, b))


def cache_state(cache) -> dict:
    return {"hits": cache.hits, "misses": cache.misses,
            "evictions": cache.evictions, "uploads": cache.uploads,
            "slots": dict(cache._slot)}


def replayed_state(cfg: Config, capacity: int, id_batches) -> dict:
    """The warm-up pass, ``reset_stats`` and the measured pass of the same
    ids through a second ``DeviceFeatureCache`` on the CPU (rows of one
    byte: the bookkeeping does not read them)."""
    cache = DeviceFeatureCache(cfg, capacity, num_regions=1, channels=1,
                               device="cpu")

    def fetch(ids):
        return np.zeros((len(ids), 1, 1), np.int8), np.zeros((len(ids), 1))

    for ids in id_batches:
        cache.ensure(ids, fetch)
    cache.reset_stats()
    for ids in id_batches:
        cache.ensure(ids, fetch)
    return cache_state(cache)


def miss_upload_fit(cfg: Config, dev) -> dict:
    """The device side of a batch of k misses, for k in MISS_COUNTS: one
    ``non_blocking`` copy of k int8 rows and f16 scales from pre-staged
    pinned host memory, then ``index_copy_`` into a bank (what
    ``DeviceFeatureCache._upload`` enqueues), timed by CUDA events, the
    median of MISS_REPS; fitted by least squares as ms = a + bytes / BW."""
    l, d = cfg.img_feature_dim, cfg.img_feature_channel
    kmax = max(MISS_COUNTS)
    bank = DeviceFeatureCache(cfg, kmax, device=dev)
    gen = torch.Generator().manual_seed(31)
    rows = torch.randint(-127, 128, (kmax, l, d), generator=gen,
                         dtype=torch.int8).pin_memory()
    scale = torch.rand((kmax, d), generator=gen).half().pin_memory()
    ms, moved = [], []
    for k in MISS_COUNTS:
        idx = torch.randperm(kmax, generator=gen)[:k].to(dev)

        def upload():
            bank.rows.index_copy_(0, idx, rows[:k].to(dev, non_blocking=True))
            bank.scale.index_copy_(0, idx,
                                   scale[:k].to(dev, non_blocking=True))

        upload()
        ms.append(float(np.median([time_ms(upload, 1)
                                   for _ in range(MISS_REPS)])))
        moved.append(k * (l * d + 2 * d))
    slope, a = np.polyfit(np.array(moved, np.float64), np.array(ms), 1)
    fit = {"a_ms": float(a), "bandwidth_gb_per_s": float(1e-6 / slope),
           "bytes_per_miss": l * d + 2 * d,
           "ms_by_misses": dict(zip(map(str, MISS_COUNTS), ms))}
    del bank, rows, scale
    return fit


def serve_bank_phase(cfg: Config, params, stores: tuple, dev,
                     smi: str) -> dict:
    """Phase 28: full-width bf16 mhb_coAtt served by id from the device
    feature cache (``predict_stream_by_id``) over N_BATCHES batches of
    BATCH, each image asked ~BANK_REUSE questions, at capacity BANK_SMALL
    (the eviction regime) and at BANK_IMAGES (after a warm-up pass and
    ``reset_stats``, every request a hit), beside the per-request f16 and
    int8 feeds (``predict_stream``) on the same requests. Gates: by id
    bit-equal to the int8 feed; K1 once a batch; hits + misses = requests,
    with the counts and slots of the same id sequence through a second
    cache on the CPU; a control: the first batch's slots swapped in pairs
    on the device must flip its answers. Then hieCoAtten by id (K4 once a
    batch, bit-equal to its int8 feed), and the fitted cost of a miss."""
    f16_store, store = stores
    image_ids, ques = bank_traffic(cfg)
    n_req = len(ques)
    spans = [slice(s, s + BATCH) for s in range(0, n_req, BATCH)]
    id_batches = [image_ids[s] for s in spans]
    fields, runs = {}, {}

    def f16_batches():
        return engine16.predict_stream(
            (f16_store.gather(image_ids[s], np.float16), ques[s], None)
            for s in spans)

    def int8_batches():
        def items():
            for s in spans:
                rows, scale = store.gather_quantized(image_ids[s])
                yield rows, ques[s], None, scale

        return engine.predict_stream(items())

    def by_id():
        return engine.predict_stream_by_id(
            (image_ids[s], ques[s], None) for s in spans)

    def rate(name, seconds, forward_ms, launches, **extra):
        fields[name] = dict(qa_pairs_per_s=n_req / seconds,
                            wall_ms_per_batch=seconds * 1e3 / N_BATCHES,
                            device_forward_ms_per_batch=forward_ms,
                            device_share=forward_ms * N_BATCHES
                            / (seconds * 1e3), launches=launches, **extra)

    engine16 = InferenceEngine(cfg, params, batch_size=BATCH, topk=5)
    preds16, seconds, launches = stream(engine16, f16_batches, {"K1": wqf})
    img, qs, qlen = engine16._to_device(
        [engine16._to_f16(f16_store.gather(id_batches[0], np.float16)),
         *engine16._question_args(ques[spans[0]], None)])
    with torch.inference_mode():
        forward_ms = time_ms(lambda: engine16._fwd(engine16.model, img, qs,
                                                   qlen), 3)
    rate("f16_feed", seconds, forward_ms, launches)
    del engine16, img
    torch.cuda.empty_cache()

    engine = InferenceEngine(cfg, params, batch_size=BATCH, topk=5,
                             input_dtype="int8")
    preds8, seconds, launches = stream(engine, int8_batches, {"K1": wqf})
    rows, scale = engine._to_device(list(store.gather_quantized(
        id_batches[0])))
    with torch.inference_mode():
        forward_ms = time_ms(lambda: engine._fwd(engine.model, rows, scale,
                                                 qs, qlen), 3)
    rate("int8_feed", seconds, forward_ms, launches)
    del rows, scale

    k1_launches, caches = 0, {}
    for name, capacity in (("by_id_capacity_512", BANK_SMALL),
                           ("by_id_hit_rate_1", BANK_IMAGES)):
        cache = engine.attach_feature_cache(capacity, store.gather_quantized)
        preds, seconds, launches = stream(engine, by_id, {"K1": wqf},
                                          after_warm_up=cache.reset_stats)
        state = cache_state(cache)
        k1_launches += launches["K1"]
        same_as_cpu = state == replayed_state(cfg, capacity, id_batches)
        idx = engine._to_device([cache.ensure(id_batches[0],
                                              store.gather_quantized)
                                 .astype(np.int64)])[0]
        with torch.inference_mode():
            forward_ms = time_ms(lambda: engine._fwd_bank(
                engine.model, cache.rows, cache.scale, idx, qs, qlen), 3)
        state.pop("slots")
        rate(name, seconds, forward_ms, launches, capacity=capacity,
             hit_rate=state["hits"] / n_req, **state,
             counts_and_slots_equal_cpu_cache=same_as_cpu,
             bit_equal_to_int8_feed=bit_equal(preds, preds8))
        if not bit_equal(preds, preds8):
            raise AssertionError(f"serve_bank: {name}'s answers are not "
                                 "bit-equal to the int8 feed's")
        if launches["K1"] != N_BATCHES:
            raise AssertionError(f"serve_bank: K1 launched "
                                 f"{launches['K1']} times in {N_BATCHES} "
                                 "batches")
        if state["hits"] + state["misses"] != n_req or not same_as_cpu:
            raise AssertionError(f"serve_bank: {name}: hits + misses != "
                                 "requests, or the counts or slots differ "
                                 "from the CPU cache's")
        caches[name] = cache
    if fields["by_id_hit_rate_1"]["misses"] != 0 or \
            fields["by_id_capacity_512"]["evictions"] == 0:
        raise AssertionError("serve_bank: a warm full-capacity bank missed, "
                             "or the small one never evicted")

    # control: the first batch's distinct slots swapped in pairs on the
    # card; the answers of its requests must flip against the logits of
    # their own features (one bf16 ulp, ``flips``), and swapping back must
    # restore them bit for bit
    cache = caches["by_id_hit_rate_1"]
    first = engine.predict_batch_by_id(id_batches[0], ques[spans[0]])
    slots = np.array(sorted({cache._slot[int(i)] for i in id_batches[0]}))
    slots = slots[: len(slots) // 2 * 2]
    a = torch.as_tensor(slots[0::2], device=dev)
    b = torch.as_tensor(slots[1::2], device=dev)

    def swap():
        for bank in (cache.rows, cache.scale):
            ra, rb = bank.index_select(0, a), bank.index_select(0, b)
            bank.index_copy_(0, a, rb)
            bank.index_copy_(0, b, ra)

    swap()
    swapped = engine.predict_batch_by_id(id_batches[0], ques[spans[0]])
    swap()
    again = engine.predict_batch_by_id(id_batches[0], ques[spans[0]])
    logits = int8_logits(engine, store, id_batches[0], ques[spans[0]])
    control = flips(logits, torch.as_tensor(
        [p.answer_id for p in swapped], device=dev)) / BATCH
    served_flips = flips(logits, torch.as_tensor(
        [p.answer_id for p in first], device=dev))
    fields["slot_swap_control_flip_share"] = control
    fields["flips_vs_int8_forward_first_batch"] = served_flips
    if control < 10 * MAX_FLIP_RATE or served_flips or \
            not bit_equal(again, first):
        raise AssertionError("serve_bank: the slot-swap control is not "
                             "seen, or the served answers are not the "
                             "forward's")
    del engine, cache, caches
    torch.cuda.empty_cache()

    # hieCoAtten by id: K4 once a batch, bit-equal to its int8 feed
    hie_cfg = Config(model_name="hieCoAtten")
    hie_params = hie_served_params(hie_cfg)
    engine = InferenceEngine(hie_cfg, hie_params, batch_size=BATCH, topk=5,
                             input_dtype="int8")
    preds8, _, _ = stream(engine, int8_batches, {"K4": co})
    engine.attach_feature_cache(BANK_IMAGES, store.gather_quantized)
    preds, seconds, launches = stream(engine, by_id, {"K4": co})
    fields["hiecoatten_by_id"] = dict(
        launches=launches, qa_pairs_per_s=n_req / seconds,
        bit_equal_to_int8_feed=bit_equal(preds, preds8))
    if launches["K4"] != N_BATCHES or not bit_equal(preds, preds8):
        raise AssertionError("serve_bank: hieCoAtten by id did not launch "
                             "K4 once a batch, or is not its int8 feed's")
    del engine
    torch.cuda.empty_cache()

    fields["miss_upload"] = miss_upload_fit(cfg, dev)
    say("serve_bank", model="mhb_coAtt", requests=n_req, batch=BATCH,
        images=BANK_IMAGES, questions_per_image=BANK_REUSE,
        distinct_images=int(len(np.unique(image_ids))), **fields, card=smi)
    return {"K1": k1_launches, "K4": launches["K4"]}


def hie_served_params(hie_cfg: Config) -> dict:
    """hieCoAtten's weights of the serving phases: whv, whq and the
    question embedding at 8x xavier, so both attention maps are peaked."""
    params = hiecoatten.init_params(hie_cfg, torch.Generator().manual_seed(1))
    for key, leaf in (("fc_Whv", "w"), ("fc_Whq", "w"),
                      ("que_emb", "table")):
        params[key][leaf] = params[key][leaf] * 8.0
    return params


def http_vocab(cfg: Config) -> tuple:
    """A vocab of ``Config()``'s sizes (words ``w<i>`` for token i,
    answers ``a<i>``), and the text of a question's token ids."""
    words = [f"w{i}" for i in range(1, cfg.q_vocab_size - 1)]
    q_vocab = {w: i for i, w in enumerate(words, 1)}
    q_vocab["UNK"] = cfg.q_vocab_size - 1
    vocab = {"question_vocab": q_vocab,
             "answer_vocab": {f"a{i}": i for i in range(cfg.a_vocab_size)},
             "max_question_length": cfg.max_question_length}
    return vocab, lambda row: " ".join(f"w{t}" for t in row if t)


def http_args(ws: str, **kw) -> argparse.Namespace:
    base = dict(model_name="mhb_coAtt", model_dir=os.path.join(ws, "models"),
                data_dir=os.path.join(ws, "data"), vocab=None,
                feature_type="resnet152", version=2,
                num_answer=1000, batch_size=BATCH, topk=5,
                max_wait_ms=HTTP_WAIT_MS, device_cache_images=BANK_IMAGES,
                device="cuda")
    base.update(kw)
    return argparse.Namespace(**base)


def post(url: str, payload, path: str = "/predict") -> tuple:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@contextlib.contextmanager
def http_server(service):
    """``service`` behind ``ThreadingHTTPServer`` on 127.0.0.1, a free
    port; shut down and closed on exit."""
    import threading

    httpd = serve_cli.VqaHTTPServer(
        ("127.0.0.1", 0), serve_cli.make_handler(service, "mhb_coAtt"))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)


def serve_http_phase(cfg: Config, params, store, ws: str, dev,
                     smi: str) -> int:
    """Phase 29: the port's ``cli.serve`` in process: ``build_service``
    (the model saved by ``checkpoint.save_weights`` into ``<ws>/models``
    and loaded back, a vocab of ``Config()``'s sizes, the int8 store with
    ``device_cache_images``, batch BATCH, ``max_wait_ms`` HTTP_WAIT_MS)
    behind ``ThreadingHTTPServer``; 2048 questions from HTTP_CLIENTS
    concurrent clients, half as single /predict requests and half as bulk
    calls of HTTP_BULK. Gates: every answer within ``flips`` of the int8
    forward's logits (the bit-equal share with ``predict_batch_by_id`` of a
    second engine on the same weights printed), bulk order kept (each item
    held against its own request), /healthz and /metrics counting the
    requests and the bank's hits and misses, an unknown id 400, K1 launches
    equal to the engine calls. Returns K1's launches."""
    image_ids, ques = bank_traffic(cfg)
    n_req = len(ques)
    vocab, text = http_vocab(cfg)
    with open(os.path.join(ws, "data", "qa_v2_1000answers_all.vocab.json"),
              "w") as f:
        json.dump(vocab, f)
    model = load_jax_params(get_model(cfg.model_name)(cfg), params)
    ckpt.save_weights(os.path.join(ws, "models", cfg.model_name),
                      model.state_dict())
    del model
    service = serve_cli.build_service(http_args(ws))
    items = [{"image_id": int(i), "question": text(q)}
             for i, q in zip(image_ids, ques)]
    n_single = n_req // 2
    bulks = [list(range(s, min(s + HTTP_BULK, n_req)))
             for s in range(n_single, n_req, HTTP_BULK)]
    spec_path = os.path.join(ws, "http_load.json")
    script = os.path.join(ws, "http_load.py")
    with open(script, "w") as f:
        f.write(HTTP_LOAD)
    with http_server(service) as url:
        post(url, items[0])  # warm-up: one single and one bulk call
        post(url, {"requests": items[:HTTP_BULK]})
        torch.cuda.synchronize()
        service.bank.reset_stats()
        before = service.stats.snapshot()
        wqf.launch_count = 0
        with open(spec_path, "w") as f:
            json.dump({"url": url, "items": items, "n_single": n_single,
                       "bulks": bulks, "clients": HTTP_CLIENTS}, f)
        # the clients run in a process of their own, as users' would: in
        # this one they would share the server's interpreter lock
        subprocess.run([sys.executable, script, spec_path],
                       check=True, timeout=900)
        with open(spec_path + ".out") as f:
            load = json.load(f)
        out, seconds = load["out"], load["seconds"]
        k1 = wqf.launch_count
        snap = service.stats.snapshot()
        bank = {"hits": service.bank.hits, "misses": service.bank.misses,
                "evictions": service.bank.evictions}
        health = json.loads(urlread(url + "/healthz"))
        metrics = urlread(url + "/metrics")
        unknown, _ = post(url, {"image_id": 10 ** 9, "question": "w1"})
    del service
    torch.cuda.empty_cache()
    if load["errors"]:
        raise AssertionError(f"serve_http: {len(load['errors'])} requests "
                             f"failed, e.g. {load['errors'][:3]}")

    answers = {f"a{i}": i for i in range(cfg.a_vocab_size)}
    served = np.array([answers[r["answer"]] for r in out])
    ref = InferenceEngine(cfg, params, batch_size=BATCH, topk=5,
                          input_dtype="int8")
    ref.attach_feature_cache(BANK_IMAGES, store.gather_quantized)
    n_flips = n_equal = 0
    for s in range(0, n_req, BATCH):
        preds = ref.predict_batch_by_id(image_ids[s:s + BATCH],
                                        ques[s:s + BATCH])
        for r, p in zip(out[s:s + BATCH], preds):
            n_equal += ([answers[t["answer"]] for t in r["top"]]
                        == p.top_ids.tolist()
                        and [t["prob"] for t in r["top"]]
                        == p.top_probs.tolist())
        logits = int8_logits(ref, store, image_ids[s:s + BATCH],
                             ques[s:s + BATCH])
        n_flips += flips(logits, torch.as_tensor(served[s:s + BATCH],
                                                 device=dev))
    del ref
    torch.cuda.empty_cache()
    label = '{model="mhb_coAtt"}'
    metric = {ln.split(" ")[0]: float(ln.split(" ")[1])
              for ln in metrics.splitlines() if not ln.startswith("#")}
    batches = snap["batches"] - before["batches"]
    fields = dict(
        requests=n_req, clients=HTTP_CLIENTS, singles=n_single,
        bulk_calls=len(bulks), bulk_items=HTTP_BULK, batch=BATCH,
        max_wait_ms=HTTP_WAIT_MS, qa_pairs_per_s=n_req / seconds,
        seconds=seconds, client_latency=load["latency_ms"],
        request_latency=snap["request"],
        queue_wait=snap["queue_wait"], dispatch=snap["dispatch"],
        batch_occupancy=snap["batch_occupancy"], engine_calls=batches,
        launches={"K1": k1}, bank=bank, flips_vs_int8_forward=n_flips,
        flip_rate=n_flips / n_req, bit_equal_share=n_equal / n_req,
        healthz_requests=health["latency"]["requests"],
        metrics_bank_hits=metric.get(f"vqa_device_bank_hits_total{label}"),
        unknown_image_status=unknown, card=smi)
    say("serve_http", **fields)
    if n_flips / n_req > MAX_FLIP_RATE:
        raise AssertionError(f"serve_http: {n_flips} answers flip against "
                             "the engine's forward")
    if k1 != batches or batches < n_req // BATCH:
        raise AssertionError(f"serve_http: K1 launched {k1} times in "
                             f"{batches} engine calls")
    if bank["hits"] + bank["misses"] != n_req or \
            metric.get(f"vqa_device_bank_hits_total{label}") != bank["hits"]:
        raise AssertionError("serve_http: the bank's counters disagree")
    if health["latency"]["requests"] < n_req or unknown != 400 or \
            metric.get(f"vqa_requests_total{label}", 0) < n_req:
        raise AssertionError("serve_http: /healthz, /metrics or the "
                             "unknown-id status is wrong")
    return k1


def urlread(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=600) as resp:
        return resp.read().decode()


def torchvision_npz(trunk, path: str) -> None:
    """Write a random ``resnet.ResNetTrunk`` as torchvision's state dict
    (``.npz``, what ``--backbone_weights`` and ``--weights`` read): each
    folded scale as gamma with mean 0 and var 1 - eps."""
    sd = {}
    for mod_path, conv, bn in resnet._conv_bn_entries(trunk.stages):
        m = trunk.get_submodule(mod_path)
        sd[conv] = m.weight.detach().numpy()
        sd[bn + ".weight"] = m.scale.detach().numpy()
        sd[bn + ".bias"] = m.bias.detach().numpy()
        sd[bn + ".running_mean"] = np.zeros_like(sd[bn + ".bias"])
        sd[bn + ".running_var"] = np.full_like(sd[bn + ".bias"],
                                               1.0 - resnet.BN_EPS)
    np.savez(path, **sd)


def card_vs_cpu(fn, x: np.ndarray, dev) -> float:
    """max |card - CPU| / max |CPU| of ``fn(tensor)`` at f32 (TF32 off)."""
    with torch.inference_mode():
        want = fn(torch.from_numpy(x), "cpu").double()
        got = fn(torch.from_numpy(x).to(dev), dev).double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def backbone_phase(cfg: Config, params, ws: str, dev, smi: str) -> int:
    """Phase 30: ResNet-152 at full depth at 448 and VGG-19's pool4 tap at
    224, random weights from a seed, f32 on the card (TF32 off) against
    f32 on the CPU at N = BACKBONE_N (relative error < BACKBONE_REL_ERR,
    the bound of ``tests/test_torch_parity.py``); the extractor's serving
    dtype (bf16) on a batch of EXTRACT_BATCH: images/s. If PIL imports:
    one PNG through /predict_image (a server with ``--backbone_weights``)
    and through ``cli.predict`` (bf16, K1 once), each answer the top of
    the forward on that image's grid, and N_PNG PNGs through
    ``cli.extract_features`` (f32), whose store rows equal
    ``GridExtractor.from_bytes`` of each image to one f16 rounding.
    Without PIL it prints ``"pil": false`` and feeds the trunks uint8
    arrays. Returns K1's launches."""
    fields = {}
    rng = np.random.default_rng(30)
    trunk = resnet.random_params(torch.Generator().manual_seed(30))
    trunk.eval()
    x = rng.standard_normal((BACKBONE_N, 448, 448, 3)).astype(np.float32)

    def resnet_on(t, where):
        return trunk.to(where)(t, torch.float32)

    fields["resnet152_rel_err"] = card_vs_cpu(resnet_on, x, dev)
    vtrunk = vgg.random_params(torch.Generator().manual_seed(30)).eval()
    xv = rng.standard_normal((BACKBONE_N, 224, 224, 3)).astype(np.float32)

    def vgg_on(t, where):
        return vgg.grid_features(vtrunk.to(where), t, dtype=torch.float32)

    fields["vgg19_rel_err"] = card_vs_cpu(vgg_on, xv, dev)
    npz = os.path.join(ws, "resnet152.npz")
    torchvision_npz(trunk.cpu(), npz)
    del trunk, vtrunk

    # the serving dtype's rate: uint8 images through each extractor
    for name, size in (("resnet152", 448), ("vgg19", 224)):
        ex = GridExtractor(name, npz if name == "resnet152" else None,
                           device=dev)
        u8 = rng.integers(0, 256, (EXTRACT_BATCH, size, size, 3),
                          dtype=np.uint8)
        ex.batch(u8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            out = ex.batch(u8)
        torch.cuda.synchronize()
        seconds = (time.perf_counter() - t0) / 3
        fields[f"{name}_bf16_images_per_s"] = EXTRACT_BATCH / seconds
        fields[f"{name}_grid"] = list(out.shape[1:])
        del ex, out
    torch.cuda.empty_cache()
    try:
        from PIL import Image
    except ImportError:
        Image = None
    fields["pil"] = Image is not None
    k1 = 0
    if Image is not None:
        k1 = backbone_cli_checks(cfg, params, ws, npz, Image, dev, fields)
    say("backbone", batch=EXTRACT_BATCH, n=BACKBONE_N, **fields, card=smi)
    if max(fields["resnet152_rel_err"], fields["vgg19_rel_err"]) >= \
            BACKBONE_REL_ERR:
        raise AssertionError("backbone: the card's f32 trunks disagree with "
                             "the CPU's")
    if Image is not None:
        if fields["predict_image_flips"] or fields["predict_cli"]["flips"] \
                or k1 != 1:
            raise AssertionError("backbone: /predict_image or cli.predict "
                                 "is not the forward's answer, or K1 did "
                                 "not launch once")
        extracted = fields["extract_cli"]
        if extracted["rel_err"] > STORE_RTOL or \
                extracted["other_image_rel_err_control"] < 100 * STORE_RTOL:
            raise AssertionError("backbone: the extracted store's rows are "
                                 "not the extractor's")
    return k1


def backbone_cli_checks(cfg, params, ws, npz, Image, dev, fields) -> int:
    """The PIL half of phase 30; returns K1's launches in ``cli.predict``."""
    import io

    rng = np.random.default_rng(32)
    png_dir = os.path.join(ws, "png")
    os.makedirs(png_dir)
    pngs = []
    for i in range(N_PNG):
        arr = rng.integers(0, 256, (200 + 8 * i, 300, 3), dtype=np.uint8)
        path = os.path.join(png_dir, f"COCO_val2014_{i + 1:012d}.png")
        Image.fromarray(arr).save(path)
        with open(path, "rb") as f:
            pngs.append(f.read())
    vocab, text = http_vocab(cfg)
    question = text(traffic(cfg)[1][0])
    ex = GridExtractor("resnet152", npz, device=dev)

    engine = InferenceEngine(cfg, params, batch_size=1, topk=5, device=dev)

    def top_of(grid: np.ndarray, answer: int, int8: bool) -> int:
        """flips of ``answer`` against the forward on ``grid``, fed as the
        int8 feed (the server's int8 store) or as the f32 grid."""
        ids, qlen = engine._to_device(engine._question_args(
            np.asarray([tokens], np.int32), None))
        if int8:
            q, s, _ = quantize_features(grid)
            img = torch.from_numpy(q).to(dev).to(torch.bfloat16) * \
                torch.from_numpy(s).to(dev)[:, None, :].to(torch.bfloat16)
        else:
            img = torch.from_numpy(grid[None]).to(dev)
        with torch.inference_mode():
            logits = engine.model(img, ids, qlen)
        return flips(logits, torch.as_tensor([answer], device=dev))

    from vqa_attention_networks_tpu_torch.data.text import encode_question

    tokens = encode_question(question, vocab["question_vocab"],
                             cfg.max_question_length)
    grid = ex.from_bytes(pngs[0])
    answers = {f"a{i}": i for i in range(cfg.a_vocab_size)}
    service = serve_cli.build_service(http_args(
        ws, backbone_weights=npz, device_cache_images=0))
    import base64

    with http_server(service) as url:
        status, body = post(url, {"question": question, "image_b64":
                                  base64.b64encode(pngs[0]).decode()},
                            "/predict_image")
    del service
    if status != 200:
        raise AssertionError(f"backbone: /predict_image {status} {body}")
    fields["predict_image_flips"] = top_of(grid, answers[body["answer"]],
                                           int8=True)

    buf = io.StringIO()
    wqf.launch_count = 0
    with contextlib.redirect_stdout(buf):
        cli_predict.main([
            "--image_path", os.path.join(png_dir, "COCO_val2014_"
                                         f"{1:012d}.png"),
            "--model_name", cfg.model_name,
            "--model_dir", os.path.join(ws, "models"),
            "--vocab", os.path.join(ws, "data",
                                    "qa_v2_1000answers_all.vocab.json"),
            "--question", question, "--backbone", "resnet152",
            "--weights", npz, "--compute_dtype", "bfloat16",
            "--device", "cuda"])
    torch.cuda.synchronize()
    k1 = wqf.launch_count
    printed = [ln for ln in buf.getvalue().splitlines()
               if ln.startswith("Ans: ")][0][len("Ans: "):]
    fields["predict_cli"] = {"answer": printed, "launches": {"K1": k1},
                             "flips": top_of(grid, answers[printed],
                                             int8=False)}

    out_dir = os.path.join(ws, "extracted")
    with contextlib.redirect_stdout(io.StringIO()):
        cli_extract.main(["--split", "val", "--image_dir", png_dir,
                          "--output_dir", out_dir, "--batch_size",
                          str(N_PNG), "--weights", npz, "--dtype",
                          "float32", "--device", "cuda"])
    rows = FeatureStore(os.path.join(out_dir, "resnet152_val")).gather(
        list(range(1, N_PNG + 1)), np.float32)
    ex32 = GridExtractor("resnet152", npz, device=dev, dtype=torch.float32)
    want = np.stack([ex32.from_bytes(b) for b in pngs])
    err = np.abs(rows - want) / np.abs(want).max(axis=(1, 2), keepdims=True)
    other = np.abs(rows[1:] - want[:-1]).max() / np.abs(want).max()
    fields["extract_cli"] = {"images": N_PNG, "rel_err": float(err.max()),
                             "other_image_rel_err_control": float(other)}
    del engine, ex, ex32
    torch.cuda.empty_cache()
    return k1


def main() -> None:
    # phase 1: the device
    card_name, smi = card()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions: f32
    torch.backends.cudnn.allow_tf32 = False
    say("device", torch_name=card_name, nvidia_smi=smi,
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # phase 2: build, one nvcc per source, all started together
    names = ("stage1_coattention", "train_fusion", "coattention",
             "glimpse_attention", "pooled_fusion", "lstm_scan")
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build.build, names))
    for name, (path, seconds, log) in zip(names, built):
        ptxas = [ln.strip() for ln in log.splitlines()
                 if any(key in ln for key in ("registers", "spill", "arning",
                                              "(C75"))]
        say("build", kernel=name,
            library=str(path.relative_to(_build.BUILD_DIR.parents[1])),
            seconds=round(seconds, 2), arch="sm_90a", ptxas=ptxas)

    # phase 3: K1 against its plain version at production shapes
    cfg = Config()
    max_err = 0.0
    for n in (8, 256, 1024):
        img, q, sw = k1_inputs(n, seed=n, cfg=cfg, device=dev)
        got, z, h1 = wqf.stage1_coattention_cuda(img, q, sw,
                                                 intermediates=True)
        want, want_z, want_h1 = wqf.stage1_coattention_reference(
            img, q, sw, intermediates=True)
        again = wqf.stage1_coattention(img, q, sw)
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        ok = bool(within(got, want, img.shape[2]).all())
        z_ok, z_max, z_equal = scratch_diff(
            z * z.abs(), want_z * want_z.abs(), POOLED_ATOL, POOLED_RTOL)
        h1_ok, h1_max, h1_equal = scratch_diff(h1, want_h1, H1_ATOL, H1_RTOL)
        max_err = max(max_err, float(diff.max()))
        say("k1_check", n=n, max_abs_diff=float(diff.max()),
            mean_abs_diff=float(diff.mean()), within_tolerance=ok,
            pooled_max_abs_diff=z_max, z_bit_equal_share=z_equal,
            h1_max_abs_diff=h1_max, h1_bit_equal_share=h1_equal,
            uniform_rejected_share=uniform_rejected(img, want),
            rerun_bit_equal=bool(torch.equal(got, again.float())),
            finite=bool(torch.isfinite(got).all()))
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"N={n}")
        if not (z_ok and h1_ok):
            raise AssertionError(f"K1's z or h1 scratch disagrees with the "
                                 f"plain version at N={n}")
        if not torch.equal(got, again.float()):
            raise AssertionError("K1 is not deterministic across reruns")
        del img, q, sw, got, want, again, z, h1, want_z, want_h1

    # launches of each kernel on the main paths, summed over the served runs
    launches = {"K1": 0, "K4": 0, "K5": 0, "K7": 0}
    with tempfile.TemporaryDirectory() as tmp:
        store = make_synthetic_feature_store(tmp, list(range(N_IMAGES)))

        # phase 4: full-width mhb_coAtt served through predict_stream; the
        # co-attention weights drawn at the scale that peaks the attention
        # (xavier weights with zero biases leave it near uniform); control:
        # co_att_conv2 zeroed gives a uniform attention, what a K1 with a
        # dead fusion or hidden stage gives
        gen = torch.Generator().manual_seed(0)
        params = init_params(cfg, gen)
        params["co_att_conv1"]["w"] = torch.randn(cfg.mfb_out, 512,
                                                  generator=gen)
        params["co_att_conv2"]["w"] = 3.0 * torch.randn(512, 2, generator=gen)
        blind = dict(params, co_att_conv2={"w": torch.zeros(512, 2),
                                           "b": torch.zeros(2)})
        bf16_cfg = cfg.replace(compute_dtype="bfloat16")
        served = serve_phase(
            "serve", cfg, params, store, {"K1": wqf}, dev, smi,
            control=blind,
            info={"composed": bf16_cfg.replace(fast_path="composed")})
        launches["K1"] += served["launches"]["K1"]
        e2e = {"mhb_coAtt": served["qa_pairs_per_s"]}

        # phase 5: K1 times, on this card at its power limit
        times = {}
        for n in (BATCH, 1024):
            img, q, sw = k1_inputs(n, seed=n, cfg=cfg, device=dev)

            def kernel():
                wqf.stage1_coattention(img, q, sw)

            def plain():
                wqf.stage1_coattention_reference(img, q, sw)

            kernel(), plain()  # warm-up
            plain_a = time_ms(plain, 3)
            kernel_a = time_ms(kernel, 10)
            kernel_b = time_ms(kernel, 10)
            plain_b = time_ms(plain, 3)
            times[n] = ((kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2)
            if n == BATCH:
                _, l, d = img.shape
                c, g = sw.c1w.shape[1], sw.c2w.shape[1]
                k1_bound = bound(
                    nbytes(img, q, sw.w3, sw.b3, sw.c1w, sw.c1b, sw.c2w,
                           sw.c2b) + 2 * n * g * d,
                    {"bf16": 2 * n * l * (d * sw.o + sw.o * c + c * g
                                          + g * d),
                     "f32": 2 * n * sw.k * d * sw.o})  # the wq build
            # at N=256, each of K1's launches apart (device time)
            by_launch = device_ms_by_kernel(kernel) if n == BATCH else None
            say("k1_time", n=n, kernel_ms=times[n][0], plain_ms=times[n][1],
                kernel_runs_ms=[kernel_a, kernel_b],
                plain_runs_ms=[plain_a, plain_b],
                device_ms_by_launch=by_launch, card=smi)
            del img, q, sw
        say("e2e", model="mhb_coAtt", qa_pairs_per_s=e2e["mhb_coAtt"],
            batch=BATCH, requests=BATCH * N_BATCHES, card=smi)

        # phase 6: K2 against its plain version at production widths
        k2_err = {}
        for n in K2_NS:
            for rate in K2_RATES:
                for name, err in k2_check(n, rate, cfg, dev).items():
                    k2_err[name] = max(k2_err.get(name, 0.0), err)
        torch.cuda.empty_cache()

        # phase 7: training through the port's Solver (the K2 main path)
        bf16_train = Config(compute_dtype="bfloat16")
        train_params = init_params(bf16_train, torch.Generator().manual_seed(0))
        runs = [train_phase("train", bf16_train, train_params, store, smi,
                            TRAIN_STEPS, "K2")]
        torch.cuda.empty_cache()

        # phase 8: K2 times at the training batch, then one pre-pool
        # training step under the profiler
        k2_times, k2_bounds, k2_library = k2_time(cfg, dev, smi)
        torch.cuda.empty_cache()
        train_profile(bf16_train, train_params, store, smi)
        torch.cuda.empty_cache()

        # phase 9: K3 against its plain version at production widths
        k3_err = {}
        for n in K3_NS:
            for name, err in k3_check(n, cfg, dev).items():
                k3_err[name] = max(k3_err.get(name, 0.0), err)
        torch.cuda.empty_cache()

        # phase 10: pooled-site training of mhb_coAtt (the K3 main path)
        runs.append(train_phase(
            "train_pooled", bf16_train.replace(dropout_site="pooled"),
            train_params, store, smi, TRAIN_STEPS, "K3"))
        del train_params
        torch.cuda.empty_cache()

        # phase 11: mfb and mfb-multilayer training, quirk off, at the
        # pre-pool site (K2) and the pooled site (K3); then one quirk-on
        # step: the gradient-dead fusion
        for name, site, kernel in MFB_TRAIN_RUNS:
            mfb_cfg = Config(model_name=name, compute_dtype="bfloat16",
                             dropout_site=site, keep_reference_quirks=False)
            mfb_params = mfb.init_params(mfb_cfg,
                                         torch.Generator().manual_seed(3))
            runs.append(train_phase("train_mfb", mfb_cfg, mfb_params, store,
                                    smi, MFB_TRAIN_STEPS, kernel))
            if name == "mfb" and site == "pooled":
                dead_gradient_check(mfb_cfg, mfb_params, store)
            del mfb_params
            torch.cuda.empty_cache()
        train_launches = {
            kernel: {key: sum(r["launches"][kernel][key] for r in runs)
                     for key in counts}
            for kernel, counts in TRAIN_COUNTERS.items()}

        # phase 12: K3 times at the training batch
        k3_times, k3_bounds, k3_library = k3_time(cfg, dev, smi)
        torch.cuda.empty_cache()

        # phase 13: K4 against its plain version
        k4_err = max(k4_check(n, dev) for n in (8, BATCH))

        # phase 14: full-width hieCoAtten served; whv, whq and the question
        # embedding drawn at 8x xavier so both maps are peaked; control:
        # whv and whq zeroed give uniform maps
        hie_cfg = Config(model_name="hieCoAtten")
        hie_params = hiecoatten.init_params(
            hie_cfg, torch.Generator().manual_seed(1))
        for key, leaf in (("fc_Whv", "w"), ("fc_Whq", "w"),
                          ("que_emb", "table")):
            hie_params[key][leaf] = hie_params[key][leaf] * 8.0
        zero_att = {"w": torch.zeros(hie_cfg.embed_size, 1),
                    "b": torch.zeros(1)}
        served = serve_phase(
            "serve_hiecoatten", hie_cfg, hie_params, store, {"K4": co}, dev,
            smi, control=dict(hie_params, fc_Whv=zero_att, fc_Whq=zero_att))
        launches["K4"] += served["launches"]["K4"]
        e2e["hieCoAtten"] = served["qa_pairs_per_s"]
        torch.cuda.empty_cache()

        # phase 15: K5 against its plain version
        k5_err = max(k5_check(n, cfg, dev) for n in (8, BATCH))
        torch.cuda.empty_cache()

        # phase 16: mfb and mfb-multilayer served under VQA_FORCE_PALLAS
        # with the quirk off; the co-attention weights peak its softmax;
        # control: the fusion's weights zeroed (K5's output 0) gives a
        # uniform co-attention; then the quirk's dead fusion
        for name in ("mfb", "mfb-multilayer"):
            mfb_cfg = Config(model_name=name, keep_reference_quirks=False)
            gen = torch.Generator().manual_seed(2)
            mfb_params = mfb.init_params(mfb_cfg, gen)
            width = mfb_params["co_att_conv2"]["w"].shape[0]
            mfb_params["co_att_conv1"]["w"] = torch.randn(
                mfb_cfg.mfb_out, 1024, generator=gen)
            mfb_params["co_att_conv2"]["w"] = 3.0 * torch.randn(
                width, 2, generator=gen)
            if name == "mfb-multilayer":
                mfb_params["co_att_multiconv"]["w"] = torch.randn(
                    1024, 512, generator=gen) * (3.0 / 1024 ** 0.5)
            dead = dict(mfb_params, img_conv1d={
                "w": torch.zeros_like(mfb_params["img_conv1d"]["w"]),
                "b": torch.zeros_like(mfb_params["img_conv1d"]["b"])})
            with switches(VQA_FORCE_PALLAS="1"):
                served = serve_phase(f"serve_{name}", mfb_cfg, mfb_params,
                                     store, {"K5": gf}, dev, smi,
                                     control=dead)
                if name == "mfb":
                    dead_fusion_check(mfb_cfg, mfb_params, store, dev)
            launches["K5"] += served["launches"]["K5"]
            e2e[name] = served["qa_pairs_per_s"]
            del mfb_params, dead
            torch.cuda.empty_cache()

        # phase 17: K7 against its plain version at both call shapes
        k7_err = max(k7_check(shape, quirk, dev) for shape in K7_SHAPES
                     for quirk in (False, True))
        torch.cuda.empty_cache()

        # phase 18: mhb_coAtt with K7 (question glimpse, beside K1), then
        # composed with K5 and K7 (both glimpses)
        with switches(VQA_PALLAS_GLIMPSE="1"):
            served = serve_phase("serve_glimpse", cfg, params, store,
                                 {"K1": wqf, "K7": att}, dev, smi)
        for key in ("K1", "K7"):
            launches[key] += served["launches"][key]
        e2e["mhb_coAtt_glimpse"] = served["qa_pairs_per_s"]
        composed_cfg = cfg.replace(fast_path="composed")
        with switches(VQA_PALLAS_GLIMPSE="1", VQA_FORCE_PALLAS="1"):
            served = serve_phase("serve_composed", composed_cfg, params,
                                 store, {"K5": gf, "K7": att}, dev, smi)
        for key in ("K5", "K7"):
            launches[key] += served["launches"][key]
        e2e["mhb_coAtt_composed"] = served["qa_pairs_per_s"]
        torch.cuda.empty_cache()

        # phase 19: mhb, visLstm, iBOWIMG and attentionNet served (no
        # kernel on their paths)
        for name in FAMILIES_SERVED:
            e2e[name] = serve_family(name, store, dev, smi)["qa_pairs_per_s"]

        # phase 20: hieCoAtten and those four trained
        for name in FAMILIES_TRAINED:
            train_family(name, store, smi)
            torch.cuda.empty_cache()

    # phase 21: their f32 forwards on the card against the CPU's
    families_agree(dev)
    torch.cuda.empty_cache()

    # phase 22: K4, K5 and K7 against their plain versions at N=256
    a4 = k4_inputs(BATCH, 4, dev)
    n, l, e = a4[0].shape
    t = a4[1].shape[1]
    k4_bound = bound(nbytes(*a4) + 4 * n * (2 * e + l + t),
                     {"bf16": 2 * n * (3 * t * l * e + 2 * (l + t) * e)})
    k4_time = interleaved_ms(lambda: co.coattention_core_cuda(*a4),
                             lambda: co.coattention_core_reference(*a4), 10)
    k4_device = launch_ms(lambda: co.coattention_core_cuda(*a4))
    del a4
    a5 = k5_inputs(BATCH, 5, cfg, dev)
    k = cfg.mfb_factor
    w_bf16, b5, q5 = tf.operands(*a5[1:])
    n, l, d = a5[0].shape
    f = w_bf16.shape[1]
    k5_bound = bound(nbytes(a5[0], w_bf16, b5, q5) + 4 * n * l * (f // k),
                     {"bf16": 2 * n * l * d * f})
    k5_time = interleaved_ms(lambda: gf.inference_fusion_cuda(*a5, k),
                             lambda: gf.grid_fuse_reference(*a5, k))
    # for information: torch.matmul on the bare product img @ bf16(W),
    # which no path of the port calls
    flat = a5[0].reshape(-1, d)
    torch.matmul(flat, w_bf16)  # warm-up
    matmul_ms = time_ms(lambda: torch.matmul(flat, w_bf16), 10)
    del a5, w_bf16, b5, q5, flat
    torch.cuda.empty_cache()
    k7_times, k7_bounds, k7_launches = {}, {}, {}
    for shape_name, (n, p, c, a, d) in K7_SHAPES.items():
        a7 = k7_inputs((n, p, c, a, d), 7, dev)
        k7_bounds[shape_name] = bound(
            nbytes(a7[0], a7[1].to(torch.bfloat16), a7[2],
                   a7[3].to(torch.bfloat16), a7[4], a7[5]) + 2 * n * 2 * d,
            {"bf16": 2 * n * p * (c * a + a * 2 + 2 * d)})

        def kernel():
            return att.glimpse_attention_cuda(*a7, uniform_quirk=False)

        k7_times[shape_name] = interleaved_ms(
            kernel, lambda: att.glimpse_attention_reference(
                *a7, uniform_quirk=False), 10)
        # its two launches and the wrapper's cast of W1 apart
        k7_launches[shape_name] = device_ms_by_kernel(kernel)
        del a7
    for name, (run, bnd) in {"K4": (k4_time, k4_bound),
                             "K5": (k5_time, k5_bound),
                             **{f"K7_{s}": (k7_times[s], k7_bounds[s])
                                for s in K7_SHAPES}}.items():
        extra = {"matmul_ms": matmul_ms} if name == "K5" else {}
        if name == "K4":
            extra["device_ms"] = k4_device
        if name.startswith("K7_"):
            extra["device_ms_by_launch"] = k7_launches[name[3:]]
        say("time", kernel=name, n=BATCH, kernel_ms=run[0], plain_ms=run[1],
            kernel_runs_ms=run[2], plain_runs_ms=run[3], bound_ms=bnd[0],
            bound_by=bnd[1], **extra, card=smi)
    say("e2e_served", qa_pairs_per_s=e2e, batch=BATCH,
        requests=BATCH * N_BATCHES, card=smi)
    torch.cuda.empty_cache()

    # phase 23: K6 against its plain version at production widths
    k6_err = max(k6_check(n, cfg, dev) for n in K6_NS)
    torch.cuda.empty_cache()

    # phase 24: K6's path, its entry forward and backward
    launches["K6"] = k6_path(cfg, dev)
    torch.cuda.empty_cache()

    # phase 25: K8 against its plain version, then its path
    k8_err = max(k8_check(n, dev) for n in K8_NS)
    launches["K8"] = k8_path(dev)
    torch.cuda.empty_cache()

    # phase 26: K6 and K8 times, and cuDNN's LSTM beside K8
    k6_times, k6_bound = k6_time(cfg, dev, smi)
    k8_times, k8_bound, k8_library_ms = k8_time(dev, smi)
    torch.cuda.empty_cache()

    # phase 27: the command line, corpus to results files (K2 and K1)
    cli_launches = cli_phase(smi)
    launches["K1"] += cli_launches["K1"]
    for key, n in cli_launches["K2"].items():
        train_launches["K2"][key] += n
    torch.cuda.empty_cache()

    # phases 28-30 share one workspace: the stores, the vocab, the weights
    with tempfile.TemporaryDirectory() as ws:
        os.makedirs(os.path.join(ws, "data"))
        t0 = time.perf_counter()
        stores = bank_stores(os.path.join(ws, "data"), cfg)
        say("bank_store", images=BANK_IMAGES,
            seconds=time.perf_counter() - t0)

        # phase 28: mhb_coAtt (K1) and hieCoAtten (K4) served by id
        t0 = time.perf_counter()
        by_id = serve_bank_phase(cfg, params, stores, dev, smi)
        launches["K1"] += by_id["K1"]
        launches["K4"] += by_id["K4"]
        say("serve_bank_time", seconds=time.perf_counter() - t0)

        # phase 29: the HTTP server in process (K1)
        t0 = time.perf_counter()
        launches["K1"] += serve_http_phase(cfg, params, stores[1], ws, dev,
                                           smi)
        say("serve_http_time", seconds=time.perf_counter() - t0)

        # phase 30: the backbones, /predict_image, cli.predict (K1) and
        # cli.extract_features
        t0 = time.perf_counter()
        launches["K1"] += backbone_phase(cfg, params, ws, dev, smi)
        say("backbone_time", seconds=time.perf_counter() - t0)
        del stores

    def entry(name, source, replaces, n_launches, err, run, bnd,
              library_ms=None) -> dict:
        # library_ms: one PyTorch call beside the kernel: K8's computes its
        # function (torch.nn.LSTM); K2's and K3's d_img the bare product
        # over the operand, for information (K3's without the wq build)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": err, "ms": run[0], "plain_ms": run[1],
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    kernels = [entry("stage1_coattention", K1_SOURCE, K1_REPLACES,
                     launches["K1"], max_err, times[BATCH], k1_bound)]
    for launch, replaces in K2_REPLACES.items():
        kernels.append(entry(
            f"train_fusion_{launch}", K2_SOURCE, replaces,
            train_launches["K2"][launch],
            max(k2_err["d_w"], k2_err["d_b"], k2_err["d_b_partials"])
            if launch == "d_w" else k2_err[launch], k2_times[launch],
            k2_bounds[launch], k2_library.get(launch)))
    for launch, replaces in K3_REPLACES.items():
        kernels.append(entry(
            f"pooled_fusion_{launch}", K3_SOURCE, replaces,
            train_launches["K3"][launch],
            max(k3_err["d_w"], k3_err["d_b"], k3_err["d_q"])
            if launch == "d_w" else max(k3_err["g_pooled"], k3_err["d_bq"])
            if launch == "g_pooled" else k3_err[launch], k3_times[launch],
            k3_bounds[launch], k3_library.get(launch)))
    kernels += [
        entry("coattention", K4_SOURCE, K4_REPLACES, launches["K4"], k4_err,
              k4_time, k4_bound),
        entry("inference_fusion", K5_SOURCE, K5_REPLACES, launches["K5"],
              k5_err, k5_time, k5_bound),
        # both call shapes launch it; ms and bound at the co-attention's
        entry("glimpse_attention", K7_SOURCE, K7_REPLACES, launches["K7"],
              k7_err, k7_times["co_attention"], k7_bounds["co_attention"]),
        entry("wq_grid_fusion", K6_SOURCE, K6_REPLACES, launches["K6"],
              k6_err, k6_times, k6_bound),
        # one call of the scan: one persistent launch
        entry("lstm_scan", K8_SOURCE, K8_REPLACES, launches["K8"], k8_err,
              k8_times, k8_bound, library_ms=k8_library_ms),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name,
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
