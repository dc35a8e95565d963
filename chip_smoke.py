"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a): the
card's correctness gates. It times nothing: a kernel's time is
``vqa_attention_networks_tpu_torch/step_time.py``'s, an end-to-end rate
``port_bench``'s. Each kernel's inputs and tolerance are
``vqa_attention_networks_tpu_torch/ops/card_cases.py``'s.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards N   # phases 33-37 alone over N cards
    python3 chip_smoke.py --mcan      # phase 38 alone
    python3 chip_smoke.py --ban       # phase 39 alone

Phases, one line each (a failing phase raises and the exit code is not 0);
the numbers 5, 8, 12, 22 and 26, once timing phases, are left unused, so
that a number names the same phase in older records:

1. the device: torch's name for it, and nvidia-smi's name and power limit;
2. build the hand-written kernels from ``vqa_attention_networks_tpu_torch/
   csrc`` into ``build/kernels/`` and print ptxas's registers and spills;
3. K1 (stage-1 fusion + co-attention) against its plain PyTorch version on
   the card at production shapes, N = 8, 256 and 1024: max and mean |diff|,
   failing past the tolerance of ``card_cases.within``; the kernel's z and
   h1 scratch against the plain version's; and a control: the inputs peak the
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
    at batch 256 (2048 requests, each with its question length): the gate
    that every served answer is the top of the same forward (one bf16 ulp,
    ``flips``); for MHB the lengths used, and a control: with
    every length set to T the answers must change (the lengths reach it);
20. training of hieCoAtten (the composed chain with its five dropouts),
    mhb, visLstm, iBOWIMG and attentionNet through ``Solver.train``:
    full width, bf16, batch 64, 10 steps, then 10 on one repeated batch:
    finite losses, the repeated batch's loss
    falling, ``val()`` equal to a fresh load's, the batch norms' running
    statistics moved (iBOWIMG, attentionNet), no training kernel launched;
21. ``families_agree``: the f32 forward of each of those four families
    (eval, and training with dropout 0 and pad rows in ``valid``) and
    hieCoAtten's training forward, full width, N = 8, on the card and on
    the CPU (TF32 off), each against the same forward at f64 on the CPU:
    the card within 1e-5 of the largest |logit| (the bound of the CPU
    tests against JAX) or within 4x the CPU's own f32 error;
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
    share of predictions that differ, both accuracies);
28. ``serve_bank``: full-width bf16 mhb_coAtt (phase 4's weights) served
    by id from the device feature cache (``predict_stream_by_id``) over
    8 batches of 256 from an int8 store of 1,024 synthetic images
    (``quantize_store`` of an f16 store), each image asked ~3 questions:
    at capacity 512 (the eviction regime) and at 1,024 (after a warm-up
    pass and ``reset_stats``, every request a hit). Gates: the top-k ids
    and probabilities bit-equal to ``predict_stream`` with the
    per-request int8 feed; K1's three kernels once a batch, counted on
    the card in a CUDA profile of the measured pass (by id they run from
    a replay of the engine's CUDA graph, which no host call launches);
    hits + misses = requests, and the counts and slots equal those of the
    same id sequence through a second ``DeviceFeatureCache`` on the CPU;
    a control: the first batch's slots swapped in pairs on the card must
    flip its answers (``flips``) and swapping back restores them bit for
    bit; hieCoAtten by id, K4 once a batch on the card, bit-equal to its
    int8 feed;
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
    unknown image id 400, K1's kernels run on the card once an engine
    call (a CUDA profile of the load); the batch occupancy;
30. ``backbone``: ResNet-152 at full depth at 448 and VGG-19's pool4 tap
    at 224, random weights from a seed, f32 on the card (TF32 off)
    against f32 on the CPU at N = 2 (relative error < 1e-4), and each
    extractor at bf16 on a batch of 32 (its grid); if PIL imports, one
    PNG through /predict_image and through ``cli.predict`` (bf16, K1
    once), each answer the top of the forward on that image's grid, and
    8 PNGs through ``cli.extract_features``, whose store rows equal
    ``GridExtractor.from_bytes`` of each image to one f16 rounding
    (without PIL: ``"pil": false``, and the trunks take uint8 arrays);
31. ``train_switches`` (run after phase 20, on phase 4's store): the
    Solver's switches on full-width bf16 mhb_coAtt at the pre-pool site
    (K2), 10 steps an arm beside the plain run: gradient accumulation
    (a=2: K2 twice a step, within the training tolerance of its plain-K2
    arm; at f64 and dropout 0, one step's gradients against a=1's), remat
    (bit-equal parameters, K2's forward twice a step, the peak memory of
    both), the device feature bank on the f16 store and its int8 twin
    (bit-equal to each host feed), ``profile_steps=2`` (a trace that names K2's
    kernels) and ``debug_nans`` (a sound step passes, a NaN weight
    raises);
32. ``artifact`` (after phase 30, on phase 28's stores and requests):
    mhb_coAtt (phase 4's weights) and hieCoAtten exported at batch 256 for
    both feeds (``aot.save_serving_artifact``), served by
    ``InferenceEngine(artifact_dir=...)`` beside the eager engine: the
    answers bit-equal, K1 or K4 once per call on the card,
    ``fast_path_traced``;
33. ``dp_train`` (after phase 31, on phase 4's store): the data-parallel
    Solver, full-width bf16 mhb_coAtt at the pre-pool site, rate 0.1,
    global batch 64, 3 steps, against one process without a process group:
    (a) one NCCL rank; (b) two gloo ranks sharing the card (``chip_smoke.py
    --dp-rank``, a process each; NCCL refuses two ranks on one device),
    each launching K2 on its 32 rows. Each arm's gates (``dp_gates``): the
    losses within the training tolerance, the first step's gradient within
    ``DP_GRAD_RTOL`` of one process's, the masks gate (each rank's first K2
    mask, drawn by the kernel at the row offset the rank passed, is its
    rows of one process's), both ranks one model, K2's launches once a step
    by kind. Two controls on (b)'s ranks: rank 1 drawing at row0 = 0, which
    the masks gate must reject, and each rank's loss over its own valid
    rows, which the gradient gate must reject. Losses, gradient and
    parameter differences, K2's launches per rank (two ranks on one card:
    correctness, not scaling); only (a)'s and (b)'s launches reach the
    kernels line;
34. ``dp_serve``: phase 4's weights and 2048 requests through
    ``InferenceEngine(data_parallel=2)``, two replicas on ``cuda:0``,
    against ``data_parallel=1``: answers bit-equal, K1 twice a batch;
35. ``tp_train``: tensor parallelism at mesh (1, 2), two gloo ranks sharing
    ``cuda:0``: full-width bf16 mhb_coAtt, batch 64, the fusion
    projections split over the model axis, 3 steps at the pre-pool site
    (K2 on each rank's 2,500 columns, zero-padded to 2,520, at its
    ``col0``) and 2 at the pooled site (K3 on the padded shard), each
    against one process: ``dp_gates`` (losses, the gathered first-step
    gradient and its replicated layers' part, the masks gate by the kernel
    at each rank's ``row0`` and ``col0``, one model, K2's or K3's launches
    by kind); two controls that must fail: model rank 1 at col0 = 0 (the
    masks gate) and no all-reduce in ``model_input``'s backward (the
    replicated layers' gradient); each rank's ``val()`` (K1 once, on the
    gathered weights) equal to one process's on those weights; each
    rank's parameter, gradient and Adam bytes;
36. ``sharded_bank_train``: two data ranks (gloo, ``cuda:0``), phase 4's
    f16 store and its int8 twin, 2 steps from the host feed, the
    replicated bank and the sharded bank: the losses bit-equal across the
    three, each rank's bank bytes (half the store's);
37. ``sharded_bank_serve``: phase 4's weights and requests by id from the
    device cache split over ``InferenceEngine(data_parallel=2)``'s two
    replicas on ``cuda:0`` (int8 twin of phase 4's store), at capacity
    191 (rounded up to 192: evictions) and 256 (warm): answers bit-equal
    to one replica's cache, K1 once a shard, the counts and slots those of
    the same ids through a cache on the CPU;
38. ``mcan`` (after phase 32, on phase 28's int8 store): N1 (MCAN's fused
    residual + LayerNorm, ``ops/mcan_norm.py``) against its composed form
    at MCAN-large's three shapes at N = 256 (the grid, [50,176, 1,024]; the
    words, [3,584, 1,024]; the head, [256, 2,048]): within one bf16 ulp +
    2^-16 (``n1_within``), under 1% of outputs differing, bit-equal
    reruns; on rows of a spread of ~1e-3, where eps is not negligible, the
    same, and a control: a norm with eps under the root must be rejected
    on most outputs. N2 (MCAN's attention, ``ops/mcan_attention.py``) at
    MCAN-large's three attention shapes at N = 256, 16 heads ([196 x 196],
    [196 x 14], [14 x 14]), random key masks and sample 0's all masked:
    no further from the f32 composed attention than the composed bf16
    form plus one bf16 ulp (``n2_within``), bit-equal reruns.
    Then MCAN-large (``port_bench/configs/mcan_large.json``, random
    weights) served by id from the device feature cache
    (``predict_stream_by_id``, BANK_IMAGES images, 8 batches of 256)
    beside the per-request int8 feed on the same requests. Gates: by id
    bit-equal to the int8 feed; N1's kernel 31 and N2's 18 times a batch
    on the card in the CUDA profile of each measured pass (``stream``; by
    id from the replays of the engine's CUDA graph, one a batch); by id's
    answers within the MCAN cell's ``logit_err`` limit of the composed
    forward's logits (``reference_kernels=True``) on the same grids;
39. ``ban`` (after phase 38, on phase 28's int8 store): N3 (BAN's
    attention map, ``ops/ban_attention.py``) at N = 256 at BAN-8's shape
    ([196 cells x 14 words] x 8 glimpses, K = 3,840) and at the port's
    default widths (22 words x 6 glimpses, K = 3,072), random grid masks:
    each entry within one bf16 ulp of the map at the kernel's own rounding
    points and each glimpse summing to 1 (``n3_within``), bit-equal
    reruns, the map without h_bias within f32 rounding of the map with it,
    and three controls that must fail the tolerance (``n3_controls``: the
    mask ignored, each glimpse's max taken per word, a glimpse normalised
    per warpgroup). Then BAN-8 (``port_bench/configs/ban8.json``, the
    benchmark's weights from a seed) served by id beside the per-request
    int8 feed, as phase 38: by id bit-equal to the int8 feed, N3 once a
    batch on the card in each measured pass (by id one graph replay a
    batch), the by-id pass's memory above what it started from under one
    [256, 8, 196, 3,840] bf16 tensor (ban-vqa's h (x) av), and the
    answers' ``logit_err`` against the float32 reference under
    ``BAN_LOGIT_ERR``, over which the float8 control must read;

then a JSON line of the kernels (each with its source, the TPU kernel it
replaces, its launches on the main paths and its largest error against
its plain version), nvidia-smi's line, and as the last line
``{"ok": true, "device": {...}}``. ``--cards N``
runs phases 33-37 alone with a rank and a replica a card over NCCL (phase
35 at (N/2, 2)); ``--mcan`` runs phase 38 alone on a bank of its own and
prints N1's and N2's line of the kernels, ``--ban`` phase 39 alone and
N3's. A switch
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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from port_bench import inputs as bench_inputs
from port_bench.check import serve_numbers, top_k
from port_bench.reference import ban as ban_reference
from port_bench.reference import common as bench_common
from vqa_attention_networks_tpu_torch.aot import save_serving_artifact
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
from vqa_attention_networks_tpu_torch.ops import ban_attention
from vqa_attention_networks_tpu_torch.ops import card_cases as cc
from vqa_attention_networks_tpu_torch.ops import coattention as co
from vqa_attention_networks_tpu_torch.ops import grid_fusion as gf
from vqa_attention_networks_tpu_torch.ops import lstm as k8
from vqa_attention_networks_tpu_torch.ops import mcan_attention
from vqa_attention_networks_tpu_torch.ops import mcan_norm
from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf
from vqa_attention_networks_tpu_torch.ops import train_fusion as tf
from vqa_attention_networks_tpu_torch.ops import wq_fusion as wqf
from vqa_attention_networks_tpu_torch.ops import wq_grid_fusion as wqg
from vqa_attention_networks_tpu_torch.ops.card_cases import (
    BATCH,
    TRAIN_BATCH,
    card,
    k2_view,
    k2_within,
    k3_within,
    k4_within,
    k6_within,
    k7_within,
    k8_within,
    n1_within,
    n2_within,
    randn,
    within,
)
from vqa_attention_networks_tpu_torch.parallel.dryrun import (
    failures,
    run_processes,
)
from vqa_attention_networks_tpu_torch.serve import (
    DeviceFeatureCache,
    InferenceEngine,
)
from vqa_attention_networks_tpu_torch.train.feature_bank import dequantize
from vqa_attention_networks_tpu_torch.train.solver import Solver, init_params
from vqa_attention_networks_tpu_torch.utils import checkpoint as ckpt
from vqa_attention_networks_tpu_torch.weights import (
    load_jax_params,
    to_jax_params,
)

MAX_FLIP_RATE = 1e-3
N_BATCHES, N_IMAGES = 8, 256
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
K2_RATES, K2_NS = (0.1, 0.0), (8, 64)
TRAIN_STEPS = 20
# the kernel and plain training runs see the same weights, batches and
# masks and differ in the order of K2's f32 sums; bf16 roundings
# downstream and Adam's sign-like first steps amplify that, so their
# losses are held over the first steps only
TRAIN_AGREE_STEPS, TRAIN_LOSS_RTOL = 5, 1e-3
# data parallelism (phases 33-34): dp_train's steps an arm, each arm's
# ranks' deadline
DP_STEPS, DP_RANK_TIMEOUT = 3, 240.0
# tensor parallelism and the sharded banks (phases 35-37): the model axis,
# tp_train's pooled-site steps, sharded_bank_train's steps a feed,
# sharded_bank_serve's small capacity (rounded up to a multiple of the
# replicas)
TP_MODEL, TP_POOLED_STEPS = 2, 2
BANK_TRAIN_STEPS = 2
SHARDED_BANK_SMALL = 191
# a data-parallel arm's first-step gradient (after DDP's all-reduce) against
# one process's: the relative L2 norm of the difference. On an H100 the
# sound arms read 0 (one rank) and 2.6e-3 (two ranks: other summation
# orders, bf16 roundings); the controls 0.20 (rank 1's mask at row0 = 0)
# and 1.0 (each rank's loss over its own valid rows: twice the gradient,
# which Adam's near sign-like first steps hide from the parameters)
DP_GRAD_RTOL = 1e-2
K4_SOURCE = "vqa_attention_networks_tpu_torch/csrc/coattention.cu"
K4_REPLACES = "vqa_attention_networks_tpu/ops/pallas_coattention.py:106"
K5_SOURCE = K2_SOURCE  # train_fusion_inference_forward
K5_REPLACES = "vqa_attention_networks_tpu/ops/pallas_fusion.py:85"
K7_SOURCE = "vqa_attention_networks_tpu_torch/csrc/glimpse_attention.cu"
K7_REPLACES = "vqa_attention_networks_tpu/ops/pallas_attention.py:67"
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
K6_GRAD_N = 64
# K8's check keeps the gate pre-activations off the sigmoid's flat tails
# (|x| < K8_LIVE on at least K8_LIVE_SHARE of them), where a wrong gate
# would be invisible
K8_LIVE, K8_LIVE_SHARE = 3.0, 0.5
# the cli phase: tools/gen_corpus.py's questions (train, val), prepare's
# --num_answer (more than the corpus's answers), 2 epochs of batch
# TRAIN_BATCH with a checkpoint every CLI_EVERY steps, and the mid-epoch
# checkpoint a second workspace resumes from
CLI_CORPUS, CLI_NUM_ANSWER = (640, 192), 1000
CLI_EPOCHS, CLI_EVERY, CLI_RESUME_STEP = 2, 4, 12
# serving by id (phase 28) and over HTTP (29): BANK_IMAGES synthetic images
# at 196 x 2048 in an int8 store, each asked ~BANK_REUSE questions; the
# eviction regime's capacity; HTTP_CLIENTS concurrent clients, bulk calls
# of HTTP_BULK items, the batching window
BANK_IMAGES, BANK_REUSE, BANK_SMALL = 1024, 3, 512
HTTP_CLIENTS, HTTP_BULK, HTTP_WAIT_MS = 64, 16, 5.0
# the Solver's switches (31): steps an arm; a=2's f64 gradients against
# a=1's, each within SWITCH_GRAD_RTOL of its largest value plus
# SWITCH_GRAD_ATOL of the model's largest gradient (the same mean of the
# same products, summed over 64 rows or over two halves of 32: f64
# summation order, ~1e-13 of the terms; the atol holds the gradients that
# are 0 up to rounding). At f32, summation noise on those is a large share
# of their own largest value (PERF.md); K2's kernels by name
SWITCH_STEPS = 10
SWITCH_GRAD_RTOL, SWITCH_GRAD_ATOL = 1e-9, 1e-9
K2_KERNELS = ("fwd_kernel", "g_prod_kernel", "d_w_gemm_kernel",
              "d_q_kernel")
# the backbones (30): images on the card at f32 against the CPU, the bound
# of tests/test_torch_parity.py, the extractor's batch, the PNGs through the
# CLIs, and one f16 rounding of an f32 grid (the extracted store)
BACKBONE_N, BACKBONE_REL_ERR, EXTRACT_BATCH, N_PNG = 2, 1e-4, 32, 8
STORE_RTOL = 2.0 ** -10
# the HTTP load of phase 29, a stdlib script run in a process of its own:
# argv[1] names a JSON spec (url, items, the singles' count, the bulk calls'
# item positions, the clients); it writes <spec>.out with every result in
# the items' order and the failed requests
HTTP_LOAD = r"""
import json, sys, urllib.error, urllib.request
from concurrent.futures import ThreadPoolExecutor

with open(sys.argv[1]) as f:
    spec = json.load(f)
url, items, clients = spec["url"], spec["items"], spec["clients"]
out, errors = [None] * len(items), []


def post(payload):
    req = urllib.request.Request(url + "/predict", json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        errors.append([e.code, e.read().decode(errors="replace")[:200]])
    except OSError as e:  # a refused or reset connection
        errors.append([type(e).__name__, str(e)])
    return None


def client(c):
    for pos in range(c, spec["n_single"], clients):
        out[pos] = post(items[pos])
    for chunk in spec["bulks"][c::clients]:
        body = post({"requests": [items[p] for p in chunk]})
        for pos, result in zip(chunk, body["results"] if body else []):
            out[pos] = result


with ThreadPoolExecutor(clients) as pool:
    list(pool.map(client, range(clients)))
if any(r is None for r in out):
    errors.append("missing results")
with open(sys.argv[1] + ".out", "w") as f:
    json.dump({"out": out, "errors": errors}, f)
"""


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


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


def k2_launches(img, w_bf16, b, q, g, seed, rate) -> dict:
    """Every K2 launch once; the backward ones on the kernel's own forward
    output, d_img and d_W/d_b over one g_prod build, as the backward runs
    them."""
    got = {"forward": tf.forward_cuda(img, w_bf16, b, q, seed, cc.K, rate)}
    args = (g, got["forward"], img, w_bf16, b, q, seed, cc.K, rate)
    got["g_prod"], got["d_b_partials"] = tf.g_prod_cuda(*args)
    got["d_img"] = tf.d_img_from_operand_cuda(got["g_prod"], w_bf16,
                                              *img.shape[:2])
    got["d_w"], got["d_b"] = tf.d_w_from_operand_cuda(
        img, got["g_prod"], got["d_b_partials"])
    got["d_q"] = tf.d_q_cuda(*args)
    return got


def k2_plain(img, w_bf16, b, q, g, out, keep) -> dict:
    """The plain version of every K2 launch; the backward ones on ``out``."""
    want = {"forward": tf.forward_reference(img, w_bf16, b, q, cc.K, keep),
            "d_img": tf.d_img_reference(g, out, w_bf16, q, cc.K, keep)}
    want["g_prod"], want["d_b_partials"] = tf.g_prod_reference(
        g, out, q, cc.K, keep)
    want["d_w"], want["d_b"] = tf.d_w_reference(g, out, img, q, cc.K, keep)
    want["d_q"] = tf.d_q_reference(g, out, img, w_bf16, b, cc.K, keep)
    return want


def k2_check(n: int, rate: float, device) -> dict:
    """K2 at production widths against its plain version, with controls;
    raises on a failure. Returns max |diff| per launch."""
    img, w, b, q, g = cc.k2_inputs(n, 100 + n, device)
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
        zero |= ~mask.reshape(*out.shape, cc.K).any(-1)
    zero[0, 0, :cc.K2_FORCED_ZEROS] = True
    dropped = int(zero.sum())
    forced = min(cc.K2_FORCED_ZEROS, out.shape[-1])
    expect = rate ** cc.K * (out.numel() - forced) + forced
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
    no_rule_w, no_rule_b = tf.d_w_reference(g, clamped, img, qf, cc.K, keep)
    no_rule_img = tf.d_img_reference(g, clamped, w_bf16, qf, cc.K, keep)
    controls = {
        "d_w_d_b_without_zero_rule_rejected": not bool(
            k2_within("d_w", no_rule_w, want["d_w"]).all()
            and k2_within("d_b", no_rule_b, want["d_b"]).all()),
        "d_img_without_zero_rule_rejected": not bool(
            k2_within("d_img", no_rule_img, want["d_img"]).all()),
    }
    if rate > 0:
        other = tf.forward_reference(img, w_bf16, bf, qf, cc.K, tf.keep_scale(
            tf.dropout_mask(seed + 1, n, l, f, rate, device), rate))
        controls["other_seed_rejected_share"] = 1.0 - float(
            k2_within("forward", other, want["forward"]).float().mean())
        no_mask = tf.d_w_reference(g, out, img, qf, cc.K, None)[0]
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


def k3_launches(img, w_bf16, b, q, g) -> dict:
    """Every K3 launch once; the backward ones on the kernel's own forward
    output, d_img and d_W/d_b/d_q over one g_pooled build, as the backward
    runs them."""
    got = {"forward": pf.forward_cuda(img, w_bf16, b, q, cc.K)}
    args = (g, got["forward"], img, w_bf16, b, q, cc.K)
    got["g_pooled"], got["d_bq"] = pf.g_pooled_cuda(*args)
    got["d_img"] = pf.d_img_from_gp_cuda(got["g_pooled"], img, w_bf16, b, q,
                                         cc.K)
    got["d_w"], got["d_b"], got["d_q"] = pf.d_w_from_gp_cuda(
        got["g_pooled"], got["d_bq"], img, w_bf16, b, q, cc.K)
    return got


def k3_plain(img, w_bf16, b, q, g, out) -> dict:
    """The plain version of every K3 launch; the backward ones on ``out``."""
    want = {"forward": pf.forward_reference(img, w_bf16, b, q, cc.K),
            "d_img": pf.d_img_reference(g, out, w_bf16, q, cc.K)}
    want["g_pooled"], want["d_bq"] = pf.g_pooled_reference(g, out)
    want["d_w"], want["d_b"], want["d_q"] = pf.d_w_reference(
        g, out, img, w_bf16, b, q, cc.K)
    return want


def k3_check(n: int, device) -> dict:
    """K3 at production widths against its plain version, with controls;
    raises on a failure. Returns max |diff| per launch. The inputs are
    K2's (region 0 of sample 0 is all zeros and the bias of the first
    card_cases.K2_FORCED_ZEROS outputs is 0, so they pool to exactly 0 in
    that row), and the last K3_DEAD_OUTPUTS outputs, at the ragged edge of
    every O tile, have zero weights and bias, so they pool to exactly 0 in
    every row: the places where g_pooled's zero rule acts."""
    img, w, b, q, g = cc.k2_inputs(n, 300 + n, device)
    dead = slice(w.shape[1] - K3_DEAD_OUTPUTS * cc.K, None)
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
    forced[0, 0, :cc.K2_FORCED_ZEROS] = True
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
    perm = pf.forward_reference(img, w_bf16, bf, qb.roll(1, 0), cc.K)
    other_q = pf.d_w_reference(g, out, img, w_bf16, bf, qb.roll(1, 0),
                               cc.K)[0]
    clamped = torch.where(out == 0, torch.full_like(out, 1e-20), out)
    no_rule_w, no_rule_b, _ = pf.d_w_reference(g, clamped, img, w_bf16, bf,
                                               qb, cc.K)
    no_rule_img = pf.d_img_reference(g, clamped, w_bf16, qb, cc.K)
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


def served_params(cfg: Config, gen: torch.Generator) -> dict:
    """Phase 4's mhb_coAtt weights, drawn from ``gen``: the co-attention's
    at the scale that peaks the attention (xavier weights with zero biases
    leave it near uniform)."""
    params = init_params(cfg, gen)
    params["co_att_conv1"]["w"] = torch.randn(cfg.mfb_out, 512,
                                              generator=gen)
    params["co_att_conv2"]["w"] = 3.0 * torch.randn(512, 2, generator=gen)
    return params


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
    Raises on a failed gate; returns the launches."""
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
    preds = [p for batch in engine.predict_stream(batches()) for p in batch]
    torch.cuda.synchronize()
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
    fields = dict(model=cfg.model_name, requests=n_req, batch=BATCH,
                  launches=launches, flips_vs_plain=n_flips,
                  flip_rate=n_flips / n_req,
                  argmax_differs_info_only=n_argmax,
                  distinct_answers=int(len(np.unique(answers))), card=smi)
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
    return launches


def k4_check(n: int, dev) -> float:
    """K4 against its plain version with its controls; raises on a
    failure. Returns the largest |diff| over (v, q, av, aq)."""
    args = cc.k4_inputs(n, 40 + n, dev)
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
    say("k4_check", n=n, **cc.K4_SHAPE, av_max_mean=av_peak,
        uniform_av=1.0 / cc.K4_SHAPE["l"], **fields)
    if failed:
        raise AssertionError(f"K4 disagrees with its plain version on "
                             f"{failed} at N={n}")
    if av_peak < 10.0 / cc.K4_SHAPE["l"]:
        raise AssertionError("the K4 inputs do not peak the region softmax")
    if min(rec["uniform_control_rejected_share"] for rec in fields.values()
           if isinstance(rec, dict)) < 0.5:
        raise AssertionError("the K4 check does not reject uniform maps")
    return max_abs


def k5_check(n: int, dev) -> float:
    """K5 against grid_fuse_reference, bit-equal reruns, and the control
    (q permuted across samples); raises on a failure. Returns max |diff|
    of the output."""
    img, w, b, q = cc.k5_inputs(n, 50 + n, dev)
    k = cc.K
    got = gf.inference_fusion_cuda(img, w, b, q, k)
    again = gf.inference_fusion_cuda(img, w, b, q, k)
    want = gf.grid_fuse_reference(img, w, b, q, k)
    torch.cuda.synchronize()
    pooled, want_pooled = got * got.abs(), want * want.abs()
    tol = cc.K5_RTOL * want_pooled.abs().max()
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


def k7_check(shape_name: str, quirk: bool, dev) -> float:
    """K7 against its plain version at one call shape and quirk mode, with
    the uniform-pool control; raises on a failure. Returns max |diff|."""
    shape = cc.K7_SHAPES[shape_name]
    n, _, _, _, d = shape
    args = cc.k7_inputs(shape, 70, dev)
    got = att.glimpse_attention_cuda(*args, uniform_quirk=quirk)
    again = att.glimpse_attention_cuda(*args, uniform_quirk=quirk)
    want = att.glimpse_attention_reference(*args, uniform_quirk=quirk)
    torch.cuda.synchronize()
    g, w = got.float().reshape(n, 2, d), want.float().reshape(n, 2, d)
    tol = cc.K7_RTOL_ROW * w.abs().amax(-1, keepdim=True)
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
    """``Solver.train`` from ``params``: per-step losses, the launch counts
    of K2 and K3 in the run (each set to 0 just before it), and the
    solver."""
    solver = Solver(cfg, qa, store, params=params, **solver_kw)
    losses = []
    for counts in TRAIN_COUNTERS.values():
        for name in counts:
            counts[name] = 0
    solver.train(on_step=lambda step, loss: losses.append(loss))
    return {"losses": [float(x) for x in losses],
            "launches": {k: dict(v) for k, v in TRAIN_COUNTERS.items()},
            "solver": solver}


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
        peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20, card=smi)
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


def serve_family(name: str, store, dev, smi: str) -> None:
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
    preds = [p for b in engine.predict_stream(batches(qlen)) for p in b]
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
    fields = dict(model=name, requests=n_req, batch=BATCH,
                  kernels_on_path="none", flips_vs_direct_forward=n_flips,
                  distinct_answers=int(len(np.unique(answers))))
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
    say(f"train_{name}", model=name, steps=steps, batch=TRAIN_BATCH,
        compute_dtype="bfloat16", losses=run["losses"],
        repeated_batch_losses=r_loss,
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


def k6_check(n: int, dev) -> float:
    """K6 at production widths against its plain version, with its two
    controls; raises on a failure. Returns max |diff| of the output."""
    img, w, b, q = cc.k6_inputs(n, 60 + n, dev)
    k = cc.K
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


def k6_path(dev) -> int:
    """K6's path: its entry ``wq_grid_fuse``, forward (the kernel) and
    backward (the composed chain's VJP), at N = K6_GRAD_N, with its launch
    count set to 0 just before; the gradients against
    ``composed_reference``'s on the card. Raises on a failure; returns the
    launches."""
    img, w, b, q = cc.k6_inputs(K6_GRAD_N, 61, dev)
    args = [x.float().requires_grad_(True) if i else x.requires_grad_(True)
            for i, x in enumerate((img, w, b, q))]
    k = cc.K
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
        ok &= (rel <= cc.K6_GRAD_RTOL and fields[name]["finite"]
               and dtype == x.dtype)
    say("k6_path", entry="wq_grid_fuse", n=K6_GRAD_N, launches=launches,
        gradients=fields)
    if launches != 1:
        raise AssertionError(f"K6 launched {launches} times on its path")
    if not ok:
        raise AssertionError("K6's backward disagrees with the composed "
                             "chain's VJP")
    return launches


def k8_steps_rejected(out: torch.Tensor, xp: torch.Tensor,
                      w_hh: torch.Tensor) -> float:
    """Control: the share of ``out`` (a faulty scan's output) whose steps
    the check rejects."""
    forced = k8.lstm_scan_reference(xp, w_hh, h_carry=out)
    return 1.0 - float(k8_within(out, forced).float().mean())


def k8_check(n: int, dev) -> float:
    """K8's scan against its plain version, step by step and run free, with
    its controls; raises on a failure. Returns the free-running max |diff|."""
    x, w_ih, w_hh, b_ih, b_hh = cc.k8_inputs(n, 80 + n, dev)
    # the kernel's inputs as lstm_seq gives them; the plain version takes
    # the whole input projection
    xp = k8.input_projection(x, w_ih, b_ih, b_hh)
    geo, counter = k8_geometry(n)
    got = k8.lstm_scan_cuda(*cc.k8_scan_inputs(x, w_ih, w_hh, b_ih, b_hh),
                            counter)
    again = k8.lstm_scan_cuda(*cc.k8_scan_inputs(x, w_ih, w_hh, b_ih, b_hh))
    torch.cuda.synchronize()
    arrivals = int(counter.sum())
    want = k8.lstm_scan_reference(xp, w_hh)
    forced = k8.lstm_scan_reference(xp, w_hh, h_carry=got)
    torch.cuda.synchronize()
    max_abs = float((got.float() - want.float()).abs().max())
    ok = bool(k8_within(got, forced).all()) and max_abs <= cc.K8_FREE_ATOL
    # the pre-activations the plain run saw: its h carry is its bf16 output
    h_prev = torch.cat([torch.zeros_like(want[:, :1]), want[:, :-1]], 1)
    pre = xp.float() + h_prev.float() @ w_hh.to(torch.bfloat16).float().t()
    live = float((pre.abs() < K8_LIVE).float().mean())
    del pre
    h = cc.K8_SHAPE["h"]
    swapped = k8.lstm_scan_reference(
        xp, torch.cat([w_hh[h:2 * h], w_hh[:h], w_hh[2 * h:]]))
    controls = {
        "i_f_swapped_rejected_share": k8_steps_rejected(swapped, xp, w_hh),
        "shifted_one_step_rejected_share": k8_steps_rejected(h_prev, xp,
                                                             w_hh)}
    del swapped, h_prev
    say("k8_check", n=n, **cc.K8_SHAPE, blocks=geo.blocks,
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
    args = cc.k8_inputs(BATCH, 90, dev)
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
    ok = bool(k8_within(got, forced).all()) and max_abs <= cc.K8_FREE_ATOL
    say("k8_path", entry="lstm_seq", n=BATCH, **cc.K8_SHAPE, launches=launches,
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
    geo = k8.geometry(n, cc.K8_SHAPE["t"], cc.K8_SHAPE["h"],
                      torch.cuda.get_device_properties(0)
                      .multi_processor_count)
    groups = geo.blocks // (cc.K8_SHAPE["h"] // geo.units_per_block)
    return geo, torch.zeros(groups, dtype=torch.int32, device="cuda")


def cli_counts() -> dict:
    """Every launch counter of the CLI phase's kernels, as a dict."""
    return {"K1": wqf.launch_count, "K2": dict(tf.launch_count),
            "K3": dict(pf.launch_count)}


def cli_run(fn, argv) -> dict:
    """Call a CLI's ``main(argv)`` with every counter of ``cli_counts`` set
    to 0 just before -> its counts just after."""
    wqf.launch_count = 0
    for counts in TRAIN_COUNTERS.values():
        for name in counts:
            counts[name] = 0
    fn(argv)
    torch.cuda.synchronize()
    return cli_counts()


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
        prepare_data.main(["--data_dir", data, "--num_answer",
                           str(CLI_NUM_ANSWER)])
        qa = load_qa_data(qa_artifact_path(data, 2, CLI_NUM_ANSWER))
        train_ids = sorted(set(qa.train.image_ids.tolist()))
        val_ids = sorted(set(qa.val.image_ids.tolist()) - set(train_ids))
        for split, ids in (("train", train_ids), ("val", val_ids)):
            make_synthetic_feature_store(
                os.path.join(data, f"resnet152_{split}"), ids,
                seed=len(split))
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
        trained = cli_run(cli_train.main, train_flags)
        losses = {e["step"]: (e["train loss"], e["val loss"])
                  for e in events(f"runs/{model}/events.jsonl")
                  if e["tag"] == f"{model}/loss"}
        kept = ckpt.all_steps(f"models/{model}")

        # the mid-epoch resume, in a second workspace holding only the
        # straight run's step_<CLI_RESUME_STEP>
        resume_ws = os.path.join(ws, "resume")
        shutil.copytree(f"models/{model}/step_{CLI_RESUME_STEP}",
                        os.path.join(resume_ws, "models", model,
                                     f"step_{CLI_RESUME_STEP}"))
        with contextlib.chdir(resume_ws):
            resumed = cli_run(cli_train.main, train_flags + ["--resume"])
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
        evaluated = cli_run(cli_evaluate.main, flags)
        txt, record, preds = cli_results(model)
        with switches(VQA_DISABLE_PALLAS="1"):
            plain_counts = cli_run(cli_evaluate.main, flags)
        _, plain_record, plain_preds = cli_results(model)
        torch.cuda.empty_cache()

    n_val = len(qa.val)
    k2_want = {"forward": 1, "g_prod": 1, "d_w": 1, "d_q": 1, "d_img": 0}
    k3_zero = {name: 0 for name in pf.launch_count}
    qids = qa.val.question_ids.tolist()
    differ_share = float(np.mean([p["answer"] != q["answer"]
                                  for p, q in zip(preds, plain_preds)]))
    say("cli", model=model, corpus=list(CLI_CORPUS),
        prepared_questions=[len(qa.train), len(qa.val)],
        prepared_note="prepare drops the questions whose answer the UNK "
                      "slot displaces (the corpus's least frequent answer)",
        answer_vocab=qa.a_vocab_size, num_answer_flag=CLI_NUM_ANSWER,
        images=[len(train_ids), len(val_ids)], steps=steps,
        iters_per_epoch=iters,
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


# the kernels one launch of K1 and of K4 runs, by the names a CUDA profile
# gives them (csrc/stage1_coattention.cu, csrc/coattention.cu)
K1_KERNELS = ("stage1_grid_kernel", "stage1_hidden_kernel",
              "stage1_pool_kernel")
K4_KERNELS = ("coattention_kernel",)


def device_launches(prof, kernels: dict) -> dict:
    """Launches of hand-written kernels counted on the card, in the CUDA
    profile ``prof``: ``kernels`` maps a key to the kernels one launch runs
    once each (K1's three), and the key reads how often they ran. A CUDA
    graph's replay runs kernels that no host call launches, so a host
    counter cannot see them. Raises where a key's kernels ran unequally
    often."""
    import re

    runs = {key: [0] * len(names) for key, names in kernels.items()}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for key, names in kernels.items():
            for i, name in enumerate(names):
                if re.search(rf"\b{name}\b", e.name):
                    runs[key][i] += 1
    for key, counts in runs.items():
        if len(set(counts)) != 1:
            raise AssertionError(f"{key}'s kernels {kernels[key]} ran "
                                 f"{counts} times: not once each a launch")
    return {key: counts[0] for key, counts in runs.items()}


def stream(engine, batches, kernels: dict, after_warm_up=None) -> tuple:
    """One measured pass of ``batches`` (a function returning the stream)
    after a warm-up pass and ``after_warm_up()``: (predictions, launches).
    The measured pass runs under a CUDA profile, and ``launches`` counts
    ``kernels`` in it on the card (``device_launches``): by id on one card
    the engine replays a CUDA graph, which the warm-up pass captured."""
    from torch.profiler import ProfilerActivity, profile

    list(batches())
    torch.cuda.synchronize()
    if after_warm_up is not None:
        after_warm_up()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        preds = [p for batch in batches() for p in batch]
        torch.cuda.synchronize()
    return preds, device_launches(prof, kernels)


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


def serve_bank_phase(cfg: Config, params, stores: tuple, dev,
                     smi: str) -> dict:
    """Phase 28: full-width bf16 mhb_coAtt served by id from the device
    feature cache (``predict_stream_by_id``) over N_BATCHES batches of
    BATCH, each image asked ~BANK_REUSE questions, at capacity BANK_SMALL
    (the eviction regime) and at BANK_IMAGES (after a warm-up pass and
    ``reset_stats``, every request a hit), beside the per-request f16 and
    int8 feeds (``predict_stream``) on the same requests. Gates: by id
    bit-equal to the int8 feed; K1's three kernels once a batch on the
    card (from a replay of the graph, which the warm-up pass captured);
    hits + misses = requests,
    with the counts and slots of the same id sequence through a second
    cache on the CPU; a control: the first batch's slots swapped in pairs
    on the device must flip its answers. Then hieCoAtten by id (K4 once a
    batch, bit-equal to its int8 feed)."""
    f16_store, store = stores
    image_ids, ques = bank_traffic(cfg)
    n_req = len(ques)
    spans = [slice(s, s + BATCH) for s in range(0, n_req, BATCH)]
    id_batches = [image_ids[s] for s in spans]
    fields = {}

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

    engine16 = InferenceEngine(cfg, params, batch_size=BATCH, topk=5)
    fields["f16_feed"] = dict(launches=stream(engine16, f16_batches,
                                              {"K1": K1_KERNELS})[1])
    del engine16
    torch.cuda.empty_cache()

    engine = InferenceEngine(cfg, params, batch_size=BATCH, topk=5,
                             input_dtype="int8")
    preds8, launches = stream(engine, int8_batches, {"K1": K1_KERNELS})
    fields["int8_feed"] = dict(launches=launches)

    k1_launches, caches = 0, {}
    for name, capacity in (("by_id_capacity_512", BANK_SMALL),
                           ("by_id_hit_rate_1", BANK_IMAGES)):
        cache = engine.attach_feature_cache(capacity, store.gather_quantized)
        preds, launches = stream(engine, by_id, {"K1": K1_KERNELS},
                                 after_warm_up=cache.reset_stats)
        state = cache_state(cache)
        k1_launches += launches["K1"]
        same_as_cpu = state == replayed_state(cfg, capacity, id_batches)
        state.pop("slots")
        fields[name] = dict(launches=launches, capacity=capacity,
                            hit_rate=state["hits"] / n_req, **state,
                            counts_and_slots_equal_cpu_cache=same_as_cpu,
                            bit_equal_to_int8_feed=bit_equal(preds, preds8))
        if not bit_equal(preds, preds8):
            raise AssertionError(f"serve_bank: {name}'s answers are not "
                                 "bit-equal to the int8 feed's")
        if launches["K1"] != N_BATCHES:
            raise AssertionError(f"serve_bank: K1 ran {launches['K1']} "
                                 f"times on the card in {N_BATCHES} "
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

    # hieCoAtten by id: K4 once a batch on the card, bit-equal to its
    # int8 feed
    hie_cfg = Config(model_name="hieCoAtten")
    hie_params = hie_served_params(hie_cfg)
    engine = InferenceEngine(hie_cfg, hie_params, batch_size=BATCH, topk=5,
                             input_dtype="int8")
    preds8, _ = stream(engine, int8_batches, {"K4": K4_KERNELS})
    engine.attach_feature_cache(BANK_IMAGES, store.gather_quantized)
    preds, launches = stream(engine, by_id, {"K4": K4_KERNELS})
    fields["hiecoatten_by_id"] = dict(
        launches=launches, bit_equal_to_int8_feed=bit_equal(preds, preds8))
    if launches["K4"] != N_BATCHES or not bit_equal(preds, preds8):
        raise AssertionError("serve_bank: hieCoAtten by id did not run K4 "
                             "once a batch on the card, or is not its "
                             "int8 feed's")
    del engine
    torch.cuda.empty_cache()

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
    requests and the bank's hits and misses, an unknown id 400, K1's
    kernels run on the card (a CUDA profile of the load) once an engine
    call. Returns K1's launches."""
    from torch.profiler import ProfilerActivity, profile

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
        with open(spec_path, "w") as f:
            json.dump({"url": url, "items": items, "n_single": n_single,
                       "bulks": bulks, "clients": HTTP_CLIENTS}, f)
        # the clients run in a process of their own, as users' would: in
        # this one they would share the server's interpreter lock
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            subprocess.run([sys.executable, script, spec_path],
                           check=True, timeout=900)
            torch.cuda.synchronize()
        with open(spec_path + ".out") as f:
            load = json.load(f)
        out = load["out"]
        k1 = device_launches(prof, {"K1": K1_KERNELS})["K1"]
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
        raise AssertionError(f"serve_http: K1 ran {k1} times on the card "
                             f"in {batches} engine calls")
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
    dtype (bf16) on a batch of EXTRACT_BATCH: its grid. If PIL imports:
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

    # the serving dtype: uint8 images through each extractor
    for name, size in (("resnet152", 448), ("vgg19", 224)):
        ex = GridExtractor(name, npz if name == "resnet152" else None,
                           device=dev)
        u8 = rng.integers(0, 256, (EXTRACT_BATCH, size, size, 3),
                          dtype=np.uint8)
        out = ex.batch(u8)
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


def solver_params(solver) -> dict:
    return {k: v.detach().clone() for k, v in
            solver.model.named_parameters()}


def same_params(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def train_switches_phase(params, store, store_dir: str, work_dir: str,
                         smi: str) -> dict:
    """Phase 31: the Solver's switches on full-width bf16 mhb_coAtt at the
    pre-pool site (K2), dropout 0.1, batch TRAIN_BATCH, SWITCH_STEPS steps
    an arm, each against the plain run (no switch, the host f16 feed):

    - gradient accumulation, a=2: K2 forward, g_prod, d_W and d_q twice a
      step; the kernel arm's losses within TRAIN_LOSS_RTOL of the
      ``reference_kernels=True`` arm's over TRAIN_AGREE_STEPS steps; at f64
      (parameters too) with dropout 0, one step's gradients within
      SWITCH_GRAD_RTOL and SWITCH_GRAD_ATOL of a=1's (the same mean,
      summed in another order);
    - remat: the parameters after the run bit-equal to the plain run's, K2's
      forward twice a step (the recomputation), its backward once; the
      peak memory of both runs;
    - the device feature bank, on the f16 store and on its int8 twin: the
      parameters bit-equal to the host feed's of the same store;
    - ``profile_steps=2``: the trace is written and names K2's kernels;
    - ``debug_nans``: a sound step passes the trap, a NaN put into a
      weight raises at the backward.
    Returns the K2 launches of the kernel arms, by launch."""
    cfg = Config(compute_dtype="bfloat16", num_epoch=1,
                 batch_size=TRAIN_BATCH)
    qa, _ = train_data(cfg, SWITCH_STEPS)
    steps = SWITCH_STEPS
    fields, counted = {}, []
    once = dict(forward=steps, g_prod=steps, d_w=steps, d_q=steps, d_img=0)
    twice = {k: 2 * v for k, v in once.items()}

    def run(name, data_store=store, want=once, solver_kw=None, **kw):
        # the run's own peak: its model, Adam's state, gradients and
        # activations, over what the earlier arms still hold
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        result = train_run(cfg.replace(**kw), qa, data_store, params,
                           **(solver_kw or {}))
        solver = result.pop("solver")
        result["params"] = solver_params(solver)
        peak_mib = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
        k2 = result["launches"]["K2"]
        fields[name] = {"losses": result["losses"], "k2_launches": k2,
                        "run_peak_mib": peak_mib}
        if want is not None:
            counted.append(k2)
            if k2 != want or any(result["launches"]["K3"].values()):
                raise AssertionError(f"train_switches: {name} launched K2 "
                                     f"{k2} (want {want}) and K3 "
                                     f"{result['launches']['K3']}")
        if not np.isfinite(result["losses"]).all():
            raise AssertionError(f"train_switches: {name}'s losses are not "
                                 "finite")
        return result, solver

    plain, plain_solver = run("plain")
    accum, _ = run("grad_accum_2", grad_accum_steps=2, want=twice)
    accum_ref, _ = run("grad_accum_2_plain_k2", grad_accum_steps=2,
                       want=None, solver_kw={"reference_kernels": True})
    if any(accum_ref["launches"]["K2"].values()):
        raise AssertionError("train_switches: the plain arm launched K2")
    rel = np.abs(np.array(accum["losses"]) - accum_ref["losses"]) / \
        np.abs(accum_ref["losses"])
    fields["grad_accum_2"]["rel_diff_to_plain_k2"] = rel.tolist()
    if (rel[:TRAIN_AGREE_STEPS] > TRAIN_LOSS_RTOL).any():
        raise AssertionError("train_switches: gradient accumulation's kernel "
                             "and plain-K2 runs disagree")

    # a=2 against a=1 at f64, dropout 0: one step's gradients
    f64 = cfg.replace(compute_dtype="float64", dropout_lstm=0.0,
                      dropout_fusion=0.0)
    batch = next(plain_solver.batches["train"].epoch(0))
    grads = {}
    for a in (1, 2):
        solver = Solver(f64.replace(grad_accum_steps=a), qa, store,
                        params=params)
        solver.model.double()
        solver._train_step(batch)
        grads[a] = {k: p.grad.clone() for k, p in
                    solver.model.named_parameters() if p.grad is not None}
        del solver
    # each gradient's difference over its largest value plus, for one that
    # is 0 up to rounding (the biases just before a softmax over L or T),
    # SWITCH_GRAD_ATOL of the model's largest gradient
    top = max(float(g.abs().max()) for g in grads[1].values())
    rel = sorted(((float((grads[2][k] - g).abs().max())
                   / (float(g.abs().max())
                      + SWITCH_GRAD_ATOL / SWITCH_GRAD_RTOL * top), k)
                  for k, g in grads[1].items()), reverse=True)
    worst = rel[0][0]
    fields["grad_accum_f64_grad_diff"] = {
        "worst_over_tolerance": worst / SWITCH_GRAD_RTOL,
        "largest": {k: v for v, k in rel[:3]}}
    if grads[1].keys() != grads[2].keys() or worst > SWITCH_GRAD_RTOL:
        raise AssertionError(f"train_switches: a=2's f64 gradients differ "
                             f"from a=1's: {rel[:3]}")
    del grads
    torch.cuda.empty_cache()

    remat, _ = run("remat", remat=True, want=dict(once, forward=2 * steps))
    fields["remat"]["bit_equal_to_plain"] = same_params(remat["params"],
                                                        plain["params"])
    if not fields["remat"]["bit_equal_to_plain"] or \
            remat["losses"] != plain["losses"]:
        raise AssertionError("train_switches: remat's run is not bit-equal "
                             "to the plain run")

    int8_store = quantize_store(store_dir, os.path.join(work_dir, "int8"))
    feeds = {"f16": (store, plain, plain_solver)}
    int8, int8_solver = run("int8_feed", data_store=int8_store)
    feeds["int8"] = (int8_store, int8, int8_solver)
    for feed, (data_store, host, host_solver) in feeds.items():
        bank, bank_solver = run(f"bank_{feed}", data_store=data_store,
                                device_feature_bank=True)
        equal = same_params(bank["params"], host["params"])
        fields[f"bank_{feed}"].update(
            bit_equal_to_host_feed=equal,
            bank_mib=bank_solver.bank.nbytes / 2 ** 20)
        if not equal or bank["losses"] != host["losses"]:
            raise AssertionError(f"train_switches: the {feed} bank's run is "
                                 "not bit-equal to the host feed's")
        del bank_solver
    del feeds, plain_solver, int8_solver
    torch.cuda.empty_cache()

    prof_dir = os.path.join(work_dir, "profile")
    profiled, solver = run("profile_steps_2", profile_steps=2,
                           profile_dir=prof_dir)
    with open(solver.profile_trace) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    found = [k for k in K2_KERNELS if any(k in n for n in names)]
    fields["profile_steps_2"].update(trace=os.path.relpath(
        solver.profile_trace, work_dir), k2_kernels_named=found)
    if found != list(K2_KERNELS):
        raise AssertionError(f"train_switches: the trace names {found} of "
                             f"K2's kernels {K2_KERNELS}")
    del solver

    solver = Solver(cfg.replace(debug_nans=True), qa, store, params=params)
    sound = float(solver._train_step(batch)[0])
    with torch.no_grad():
        solver.model.ques_proj1.weight[0, 0] = float("nan")
    try:
        solver._train_step(batch)
        trapped = None
    except RuntimeError as e:
        trapped = str(e).splitlines()[0][:120]
    fields["debug_nans"] = {"sound_step_loss": sound, "nan_trapped": trapped}
    if not np.isfinite(sound) or trapped is None or "nan" not in trapped:
        raise AssertionError("train_switches: debug_nans did not pass a "
                             "sound step or did not trap a NaN weight")
    del solver
    torch.cuda.empty_cache()
    for result in fields.values():
        if isinstance(result, dict):
            result.pop("losses", None)
    say("train_switches", model=cfg.model_name, batch=TRAIN_BATCH,
        steps=steps, dropout_fusion=cfg.dropout_fusion, **fields, card=smi)
    return {key: sum(k2[key] for k2 in counted) for key in once}


def artifact_phase(cfg: Config, params, stores: tuple, ws: str, dev,
                   smi: str) -> dict:
    """Phase 32: the exported serving artifact. bf16 mhb_coAtt at
    ``Config()`` widths (phase 4's weights) and hieCoAtten (phase 28's),
    each exported at batch BATCH for the f16 and the int8 feed
    (``aot.save_serving_artifact``), loaded by ``InferenceEngine(
    artifact_dir=...)`` and served phase 28's requests
    (``predict_stream``, 2,048 requests) beside the eager engine. Gates:
    the answers bit-equal to the eager engine's; ``fast_path_traced``; K1
    (mhb_coAtt) or K4 (hieCoAtten) once per artifact call, counted on the
    card."""
    f16_store, store = stores
    image_ids, ques = bank_traffic(cfg)
    spans = [slice(s, s + BATCH) for s in range(0, len(ques), BATCH)]
    hie_cfg = Config(model_name="hieCoAtten")
    fields, launches = {}, {"K1": 0, "K4": 0}
    for name, fcfg, fparams, key, kernels in (
            ("mhb_coAtt", cfg, params, "K1", K1_KERNELS),
            ("hieCoAtten", hie_cfg, hie_served_params(hie_cfg), "K4",
             K4_KERNELS)):
        for feed in ("float16", "int8"):
            out = os.path.join(ws, f"aot_{name}_{feed}")
            save_serving_artifact(out, fcfg.replace(compute_dtype="bfloat16"),
                                  fparams, BATCH, 5, feed, dev)
            with open(os.path.join(out, "serving.json")) as f:
                meta = json.load(f)

            def items(s):
                if feed == "int8":
                    rows, scale = store.gather_quantized(image_ids[s])
                    return rows, ques[s], None, scale
                return f16_store.gather(image_ids[s], np.float16), ques[s], \
                    None

            rec = {"fast_path_traced": meta["fast_path_traced"],
                   "kernel_ops": meta["kernel_ops"]}
            preds = {}
            for kind in ("eager", "artifact"):
                engine = InferenceEngine(
                    fcfg, fparams, batch_size=BATCH, topk=5,
                    input_dtype=feed,
                    artifact_dir=out if kind == "artifact" else None)
                preds[kind], counts = stream(
                    engine, lambda: engine.predict_stream(
                        items(s) for s in spans), {key: kernels})
                rec[kind] = {"launches": counts}
                del engine
            launches[key] += counts[key]  # the artifact engine's
            rec["bit_equal_to_eager"] = bit_equal(preds["artifact"],
                                                  preds["eager"])
            fields[f"{name}_{feed}"] = rec
            if not (rec["bit_equal_to_eager"] and meta["fast_path_traced"]
                    and counts[key] == len(spans)):
                raise AssertionError(
                    f"artifact: {name} ({feed}) is not bit-equal to the "
                    f"eager engine, was exported without its kernel, or "
                    f"launched {key} {counts[key]} times in {len(spans)} "
                    "calls")
            torch.cuda.empty_cache()
    say("artifact", requests=len(ques), batch=BATCH, **fields, card=smi)
    return launches


# ---------------------------------------------------------------------------
# phases 33-34: data parallelism (ROADMAP Queue 1 item 10a)
# ---------------------------------------------------------------------------

def dp_config(batch: int = TRAIN_BATCH) -> Config:
    """dp_train's training: full-width bf16 mhb_coAtt at the pre-pool site
    (K2), rate 0.1, global batch ``batch``, DP_STEPS steps."""
    return Config(compute_dtype="bfloat16", batch_size=batch, num_epoch=1,
                  checkpoint_every_steps=0, prefetch_workers=1)


def dp_per_step() -> dict:
    """K2's launches by kind in DP_STEPS pre-pool steps (img takes no
    gradient)."""
    return {"forward": DP_STEPS, "g_prod": DP_STEPS, "d_w": DP_STEPS,
            "d_q": DP_STEPS, "d_img": 0}


def l2(tree: dict) -> float:
    """The L2 norm over every tensor of a tree, summed in f64."""
    return sum(float(v.double().square().sum())
               for v in tree.values()) ** 0.5


def full_grads(solver) -> dict:
    """The gradients left by the last backward (after DDP's all-reduce),
    a tensor-parallel rank's shards gathered to the full tensors (every
    rank of the model group calls this together); 0 where none."""
    from vqa_attention_networks_tpu_torch.parallel import sharding, tensor

    grads = {k: (torch.zeros_like(p) if p.grad is None
                 else p.grad.detach().clone())
             for k, p in solver.model.named_parameters()}
    tp, split = sharding.model_shardings(solver.model)
    for k, dim in split.items():
        grads[k] = tensor.gather(grads[k], tp, dim)
    return grads


def replicated_names(cfg: Config) -> list:
    """The parameters of ``cfg``'s model whole on every model rank that
    take gradient through ``parallel.tensor.model_input`` (all but the
    split fusion projections and the classifier after the gathers)."""
    from vqa_attention_networks_tpu_torch.parallel.sharding import (
        param_shardings,
    )

    with torch.device("meta"):  # names and shapes, no memory
        model = get_model(cfg.model_name)(cfg)
    split = param_shardings(model, cfg.fusion_dim)
    return [k for k, v in split.items()
            if v is None and not k.startswith("linear_pred")]


def dp_train_arm(store_dir: str, out: str, fault: str = None,
                 reference: str = None, batch: int = TRAIN_BATCH,
                 model_parallel: int = 1, site: str = "prepool",
                 steps: int = DP_STEPS, val: bool = False,
                 blocks: int = 1, also: str = None) -> dict:
    """One arm's training in this process (a rank of a process group, or
    one process without one): ``Solver.train`` from phase 7's seed over
    ``steps`` global batches of ``batch`` rows (a multiple of
    TRAIN_BATCH), at ``dropout_site`` ``site`` and ``model_parallel``,
    with K2's and K3's counters set to 0 just before it; K2's forward calls
    recorded as (seed, row0, rows, col0, f_total, columns), and the first
    step's gradient (after DDP's all-reduce; a tensor-parallel rank's
    gathered) kept. ``fault`` makes a control: ``"row0"``, rank 1 draws
    K2's mask at row0 = 0 (its rows' mask is then rank 0's); ``"count"``,
    each rank's loss is over its own valid rows, not the global batch's;
    ``"col0"``, model rank 1 draws K2's mask at col0 = 0 (its columns'
    mask is then model rank 0's); ``"allreduce"``, the all-reduce over the
    model group in ``model_input``'s backward is left out. ``reference``:
    one process's ``out``, whose final parameters and first-step gradient
    this arm is held against; without it both are saved beside ``out``.
    ``val``: then one ``val()`` with K1's counter set to 0 just before it
    (the gathered weights saved beside ``out`` by rank 0). ``blocks`` > 1
    (one process): each fusion projection's product computed in that many
    column blocks, concatenated, as the model axis splits it (the same
    function; at bf16 cuBLAS rounds a product of another width otherwise,
    which the signed sqrt near 0 amplifies in the gradient). ``also``:
    a second reference whose first-step gradient the arm's is compared with,
    for information. Writes the result to ``out`` as JSON."""
    from vqa_attention_networks_tpu_torch.parallel import distributed, tensor
    from vqa_attention_networks_tpu_torch.parallel.sharding import (
        gather_state_dict,
    )

    cfg = dp_config(batch).replace(model_parallel=model_parallel,
                                   dropout_site=site)
    qa, _ = train_data(cfg, steps * batch // TRAIN_BATCH)
    store = FeatureStore(store_dir)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    calls, real = [], tf.train_grid_fuse
    force_zero = fault == "row0" and distributed.rank() == 1
    col_zero = fault == "col0" and distributed.rank() % model_parallel == 1
    real_backward = tensor._ModelInput.backward
    real_dense = layers.dense

    def blocked(x, weight, bias=None):
        if weight.shape[0] != cfg.fusion_dim:
            return real_dense(x, weight, bias)
        w = weight.shape[0] // blocks
        return torch.cat([real_dense(
            x, weight[i * w:(i + 1) * w],
            None if bias is None else bias[i * w:(i + 1) * w])
            for i in range(blocks)], -1)

    def recorded(img, w, b, q, seed, k, rate, row0=0, col0=0, f_total=None):
        row0 = 0 if force_zero else row0
        col0 = 0 if col_zero else col0
        f_total = w.shape[1] if f_total is None else f_total
        calls.append([int(seed), int(row0), int(img.shape[0]), int(col0),
                      int(f_total), int(w.shape[1])])
        return real(img, w, b, q, seed, k, rate, row0, col0, f_total)

    tf.train_grid_fuse = recorded
    if fault == "allreduce":
        tensor._ModelInput.backward = staticmethod(lambda ctx, g: (g, None))
    if blocks > 1:
        layers.dense = blocked
    try:
        solver = Solver(cfg, qa, store, params=params)
        if fault == "count":
            own = solver._loss
            solver._loss = (lambda logits, answers, soft, valid, count=None:
                            own(logits, answers, soft, valid))
        losses, grads = [], {}

        def on_step(step, loss):
            if not grads:
                grads.update(full_grads(solver))
            losses.append(float(loss))

        for module in (tf, pf):
            for name in module.launch_count:
                module.launch_count[name] = 0
        solver.train(on_step=on_step)
        launches = dict((tf if site == "prepool" else pf).launch_count)
    finally:
        tf.train_grid_fuse = real
        tensor._ModelInput.backward = real_backward
        layers.dense = real_dense
    names = [k for k, _ in solver.model.named_parameters()]
    state = {k: v.detach() for k, v in gather_state_dict(solver.model).items()
             if k in names}
    result = {
        "rank": distributed.rank(), "world": distributed.world_size(),
        "model_parallel": model_parallel, "site": site,
        "losses": losses,
        "k2_launches": launches, "k2_calls": calls,
        "params_l1": float(sum(v.double().abs().sum()
                               for v in state.values())),
        "param_bytes": sum(p.nbytes for p in solver.model.parameters()),
        "adam_bytes": sum(t.nbytes for s in solver.optimizer.state.values()
                          for t in s.values() if torch.is_tensor(t)),
        "grad_bytes": sum(p.grad.nbytes for p in solver.model.parameters()
                          if p.grad is not None)}
    if val:
        wqf.launch_count = 0
        result["val"] = list(solver.val())
        result["k1_val_launches"] = wqf.launch_count
        gathered = gather_state_dict(solver.model)  # every rank: collective
        if distributed.rank() == 0:
            torch.save(gathered, out + ".state.pt")
    if reference is not None:
        want = torch.load(reference + ".pt", map_location=solver.device)
        result["max_param_diff"] = max(
            float((state[k] - want[k]).abs().max()) for k in want)
        want = torch.load(reference + ".grad.pt", map_location=solver.device)
        result["grad_rel_diff"] = l2({k: grads[k] - want[k]
                                      for k in want}) / l2(want)
        result["grad_norm_ratio"] = l2(grads) / l2(want)
        # the five parameters furthest from one process's (relative L2)
        by_param = {k: l2({k: grads[k] - want[k]}) / max(l2({k: want[k]}),
                                                          1e-30)
                    for k in want}
        result["worst_params"] = sorted(by_param.items(),
                                        key=lambda kv: -kv[1])[:5]
        whole = replicated_names(cfg)
        result["replicated_grad_rel_diff"] = l2(
            {k: grads[k] - want[k] for k in whole}) / l2(
            {k: want[k] for k in whole})
        if also is not None:
            want = torch.load(also + ".grad.pt", map_location=solver.device)
            result["also_grad_rel_diff"] = l2({k: grads[k] - want[k]
                                               for k in want}) / l2(want)
    else:
        torch.save(state, out + ".pt")
        torch.save(grads, out + ".grad.pt")
    with open(out, "w") as f:
        json.dump(result, f)
    return result


def dp_rank(spec_path: str, rank: int) -> None:
    """``chip_smoke.py --dp-rank SPEC RANK``: one rank of a dp_train arm,
    joined to its process group on its card."""
    from vqa_attention_networks_tpu_torch.parallel import (
        initialize_distributed,
    )

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(init_method=spec["rendezvous"],
                           world_size=spec["world"], rank=rank,
                           device=spec["devices"][rank],
                           backend=spec["backend"])
    # the spec's arm, then each arm of "then" in the same processes
    for arm in [spec] + [dict(spec, **a) for a in spec.get("then", [])]:
        out = os.path.join(arm["work"], f"{arm['arm']}_rank{rank}.json")
        if arm.get("banks"):
            bank_train_arm(arm, out)
        else:
            dp_train_arm(arm["store"], out, fault=arm["fault"],
                         reference=arm["reference"], batch=arm["batch"],
                         **arm.get("arm_kw", {}))
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()


def dp_ranks(arm: str, world: int, backend: str, devices: list,
             store_dir: str, work: str, reference: str, fault: str = None,
             batch: int = TRAIN_BATCH, **extra) -> list:
    """Run ``world`` ranks of an arm, each a process of its own on its card
    (``devices[rank]``); a rank that fails or outlives DP_RANK_TIMEOUT
    fails the phase (every rank is killed then). ``extra``: ``arm_kw``
    (``dp_train_arm``'s), or ``banks`` (``bank_train_arm``'s stores); and
    ``then``, more arms (dicts of ``arm``, ``reference``, ``fault``,
    ``arm_kw``) the same processes run after it, saving their starts. ->
    the arm's ranks' results (with ``then``: each arm's, by name)."""
    spec = dict(arm=arm, world=world, backend=backend, store=store_dir,
                work=work, reference=reference, fault=fault,
                devices=devices, batch=batch,
                rendezvous=f"file://{work}/{arm}_rendezvous", **extra)
    path = os.path.join(work, f"{arm}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    logs = os.path.join(work, f"{arm}_logs")
    os.makedirs(logs)
    failed = failures(run_processes(
        [[sys.executable, os.path.abspath(__file__), "--dp-rank", path,
          str(r)] for r in range(world)], env, DP_RANK_TIMEOUT, logs))
    if failed:
        raise AssertionError(f"dp_train {arm}: a rank failed or outlived "
                             f"{DP_RANK_TIMEOUT} s:\n{failed}")
    results = {}
    for name in [arm] + [a["arm"] for a in extra.get("then", [])]:
        results[name] = []
        for r in range(world):
            with open(os.path.join(work, f"{name}_rank{r}.json")) as f:
                results[name].append(json.load(f))
    return results if extra.get("then") else results[arm]


def dp_masks_agree(ranks: list, single: dict, cfg: Config) -> list:
    """The masks gate: each rank's first K2 call draws, by the kernel at the
    row and column offsets it passed, the block of the one process's first
    mask that the rank holds: data rank d's rows and, under tensor
    parallelism, model rank m's columns. -> per rank whether it does."""
    seed, row0, rows = single["k2_calls"][0][:3]
    whole = cc.k2_kernel_mask(seed, rows, row0, cfg.dropout_fusion)
    agree = []
    for r in ranks:
        # f: the launch's width, a shard's zero-padded; its block of the
        # whole mask is f_total / M columns wide
        r_seed, r_row0, n, r_col0, f_total, f = r["k2_calls"][0]
        mp = r.get("model_parallel", 1)
        fw = f_total // mp
        lo, c0 = (r["rank"] // mp) * n, (r["rank"] % mp) * fw
        part = cc.k2_kernel_mask(r_seed, n, r_row0, cfg.dropout_fusion,
                                 col0=r_col0, f_total=f_total, f=f)[..., :fw]
        agree.append(r_seed == seed and f_total == whole.shape[-1]
                     and torch.equal(part, whole[lo:lo + n, :, c0:c0 + fw]))
        del part
    del whole
    torch.cuda.empty_cache()
    return agree


def dp_loss_rel_diff(ranks: list, single: dict) -> list:
    want = np.array(single["losses"])
    return [float((np.abs(np.array(r["losses"]) - want)
                   / np.abs(want)).max()) for r in ranks]


def dp_gates(ranks: list, single: dict, masks: list = None,
             per_step: dict = None) -> dict:
    """A data- or tensor-parallel arm's gates against one process at the
    same global batch -> gate -> passed: the losses within
    TRAIN_LOSS_RTOL; the first step's gradient within DP_GRAD_RTOL
    (relative L2), and under tensor parallelism the replicated layers'
    part of it too (``replicated_names``); the masks gate (where K2 draws
    them); every rank one model (the gathered parameters); K2's (or K3's)
    launches once a step by kind in each rank (``per_step``)."""
    gates = {
        "losses": max(dp_loss_rel_diff(ranks, single)) <= TRAIN_LOSS_RTOL,
        "gradient": max(r["grad_rel_diff"] for r in ranks) <= DP_GRAD_RTOL,
        "one_model": len({r["params_l1"] for r in ranks}) == 1,
        "k2_launches": all(r["k2_launches"] == (per_step or dp_per_step())
                           for r in ranks)}
    if masks is not None:
        gates["masks"] = all(masks)
    if ranks[0].get("model_parallel", 1) > 1:
        gates["replicated_gradient"] = max(
            r["replicated_grad_rel_diff"] for r in ranks) <= DP_GRAD_RTOL
    return gates


def dp_train_phase(store_dir: str, smi: str, cards: int = 1) -> dict:
    """Phase 33, ``dp_train``: the data-parallel Solver at full width, bf16,
    K2 at rate 0.1, DP_STEPS steps, global batch TRAIN_BATCH a card, each
    arm against one process on ``cuda:0`` without a process group (the
    plain Solver, K2 in it) at the same global batch. On one card: (a) one
    NCCL rank; (b) two gloo ranks sharing the card (NCCL refuses two ranks
    on one device), each launching K2 on its 32 rows. On ``cards`` > 1: N
    NCCL ranks, a rank a card. Every such arm passes all of ``dp_gates``.
    Two controls, on (b)'s ranks (the N cards' on more): ``control_row0``,
    rank 1 drawing K2's mask at row0 = 0, which the masks gate must reject
    on rank 1 alone; ``control_count``, each rank's loss over its own valid
    rows, which the gradient gate must reject (its gradient is twice one
    process's) while the masks gate passes. Ranks sharing one card measure
    correctness, not scaling: their ms a step is for information. -> K2's
    launches of the data-parallel arms' ranks (the controls' apart), by
    kind."""
    batch = TRAIN_BATCH * cards
    cfg = dp_config(batch)
    if cards == 1:
        arms = {"nccl": (1, "nccl", ["cuda:0"]),
                "gloo": (2, "gloo", ["cuda:0"] * 2)}
    else:
        arms = {"nccl": (cards, "nccl",
                         [f"cuda:{i}" for i in range(cards)])}
    faulty = arms["gloo" if cards == 1 else "nccl"]
    controls = {"control_row0": "row0", "control_count": "count"}
    with tempfile.TemporaryDirectory() as work:
        reference = os.path.join(work, "single.json")
        single = dp_train_arm(store_dir, reference, batch=batch)
        torch.cuda.empty_cache()
        # the controls run in the faulty arm's rank processes, after it
        then = [dict(arm=name, reference=reference, fault=fault)
                for name, fault in controls.items()]
        runs = {}
        for name, spec in arms.items():
            got = dp_ranks(name, *spec, store_dir, work, reference,
                           batch=batch, then=then if spec is faulty else [])
            runs.update(got if isinstance(got, dict) else {name: got})
        masks = {name: dp_masks_agree(ranks, single, cfg)
                 for name, ranks in runs.items()}
    gates = {name: dp_gates(ranks, single, masks[name])
             for name, ranks in runs.items()}
    fields = dict(
        model="mhb_coAtt", cards=cards, batch=batch, steps=DP_STEPS,
        rate=cfg.dropout_fusion, single_losses=single["losses"],
        single_k2_launches=single["k2_launches"],
        grad_rtol=DP_GRAD_RTOL, loss_rtol=TRAIN_LOSS_RTOL)
    for name, ranks in runs.items():
        fields[name] = dict(
            world=len(ranks), losses=[r["losses"] for r in ranks],
            loss_rel_diff=dp_loss_rel_diff(ranks, single),
            grad_rel_diff=[r["grad_rel_diff"] for r in ranks],
            grad_norm_ratio=[r["grad_norm_ratio"] for r in ranks],
            max_param_diff=[r["max_param_diff"] for r in ranks],
            k2_launches=[r["k2_launches"] for r in ranks],
            k2_first_call=[r["k2_calls"][0] for r in ranks],
            masks_agree=masks[name], gates=gates[name])
    say("dp_train", **fields,
        note=("two ranks share one card: correctness, not scaling"
              if cards == 1 else f"a rank a card over {cards} cards"),
        card=smi)
    if single["k2_launches"] != dp_per_step():
        raise AssertionError(
            f"dp_train: one process launched K2 {single['k2_launches']}")
    for name in arms:
        if not all(gates[name].values()):
            raise AssertionError(f"dp_train: the {name} arm failed a gate: "
                                 f"{gates[name]}")
    world = len(runs["control_row0"])
    if masks["control_row0"] != [r != 1 for r in range(world)]:
        raise AssertionError("dp_train: the masks gate does not reject the "
                             "row-offset control's rank 1 alone")
    if gates["control_count"]["gradient"] or \
            not gates["control_count"]["masks"]:
        raise AssertionError("dp_train: the gradient gate does not reject "
                             "the control whose ranks count their own rows")
    return {key: sum(r["k2_launches"][key] for name in arms
                     for r in runs[name])
            for key in dp_per_step()}


def dp_serve_phase(cfg: Config, params, store, smi: str,
                   cards: int = 1) -> int:
    """Phase 34, ``dp_serve``: full-width bf16 mhb_coAtt (phase 4's
    weights) served by the split-batch engine over phase 4's 2048
    requests, against ``data_parallel=1``: on one card
    ``InferenceEngine(data_parallel=2)`` with two replicas on ``cuda:0``;
    on ``cards`` > 1 ``data_parallel=cards`` on its default devices,
    ``cuda:0..N-1``. Gates: every answer bit-equal (each replica runs K1
    on its rows, whose per-row arithmetic the batch does not change); K1
    once a shard. -> K1's launches in the split engine's run."""
    image_ids, ques = traffic(cfg)
    n_req = len(ques)
    replicas = 2 if cards == 1 else cards

    def batches():
        for s in range(0, n_req, BATCH):
            yield store.gather(image_ids[s:s + BATCH], np.float16), \
                ques[s:s + BATCH], None

    engines = {n: InferenceEngine(
        cfg, params, batch_size=BATCH, topk=5, data_parallel=n,
        device=[torch.device("cuda", 0)] * n if cards == 1 else None)
        for n in (1, replicas)}
    runs = {n: stream(e, lambda e=e: e.predict_stream(batches()),
                      {"K1": K1_KERNELS})
            for n, e in engines.items()}
    preds = {n: r[0] for n, r in runs.items()}
    equal = bit_equal(preds[replicas], preds[1])
    flipped = sum(a.answer_id != b.answer_id
                  for a, b in zip(preds[replicas], preds[1]))
    launches = runs[replicas][1]["K1"]
    say("dp_serve", model="mhb_coAtt", requests=n_req, batch=BATCH,
        replicas=replicas,
        devices="cuda:0 x2" if cards == 1 else f"cuda:0..{cards - 1}",
        bit_equal=equal, answers_differ=flipped, k1_launches=launches,
        k1_launches_one_replica=runs[1][1]["K1"],
        note=("two replicas share one card: correctness, not scaling"
              if cards == 1 else f"a replica a card over {cards} cards"),
        card=smi)
    del engines
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError("dp_serve: the split engine's answers are not "
                             "the one-replica engine's")
    if launches != replicas * N_BATCHES:
        raise AssertionError(f"dp_serve: K1 launched {launches} times for "
                             f"{N_BATCHES} batches of {replicas} shards")
    return launches


def tp_arms(cards: int) -> tuple:
    """(ranks, backend, devices) of the tensor-parallel arms: two gloo
    ranks sharing ``cuda:0`` on one card, else a NCCL rank a card."""
    if cards == 1:
        return 2, "gloo", ["cuda:0"] * 2
    return cards, "nccl", [f"cuda:{i}" for i in range(cards)]


def tp_train_phase(store_dir: str, smi: str, cards: int = 1) -> dict:
    """Phase 35, ``tp_train``: tensor parallelism at mesh (1, 2) on one card
    (two gloo ranks sharing ``cuda:0``), (N/2, 2) over N cards (NCCL): the
    Solver on full-width bf16 mhb_coAtt, the fusion projections split over
    the model axis, global batch 64 a data replica, DP_STEPS steps at the
    pre-pool site (K2 on each rank's 2,500 columns, zero-padded to 2,520)
    and TP_POOLED_STEPS at the pooled site (K3 on the padded shard). Each
    arm is held against one process at the same batch whose fusion
    projections compute their products in the same two column blocks
    (``dp_train_arm(blocks=2)``): at bf16 a product of another width
    rounds otherwise, and the signed sqrt near 0 amplifies that in every
    gradient upstream of it (one plain process against the blocked one:
    ``also_grad_rel_diff``, 0.305 on an H100). Gates (``dp_gates``): the
    losses, the first step's gradient gathered from the shards and its
    replicated layers' part, one model, K2's or K3's launches a step by
    kind in every rank; at the pre-pool site the masks gate (each rank's K2
    mask, drawn by the kernel at its ``row0`` and ``col0``, is its block of
    one process's). Two controls that must fail: ``control_col0``, model
    rank 1 drawing at col0 = 0 (the masks gate rejects model rank 1
    alone), and ``control_allreduce``, no all-reduce over the model group
    in ``model_input``'s backward (the replicated layers' gradient gate
    rejects it). Then each rank's ``val()`` (K1 once, on the gathered
    weights) against one process's ``val()`` on the gathered weights, and
    each rank's parameter, gradient and Adam bytes beside one process's.
    -> the sound arms' launches: {"K2": by kind, "K3": by kind, "K1": n}."""
    world, backend, devices = tp_arms(cards)
    batch = TRAIN_BATCH * max(world // TP_MODEL, 1)
    cfg = dp_config(batch)
    spec = (world, backend, devices)
    pooled = dict(site="pooled", steps=TP_POOLED_STEPS)
    pooled_step = {"forward": TP_POOLED_STEPS, "g_pooled": TP_POOLED_STEPS,
                   "d_w": TP_POOLED_STEPS, "d_img": 0}
    with tempfile.TemporaryDirectory() as work:
        ref = {name: os.path.join(work, f"{name}.json") for name in
               ("single", "blocked", "blocked_pooled")}
        single = dp_train_arm(store_dir, ref["single"], batch=batch)
        blocked = dp_train_arm(store_dir, ref["blocked"], batch=batch,
                               blocks=TP_MODEL)
        blocked_pooled = dp_train_arm(store_dir, ref["blocked_pooled"],
                                      batch=batch, blocks=TP_MODEL, **pooled)
        grads = [torch.load(ref[name] + ".grad.pt", map_location="cuda:0")
                 for name in ("single", "blocked")]
        blocked_gap = l2({k: grads[1][k] - v for k, v in grads[0].items()}) \
            / l2(grads[0])
        del grads
        torch.cuda.empty_cache()
        tp = dict(model_parallel=TP_MODEL, also=ref["single"])

        def arm(name, reference, fault=None, **kw):
            return dict(arm=name, reference=reference, fault=fault,
                        arm_kw=dict(tp, **kw))

        # the four arms in one pair of rank processes, one after the other
        runs = dp_ranks("tp", *spec, store_dir, work, ref["blocked"],
                        batch=batch, arm_kw=dict(tp, val=True), then=[
                            arm("tp_pooled", ref["blocked_pooled"],
                                **dict(pooled, also=None)),
                            arm("control_col0", ref["blocked"], "col0"),
                            arm("control_allreduce", ref["blocked"],
                                "allreduce")])
        masks = {name: dp_masks_agree(ranks, single, cfg)
                 for name, ranks in runs.items() if name != "tp_pooled"}
        # one process's val() on the ranks' gathered weights
        qa, _ = train_data(cfg, DP_STEPS * batch // TRAIN_BATCH)
        one = Solver(cfg, qa, FeatureStore(store_dir),
                     params=init_params(cfg, torch.Generator().manual_seed(0)))
        one.set_weights(torch.load(os.path.join(work, "tp_rank0.json")
                                   + ".state.pt", map_location="cuda:0"))
        wqf.launch_count = 0
        one_val = list(one.val())
        one_k1 = wqf.launch_count
        del one
        torch.cuda.empty_cache()
    gates = {name: dp_gates(ranks, blocked_pooled if name == "tp_pooled"
                            else blocked, masks.get(name),
                            pooled_step if name == "tp_pooled" else None)
             for name, ranks in runs.items()}
    val_equal = [r["val"][1] == one_val[1] and abs(r["val"][0] - one_val[0])
                 <= 1e-6 * abs(one_val[0]) for r in runs["tp"]]
    fields = dict(
        model="mhb_coAtt", mesh=[world // TP_MODEL, TP_MODEL], batch=batch,
        steps=DP_STEPS, pooled_steps=TP_POOLED_STEPS,
        rate=cfg.dropout_fusion, single_losses=single["losses"],
        blocked_losses=blocked["losses"],
        blocked_pooled_losses=blocked_pooled["losses"],
        blocked_vs_single_grad_rel_diff=blocked_gap,
        single_bytes={k: single[k] for k in ("param_bytes", "grad_bytes",
                                             "adam_bytes")},
        grad_rtol=DP_GRAD_RTOL, loss_rtol=TRAIN_LOSS_RTOL,
        one_process_val=one_val, one_process_k1_val_launches=one_k1,
        val_equal=val_equal)
    for name, ranks in runs.items():
        fields[name] = dict(
            world=len(ranks), losses=[r["losses"] for r in ranks],
            loss_rel_diff=dp_loss_rel_diff(
                ranks, blocked_pooled if name == "tp_pooled" else blocked),
            grad_rel_diff=[r["grad_rel_diff"] for r in ranks],
            replicated_grad_rel_diff=[r["replicated_grad_rel_diff"]
                                      for r in ranks],
            grad_rel_diff_to_plain_process=[r.get("also_grad_rel_diff")
                                            for r in ranks],
            grad_norm_ratio=[r["grad_norm_ratio"] for r in ranks],
            worst_params=ranks[0]["worst_params"],
            max_param_diff=[r["max_param_diff"] for r in ranks],
            bytes=[{k: r[k] for k in ("param_bytes", "grad_bytes",
                                      "adam_bytes")} for r in ranks],
            launches=[r["k2_launches"] for r in ranks],
            k2_first_call=[r["k2_calls"][0] if r["k2_calls"] else None
                           for r in ranks],
            masks_agree=masks.get(name), gates=gates[name])
        if name == "tp":
            fields[name].update(val=[r["val"] for r in ranks],
                                k1_val_launches=[r["k1_val_launches"]
                                                 for r in ranks])
    say("tp_train", **fields,
        note=("two ranks share one card: correctness, not scaling"
              if cards == 1 else f"a rank a card over {cards} cards"),
        card=smi)
    for name in ("tp", "tp_pooled"):
        if not all(gates[name].values()):
            raise AssertionError(f"tp_train: the {name} arm failed a gate: "
                                 f"{gates[name]}")
    if masks["control_col0"] != [r % TP_MODEL != 1 for r in range(world)]:
        raise AssertionError("tp_train: the masks gate does not reject the "
                             "column-offset control's model rank 1 alone")
    if gates["control_allreduce"]["replicated_gradient"]:
        raise AssertionError("tp_train: the replicated layers' gradient gate "
                             "does not reject the control without the model "
                             "group's all-reduce")
    if not all(val_equal) or one_k1 != 1 or any(
            r["k1_val_launches"] != 1 for r in runs["tp"]):
        raise AssertionError("tp_train: a rank's val() is not one process's "
                             "on the gathered weights, or K1 did not launch "
                             "once a val batch")
    return {"K2": {key: sum(r["k2_launches"][key] for r in runs["tp"])
                   for key in dp_per_step()},
            "K3": {key: sum(r["k2_launches"][key] for r in runs["tp_pooled"])
                   for key in pooled_step},
            "K1": sum(r["k1_val_launches"] for r in runs["tp"])}


def bank_train_arm(spec: dict, out: str) -> None:
    """A rank of ``sharded_bank_train``: for each store of ``spec["banks"]``
    (f16, int8), BANK_TRAIN_STEPS steps of the data-parallel Solver (dp_train's
    configuration) from the host feed, the replicated bank and the sharded
    bank: the losses and the rank's bank bytes. Writes JSON."""
    from vqa_attention_networks_tpu_torch.parallel import distributed

    cfg = dp_config(spec["batch"])
    qa, _ = train_data(cfg, BANK_TRAIN_STEPS * spec["batch"] // TRAIN_BATCH)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    result = {"rank": distributed.rank(), "world": distributed.world_size()}
    feeds = {"host": {}, "replicated": dict(device_feature_bank=True),
             "sharded": dict(device_feature_bank=True,
                             device_feature_bank_shard=True)}
    for kind, store_dir in spec["banks"].items():
        store = FeatureStore(store_dir)
        for feed, kw in feeds.items():
            losses = []
            solver = Solver(cfg.replace(**kw), qa, store, params=params)
            for name in tf.launch_count:
                tf.launch_count[name] = 0
            solver.train(on_step=lambda s, loss: losses.append(float(loss)))
            entry = {"losses": losses, "k2_launches": dict(tf.launch_count)}
            if solver.bank is not None:
                entry["bank_bytes"] = solver.bank.nbytes
            result[f"{kind}_{feed}"] = entry
            del solver
            torch.cuda.empty_cache()
    with open(out, "w") as f:
        json.dump(result, f)


def sharded_bank_train_phase(store_dir: str, smi: str,
                             cards: int = 1) -> dict:
    """Phase 36, ``sharded_bank_train``: the sharded training bank over the
    data ranks, two gloo ranks sharing ``cuda:0`` on one card (N NCCL
    ranks over N cards), on phase 4's f16 store and its int8 twin:
    BANK_TRAIN_STEPS steps of dp_train's Solver from the host feed, the
    replicated bank and the sharded bank. Gates: each rank's losses
    bit-equal across the three feeds; a rank's sharded bank 1/D of the
    replicated one (the store padded to a multiple of D). Reports each
    rank's bank bytes. -> K2's launches in every rank and feed, by kind."""
    world = 2 if cards == 1 else cards
    backend = "gloo" if cards == 1 else "nccl"
    devices = (["cuda:0"] * 2 if cards == 1
               else [f"cuda:{i}" for i in range(cards)])
    batch = TRAIN_BATCH * (1 if cards == 1 else cards)
    with tempfile.TemporaryDirectory() as work:
        int8 = os.path.join(work, "int8")
        quantize_store(store_dir, int8)
        ranks = dp_ranks("banks", world, backend, devices, store_dir, work,
                         None, batch=batch,
                         banks={"f16": store_dir, "int8": int8})
    equal, ratio = {}, {}
    for kind in ("f16", "int8"):
        equal[kind] = all(
            r[f"{kind}_{feed}"]["losses"] == r[f"{kind}_host"]["losses"]
            for r in ranks for feed in ("replicated", "sharded"))
        ratio[kind] = [r[f"{kind}_replicated"]["bank_bytes"]
                       / r[f"{kind}_sharded"]["bank_bytes"] for r in ranks]
    say("sharded_bank_train", model="mhb_coAtt", data_ranks=world,
        batch=batch, steps=BANK_TRAIN_STEPS, images=N_IMAGES,
        runs={k: v for k, v in ranks[0].items()
              if k not in ("rank", "world")},
        bank_bytes={f"{k}_{f}": [r[f"{k}_{f}"]["bank_bytes"] for r in ranks]
                    for k in ("f16", "int8")
                    for f in ("replicated", "sharded")},
        bit_equal=equal, replicated_over_sharded_bytes=ratio,
        note=("two ranks share one card: the ring goes through the host "
              "(gloo)" if cards == 1 else f"NCCL over {cards} cards"),
        card=smi)
    if not all(equal.values()):
        raise AssertionError("sharded_bank_train: a feed's losses are not "
                             f"bit-equal to the host feed's: {equal}")
    want = world * -(-N_IMAGES // world) / N_IMAGES
    if any(abs(x - world / want) > 1e-9 for v in ratio.values() for x in v):
        raise AssertionError(f"sharded_bank_train: a rank's sharded bank is "
                             f"not 1/{world} of the store: {ratio}")
    runs = [r[k] for r in ranks for k in r if k not in ("rank", "world")]
    per_step = {key: n * BANK_TRAIN_STEPS // DP_STEPS
                for key, n in dp_per_step().items()}
    if any(run["k2_launches"] != per_step for run in runs):
        raise AssertionError("sharded_bank_train: K2 did not launch once a "
                             "step by kind in every rank and feed")
    return {key: sum(run["k2_launches"][key] for run in runs)
            for key in per_step}


def sharded_bank_serve_phase(cfg: Config, params, store_dir: str, smi: str,
                             cards: int = 1) -> int:
    """Phase 37, ``sharded_bank_serve``: full-width bf16 mhb_coAtt (phase
    4's weights) served by id from the device feature cache split over the
    replicas of ``InferenceEngine(data_parallel=2)`` on ``cuda:0`` (N over
    N cards), phase 4's 2048 requests from the int8 twin of its store, at
    capacity SHARDED_BANK_SMALL (rounded up to a multiple of the replicas:
    the eviction regime) and N_IMAGES (warm: every request a hit), against
    one replica's cache at the rounded capacity. Gates: answers bit-equal
    to one replica's; K1 once a shard; the hits, misses, evictions and
    slots those of the same id sequence through a cache on the CPU (JAX's
    rules); the capacity rounded up. -> K1's launches in the split runs."""
    image_ids, ques = traffic(cfg)
    n_req = len(ques)
    spans = [slice(s, s + BATCH) for s in range(0, n_req, BATCH)]
    id_batches = [image_ids[s] for s in spans]
    replicas = 2 if cards == 1 else cards
    k1, fields = 0, {}
    with tempfile.TemporaryDirectory() as work:
        store = quantize_store(store_dir, os.path.join(work, "int8"))
        engines = {n: InferenceEngine(
            cfg, params, batch_size=BATCH, topk=5, input_dtype="int8",
            data_parallel=n,
            device=[torch.device("cuda", 0)] * n if cards == 1 else None)
            for n in (1, replicas)}
        for name, capacity in (("eviction", SHARDED_BANK_SMALL),
                               ("warm", N_IMAGES)):
            rounded = -(-capacity // replicas) * replicas
            runs, states = {}, {}
            for n, engine in engines.items():
                cache = engine.attach_feature_cache(
                    rounded if n == 1 else capacity, store.gather_quantized)
                runs[n] = stream(engine, lambda e=engine:
                                 e.predict_stream_by_id(
                                     (image_ids[s], ques[s], None)
                                     for s in spans),
                                 {"K1": K1_KERNELS},
                                 after_warm_up=cache.reset_stats)
                states[n] = cache_state(cache)
                states[n]["capacity"] = cache.capacity
            replayed = replayed_state(cfg, rounded, id_batches)
            replayed["capacity"] = rounded
            equal = bit_equal(runs[replicas][0], runs[1][0])
            launches = runs[replicas][1]["K1"]
            k1 += launches
            same = states[replicas] == replayed
            for state in states.values():
                state.pop("slots")
            fields[name] = dict(
                capacity_asked=capacity, capacity=rounded,
                bit_equal=equal, k1_launches=launches,
                counts=states[replicas], counts_one_replica=states[1],
                counts_and_slots_equal_cpu_cache=same)
            if not equal or not same or launches != replicas * N_BATCHES:
                raise AssertionError(
                    f"sharded_bank_serve ({name}): answers not bit-equal to "
                    "one replica's, counts or slots not the CPU cache's, or "
                    f"K1 launched {launches} times for {N_BATCHES} batches "
                    f"of {replicas} shards")
        del engines
        torch.cuda.empty_cache()
    say("sharded_bank_serve", model="mhb_coAtt", requests=n_req,
        batch=BATCH, replicas=replicas,
        devices="cuda:0 x2" if cards == 1 else f"cuda:0..{cards - 1}",
        **fields, card=smi)
    if fields["eviction"]["counts"]["evictions"] == 0 or \
            fields["warm"]["counts"]["misses"] != 0:
        raise AssertionError("sharded_bank_serve: the small bank never "
                             "evicted, or the warm one missed")
    return k1


def kernel_entry(name, source, replaces, n_launches, err) -> dict:
    """A kernel's entry of the kernels line (its times are
    ``vqa_attention_networks_tpu_torch/step_time.py``'s)."""
    return {"name": name, "source": source, "replaces": replaces,
            "launches": n_launches, "max_abs_err": err}


# N1, MCAN's fused residual + LayerNorm (phase 38): the kernel's name in a
# CUDA profile (both of its template instances) and its launches in one
# MCAN forward (12 over the words, 18 over the grid, 1 in the head)
N1_SOURCE = "vqa_attention_networks_tpu_torch/csrc/mcan_layernorm.cu"
N1_REPLACES = ("none: the composed add_layernorm_composed "
               "(vqa_attention_networks_tpu_torch/ops/mcan_norm.py)")
N1_KERNELS = ("add_layernorm_kernel",)
N1_PER_FORWARD = 31
N1_MAX_DIFFERING = 0.01
MCAN_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "port_bench", "configs", "mcan_large.json")
# the limit of the MCAN cell's logit_err, which phase 38 holds the by-id
# answers to against the composed forward's logits
MCAN_WORKLOAD = os.path.join(os.path.dirname(MCAN_CONFIG), os.pardir,
                             "workloads", "mcan_large.serve_byid.json")

# N2, MCAN's attention (phase 38): the kernel's name in a CUDA profile and
# its launches in one MCAN forward (6 encoder, 6 decoder self- and 6
# guided attentions)
N2_SOURCE = "vqa_attention_networks_tpu_torch/csrc/mcan_attention.cu"
N2_REPLACES = ("none: the composed attention_composed "
               "(vqa_attention_networks_tpu_torch/ops/mcan_attention.py)")
N2_KERNELS = ("mcan_attention_kernel",)
N2_PER_FORWARD = 18


def n1_eps_under_the_root(x, r, w, b) -> torch.Tensor:
    """The control: the unbiased variance with eps under the root, what
    MCAN's norm is not."""
    z = (x + r).float()
    y = w * (z - z.mean(-1, keepdim=True)) / torch.sqrt(
        z.var(-1, keepdim=True) + mcan_norm.EPS) + b
    return y.to(x.dtype)


def n1_check(dev) -> float:
    """N1 against its composed form at MCAN-large's three shapes and on
    rows of a tiny spread, with the eps control there -> max |diff|."""
    cases = {name: (rows, d, 1.0)
             for name, (rows, d) in cc.N1_SHAPES.items()}
    cases["tiny_spread"] = (cc.N1_SHAPES["words"][0], 1024, 1e-3)
    max_err = 0.0
    for i, (name, (rows, d, spread)) in enumerate(cases.items()):
        x, r, w, b = cc.n1_inputs(rows, d, 38 + i, dev, spread)
        got = mcan_norm.add_layernorm(x, r, w, b)
        again = mcan_norm.add_layernorm(x, r, w, b)
        want = mcan_norm.add_layernorm_composed(x, r, w, b)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        ok = bool(n1_within(got, want).all())
        differing = float((diff > 0).float().mean())
        fields = {}
        if spread < 1.0:
            fields["eps_under_root_rejected_share"] = float(
                (~n1_within(n1_eps_under_the_root(x, r, w, b), want))
                .float().mean())
        say("n1_check", case=name, rows=rows, d=d, spread=spread,
            max_abs_diff=float(diff.max()), differing_share=differing,
            within_tolerance=ok, rerun_bit_equal=bool(torch.equal(got,
                                                                  again)),
            finite=bool(torch.isfinite(got.float()).all()), **fields)
        if not ok or differing >= N1_MAX_DIFFERING or \
                not torch.isfinite(got.float()).all():
            raise AssertionError(f"N1 disagrees with its composed form at "
                                 f"{name} [{rows}, {d}]")
        if not torch.equal(got, again):
            raise AssertionError("N1 is not deterministic across reruns")
        if fields and fields["eps_under_root_rejected_share"] < 0.5:
            raise AssertionError("n1_check: a norm with eps under the root "
                                 "passes the tolerance")
        max_err = max(max_err, float(diff.max()))
        del x, r, got, again, want, diff
    return max_err


def n2_check(dev) -> float:
    """N2 at MCAN-large's three attention shapes against the f32 composed
    attention (TF32 off): its largest error no larger than the composed
    bf16 form's plus one bf16 ulp of the output's magnitude
    (``n2_within``), finite, bit-equal reruns -> its largest error."""
    max_err = 0.0
    for i, (name, (heads, lq, lk)) in enumerate(cc.N2_SHAPES.items()):
        q, k, v, mask = cc.n2_inputs(BATCH, heads, lq, lk, 380 + i, dev)
        got = mcan_attention.attention(q, k, v, mask)
        again = mcan_attention.attention(q, k, v, mask)
        want = mcan_attention.attention_composed(
            q.float(), k.float(), v.float(), mask, heads)
        composed = mcan_attention.attention_composed(q, k, v, mask, heads)
        torch.cuda.synchronize()
        err = float((got.float() - want).abs().max())
        composed_err = float((composed.float() - want).abs().max())
        ok = n2_within(got, want, composed)
        finite = bool(torch.isfinite(got.float()).all())
        say("n2_check", case=name, shape=[BATCH, heads, lq, lk],
            max_abs_err=err, composed_bf16_max_abs_err=composed_err,
            within_tolerance=ok,
            mean_abs_err=float((got.float() - want).abs().mean()),
            composed_bf16_mean_abs_err=float(
                (composed.float() - want).abs().mean()),
            rerun_bit_equal=bool(torch.equal(got, again)), finite=finite)
        if not ok or not finite:
            raise AssertionError(f"N2 rounds more than the composed form at "
                                 f"{name}: {err} against {composed_err}")
        if not torch.equal(got, again):
            raise AssertionError("N2 is not deterministic across reruns")
        max_err = max(max_err, err)
        del q, k, v, got, again, want, composed
    return max_err


def mcan_serve(stores: tuple, dev, smi: str) -> dict:
    """MCAN-large served by id from the device feature cache beside the
    per-request int8 feed, on phase 28's requests -> N1's and N2's launches
    in both measured passes. Gates: by id bit-equal to the int8 feed, N1
    31 and N2 18 times a batch on the card in each, by id one graph replay
    a batch, and its answers within the MCAN cell's ``logit_err`` limit of
    the composed forward's logits (``reference_kernels``: no kernel) on
    the same dequantised grids."""
    with open(MCAN_CONFIG) as f:
        cfg = Config(**json.load(f)["fields"]).validate()
    params = init_params(cfg, torch.Generator().manual_seed(38))
    store = stores[1]
    image_ids, ques = bank_traffic(cfg)
    spans = [slice(s, s + BATCH) for s in range(0, len(ques), BATCH)]
    engine = InferenceEngine(cfg, params, batch_size=BATCH, topk=5,
                             input_dtype="int8")

    def int8_batches():
        def items():
            for s in spans:
                rows, scale = store.gather_quantized(image_ids[s])
                yield rows, ques[s], None, scale

        return engine.predict_stream(items())

    def by_id():
        return engine.predict_stream_by_id(
            (image_ids[s], ques[s], None) for s in spans)

    kernels = {"N1": N1_KERNELS, "N2": N2_KERNELS}
    preds8, feed = stream(engine, int8_batches, kernels)
    engine.attach_feature_cache(BANK_IMAGES, store.gather_quantized)
    warm = []
    preds, launches = stream(
        engine, by_id, kernels,
        after_warm_up=lambda: warm.append(engine._graph.replays))
    replays = engine._graph.replays - warm[0]
    per = {"N1": N1_PER_FORWARD, "N2": N2_PER_FORWARD}
    same = bit_equal(preds, preds8)
    with torch.no_grad():
        composed = []
        for s in spans:
            rows, scale = store.gather_quantized(image_ids[s])
            img = dequantize(torch.from_numpy(rows).to(dev),
                             torch.from_numpy(scale).to(dev), torch.bfloat16)
            composed.append(engine.model(
                img, torch.from_numpy(ques[s]).long().to(dev),
                reference_kernels=True).float())
    with open(MCAN_WORKLOAD) as f:
        limit = json.load(f)["limits"]["logit_err"]
    err = serve_numbers(np.stack([p.top_ids for p in preds]),
                        np.stack([p.top_probs for p in preds]),
                        torch.cat(composed))["logit_err"]
    say("mcan_serve", model="mcan", config="mcan_large", requests=len(ques),
        batch=BATCH, images=BANK_IMAGES, n1_launches_int8_feed=feed["N1"],
        n1_launches_by_id=launches["N1"],
        n1_launches_expected=N1_PER_FORWARD * N_BATCHES,
        n2_launches_int8_feed=feed["N2"], n2_launches_by_id=launches["N2"],
        n2_launches_expected=N2_PER_FORWARD * N_BATCHES,
        graph_replays=replays, bit_equal_to_int8_feed=same,
        logit_err_vs_composed=err, logit_err_limit=limit, card=smi)
    for key, n in per.items():
        if feed[key] != n * N_BATCHES or launches[key] != n * N_BATCHES:
            raise AssertionError(f"mcan_serve: {key} ran {feed[key]} (int8 "
                                 f"feed) and {launches[key]} (by id) times "
                                 f"on the card, not {n} a batch")
    if replays != N_BATCHES or not same:
        raise AssertionError("mcan_serve: by id did not replay the graph "
                             "once a batch, or is not the int8 feed's")
    if not err <= limit:
        raise AssertionError(f"mcan_serve: by id's logit_err {err} against "
                             f"the composed forward is over {limit}")
    del engine
    torch.cuda.empty_cache()
    return {key: feed[key] + launches[key] for key in per}


def mcan_phase(stores: tuple, dev, smi: str) -> dict:
    """Phase 38: N1's and N2's checks, then MCAN-large served by id -> the
    kernels-line entries of N1 and N2."""
    err = n1_check(dev)
    torch.cuda.empty_cache()
    n2_err = n2_check(dev)
    torch.cuda.empty_cache()
    launches = mcan_serve(stores, dev, smi)
    return [kernel_entry("mcan_add_layernorm", N1_SOURCE, N1_REPLACES,
                         launches["N1"], err),
            kernel_entry("mcan_attention", N2_SOURCE, N2_REPLACES,
                         launches["N2"], n2_err)]


def mcan_main() -> None:
    """``chip_smoke.py --mcan``: phase 38 alone, N1 and N2 built alone, on
    a bank of BANK_IMAGES images of its own; prints the phase's lines (the
    builds with ptxas's registers and spills), the kernels line with N1's
    and N2's entries, nvidia-smi's line and the last line."""
    card_name, smi = card()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 references
    names = ("mcan_layernorm", "mcan_attention")
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build.build, names))
    for name, (_, _, log) in zip(names, built):
        say("build", kernel=name, ptxas=[ln.strip() for ln in log.splitlines()
                   if any(key in ln for key in ("registers", "spill"))])
    with tempfile.TemporaryDirectory() as ws:
        entries = mcan_phase(bank_stores(ws, Config()), dev, smi)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name,
        "count": torch.cuda.device_count()}}))


# N3, BAN's attention map (phase 39): the kernel's name in a CUDA profile
# and its launches in one BAN forward
N3_SOURCE = "vqa_attention_networks_tpu_torch/csrc/ban_attention.cu"
N3_REPLACES = ("none: the composed attention_map_composed "
               "(vqa_attention_networks_tpu_torch/ops/ban_attention.py)")
N3_KERNELS = ("ban_attention_kernel",)
N3_PER_FORWARD = 1
BAN_CONFIG = os.path.join(os.path.dirname(MCAN_CONFIG), "ban8.json")
# phase 39's gate on BAN-8's served answers: their logit_err against the
# float32 reference (``port_bench/reference/ban.py``) on the phase's weights
# (seed 39), grids and questions, set between the program's reading there
# and the float8 control's (the reference with float8 e4m3 products),
# which must read over it
BAN_LOGIT_ERR = 0.2


def n3_check(dev) -> float:
    """N3 at BAN-8's shape and at the port's default widths (three
    warpgroups), N = 256, against its map at its own rounding points
    (``n3_exact``, TF32 off): ``n3_within`` entry by entry, bit-equal
    reruns; the exact map without h_bias (the kernel leaves it out) within
    f32 rounding of the map with it; each control of ``n3_controls`` (the
    mask ignored, each glimpse's max taken per word, a glimpse normalised
    per warpgroup) outside the tolerance -> N3's largest error."""
    worst = 0.0
    for name, shape in (("ban8", cc.N3_SHAPE),
                        ("defaults", cc.N3_DEFAULT_SHAPE)):
        av, aq, h, hb, mask = cc.n3_inputs(BATCH, 39, dev, **shape)
        got = ban_attention.attention_map(av, aq, h, hb, mask)
        again = ban_attention.attention_map(av, aq, h, hb, mask)
        exact = cc.n3_exact(av, aq, h, hb, mask)
        no_bias = cc.n3_exact(av, aq, h, torch.zeros_like(hb), mask)
        composed = ban_attention.attention_map_composed(av, aq, h, hb, mask)
        controls = {c: cc.n3_within(m, exact) for c, m in
                    cc.n3_controls(av, aq, h, hb, mask).items()}
        torch.cuda.synchronize()
        err = float((got.float() - exact).abs().max())
        rel = float(((got.float() - exact).abs()
                     / exact.abs().clamp_min(cc.N3_FLOOR)).max())
        bias_err = float((no_bias - exact).abs().max())
        ok = cc.n3_within(got, exact)
        say("n3_check", shape_name=name, shape=[BATCH, *shape.values()],
            max_abs_err=err, max_rel_err=rel,
            composed_bf16_max_abs_err=float((composed.float() - exact)
                                            .abs().max()),
            h_bias_max_abs_effect=bias_err, within_tolerance=ok,
            controls_within=controls,
            rerun_bit_equal=bool(torch.equal(got, again)))
        if not ok:
            raise AssertionError(f"N3 at {name}'s shape is off its map at "
                                 f"its own rounding: {err} ({rel} of an "
                                 "entry)")
        if not torch.equal(got, again):
            raise AssertionError("N3 is not deterministic across reruns")
        if bias_err > 1e-6 or len(controls) < 3 or any(controls.values()):
            raise AssertionError(f"n3_check: h_bias moves the map by "
                                 f"{bias_err}, or a control passes: "
                                 f"{controls}")
        worst = max(worst, err)
        del av, aq, got, again, exact, no_bias, composed
        torch.cuda.empty_cache()
    return worst


def ban_serve(stores: tuple, dev, smi: str) -> int:
    """BAN-8 served by id from the device feature cache beside the
    per-request int8 feed, on phase 28's requests, with the benchmark's
    weights from a seed -> N3's launches in both measured passes. Gates:
    by id bit-equal to the int8 feed, N3 once a batch on the card in each,
    by id one graph replay a batch, the by-id pass's memory above its
    start under one [256, 8, 196, 3,840] bf16 tensor, and its answers'
    ``logit_err`` against the float32 reference on the same grids under
    BAN_LOGIT_ERR, over which the float8 control must read."""
    with open(BAN_CONFIG) as f:
        fields = json.load(f)["fields"]
    cfg = Config(**fields).validate()
    params = bench_inputs.tree(bench_inputs.weights(
        ban_reference.param_shapes(fields), 39, dev))
    store = stores[1]
    image_ids, ques = bank_traffic(cfg)
    spans = [slice(s, s + BATCH) for s in range(0, len(ques), BATCH)]
    engine = InferenceEngine(cfg, params, batch_size=BATCH, topk=5,
                             input_dtype="int8")

    def int8_batches():
        def items():
            for s in spans:
                rows, scale = store.gather_quantized(image_ids[s])
                yield rows, ques[s], None, scale

        return engine.predict_stream(items())

    def by_id():
        return engine.predict_stream_by_id(
            (image_ids[s], ques[s], None) for s in spans)

    kernels = {"N3": N3_KERNELS}
    preds8, feed = stream(engine, int8_batches, kernels)
    engine.attach_feature_cache(BANK_IMAGES, store.gather_quantized)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    warm = []
    preds, launches = stream(
        engine, by_id, kernels,
        after_warm_up=lambda: warm.append(engine._graph.replays))
    above = torch.cuda.max_memory_allocated() - start
    replays = engine._graph.replays - warm[0]
    same = bit_equal(preds, preds8)
    bench_common.exact_products()
    leaves_of = {f"{layer}/{leaf}": torch.as_tensor(v, device=dev)
                 for layer, leaves in params.items()
                 for leaf, v in leaves.items()}
    logits = {"float32": [], "float8": []}
    with torch.no_grad():
        for s in spans:
            rows, scale = store.gather_quantized(image_ids[s])
            img = dequantize(torch.from_numpy(rows).to(dev),
                             torch.from_numpy(scale).to(dev), torch.float32)
            q = torch.from_numpy(ques[s]).long().to(dev)
            for name, out in logits.items():
                out.append(ban_reference.forward(
                    leaves_of, img, q, fields,
                    bench_common.Precision(name)).cpu())
    want = torch.cat(logits["float32"])
    err = serve_numbers(np.stack([p.top_ids for p in preds]),
                        np.stack([p.top_probs for p in preds]),
                        want)["logit_err"]
    err8 = serve_numbers(*top_k(torch.cat(logits["float8"]), 5),
                         want)["logit_err"]
    einsum_bytes = BATCH * cfg.att_num * cfg.img_feature_dim * 3 * \
        cfg.hidden_dim * 2
    say("ban_serve", model="ban", config="ban8", requests=len(ques),
        batch=BATCH, images=BANK_IMAGES, n3_launches_int8_feed=feed["N3"],
        n3_launches_by_id=launches["N3"],
        n3_launches_expected=N3_PER_FORWARD * N_BATCHES,
        graph_replays=replays, bit_equal_to_int8_feed=same,
        by_id_bytes_above_start=above, einsum_operand_bytes=einsum_bytes,
        logit_err_vs_reference=err, logit_err_float8=err8,
        logit_err_limit=BAN_LOGIT_ERR, card=smi)
    n = N3_PER_FORWARD * N_BATCHES
    if feed["N3"] != n or launches["N3"] != n:
        raise AssertionError(f"ban_serve: N3 ran {feed['N3']} (int8 feed) "
                             f"and {launches['N3']} (by id) times on the "
                             f"card, not {N3_PER_FORWARD} a batch")
    if replays != N_BATCHES or not same:
        raise AssertionError("ban_serve: by id did not replay the graph "
                             "once a batch, or is not the int8 feed's")
    if above >= einsum_bytes:
        raise AssertionError(f"ban_serve: the by-id pass took {above} bytes "
                             f"above its start, an h (x) av tensor's worth")
    if not err <= BAN_LOGIT_ERR < err8:
        raise AssertionError(f"ban_serve: by id's logit_err {err} against "
                             f"the reference is over {BAN_LOGIT_ERR}, or "
                             f"the float8 control's {err8} is not")
    del engine
    torch.cuda.empty_cache()
    return feed["N3"] + launches["N3"]


def ban_phase(stores: tuple, dev, smi: str) -> list:
    """Phase 39: N3's check, then BAN-8 served by id -> the kernels-line
    entry of N3."""
    err = n3_check(dev)
    torch.cuda.empty_cache()
    launches = ban_serve(stores, dev, smi)
    return [kernel_entry("ban_attention", N3_SOURCE, N3_REPLACES, launches,
                         err)]


def ban_main() -> None:
    """``chip_smoke.py --ban``: phase 39 alone, N3 built alone, on a bank of
    BANK_IMAGES images of its own; prints the phase's lines (the build with
    ptxas's registers and spills), the kernels line with N3's entry,
    nvidia-smi's line and the last line."""
    card_name, smi = card()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 references
    _, _, log = _build.build("ban_attention")
    say("build", kernel="ban_attention", ptxas=[
        ln.strip() for ln in log.splitlines()
        if any(key in ln for key in ("registers", "spill"))])
    with tempfile.TemporaryDirectory() as ws:
        entries = ban_phase(bank_stores(ws, Config()), dev, smi)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name,
        "count": torch.cuda.device_count()}}))


def cards_main(cards: int) -> None:
    """``chip_smoke.py --cards N``: phases 33-37 alone over N cards of one
    host, a rank and a replica a card (``dp_train_phase``,
    ``dp_serve_phase``, ``tp_train_phase``, ``sharded_bank_train_phase``
    and ``sharded_bank_serve_phase`` with ``cards``): global batch 64 a
    card over NCCL against one card at that batch, tensor parallelism at
    (N/2, 2), the banks over N, and the split engine on its default
    devices. Builds K1, K2 and K3 only; prints the phases' lines and
    nvidia-smi's; a failed gate raises."""
    _, smi = card()
    if torch.cuda.device_count() < cards:
        raise SystemExit(f"chip_smoke --cards {cards}: "
                         f"{torch.cuda.device_count()} card(s) visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = ("stage1_coattention", "train_fusion", "pooled_fusion")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    cfg = Config()
    params = served_params(cfg, torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as tmp:
        store = make_synthetic_feature_store(tmp, list(range(N_IMAGES)))
        dp_train_phase(tmp, smi, cards)
        torch.cuda.empty_cache()
        dp_serve_phase(cfg, params, store, smi, cards)
        if cards % TP_MODEL == 0 or cards == 1:
            tp_train_phase(tmp, smi, cards)
        sharded_bank_train_phase(tmp, smi, cards)
        sharded_bank_serve_phase(cfg, params, tmp, smi, cards)
    print(smi)


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
             "glimpse_attention", "pooled_fusion", "lstm_scan",
             "mcan_layernorm", "mcan_attention", "ban_attention")
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build.build, names))
    for name, (path, _, log) in zip(names, built):
        ptxas = [ln.strip() for ln in log.splitlines()
                 if any(key in ln for key in ("registers", "spill", "arning",
                                              "(C75"))]
        say("build", kernel=name,
            library=str(path.relative_to(_build.BUILD_DIR.parents[1])),
            arch="sm_90a", ptxas=ptxas)

    # phase 3: K1 against its plain version at production shapes
    cfg = Config()
    max_err = 0.0
    for n in (8, 256, 1024):
        img, q, sw = cc.k1_inputs(n, n, dev)
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
            z * z.abs(), want_z * want_z.abs(), cc.POOLED_ATOL,
            cc.POOLED_RTOL)
        h1_ok, h1_max, h1_equal = scratch_diff(h1, want_h1, cc.H1_ATOL,
                                               cc.H1_RTOL)
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
        params = served_params(cfg, gen)
        blind = dict(params, co_att_conv2={"w": torch.zeros(512, 2),
                                           "b": torch.zeros(2)})
        bf16_cfg = cfg.replace(compute_dtype="bfloat16")
        launches["K1"] += serve_phase(
            "serve", cfg, params, store, {"K1": wqf}, dev, smi,
            control=blind,
            info={"composed": bf16_cfg.replace(fast_path="composed")})["K1"]

        # phase 6: K2 against its plain version at production widths
        k2_err = {}
        for n in K2_NS:
            for rate in K2_RATES:
                for name, err in k2_check(n, rate, dev).items():
                    k2_err[name] = max(k2_err.get(name, 0.0), err)
        torch.cuda.empty_cache()

        # phase 7: training through the port's Solver (the K2 main path)
        bf16_train = Config(compute_dtype="bfloat16")
        train_params = init_params(bf16_train, torch.Generator().manual_seed(0))
        runs = [train_phase("train", bf16_train, train_params, store, smi,
                            TRAIN_STEPS, "K2")]
        torch.cuda.empty_cache()

        # phase 9: K3 against its plain version at production widths
        k3_err = {}
        for n in K3_NS:
            for name, err in k3_check(n, dev).items():
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

        # phase 13: K4 against its plain version
        k4_err = max(k4_check(n, dev) for n in (8, BATCH))

        # phase 14: full-width hieCoAtten served; whv, whq and the question
        # embedding drawn at 8x xavier so both maps are peaked; control:
        # whv and whq zeroed give uniform maps
        hie_cfg = Config(model_name="hieCoAtten")
        hie_params = hie_served_params(hie_cfg)
        zero_att = {"w": torch.zeros(hie_cfg.embed_size, 1),
                    "b": torch.zeros(1)}
        launches["K4"] += serve_phase(
            "serve_hiecoatten", hie_cfg, hie_params, store, {"K4": co}, dev,
            smi, control=dict(hie_params, fc_Whv=zero_att,
                              fc_Whq=zero_att))["K4"]
        torch.cuda.empty_cache()

        # phase 15: K5 against its plain version
        k5_err = max(k5_check(n, dev) for n in (8, BATCH))
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
                launches["K5"] += serve_phase(
                    f"serve_{name}", mfb_cfg, mfb_params, store, {"K5": gf},
                    dev, smi, control=dead)["K5"]
                if name == "mfb":
                    dead_fusion_check(mfb_cfg, mfb_params, store, dev)
            del mfb_params, dead
            torch.cuda.empty_cache()

        # phase 17: K7 against its plain version at both call shapes
        k7_err = max(k7_check(shape, quirk, dev) for shape in cc.K7_SHAPES
                     for quirk in (False, True))
        torch.cuda.empty_cache()

        # phase 18: mhb_coAtt with K7 (question glimpse, beside K1), then
        # composed with K5 and K7 (both glimpses)
        with switches(VQA_PALLAS_GLIMPSE="1"):
            served = serve_phase("serve_glimpse", cfg, params, store,
                                 {"K1": wqf, "K7": att}, dev, smi)
        composed_cfg = cfg.replace(fast_path="composed")
        with switches(VQA_PALLAS_GLIMPSE="1", VQA_FORCE_PALLAS="1"):
            composed = serve_phase("serve_composed", composed_cfg, params,
                                   store, {"K5": gf, "K7": att}, dev, smi)
        for key, n in (*served.items(), *composed.items()):
            launches[key] += n
        torch.cuda.empty_cache()

        # phase 19: mhb, visLstm, iBOWIMG and attentionNet served (no
        # kernel on their paths)
        for name in FAMILIES_SERVED:
            serve_family(name, store, dev, smi)

        # phase 20: hieCoAtten and those four trained
        for name in FAMILIES_TRAINED:
            train_family(name, store, smi)
            torch.cuda.empty_cache()

        # phase 31: the Solver's switches (K2), on phase 7's weights
        switch_params = init_params(bf16_train,
                                    torch.Generator().manual_seed(0))
        with tempfile.TemporaryDirectory() as work:
            for key, n in train_switches_phase(switch_params, store, tmp,
                                               work, smi).items():
                train_launches["K2"][key] += n
        del switch_params
        torch.cuda.empty_cache()

        # phase 33: data-parallel training, K2 in every rank, on phase
        # 4's store
        for key, n in dp_train_phase(tmp, smi).items():
            train_launches["K2"][key] += n

        # phase 34: the split-batch engine, two replicas on the card (K1)
        launches["K1"] += dp_serve_phase(cfg, params, store, smi)

        # phase 35: tensor parallelism at (1, 2), K2 and K3 on the shards,
        # K1 on the gathered weights
        tp = tp_train_phase(tmp, smi)
        for kernel in ("K2", "K3"):
            for key, n in tp[kernel].items():
                train_launches[kernel][key] += n
        launches["K1"] += tp["K1"]

        # phase 36: the sharded training bank over two data ranks (K2)
        for key, n in sharded_bank_train_phase(tmp, smi).items():
            train_launches["K2"][key] += n

        # phase 37: the device cache split over two replicas (K1)
        launches["K1"] += sharded_bank_serve_phase(cfg, params, tmp, smi)

    # phase 21: their f32 forwards on the card against the CPU's
    families_agree(dev)
    torch.cuda.empty_cache()

    # phase 23: K6 against its plain version at production widths
    k6_err = max(k6_check(n, dev) for n in K6_NS)
    torch.cuda.empty_cache()

    # phase 24: K6's path, its entry forward and backward
    launches["K6"] = k6_path(dev)
    torch.cuda.empty_cache()

    # phase 25: K8 against its plain version, then its path
    k8_err = max(k8_check(n, dev) for n in K8_NS)
    launches["K8"] = k8_path(dev)
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
        stores = bank_stores(os.path.join(ws, "data"), cfg)

        # phase 28: mhb_coAtt (K1) and hieCoAtten (K4) served by id
        by_id = serve_bank_phase(cfg, params, stores, dev, smi)
        launches["K1"] += by_id["K1"]
        launches["K4"] += by_id["K4"]

        # phase 29: the HTTP server in process (K1)
        launches["K1"] += serve_http_phase(cfg, params, stores[1], ws, dev,
                                           smi)

        # phase 30: the backbones, /predict_image, cli.predict (K1) and
        # cli.extract_features
        launches["K1"] += backbone_phase(cfg, params, ws, dev, smi)

        # phase 32: the exported serving artifact (K1, K4)
        for key, n in artifact_phase(cfg, params, stores, ws, dev,
                                     smi).items():
            launches[key] += n

        # phase 38: MCAN-large: N1 and N2 against their composed forms,
        # then served by id
        mcan_entries = mcan_phase(stores, dev, smi)

        # phase 39: BAN-8: N3 against its composed form, then served by id
        ban_entries = ban_phase(stores, dev, smi)
        del stores

    kernels = [kernel_entry("stage1_coattention", K1_SOURCE, K1_REPLACES,
                            launches["K1"], max_err)]
    for launch, replaces in K2_REPLACES.items():
        kernels.append(kernel_entry(
            f"train_fusion_{launch}", K2_SOURCE, replaces,
            train_launches["K2"][launch],
            max(k2_err["d_w"], k2_err["d_b"], k2_err["d_b_partials"])
            if launch == "d_w" else k2_err[launch]))
    for launch, replaces in K3_REPLACES.items():
        kernels.append(kernel_entry(
            f"pooled_fusion_{launch}", K3_SOURCE, replaces,
            train_launches["K3"][launch],
            max(k3_err["d_w"], k3_err["d_b"], k3_err["d_q"])
            if launch == "d_w" else max(k3_err["g_pooled"], k3_err["d_bq"])
            if launch == "g_pooled" else k3_err[launch]))
    kernels += [
        kernel_entry("coattention", K4_SOURCE, K4_REPLACES, launches["K4"],
                     k4_err),
        kernel_entry("inference_fusion", K5_SOURCE, K5_REPLACES,
                     launches["K5"], k5_err),
        kernel_entry("glimpse_attention", K7_SOURCE, K7_REPLACES,
                     launches["K7"], k7_err),
        kernel_entry("wq_grid_fusion", K6_SOURCE, K6_REPLACES,
                     launches["K6"], k6_err),
        # one call of the scan: one persistent launch
        kernel_entry("lstm_scan", K8_SOURCE, K8_REPLACES, launches["K8"],
                     k8_err),
        *mcan_entries,
        *ban_entries,
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name,
        "count": torch.cuda.device_count(),
    }}))

if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of phase 33, started there
        dp_rank(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1:2] == ["--cards"]:
        cards_main(int(sys.argv[2]))
    elif sys.argv[1:2] == ["--mcan"]:
        mcan_main()
    elif sys.argv[1:2] == ["--ban"]:
        ban_main()
    else:
        main()
