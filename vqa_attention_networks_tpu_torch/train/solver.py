"""The ``Solver`` (port of ``vqa_attention_networks_tpu/train/solver.py``):
the train step, ``train()`` over epochs with checkpoints and early
stopping, ``val()`` on one batch or over the whole split with its results
files, and the persistence of ``save_checkpoint`` / ``restore`` /
``save``, for all eight families and MCAN (``TRAINABLE``), at either
``dropout_site``, on one device or data-parallel over the ranks of a
process group.

- **Parameters**: the family's ``init_params`` drawn from a
  ``torch.Generator`` seeded by ``cfg.seed``, or a JAX-layout tree
  (``params=``) through ``weights.load_jax_params``; ``glove_table=``
  fills mhb_coAtt's frozen GloVe table under ``cfg.glove``. Parameters are
  f32 whatever the compute dtype, as in the JAX Solver.
- **Optimizer**: ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2
  0.999, eps 1e-8) and the staircase schedule of ``solver.py:159-166``:
  step s runs at ``lr * decay_rate ** (s // decay_step)``. optax reads its
  count before incrementing it, so step 0 runs at ``lr``.
- **Batches**: ``VqaBatches`` and ``prefetch`` of the port's
  ``data/dataset.py``, as the JAX Solver feeds them.
- **Feeds** (``solver.py:188-216``): f16 rows at bf16 compute, f32 else;
  an int8 store ships int8 rows and f16 scales, dequantised on the device
  (``feature_bank.dequantize``, the expression of JAX's ``_dequant`` and
  of ``aot.serving_forward``'s int8 path); under
  ``cfg.device_feature_bank`` the whole store sits on the device
  (``train/feature_bank.py``) and batches carry row indices, for
  ``train()`` and ``val()`` alike, bit-equal to the host feed.
- **The train step** (``solver.py:269-347``): the training forward (given
  the batch's ``ques_length``, which MHB reads, and its ``valid`` mask,
  which masks the pad rows out of a batch norm's statistics), the loss
  with its ``valid`` mask (soft cross entropy, cross entropy,
  ``soft_bce`` under ``loss_override``, or for MCAN its summed sigmoid BCE
  over VQA scores, ``losses.vqa_score_bce``), backward, Adam, then
  ``merge_batch_stats``: the momentum-0.1 EMA of the step's batch-norm
  statistics into the layers' running buffers (``_merge_batch_stats``,
  ``solver.py:70-107``; a no-op for the families without batch norm). Its
  randomness is a pure function of ``(cfg.seed + 1, step)``
  (``step_randomness``): the dropout generator's seed and K2's mask seed
  (the pooled site's mask comes from the generator). So a run resumed at
  step s replays step s's masks, as ``fold_in(base, step)`` does in JAX.
- **Gradient accumulation** (``grad_accum_steps = a > 1``,
  ``solver.py:295-337``): the batch splits along dim 0 into ``a``
  contiguous micro-batches, each differentiated on its own (backward per
  micro-batch, so activation memory is one micro-batch's, the gradients
  summing in ``.grad``); the sum is divided by ``a`` before Adam, the loss
  is the micro-batches' mean and the correct count their sum. Micro-batch
  i draws from ``step_randomness(base, step, i)``, so each has its own
  dropout masks and its own K2 seed (K2's mask is a function of the seed
  and the element's index within one launch: a shared seed would repeat
  one mask). The batch-norm EMA runs once per micro-batch, in order,
  skipping a micro-batch whose rows are all padding.
- **Remat** (``cfg.remat``, ``solver.py:277-280``): the training forward
  runs under ``torch.utils.checkpoint`` (non-reentrant) and is recomputed
  in backward, K2's forward included (two launches a step). The dropout
  generator is an explicit ``torch.Generator``, which the checkpoint does
  not restore: it is made from its seed inside the checkpointed function,
  so the recomputation draws the same masks and the gradients are
  bit-equal to a run without remat. The batch-norm statistics are the
  first forward's. Kept for parity with JAX's whole-apply
  ``jax.checkpoint``: with one checkpoint over the whole forward the
  backward holds all of the recomputed forward before it frees any, so
  the peak memory does not fall (checkpoints per stage, not built, are
  the way to lower it).
- **Profiler and NaN trap** (``solver.py:122-124, 592-637``):
  ``cfg.profile_steps`` runs ``torch.profiler`` (CPU, and CUDA on the card)
  over the first steps of ``train()`` up to step ``profile_steps``, waits
  for the last one and writes a Chrome trace under ``cfg.profile_dir``,
  which holds the step's spans (``utils/trace.py``: ``train.feed_wait``,
  ``train.step`` and inside it ``train.device_batch``, ``train.forward``,
  ``train.backward``, ``train.optimizer``), recorded whenever a profiler
  records;
  ``cfg.debug_nans`` runs each step under
  ``torch.autograd.set_detect_anomaly``, which raises at the backward op
  that made a NaN. A non-finite epoch loss raises ``FloatingPointError``
  with JAX's recipe.
- **Checkpoints** (``utils/checkpoint.py``, the port's own format) every
  ``checkpoint_every_steps`` steps and at ``save()``: the module's
  ``state_dict`` (running buffers included), Adam's (its step counters
  too), the step, the early-stop record and the best snapshot, under
  ``<out_dir>/<model>/step_<n>``, ``keep_checkpoints`` of them kept. With
  the shuffle a function of ``(seed, epoch)``, ``restore()`` then
  ``train()`` continues bit for bit, mid-epoch too (``divmod(step,
  iters)``).
- **Early stopping** on val ``loss`` or ``acc`` with ``patience``
  (``solver.py:678-707``); the best snapshot is a copy of the weights,
  which ``save()`` exports to ``<out_dir>/<model>/weights``.
- **val()** scores one batch through the eval forward (K1 at bf16 on the
  card for mhb_coAtt, K4 for hieCoAtten); ``val(full=True)`` sweeps the
  split and writes ``results/<model>.txt`` (the reference's line, whose
  denominator counts pad rows), ``results/<model>.json`` (exact, top-3 and
  VQA-consensus accuracy, the per-answer-type and per-question-type
  breakdowns) and ``results/<model>_predictions.json`` (the leaderboard
  rows, valid rows only). Before the eval forward the model lays out K1's
  weights again if anything wrote them (a step, ``restore()``, a weights
  load or the best snapshot); a batch norm normalises by its running
  buffers.
- **Metrics**: with ``log_dir``, the per-epoch scalars of
  ``solver.py:665-676`` go to ``utils/logging.MetricWriter`` under the
  same tags; without it, stdout only.
- TF32 stays off: f32 products are full f32, the counterpart of the JAX
  package's ``Precision.HIGHEST``.

- **Data parallelism** (JAX's ``data`` mesh axis, ``solver.py:126-142``):
  inside a process group (``parallel.initialize_distributed``, one rank a
  device, ``torchrun --nproc_per_node N``) the Solver trains over the W
  ranks, ``data_parallel`` defaulting to W. Every rank assembles the same
  global batch and gathers the features of its own rows only
  (``parallel/sharding.step_rows``: its slice of each micro-batch). The
  model is wrapped in ``DistributedDataParallel`` (its gradient all-reduce
  is JAX's), and the step keeps JAX's global-batch semantics: each loss is
  the rank's valid rows' sum over the global micro-batch's valid count,
  times W against DDP's averaging, so the gradient is the global mean of
  a padded batch too; a batch norm's statistics are the global batch's
  (``layers.BatchNorm`` over the mesh's data group, which every gathered
  figure below spans too); the dropout masks, K2's included, are the
  rank's rows of the masks one process draws (``layers.GlobalRows``);
  micro-batches ``0..a-2`` run under ``no_sync()``; the batch-norm EMA
  skips a micro-batch with no valid row in the global batch. The step's
  loss and correct count, ``val()``'s sums and its predictions
  (``host_fetch``) are gathered, so every rank holds the same figures and
  stops early at the same epoch; the primary alone writes the results
  files, the metrics and the checkpoints, which every rank restores.
- **Tensor parallelism** (JAX's ``model`` mesh axis, ``solver.py:126-187``):
  with ``model_parallel = M`` the world is a ``(W, M)`` mesh
  (``parallel.make_mesh``), each data replica M ranks. Every "global"
  figure above spans the data axis only (its group is the mesh's data
  group: model ranks hold the same rows). The fusion projections are
  column-split over the model group (``parallel.sharding.shard_params``,
  JAX's ``_leaf_spec``), and the training forward computes each rank's
  block of every fusion and gathers it (``parallel/tensor.py``); Adam runs
  on the shards, elementwise, as JAX gives each moment its parameter's
  sharding. The replicated parameters stay bit-equal across the model
  group. The eval forward needs whole rows (the grid L2, K1): ``val()``
  runs it on ``eval_model()``, a replica made from the gathered weights at
  each ``val()``, K1's layout with it, and each model rank scores its data
  shard. Checkpoints, the best snapshot and the weights export hold the
  gathered tensors (Adam's moments too), so a checkpoint restores on any
  mesh, one process included; ``set_weights`` takes a full state dict.
- **The sharded bank** (``device_feature_bank_shard`` over W > 1 data
  ranks, ``train/feature_bank.py``): each data rank holds a row block of
  the store and the lookup is JAX's ring exchange around the data group,
  bit-equal to the replicated bank and the host feed. In one process, or
  without the flag, the bank is the replicated one, a copy of the store on
  each rank's device, as in JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import (Any, Callable, Dict, Iterator, Mapping, Optional,
                    Tuple, Union)

import numpy as np
import torch

from vqa_attention_networks_tpu_torch.config import SCORE_MODELS, Config
from vqa_attention_networks_tpu_torch.data.dataset import (
    Batch,
    VqaBatches,
    prefetch,
)
from vqa_attention_networks_tpu_torch.data.feature_store import FeatureStore
from vqa_attention_networks_tpu_torch.data.prepare import (
    ANSWER_TYPE_NAMES,
    QAData,
)
from vqa_attention_networks_tpu_torch.models import (
    TRAINABLE,
    ban,
    get_model,
    hiecoatten,
    ibowimg,
    mcan,
    mfb,
    mhb_coatt,
    vis_lstm,
)
from vqa_attention_networks_tpu_torch.models.layers import (
    GlobalRows,
    span_batch_statistics,
)
from vqa_attention_networks_tpu_torch.parallel import distributed
from vqa_attention_networks_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
)
from vqa_attention_networks_tpu_torch.parallel.sharding import (
    check_model_axis,
    gather_optimizer_state,
    gather_state_dict,
    local_optimizer_state,
    local_state_dict,
    shard_batch,
    shard_params,
    step_rows,
)
from vqa_attention_networks_tpu_torch.parallel.tensor import TensorParallel
from vqa_attention_networks_tpu_torch.train.feature_bank import (
    FeatureBank,
    dequantize,
)
from vqa_attention_networks_tpu_torch.train.losses import (
    correct_count,
    cross_entropy,
    soft_bce,
    soft_cross_entropy,
    topk_correct_count,
    vqa_consensus_scores,
    vqa_score_bce,
    vqa_scores,
)
from vqa_attention_networks_tpu_torch.utils import checkpoint as ckpt
from vqa_attention_networks_tpu_torch.utils import trace
from vqa_attention_networks_tpu_torch.utils.logging import (
    MetricWriter,
    NullMetricWriter,
)
from vqa_attention_networks_tpu_torch.utils.timer import Timer
from vqa_attention_networks_tpu_torch.weights import load_jax_params

# each family's random parameter tree (its ``init_params``)
_INIT_PARAMS = {
    "mhb_coAtt": mhb_coatt.init_params,
    "mhb": mhb_coatt.mhb_init_params,
    "hieCoAtten": hiecoatten.init_params,
    "mfb": mfb.init_params,
    "mfb-multilayer": mfb.init_params,
    "visLstm": vis_lstm.init_params,
    "iBOWIMG": ibowimg.ibowimg_init_params,
    "attentionNet": ibowimg.attention_net_init_params,
    "mcan": mcan.init_params,
    "ban": ban.init_params,
}
BN_MOMENTUM = 0.1  # torch nn.BatchNorm1d's default


def init_params(cfg: Config, generator: torch.Generator) -> Dict:
    """A random parameter tree of ``cfg.model_name`` in the JAX layout,
    drawn from ``generator`` (xavier-uniform weights, zero biases, a batch
    norm's running statistics at 0 and 1)."""
    return _INIT_PARAMS[cfg.model_name](cfg, generator)


def step_randomness(base: int, step: int,
                    micro: Optional[int] = None) -> Tuple[int, int]:
    """(dropout generator seed, K2 mask seed) of training step ``step``, or
    of its micro-batch ``micro`` under gradient accumulation: a pure
    function of ``(base, step[, micro])``, so a resumed run replays it (the
    counterpart of ``fold_in(fold_in(base, step), micro)``)."""
    key = [base, step] if micro is None else [base, step, micro]
    w = np.random.SeedSequence(key).generate_state(3, np.uint32)
    return int(w[0]) | (int(w[1]) << 32), int(w[2]) & 0x7FFFFFFF


def learning_rate(cfg: Config, step: int) -> float:
    """The staircase schedule at ``step`` (optax's ``exponential_decay``
    with ``staircase=True``)."""
    if not cfg.lr_decay:
        return cfg.lr
    return cfg.lr * cfg.decay_rate ** (step // cfg.decay_step)


def make_optimizer(model: torch.nn.Module, cfg: Config) -> torch.optim.Adam:
    """Adam with optax's defaults over the trainable parameters (the frozen
    GloVe table is a buffer)."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8)


def merge_batch_stats(model: torch.nn.Module,
                      batch_stats: Optional[Mapping[str, Mapping[
                          str, torch.Tensor]]],
                      live: Optional[torch.Tensor] = None) -> None:
    """EMA one forward's batch-norm statistics (its ``aux["batch_stats"]``:
    layer name -> {"mean", "var"}) into the layers' running buffers:
    ``(1 - BN_MOMENTUM) * running + BN_MOMENTUM * batch``, as
    ``_merge_batch_stats`` does for one micro-batch. Where the boolean
    ``live`` is false (a micro-batch of padding only) the buffers keep
    their values, as JAX's ``where(micro_valid[i] > 0, ...)``."""
    with torch.no_grad():
        for layer, stats in (batch_stats or {}).items():
            module = model.get_submodule(layer)
            for key, batch in stats.items():
                running = getattr(module, key)
                merged = (1 - BN_MOMENTUM) * running + BN_MOMENTUM * batch
                if live is not None:
                    merged = torch.where(live, merged, running)
                running.copy_(merged)


class TrainForward(torch.nn.Module):
    """The training forward of ``model`` as a module: what
    ``DistributedDataParallel`` wraps under data parallelism, with remat's
    checkpoint inside it (``torch.utils.checkpoint``, non-reentrant, which
    DDP needs). The dropout generator is made inside the checkpointed
    function: under ``remat`` the forward runs again in the backward, and
    a generator made from its seed there draws the same masks again (the
    checkpoint restores only the default generators, which no mask draws
    from)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, img, ques, ques_length, valid, make_generator,
                fusion_seed, reference_kernels: bool = False,
                remat: bool = False):
        def run(img, ques, ques_length, valid):
            return self.model(img, ques, ques_length, train=True,
                              valid=valid, generator=make_generator(),
                              fusion_seed=fusion_seed,
                              reference_kernels=reference_kernels, aux=True)

        if remat:
            return torch.utils.checkpoint.checkpoint(
                run, img, ques, ques_length, valid, use_reentrant=False,
                preserve_rng_state=False)
        return run(img, ques, ques_length, valid)


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               loss_fn: Callable[[torch.Tensor, slice], torch.Tensor],
               img: torch.Tensor, ques: torch.Tensor,
               ques_length: Optional[torch.Tensor] = None, *, lr: float,
               randomness: Callable[[Optional[int]], Tuple[
                   Callable[[], torch.Generator], int]],
               valid: Optional[torch.Tensor] = None,
               reference_kernels: bool = False, grad_accum_steps: int = 1,
               remat: bool = False,
               forward: Optional[torch.nn.Module] = None,
               micro_live: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step, the Solver's: ``grad_accum_steps`` micro-batches (rows
    ``rows = slice(i * m, (i + 1) * m)``, contiguous along dim 0), each a
    training forward, ``loss_fn(logits, rows)`` and its backward into
    ``.grad``; the summed gradients divided by ``a``, Adam at ``lr``, then
    each micro-batch's batch-norm statistics merged in order, skipping a
    micro-batch of padding only (``micro_live[i]`` false; by default, no
    valid row among its ``rows``). ``randomness(i)`` gives micro-batch i's
    (``None`` when ``a == 1``) dropout generator factory and K2 mask seed.
    ``forward`` is ``TrainForward(model)`` by default; a DDP-wrapped one
    runs micro-batches ``0..a-2`` under its ``no_sync()``, so the gradients
    are all-reduced once a step. Returns (loss, logits), detached: the
    micro-batches' mean loss and their logits in batch order."""
    a = grad_accum_steps
    m = img.shape[0] // a
    forward = forward if forward is not None else TrainForward(model)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    live = micro_live
    if live is None and a > 1 and valid is not None:
        live = valid.reshape(a, m).any(1)
    losses, logits_all, stats = [], [], []
    for i in range(a):
        rows = slice(i * m, (i + 1) * m)
        make_generator, fusion_seed = randomness(i if a > 1 else None)
        micro = [None if x is None else x[rows]
                 for x in (img, ques, ques_length, valid)]
        sync = (forward.no_sync() if i < a - 1 and hasattr(forward, "no_sync")
                else contextlib.nullcontext())
        with sync:
            with trace.span("train.forward"):
                logits, aux = forward(*micro, make_generator, fusion_seed,
                                      reference_kernels, remat)
                loss = loss_fn(logits, rows)
            with trace.span("train.backward"):
                loss.backward()
        losses.append(loss.detach())
        logits_all.append(logits.detach())
        stats.append(aux.get("batch_stats"))
    with trace.span("train.optimizer"):
        if a > 1:
            # the mean gradient, as JAX's sum over the scan divided by a
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(a)
        optimizer.step()
        for i, batch_stats in enumerate(stats):
            merge_batch_stats(model, batch_stats,
                              None if live is None else live[i])
    if a == 1:
        return losses[0], logits_all[0]
    return sum(losses) / a, torch.cat(logits_all)


def mesh_shape(cfg: Config) -> Tuple[int, int]:
    """The (data, model) mesh the Solver trains over, by JAX's mesh rules:
    inside a process group the model axis is ``model_parallel`` and the
    data axis the rest of the world (an explicit ``data_parallel`` must
    equal it); (1, 1) without one. Raises where the world, the batch or
    the fusion does not split."""
    if cfg.model_name not in TRAINABLE:
        raise ValueError(f"the Solver does not train {cfg.model_name!r}")
    model = cfg.model_parallel
    if model < 1:
        raise ValueError(f"model_parallel={model}: at least 1")
    if model > 1 and cfg.model_name in ("mcan", "ban"):
        raise ValueError(
            f"model_parallel={model}: tensor parallelism splits the MFB "
            f"fusions' columns (mfb_out), and {cfg.model_name} has none; "
            f"train {cfg.model_name} with model_parallel=1")
    if not distributed.is_initialized():
        if cfg.data_parallel > 1 or model > 1:
            ranks = max(cfg.data_parallel, 1) * model
            asked = " x ".join(
                f"{name}={v}" for name, v in (
                    ("data_parallel", cfg.data_parallel),
                    ("model_parallel", model)) if v > 1)
            raise ValueError(
                f"{asked} needs {ranks} ranks in a process group, one a "
                f"device: start the run with torchrun --nproc_per_node "
                f"{ranks} (the CLIs join it), or call "
                "parallel.initialize_distributed() in each rank")
        return 1, 1
    world = distributed.world_size()
    if world % model:
        raise ValueError(f"model_parallel={model} does not divide the "
                         f"process group's {world} ranks")
    data = world // model
    if cfg.data_parallel > 1 and cfg.data_parallel != data:
        raise ValueError(
            f"data_parallel={cfg.data_parallel} but the process group has "
            f"{world} ranks: the data axis spans every rank of a model "
            f"coordinate ({data} at model_parallel={model})")
    check_model_axis(cfg, model)
    if cfg.batch_size % data:
        raise ValueError(f"batch_size={cfg.batch_size} not divisible by "
                         f"data_parallel={data}")
    micro = cfg.batch_size // cfg.grad_accum_steps
    if micro % data:
        raise ValueError(
            f"a micro-batch of {micro} rows (batch_size={cfg.batch_size} / "
            f"grad_accum_steps={cfg.grad_accum_steps}) does not split over "
            f"data_parallel={data}")
    return data, model


class Solver:
    def __init__(
        self,
        cfg: Config,
        qa_data: QAData,
        store: FeatureStore,
        params: Optional[Mapping[str, Any]] = None,
        device: Union[str, torch.device, None] = None,
        reference_kernels: bool = False,
        glove_table: Optional[np.ndarray] = None,
        log_dir: Optional[str] = None,
    ):
        """``params`` is a JAX-layout tree (numpy arrays); without it the
        weights are drawn from ``cfg.seed``. ``glove_table`` ([q_vocab,
        emb_dim]) replaces mhb_coAtt's placeholder table under
        ``cfg.glove``. ``device`` defaults to the card (in a process
        group, ``cuda:LOCAL_RANK``); the CPU runs only when asked for by
        name. ``reference_kernels=True`` trains through K2's or K3's plain
        version in place of the kernels, for the comparisons of
        ``chip_smoke.py``. ``log_dir`` turns on the metric writer
        (``<log_dir>/<model>/events.jsonl``), on the primary rank."""
        cfg.validate()
        self.data_parallel, self.model_parallel = mesh_shape(cfg)
        self.cfg = cfg
        self.device = distributed.rank_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if params is None:
            params = init_params(cfg, torch.Generator().manual_seed(cfg.seed))
        if cfg.glove and glove_table is not None and "glove_table" in params:
            params = dict(params, glove_table=np.asarray(glove_table,
                                                         np.float32))
        model = get_model(cfg.model_name)(cfg).to(self.device)
        self.model = load_jax_params(model, params)
        self._forward: torch.nn.Module = TrainForward(self.model)
        # the rows of each split's global batches this rank holds (None:
        # all of them)
        self._rows: Dict[str, Optional[np.ndarray]] = {"train": None,
                                                       "val": None}
        # the mesh, its data axis' process group and this rank's place on
        # it, the model axis (set by _join_mesh)
        self.mesh, self._group, self._data_rank = None, None, 0
        self.tp: Optional[TensorParallel] = None
        # eval_model()'s replica on the gathered weights (tensor
        # parallelism)
        self._full: Optional[torch.nn.Module] = None
        if distributed.is_initialized():
            self._join_mesh()
        self.optimizer = make_optimizer(self.model, cfg)
        self.reference_kernels = reference_kernels
        self.writer = (MetricWriter(log_dir, run_name=cfg.model_name)
                       if log_dir is not None and distributed.is_primary()
                       else NullMetricWriter())
        self.step = 0
        self._rng_base = cfg.seed + 1
        # the feed (solver.py:188-216): f16 rows at bf16 compute (the model
        # casts on the device), f32 else; an int8 store ships int8 rows and
        # f16 scales, dequantised on the device in _dequant_dtype
        bf16 = cfg.compute_dtype == "bfloat16"
        quantized = bool(getattr(store, "quantized", False))
        self._dequant_dtype = torch.bfloat16 if bf16 else torch.float32
        feature_dtype = (np.int8 if quantized
                         else np.float16 if bf16 else np.float32)
        self.bank: Optional[FeatureBank] = None
        if cfg.device_feature_bank:
            sharded = cfg.device_feature_bank_shard and self.data_parallel > 1
            self.bank = FeatureBank(
                store, self._dequant_dtype if quantized
                else torch.float16 if bf16 else torch.float32,
                cfg.device_feature_bank_budget, self.device,
                shard=((self._data_rank, self.data_parallel) if sharded
                       else None),
                group=self._group, data_size=self.data_parallel)
        self.profile_trace: Optional[str] = None  # set by train()
        self.batches = {
            split: VqaBatches(
                getattr(qa_data, split), store,
                batch_size=cfg.batch_size, num_answers=cfg.a_vocab_size,
                soft_answer=cfg.soft_answer,
                shuffle=(cfg.shuffle and split == "train"), seed=cfg.seed,
                feature_dtype=feature_dtype,
                device_bank=self.bank is not None,
                feature_rows=self._rows[split],
            )
            for split in ("train", "val")
        }
        # the leaderboard file's answer words, and the question-type names
        # of the per_question_type breakdown
        self._answer_words = {i: w for w, i in qa_data.answer_vocab.items()}
        self._question_type_names = qa_data.question_type_names
        # early stopping (solver.py:42-45); best_state is a copy of the
        # weights at the best val epoch, or None
        self.min_val_loss = float("inf")
        self.best_val_acc = -1.0
        self.i_patience = 0
        self.best_state: Optional[Dict[str, torch.Tensor]] = None

    def _join_mesh(self) -> None:
        """Build the ``(data, model)`` mesh, cut the model to this rank's
        shards on the model axis (``parallel.sharding.shard_params``, which
        first broadcasts the model group's first rank's model), wrap the
        training forward in DDP over the mesh's data axis and take this
        rank's rows. The mesh's data group is the one set of ranks every
        global figure spans: DDP's gradients, the batch norm's statistics,
        the evaluation's sums and predictions. DDP broadcasts the data
        group's rank 0's parameters and buffers; K1's layout is then made
        again from them (a shard has none). The batch-norm buffers are
        merged by every rank from the same global statistics
        (``merge_batch_stats``), so DDP does not
        broadcast them again. A model whose training leaves parameters
        without a gradient says so (``unused_in_training``, mfb under its
        reference quirk): DDP then looks for them, which costs a walk of
        the graph a step, so only there."""
        from torch.nn.parallel import DistributedDataParallel

        cfg, world = self.cfg, self.data_parallel
        self.mesh = make_mesh(world, self.model_parallel, self.device.type)
        self._group = self.mesh.get_group(DATA_AXIS)
        self._data_rank = rank = self.mesh.get_local_rank(DATA_AXIS)
        if self.model_parallel > 1:
            self.tp = TensorParallel(self.mesh.get_group(MODEL_AXIS),
                                     self.mesh.get_local_rank(MODEL_AXIS),
                                     self.model_parallel)
            shard_params(self.model, self.tp, cfg.fusion_dim)
        span_batch_statistics(self.model, self._group)
        self._forward = DistributedDataParallel(
            self._forward,
            device_ids=[self.device] if self.device.type == "cuda" else None,
            broadcast_buffers=False,
            find_unused_parameters=getattr(self.model, "unused_in_training",
                                           False),
            process_group=self._group)
        if hasattr(self.model, "prepare"):
            self.model.prepare()
        if world > 1:
            self._rows = {
                "train": step_rows(cfg.batch_size, cfg.grad_accum_steps,
                                   rank, world),
                "val": step_rows(cfg.batch_size, 1, rank, world)}

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _loss(self, logits, answers, soft, valid, count=None):
        """The loss over ``valid``'s rows; ``count`` (data parallelism):
        the global batch's valid count, its denominator."""
        if self.cfg.loss_override == "soft_bce":
            return soft_bce(logits, soft, valid, count)
        if self.cfg.model_name in SCORE_MODELS:
            return vqa_score_bce(logits, soft, valid, count)
        if self.cfg.soft_answer:
            return soft_cross_entropy(logits, soft, valid, count)
        return cross_entropy(logits, answers, valid, count)

    def _labels(self, answers, soft):
        # soft-answer models score against the argmax'd distribution; one
        # definition for the device tensors and the host arrays of
        # val(full=True). A score model's device soft holds its scores,
        # which tie at 1 from four annotators on: it scores against the
        # hard labels
        if self.cfg.soft_answer and self.cfg.model_name not in SCORE_MODELS:
            return soft.argmax(-1)
        return answers

    def _device_batch(self, batch: Batch,
                      split: str = "train") -> Tuple[torch.Tensor, ...]:
        """This rank's rows of ``batch`` on the device."""
        if self._rows[split] is not None:
            batch = shard_batch(batch, self._rows[split])

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        soft = (put(batch.soft_answers) if batch.soft_answers is not None
                else None)
        if soft is not None and self.cfg.model_name in SCORE_MODELS:
            # a score model's loss reads each answer's VQA score
            soft = vqa_scores(soft, None if batch.soft_n is None
                              else put(batch.soft_n))
        if self.bank is not None:
            img = self.bank.lookup(put(batch.image_rows).long())
        elif batch.feature_scale is not None:
            img = dequantize(put(batch.image_features),
                             put(batch.feature_scale), self._dequant_dtype)
        else:
            img = put(batch.image_features)
        return (img, put(batch.questions), put(batch.ques_length),
                put(batch.answers).long(), put(batch.valid), soft)

    def _dropout_generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _randomness(self, micro: Optional[int]):
        """(dropout generator factory, K2 mask seed) of micro-batch
        ``micro`` at ``self.step``. A rank holds rows ``[row0, row0 + m/W)``
        of each global micro-batch of m rows: its generator stands for
        those rows (``layers.GlobalRows``)."""
        gen_seed, fusion_seed = step_randomness(self._rng_base, self.step,
                                                micro)
        if self.data_parallel == 1:
            return (lambda: self._dropout_generator(gen_seed)), fusion_seed
        m = self.cfg.batch_size // self.cfg.grad_accum_steps
        row0 = self._data_rank * m // self.data_parallel
        return (lambda: GlobalRows(self._dropout_generator(gen_seed), row0,
                                   m)), fusion_seed

    def _gathered(self, *values: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Scalars summed over the ranks (themselves in one process)."""
        if self.data_parallel == 1:
            return values
        return tuple(distributed.all_reduce_sum(torch.stack(values),
                                                self._group))

    def _train_step(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """``train_step`` at ``self.step`` -> (loss, correct count) of the
        global batch, on the device (span ``train.step``)."""
        with trace.span("train.step", self.step):
            with trace.span("train.device_batch"):
                (img, ques, qlen, answers, valid,
                 soft) = self._device_batch(batch)
            a, w = self.cfg.grad_accum_steps, self.data_parallel
            counts = live = None
            if w > 1:
                # each micro-batch's valid count and liveness in the global
                # batch (every rank holds its valid mask)
                per_micro = batch.valid.reshape(a, -1).sum(1)
                counts = [int(c) for c in per_micro]
                live = torch.from_numpy(per_micro > 0).to(self.device)
            m_local = img.shape[0] // a

            def loss_fn(out, rows):
                loss = self._loss(out, answers[rows],
                                  None if soft is None else soft[rows],
                                  valid[rows],
                                  None if counts is None
                                  else counts[rows.start // m_local])
                # DDP averages the ranks' gradients; the ranks' shares sum
                return loss if w == 1 else loss * w

            self.model.train()
            trap = (torch.autograd.set_detect_anomaly(True)
                    if self.cfg.debug_nans else contextlib.nullcontext())
            with trap:
                loss, logits = train_step(
                    self.model, self.optimizer, loss_fn,
                    img, ques, qlen, lr=learning_rate(self.cfg, self.step),
                    randomness=self._randomness, valid=valid,
                    reference_kernels=self.reference_kernels,
                    grad_accum_steps=a, remat=self.cfg.remat,
                    forward=self._forward, micro_live=live)
            correct = correct_count(logits, self._labels(answers, soft), valid)
            if w == 1:
                return loss, correct
            return self._gathered(loss / w, correct)

    def eval_model(self) -> torch.nn.Module:
        """The model the eval forward runs: the trained one, or under
        tensor parallelism a replica on the gathered weights, loaded again
        at each call (a collective over the model group: its ranks call
        this together), so its K1 layout follows every change of the
        shards (a step, ``restore()``, ``set_weights``)."""
        if self.tp is None:
            return self.model
        state = gather_state_dict(self.model)
        if self._full is None:
            self._full = get_model(self.cfg.model_name)(self.cfg).to(
                self.device)
        self._full.load_state_dict(state)
        if hasattr(self._full, "prepare"):
            self._full.prepare()
        return self._full.eval()

    def _eval_step(self, batch: Batch, model: torch.nn.Module
                   ) -> Tuple[torch.Tensor, ...]:
        """The eval forward of ``model`` (``eval_model()``) on one batch ->
        (loss, correct, top-3 correct) of the global batch, and this rank's
        per-row argmax, on the device."""
        img, ques, qlen, answers, valid, soft = self._device_batch(batch,
                                                                   "val")
        count = (int(batch.valid.sum()) if self.data_parallel > 1
                 else None)
        model.eval()
        with torch.no_grad():
            logits = model(img, ques, qlen)
            labels = self._labels(answers, soft)
            sums = self._gathered(
                self._loss(logits, answers, soft, valid, count),
                correct_count(logits, labels, valid),
                topk_correct_count(logits, labels, k=3, valid=valid))
            return (*sums, logits.argmax(dim=-1))

    # ------------------------------------------------------------------
    # the epoch loop and validation (solver.py:581-891)
    # ------------------------------------------------------------------

    def train(self, on_step: Optional[Callable[[int, torch.Tensor], None]]
              = None) -> Dict[str, float]:
        """Epochs of training steps from ``self.step``, one ``val()`` per
        epoch -> the last epoch's metrics. A checkpoint is written every
        ``checkpoint_every_steps`` steps; early stopping ends the run after
        ``patience`` epochs without a better val metric. ``on_step(step,
        loss)`` is called after each step with the step's index and its
        loss, a device tensor (reading it waits for the device)."""
        cfg = self.cfg
        iters_per_epoch = len(self.batches["train"])
        if iters_per_epoch == 0:
            raise ValueError(
                "training split is empty — nothing to train on (check "
                "--data_dir / the prepared artifact)"
            )
        print(f"Model: {cfg.model_name}")
        print(f"total training iterations: {cfg.num_epoch * iters_per_epoch}")
        last: Dict[str, float] = {}
        # a mid-epoch checkpoint resumes inside its epoch: the shuffle is a
        # function of (seed, epoch), so the trained prefix is skipped
        start_epoch, skip_batches = divmod(self.step, iters_per_epoch)
        with self._profiler() as profiler:
            for epoch in range(start_epoch, cfg.num_epoch):
                last, stop = self._epoch(epoch, start_epoch, skip_batches,
                                         on_step, profiler)
                if stop:
                    break
        return last

    @contextlib.contextmanager
    def _profiler(self):
        """``torch.profiler`` over the first steps (``cfg.profile_steps``),
        or nothing. Yields a callable that the epoch loop calls after each
        step: it stops the profiler, once the last profiled step is done
        on the device, and writes the trace."""
        cfg = self.cfg
        if cfg.profile_steps <= 0:
            yield lambda: None
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        running = [True]

        def after_step():
            if running[0] and self.step >= cfg.profile_steps:
                running[0] = False
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                prof.stop()
                os.makedirs(cfg.profile_dir, exist_ok=True)
                self.profile_trace = os.path.join(
                    cfg.profile_dir, f"{cfg.model_name}_trace.json")
                prof.export_chrome_trace(self.profile_trace)

        try:
            yield after_step
        finally:
            if running[0]:  # the run ended before step profile_steps
                running[0] = False
                prof.stop()

    def _epoch(self, epoch: int, start_epoch: int, skip_batches: int,
               on_step, after_step) -> Tuple[Dict[str, float], bool]:
        """One epoch of ``train()`` -> (its metrics, whether early stopping
        ends the run)."""
        cfg = self.cfg
        timer = Timer()
        timer.tic()
        seen = 0
        start_b = skip_batches if epoch == start_epoch else 0
        workers = min(cfg.prefetch_workers, os.cpu_count() or 1)
        if workers > 1:
            stream = self.batches["train"].parallel_epoch(
                epoch, start_batch=start_b, workers=workers)
        else:
            stream = prefetch(
                self.batches["train"].epoch(epoch, start_batch=start_b))
        for batch in self._waited(stream):
            loss_d, correct_d = self._train_step(batch)
            if on_step is not None:
                on_step(self.step, loss_d)
            self.step += 1
            after_step()
            seen += int(batch.valid.sum())
            if (cfg.checkpoint_every_steps
                    and self.step % cfg.checkpoint_every_steps == 0):
                self.save_checkpoint()
        # one sync per epoch for the metrics
        loss = float(loss_d)
        acc = float(correct_d) / max(int(batch.valid.sum()), 1)
        if not np.isfinite(loss):
            raise FloatingPointError(
                f"non-finite train loss at epoch {epoch} step {self.step}. "
                f"Recipe: rerun with Config.debug_nans=1 (traps the "
                f"originating op), check the feature store for clamp "
                f"warnings (data/feature_store.py), or drop to "
                f"--compute_dtype float32 to rule out bf16 overflow."
            )
        qps = seen / max(timer.toc(average=False), 1e-9)
        val_loss, val_acc = self.val()
        print(
            f">>> epoch {epoch} step {self.step} | train loss {loss:.5f} "
            f"acc {acc:.4f} | val loss {val_loss:.5f} acc {val_acc:.4f} "
            f"| {qps:.0f} qa-pairs/s"
        )
        self.writer.add_scalars(
            f"{cfg.model_name}/loss",
            {"train loss": loss, "val loss": val_loss}, self.step)
        self.writer.add_scalars(
            f"{cfg.model_name}/acc",
            {"train acc": acc, "val acc": val_acc}, self.step)
        self.writer.add_scalar(f"{cfg.model_name}/qa_pairs_per_sec", qps,
                               self.step)
        last = {"train_loss": loss, "train_acc": acc,
                "val_loss": val_loss, "val_acc": val_acc, "qps": qps}
        if cfg.early_stopping and self._early_stop(val_loss, val_acc):
            print(f"validation {cfg.early_stop_metric} has not improved "
                  f"for {cfg.patience} epochs, stopping")
            return last, True
        return last, False

    def _waited(self, stream: Iterator[Batch]) -> Iterator[Batch]:
        """``stream``'s batches, each wait for the next under the span
        ``train.feed_wait`` of the step it feeds."""
        batches = iter(stream)
        while True:
            with trace.span("train.feed_wait", self.step):
                batch = next(batches, None)
            if batch is None:
                return
            yield batch

    def _early_stop(self, val_loss: float, val_acc: float) -> bool:
        """Record one epoch's val metric (loss, solver.py:160-172, or acc,
        train_hfd.py:154-166); on a better one, snapshot the weights.
        -> whether ``patience`` epochs passed without one."""
        if self.cfg.early_stop_metric == "acc":
            improved = val_acc > self.best_val_acc
            if improved:
                self.best_val_acc = val_acc
        else:
            improved = val_loss < self.min_val_loss
            if improved:
                self.min_val_loss = val_loss
        if improved:
            self.i_patience = 0
            # a copy: the optimizer updates the parameters in place, so
            # references would follow the live weights
            self.best_state = {k: v.detach().clone()
                               for k, v in self._model_state().items()}
        else:
            self.i_patience += 1
        return self.i_patience >= self.cfg.patience

    def val(self, full: bool = False) -> Tuple[float, float]:
        """Validation -> (loss, exact-match accuracy over the valid rows).
        ``full=False`` scores one batch, the reference's training-mode
        validation (solver.py:154-156); ``full=True`` sweeps the split and
        writes the results files (solver.py:174-182)."""
        cfg = self.cfg
        n_types = len(ANSWER_TYPE_NAMES)
        type_n = np.zeros(n_types)
        type_correct = np.zeros(n_types)
        type_consensus = np.zeros(n_types)
        qtype_stats: dict = {}  # code -> [n, correct, consensus]
        predictions: list = []
        loss = loss_sum = total_correct = total_top3 = total_consensus = 0.0
        have_consensus = have_types = False
        total_valid = n_batches = 0
        model = self.eval_model()
        for batch in self.batches["val"].epoch():
            loss_d, correct_d, top3_d, preds_d = self._eval_step(batch, model)
            n_valid = int(batch.valid.sum())
            loss = float(loss_d)
            # valid-weighted: the split's mean, not the last batch's
            loss_sum += loss * n_valid
            total_correct += float(correct_d)
            total_top3 += float(top3_d)
            total_valid += n_valid
            n_batches += 1
            if not full:
                break
            # the global batch's predictions on every rank
            preds = distributed.host_fetch(preds_d, self._group)
            valid = batch.valid
            if batch.question_ids is not None:
                # leaderboard rows: valid rows only (pad rows repeat ids)
                predictions += [
                    {"question_id": int(qid),
                     "answer": self._answer_words.get(int(p), "UNK")}
                    for qid, p in zip(batch.question_ids[valid],
                                      preds[valid])]
            scores = None
            if batch.soft_n is not None:
                scores = vqa_consensus_scores(batch.soft_idx, batch.soft_val,
                                              preds, batch.soft_n)
                total_consensus += float((scores * valid).sum())
                have_consensus = True
            want_qtypes = (batch.question_types is not None
                           and self._question_type_names is not None)
            if batch.answer_types is not None or want_qtypes:
                hit = (preds == self._labels(batch.answers,
                                             batch.soft_answers)) & valid
            if batch.answer_types is not None:
                for t in range(n_types):
                    mask = (batch.answer_types == t) & valid
                    type_n[t] += mask.sum()
                    type_correct[t] += (hit & mask).sum()
                    if scores is not None:
                        type_consensus[t] += float((scores * mask).sum())
                have_types = True
            if want_qtypes:
                for t in np.unique(batch.question_types[valid]):
                    if t < 0:
                        continue
                    mask = (batch.question_types == t) & valid
                    d = qtype_stats.setdefault(int(t), [0.0, 0.0, 0.0])
                    d[0] += float(mask.sum())
                    d[1] += float((hit & mask).sum())
                    if scores is not None:
                        d[2] += float((scores * mask).sum())

        acc_exact = total_correct / max(total_valid, 1)
        if not full:
            return loss, acc_exact
        loss = loss_sum / max(total_valid, 1)
        # the reference's denominator counts pad rows (solver.py:177)
        acc_ref = total_correct / max(n_batches * cfg.batch_size, 1)
        top3 = total_top3 / max(total_valid, 1)
        base = os.path.join(cfg.results_dir, cfg.model_name)
        record = {"accuracy": acc_exact,
                  "accuracy_reference_denominator": acc_ref,
                  "top3_accuracy": top3, "num_examples": total_valid,
                  "time": time.time()}
        consensus_note = ""
        if have_consensus:
            consensus = total_consensus / max(total_valid, 1)
            record["vqa_consensus_accuracy"] = consensus
            consensus_note = f", VQA consensus {consensus:.6f}"

        def bucket(n, correct, cons) -> dict:
            out = {"accuracy": correct / max(n, 1), "num_examples": int(n)}
            if have_consensus:
                out["vqa_consensus_accuracy"] = cons / max(n, 1)
            return out

        if have_types:
            record["per_answer_type"] = {
                ANSWER_TYPE_NAMES[t]: bucket(type_n[t], type_correct[t],
                                             type_consensus[t])
                for t in range(n_types) if type_n[t] > 0}
        if qtype_stats:
            names = self._question_type_names
            record["per_question_type"] = {
                names[t]: bucket(*stats) for t, stats in sorted(
                    qtype_stats.items(), key=lambda kv: names[kv[0]])}
        if distributed.is_primary():  # written once a run
            os.makedirs(cfg.results_dir, exist_ok=True)
            with open(base + ".txt", "w") as f:
                f.write("Evaluation accuracy: %.6f" % acc_ref)
            with open(base + ".json", "w") as f:
                json.dump(record, f)
            if predictions:
                # the official leaderboard schema: [{"question_id",
                # "answer"}]
                with open(base + "_predictions.json", "w") as f:
                    json.dump(predictions, f)
                print(f"Wrote {len(predictions)} predictions in the "
                      f"official submission format: "
                      f"{base}_predictions.json")
        print(f"Evaluation accuracy: {acc_ref:.6f} (exact {acc_exact:.6f},"
              f" top-3 {top3:.6f}{consensus_note})")
        if have_types:
            parts = ", ".join(
                f"{ANSWER_TYPE_NAMES[t]} "
                f"{type_correct[t] / max(type_n[t], 1):.6f}"
                f" (n={int(type_n[t])})"
                for t in range(n_types) if type_n[t] > 0)
            print(f"Per answer type: {parts}")
        return loss, acc_exact

    # ------------------------------------------------------------------
    # persistence (solver.py:897-952)
    # ------------------------------------------------------------------

    @property
    def checkpoint_dir(self) -> str:
        return os.path.join(self.cfg.out_dir, self.cfg.model_name)

    def set_weights(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Load a module ``state_dict`` (parameters and running buffers,
        the full tensors) into the model, a tensor-parallel rank its shards
        of it, then lay out K1's weights again."""
        self.model.load_state_dict(local_state_dict(self.model, state_dict))
        if hasattr(self.model, "prepare"):
            self.model.prepare()

    def _model_state(self) -> Dict[str, torch.Tensor]:
        """The module's ``state_dict``, a tensor-parallel model's gathered
        (every rank of the model group calls this together)."""
        return gather_state_dict(self.model)

    def _state(self) -> Dict[str, Any]:
        return {
            "model": self._model_state(),
            "optimizer": gather_optimizer_state(self.model, self.optimizer),
            "step": self.step,
            "early_stop": {"min_val_loss": self.min_val_loss,
                           "best_val_acc": self.best_val_acc,
                           "i_patience": self.i_patience},
            "best": self.best_state,
        }

    def save_checkpoint(self) -> str:
        """Write ``<out_dir>/<model>/step_<step>``; keeps the newest
        ``keep_checkpoints`` (0 keeps all)."""
        return ckpt.save_checkpoint(self.checkpoint_dir, self._state(),
                                    self.step,
                                    keep=self.cfg.keep_checkpoints or None)

    def restore(self, step: Optional[int] = None) -> None:
        """Restore the checkpoint at ``step`` (default: the latest): the
        weights, Adam's state, the step and the early-stop record.
        FileNotFoundError when there is none."""
        state = ckpt.restore_checkpoint(self.checkpoint_dir, step)
        self.set_weights(state["model"])
        self.optimizer.load_state_dict(
            local_optimizer_state(self.model, state["optimizer"]))
        self.step = int(state["step"])
        es = state["early_stop"]
        self.min_val_loss = float(es["min_val_loss"])
        self.best_val_acc = float(es["best_val_acc"])
        self.i_patience = int(es["i_patience"])
        self.best_state = state["best"]

    def save(self) -> str:
        """The final save (solver.py:184-190): a resume checkpoint, and the
        weights-only export of the best snapshot (or of the live weights
        without one)."""
        path = self.save_checkpoint()
        ckpt.save_weights(self.checkpoint_dir,
                          self.best_state if self.best_state is not None
                          else self._model_state())
        return path

    def close(self) -> None:
        self.writer.close()
