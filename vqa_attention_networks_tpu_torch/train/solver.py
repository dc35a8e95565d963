"""Single-device ``Solver`` (port of ``vqa_attention_networks_tpu/train/
solver.py``): the train step, ``train()`` over epochs with checkpoints and
early stopping, ``val()`` on one batch or over the whole split with its
results files, and the persistence of ``save_checkpoint`` / ``restore`` /
``save``, for all eight families (``TRAINABLE``), at either
``dropout_site``.

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
- **The train step** (``solver.py:269-347`` with ``grad_accum_steps=1``
  and no remat): the training forward (given the batch's ``ques_length``,
  which MHB reads, and its ``valid`` mask, which masks the pad rows out of
  a batch norm's statistics), the loss with its ``valid`` mask (soft cross
  entropy, cross entropy, or ``soft_bce`` under ``loss_override``),
  backward, Adam, then ``merge_batch_stats``: the momentum-0.1 EMA of the
  step's batch-norm statistics into the layers' running buffers
  (``_merge_batch_stats``, ``solver.py:70-107``; a no-op for the families
  without batch norm). Its randomness is a pure function of
  ``(cfg.seed + 1, step)`` (``step_randomness``): the dropout generator's
  seed and K2's mask seed (the pooled site's mask comes from the
  generator). So a run resumed at step s replays step s's
  masks, as ``fold_in(base, step)`` does in JAX.
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

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
gradient accumulation (and with it the batch-norm EMA per micro-batch),
remat, the device feature bank, the int8 feature feed, and the profiler
and NaN-trap switches (item 6); ``data_parallel``/``model_parallel`` > 1
(item 10).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from vqa_attention_networks_tpu_torch.config import Config
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
from vqa_attention_networks_tpu_torch.device import cuda_device
from vqa_attention_networks_tpu_torch.models import (
    TRAINABLE,
    get_model,
    hiecoatten,
    ibowimg,
    mfb,
    mhb_coatt,
    vis_lstm,
)
from vqa_attention_networks_tpu_torch.train.losses import (
    correct_count,
    cross_entropy,
    soft_bce,
    soft_cross_entropy,
    topk_correct_count,
    vqa_consensus_scores,
)
from vqa_attention_networks_tpu_torch.utils import checkpoint as ckpt
from vqa_attention_networks_tpu_torch.utils.logging import (
    MetricWriter,
    NullMetricWriter,
)
from vqa_attention_networks_tpu_torch.utils.timer import Timer
from vqa_attention_networks_tpu_torch.weights import load_jax_params

_SOLVER_ITEM = "ROADMAP Queue 1 item 6 (Solver and CLIs)"
_MULTI_GPU_ITEM = "ROADMAP Queue 1 item 10 (multi-GPU)"
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
}
BN_MOMENTUM = 0.1  # torch nn.BatchNorm1d's default


def init_params(cfg: Config, generator: torch.Generator) -> Dict:
    """A random parameter tree of ``cfg.model_name`` in the JAX layout,
    drawn from ``generator`` (xavier-uniform weights, zero biases, a batch
    norm's running statistics at 0 and 1)."""
    return _INIT_PARAMS[cfg.model_name](cfg, generator)


def _unported(what: str, item: str = _SOLVER_ITEM) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet: {item}")


def step_randomness(base: int, step: int) -> Tuple[int, int]:
    """(dropout generator seed, K2 mask seed) of training step ``step``: a
    pure function of ``(base, step)``, so a resumed run replays it."""
    w = np.random.SeedSequence([base, step]).generate_state(3, np.uint32)
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
                          str, torch.Tensor]]]) -> None:
    """EMA one step's batch-norm statistics (a forward's
    ``aux["batch_stats"]``: layer name -> {"mean", "var"}) into the
    layers' running buffers: ``(1 - BN_MOMENTUM) * running + BN_MOMENTUM
    * batch``, as ``_merge_batch_stats`` does for one micro-batch."""
    with torch.no_grad():
        for layer, stats in (batch_stats or {}).items():
            module = model.get_submodule(layer)
            for key, batch in stats.items():
                running = getattr(module, key)
                running.copy_((1 - BN_MOMENTUM) * running
                              + BN_MOMENTUM * batch)


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               loss_fn, img: torch.Tensor, ques: torch.Tensor,
               ques_length: Optional[torch.Tensor] = None, *, lr: float,
               generator: torch.Generator, fusion_seed: int,
               valid: Optional[torch.Tensor] = None,
               reference_kernels: bool = False,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: training forward, ``loss_fn(logits)``, backward, Adam at
    ``lr``, then the batch-norm statistics merged into the running
    buffers. Returns (loss, logits), both detached."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    logits, aux = model(img, ques, ques_length, train=True, valid=valid,
                        generator=generator, fusion_seed=fusion_seed,
                        reference_kernels=reference_kernels, aux=True)
    loss = loss_fn(logits)
    loss.backward()
    optimizer.step()
    merge_batch_stats(model, aux.get("batch_stats"))
    return loss.detach(), logits.detach()


def _check_ported(cfg: Config, store: FeatureStore) -> None:
    if cfg.model_name not in TRAINABLE:
        raise ValueError(f"the Solver does not train {cfg.model_name!r}")
    if cfg.data_parallel > 1 or cfg.model_parallel > 1:
        raise _unported("data_parallel / model_parallel > 1", _MULTI_GPU_ITEM)
    switches = {
        "gradient accumulation (grad_accum_steps > 1)":
            cfg.grad_accum_steps != 1,
        "remat": cfg.remat,
        "the device feature bank": cfg.device_feature_bank,
        "profile_steps": cfg.profile_steps > 0,
        "debug_nans": cfg.debug_nans,
        "the int8 feature feed": bool(getattr(store, "quantized", False)),
    }
    for what, asked in switches.items():
        if asked:
            raise _unported(what)


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
        ``cfg.glove``. ``device`` defaults to the card; the CPU runs only
        when asked for by name. ``reference_kernels=True`` trains through
        K2's or K3's plain version in place of the kernels, for the
        comparisons of ``chip_smoke.py``. ``log_dir`` turns on the metric
        writer (``<log_dir>/<model>/events.jsonl``)."""
        cfg.validate()
        _check_ported(cfg, store)
        self.cfg = cfg
        self.device = torch.device(device) if device is not None \
            else cuda_device()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if params is None:
            params = init_params(cfg, torch.Generator().manual_seed(cfg.seed))
        if cfg.glove and glove_table is not None and "glove_table" in params:
            params = dict(params, glove_table=np.asarray(glove_table,
                                                         np.float32))
        model = get_model(cfg.model_name)(cfg).to(self.device)
        self.model = load_jax_params(model, params)
        self.optimizer = make_optimizer(self.model, cfg)
        self.reference_kernels = reference_kernels
        self.writer = (MetricWriter(log_dir, run_name=cfg.model_name)
                       if log_dir is not None else NullMetricWriter())
        self.step = 0
        self._rng_base = cfg.seed + 1
        feature_dtype = (
            np.float16 if cfg.compute_dtype == "bfloat16" else np.float32
        )
        self.batches = {
            split: VqaBatches(
                getattr(qa_data, split), store,
                batch_size=cfg.batch_size, num_answers=cfg.a_vocab_size,
                soft_answer=cfg.soft_answer,
                shuffle=(cfg.shuffle and split == "train"), seed=cfg.seed,
                feature_dtype=feature_dtype,
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

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _loss(self, logits, answers, soft, valid):
        if self.cfg.loss_override == "soft_bce":
            return soft_bce(logits, soft, valid)
        if self.cfg.soft_answer:
            return soft_cross_entropy(logits, soft, valid)
        return cross_entropy(logits, answers, valid)

    def _labels(self, answers, soft):
        # soft-answer models score against the argmax'd distribution; one
        # definition for the device tensors and the host arrays of
        # val(full=True)
        return soft.argmax(-1) if self.cfg.soft_answer else answers

    def _device_batch(self, batch: Batch) -> Tuple[torch.Tensor, ...]:
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        soft = (put(batch.soft_answers) if batch.soft_answers is not None
                else None)
        return (put(batch.image_features), put(batch.questions),
                put(batch.ques_length), put(batch.answers).long(),
                put(batch.valid), soft)

    def _train_step(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step at ``self.step`` -> (loss, correct count), on the
        device."""
        img, ques, qlen, answers, valid, soft = self._device_batch(batch)
        gen_seed, fusion_seed = step_randomness(self._rng_base, self.step)
        generator = torch.Generator(device=self.device).manual_seed(gen_seed)
        self.model.train()
        loss, logits = train_step(
            self.model, self.optimizer,
            lambda out: self._loss(out, answers, soft, valid),
            img, ques, qlen, lr=learning_rate(self.cfg, self.step),
            generator=generator, fusion_seed=fusion_seed, valid=valid,
            reference_kernels=self.reference_kernels,
        )
        correct = correct_count(logits, self._labels(answers, soft), valid)
        return loss, correct

    def _eval_step(self, batch: Batch) -> Tuple[torch.Tensor, ...]:
        """The eval forward on one batch -> (loss, correct, top-3 correct,
        per-row argmax), on the device."""
        img, ques, qlen, answers, valid, soft = self._device_batch(batch)
        self.model.eval()
        with torch.no_grad():
            logits = self.model(img, ques, qlen)
            labels = self._labels(answers, soft)
            return (self._loss(logits, answers, soft, valid),
                    correct_count(logits, labels, valid),
                    topk_correct_count(logits, labels, k=3, valid=valid),
                    logits.argmax(dim=-1))

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
        for epoch in range(start_epoch, cfg.num_epoch):
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
            for batch in stream:
                loss_d, correct_d = self._train_step(batch)
                if on_step is not None:
                    on_step(self.step, loss_d)
                self.step += 1
                seen += int(batch.valid.sum())
                if (cfg.checkpoint_every_steps
                        and self.step % cfg.checkpoint_every_steps == 0):
                    self.save_checkpoint()
            # one sync per epoch for the metrics
            loss = float(loss_d)
            acc = float(correct_d) / max(int(batch.valid.sum()), 1)
            if not np.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite train loss at epoch {epoch} step "
                    f"{self.step}; drop to --compute_dtype float32 to rule "
                    f"out bf16 overflow"
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
                break
        return last

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
                               for k, v in self.model.state_dict().items()}
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
        for batch in self.batches["val"].epoch():
            loss_d, correct_d, top3_d, preds_d = self._eval_step(batch)
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
            preds = preds_d.cpu().numpy()
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
        os.makedirs(cfg.results_dir, exist_ok=True)
        base = os.path.join(cfg.results_dir, cfg.model_name)
        with open(base + ".txt", "w") as f:
            f.write("Evaluation accuracy: %.6f" % acc_ref)
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
        with open(base + ".json", "w") as f:
            json.dump(record, f)
        if predictions:
            # the official leaderboard schema: [{"question_id", "answer"}]
            with open(base + "_predictions.json", "w") as f:
                json.dump(predictions, f)
            print(f"Wrote {len(predictions)} predictions in the official "
                  f"submission format: {base}_predictions.json")
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
        """Load a module ``state_dict`` (parameters and running buffers)
        into the model, then lay out K1's weights again."""
        self.model.load_state_dict(state_dict)
        if hasattr(self.model, "prepare"):
            self.model.prepare()

    def _state(self) -> Dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
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
        self.optimizer.load_state_dict(state["optimizer"])
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
                          else self.model.state_dict())
        return path

    def close(self) -> None:
        self.writer.close()
