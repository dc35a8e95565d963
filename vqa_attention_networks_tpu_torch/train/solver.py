"""Single-device ``Solver`` (port of ``vqa_attention_networks_tpu/train/
solver.py``): the train step, ``train()`` over epochs and ``val()`` on one
batch, for all eight families (``TRAINABLE``), at either ``dropout_site``.

- **Parameters**: the family's ``init_params`` drawn from a
  ``torch.Generator`` seeded by ``cfg.seed``, or a JAX-layout tree (``params=``) through
  ``weights.load_jax_params``. Parameters are f32 whatever the compute
  dtype, as in the JAX Solver.
- **Optimizer**: ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2
  0.999, eps 1e-8) and the staircase schedule of ``solver.py:159-166``:
  step s runs at ``lr * decay_rate ** (s // decay_step)``. optax reads its
  count before incrementing it, so step 0 runs at ``lr``.
- **Batches**: ``VqaBatches`` and ``prefetch`` of the port's
  ``data/dataset.py``, as the JAX Solver feeds them.
- **The train step** (``solver.py:269-347`` with ``grad_accum_steps=1``
  and no remat): the training forward (given the batch's ``ques_length``,
  which MHB reads, and its ``valid`` mask, which masks the pad rows out of
  a batch norm's statistics), the loss with its ``valid`` mask, backward,
  Adam, then ``merge_batch_stats``: the momentum-0.1 EMA of the step's
  batch-norm statistics into the layers' running buffers
  (``_merge_batch_stats``, ``solver.py:70-107``; a no-op for the families
  without batch norm). Its randomness is a pure function of
  ``(cfg.seed + 1, step)`` (``step_randomness``): the dropout generator's
  seed and K2's mask seed (the pooled site's mask comes from the
  generator). So a run resumed at step s replays step s's
  masks, as ``fold_in(base, step)`` does in JAX.
- **val()** scores one batch through the eval forward (K1 at bf16 on the
  card for mhb_coAtt, K4 for hieCoAtten), after the model has laid out K1's
  weights again if a step changed them; a batch norm normalises by its
  running buffers, which ``weights.to_jax_params`` carries to a fresh load.
- TF32 stays off: f32 products are full f32, the counterpart of the JAX
  package's ``Precision.HIGHEST``.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
checkpoints and resume, early stopping, gradient accumulation, remat, the
device feature bank, the int8 feature feed, ``loss_override``, the
profiler and NaN-trap switches, and ``val(full=True)``'s artifacts (item
6; with gradient accumulation comes the EMA once per micro-batch);
``data_parallel``/``model_parallel`` > 1 (item 10). Metrics go to
stdout only: the JAX package's metric writer is item 6 too.
"""

from __future__ import annotations

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
from vqa_attention_networks_tpu_torch.data.prepare import QAData
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
    soft_cross_entropy,
)
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
        "early stopping": cfg.early_stopping,
        f"loss_override={cfg.loss_override!r}": bool(cfg.loss_override),
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
    ):
        """``params`` is a JAX-layout tree (numpy arrays); without it the
        weights are drawn from ``cfg.seed``. ``device`` defaults to the
        card; the CPU runs only when asked for by name.
        ``reference_kernels=True`` trains through K2's or K3's plain
        version in place of the kernels, for the comparisons of
        ``chip_smoke.py``."""
        cfg.validate()
        _check_ported(cfg, store)
        self.cfg = cfg
        self.device = torch.device(device) if device is not None \
            else cuda_device()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if params is None:
            params = init_params(cfg, torch.Generator().manual_seed(cfg.seed))
        model = get_model(cfg.model_name)(cfg).to(self.device)
        self.model = load_jax_params(model, params)
        self.optimizer = make_optimizer(self.model, cfg)
        self.reference_kernels = reference_kernels
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

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _loss(self, logits, answers, soft, valid):
        if self.cfg.soft_answer:
            return soft_cross_entropy(logits, soft, valid)
        return cross_entropy(logits, answers, valid)

    def _labels(self, answers, soft):
        # soft-answer models score against the argmax'd distribution
        return soft.argmax(dim=-1) if self.cfg.soft_answer else answers

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

    # ------------------------------------------------------------------
    # the epoch loop and validation (solver.py:581-708)
    # ------------------------------------------------------------------

    def train(self, on_step: Optional[Callable[[int, torch.Tensor], None]]
              = None) -> Dict[str, float]:
        """Epochs of training steps, one ``val()`` per epoch -> the last
        epoch's metrics. ``on_step(step, loss)`` is called after each step
        with the step's index and its loss, a device tensor (reading it
        waits for the device)."""
        cfg = self.cfg
        iters_per_epoch = len(self.batches["train"])
        if iters_per_epoch == 0:
            raise ValueError(
                "training split is empty — nothing to train on (check "
                "--data_dir / the prepared artifact)"
            )
        total = cfg.num_epoch * iters_per_epoch
        every = cfg.checkpoint_every_steps
        if every and total // every > self.step // every:
            # refuse before the first step, not after `every` steps of work
            raise _unported(f"checkpoints (one falls due every {every} steps "
                            f"of this run; set checkpoint_every_steps=0)")
        print(f"Model: {cfg.model_name}")
        print(f"total training iterations: {total}")
        last: Dict[str, float] = {}
        start_epoch, skip_batches = divmod(self.step, iters_per_epoch)
        for epoch in range(start_epoch, cfg.num_epoch):
            t0 = time.perf_counter()
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
            # one sync per epoch for the metrics
            loss = float(loss_d)
            acc = float(correct_d) / max(int(batch.valid.sum()), 1)
            if not np.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite train loss at epoch {epoch} step "
                    f"{self.step}; drop to --compute_dtype float32 to rule "
                    f"out bf16 overflow"
                )
            qps = seen / max(time.perf_counter() - t0, 1e-9)
            val_loss, val_acc = self.val()
            print(
                f">>> epoch {epoch} step {self.step} | train loss {loss:.5f} "
                f"acc {acc:.4f} | val loss {val_loss:.5f} acc {val_acc:.4f} "
                f"| {qps:.0f} qa-pairs/s"
            )
            last = {"train_loss": loss, "train_acc": acc,
                    "val_loss": val_loss, "val_acc": val_acc, "qps": qps}
        return last

    def val(self, full: bool = False) -> Tuple[float, float]:
        """One val batch through the eval forward -> (loss, exact-match
        accuracy over its valid rows), the reference's training-mode
        validation (solver.py:154-156)."""
        if full:
            raise _unported("val(full=True) and its results artifacts")
        batch = next(iter(self.batches["val"].epoch()))
        img, ques, qlen, answers, valid, soft = self._device_batch(batch)
        self.model.eval()
        with torch.no_grad():
            logits = self.model(img, ques, qlen)
            loss = self._loss(logits, answers, soft, valid)
            correct = correct_count(logits, self._labels(answers, soft),
                                    valid)
        return float(loss), float(correct) / max(int(batch.valid.sum()), 1)

    # ------------------------------------------------------------------
    # persistence: not ported yet
    # ------------------------------------------------------------------

    def save_checkpoint(self) -> str:
        raise _unported("checkpoints (checkpoint_every_steps, save)")

    def restore(self, step: Optional[int] = None) -> None:
        raise _unported("resume from a checkpoint")

    def save(self) -> str:
        raise _unported("checkpoints (checkpoint_every_steps, save)")
