"""The port's ``Solver`` (vqa_attention_networks_tpu_torch/train/solver.py)
against the JAX ``Solver`` on the same synthetic data and feature store:
each package gets its own ``Config``, QA data and store, made from the same
fields, seeds and sizes.

- f32, dropout 0: the same batches give the same per-step losses (rtol
  1e-5: full f32 on both sides, summation order only) and the same hit
  counts, stepping the JAX Solver through its own ``_train_step``.
- ``train()`` runs end to end on the CPU, the staircase rate reaches the
  optimizer, a step's randomness is a function of (seed, step), and
  ``val()`` after a step scores the new weights (the eval forward lays out
  K1's weights again once they changed), and a non-finite loss aborts.
- mfb and mfb-multilayer: the same loss parity at f32 at both dropout
  sites, and ``train()`` at bf16 through K2's and K3's plain versions.
- mhb, visLstm, iBOWIMG, attentionNet and hieCoAtten: the same loss parity
  at f32 (the JAX Solver's step takes each batch's ``ques_length``, which
  MHB reads, and its ``valid`` mask, which masks the last batch's pad rows
  out of a batch norm's statistics), the running statistics after the
  epoch equal to the JAX Solver's, and two bf16 steps of ``train()`` with
  dropout on and finite losses; ``val()`` equals a fresh load's, running
  statistics included.
- ``loss_override="soft_bce"``: the same losses as the JAX Solver; the
  checkpoints and val(full=True) run (tests/test_torch_port_checkpoint.py
  holds them in full).
- What is not ported raises ``NotImplementedError`` naming its ROADMAP item.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from vqa_attention_networks_tpu.config import Config as JaxConfig
from vqa_attention_networks_tpu.data import feature_store as jax_store
from vqa_attention_networks_tpu.data import prepare as jax_prepare
from vqa_attention_networks_tpu.parallel import make_mesh
from vqa_attention_networks_tpu.train.solver import Solver as JaxSolver
from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.data import feature_store as port_store
from vqa_attention_networks_tpu_torch.data import prepare as port_prepare
from vqa_attention_networks_tpu_torch.train.solver import (
    BN_MOMENTUM,
    Solver,
    learning_rate,
)
from vqa_attention_networks_tpu_torch.weights import to_jax_params

T = 7


def _make_data(tmp_path_factory, prepare, store_module):
    qa = prepare.make_synthetic_qa_data(np.random.default_rng(0), n_train=40,
                                        n_val=16, num_images=6, max_len=T)
    store = store_module.make_synthetic_feature_store(
        str(tmp_path_factory.mktemp("feat")),
        sorted(set(qa.train.image_ids) | set(qa.val.image_ids)), channels=32)
    return qa, store


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The port's QA data and feature store."""
    return _make_data(tmp_path_factory, port_prepare, port_store)


@pytest.fixture(scope="module")
def jax_data(tmp_path_factory):
    """The JAX package's, from the same seed and sizes."""
    return _make_data(tmp_path_factory, jax_prepare, jax_store)


def small_cfg(qa, **kw) -> Config:
    base = dict(
        model_name="mhb_coAtt", q_vocab_size=qa.q_vocab_size,
        a_vocab_size=qa.a_vocab_size, hidden_dim=16, emb_dim=8,
        img_feature_channel=32, max_question_length=T, mfb_factor=5,
        mfb_out=8, batch_size=16, num_epoch=1, checkpoint_every_steps=0,
        prefetch_workers=1,
    )
    base.update(kw)
    return Config(**base).validate()


def test_losses_match_the_jax_solver(data, jax_data, tmp_path):
    _losses_match_the_jax_solver(data, jax_data, tmp_path)


@pytest.mark.parametrize("site", ["prepool", "pooled"])
@pytest.mark.parametrize("name", ["mfb", "mfb-multilayer"])
def test_mfb_losses_match_the_jax_solver(data, jax_data, tmp_path, name,
                                         site):
    _losses_match_the_jax_solver(data, jax_data, tmp_path, model_name=name,
                                 dropout_site=site)


FAMILIES = ("mhb", "visLstm", "iBOWIMG", "attentionNet", "hieCoAtten")
WIDTHS = dict(embed_size=16, att_num=2)  # the embed_size families' widths


@pytest.mark.parametrize("name", FAMILIES)
def test_other_families_match_the_jax_solver(data, jax_data, tmp_path, name):
    port, jax_solver = _losses_match_the_jax_solver(
        data, jax_data, tmp_path, model_name=name, dropout_default=0.0,
        **WIDTHS)
    got, want = to_jax_params(port.model), jax_solver.params
    # the bias just before a batch norm has a gradient of 0 up to
    # rounding, so its Adam step is noise on both sides, up to LR: after
    # steps 1 and 2 the two packages' biases may be 2 and 4 LR apart, which
    # moves the next batch's mean (not its variance) by as much, and the
    # running mean by BN_MOMENTUM times that (test_torch_port_families.py)
    mean_atol = BN_MOMENTUM * (2 + 4) * port.cfg.lr
    for layer in ("img_bn", "batchnorm"):
        if layer in want:
            for key in ("mean", "var"):
                np.testing.assert_allclose(
                    got[layer][key], np.asarray(want[layer][key]), rtol=1e-4,
                    atol=1e-5 + (mean_atol if key == "mean" else 0.0),
                    err_msg=f"{layer}/{key}")
                assert not np.allclose(got[layer][key],
                                       0.0 if key == "mean" else 1.0)


def _losses_match_the_jax_solver(data, jax_data, tmp_path, **kw):
    qa, store = data
    cfg = small_cfg(qa, dropout_lstm=0.0, dropout_fusion=0.0, **kw)
    jax_solver = JaxSolver(JaxConfig(**dataclasses.asdict(cfg)), *jax_data,
                           mesh=make_mesh(data=1, model=1),
                           log_dir=str(tmp_path / "runs"))
    params = jax.tree_util.tree_map(np.asarray, jax_solver.params)
    port = Solver(cfg, qa, store, params=params, device="cpu")
    jax_losses, port_losses = [], []
    # 3 batches, the last padded; the two packages' batches are equal
    for batch, jax_batch in zip(port.batches["train"].epoch(0),
                                jax_solver.batches["train"].epoch(0)):
        np.testing.assert_array_equal(batch.image_features,
                                      jax_batch.image_features)
        np.testing.assert_array_equal(batch.soft_answers,
                                      jax_batch.soft_answers)
        dev = jax_solver._device_batch(jax_batch)
        key = jax.random.fold_in(jax_solver._rng_base, jax_solver.step)
        (jax_solver.params, jax_solver.opt_state, loss,
         correct) = jax_solver._train_step(jax_solver.params,
                                           jax_solver.opt_state, *dev, key)
        jax_solver.step += 1
        jax_losses.append((float(loss), float(correct)))
        loss, correct = port._train_step(batch)
        port.step += 1
        port_losses.append((float(loss), float(correct)))
    assert len(port_losses) == 3
    np.testing.assert_allclose([x[0] for x in port_losses],
                               [x[0] for x in jax_losses], rtol=1e-5)
    assert [x[1] for x in port_losses] == [x[1] for x in jax_losses]
    assert port_losses[-1][0] != port_losses[0][0]
    return port, jax_solver


def test_train_runs_an_epoch_on_the_cpu(data):
    qa, store = data
    cfg = small_cfg(qa, compute_dtype="bfloat16")  # K2's plain version
    solver = Solver(cfg, qa, store, device="cpu")
    seen = []
    metrics = solver.train(on_step=lambda step, loss: seen.append(
        (step, float(loss))))
    assert [s for s, _ in seen] == [0, 1, 2] and solver.step == 3
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["train_loss"] == seen[-1][1]
    assert 0.0 <= metrics["val_acc"] <= 1.0


@pytest.mark.parametrize("site", ["prepool", "pooled"])
@pytest.mark.parametrize("name", ["mfb", "mfb-multilayer"])
def test_train_runs_an_mfb_epoch_on_the_cpu(data, name, site):
    """bf16 with dropout on: K2's plain version at the pre-pool site, K3's
    at the pooled site (CPU tensors, so no kernel launch)."""
    from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf
    from vqa_attention_networks_tpu_torch.ops import train_fusion as tf

    qa, store = data
    cfg = small_cfg(qa, model_name=name, dropout_site=site,
                    compute_dtype="bfloat16")
    solver = Solver(cfg, qa, store, device="cpu")
    before = (dict(tf.launch_count), dict(pf.launch_count))
    seen = []
    metrics = solver.train(on_step=lambda step, loss: seen.append(
        float(loss)))
    assert (dict(tf.launch_count), dict(pf.launch_count)) == before
    assert len(seen) == 3 and all(np.isfinite(seen))
    assert all(np.isfinite(v) for v in metrics.values())
    assert seen[0] != seen[-1]


def test_hiecoatten_training_names_its_roadmap_item(data):
    """hieCoAtten trains now (item 7 is done); what its Solver still
    refuses names the item it waits on, as for every family."""
    from vqa_attention_networks_tpu_torch.models import TRAINABLE
    from vqa_attention_networks_tpu_torch.config import MODEL_NAMES

    assert TRAINABLE == MODEL_NAMES
    qa, store = data
    cfg = small_cfg(qa, model_name="hieCoAtten", **WIDTHS)
    solver = Solver(cfg, qa, store, device="cpu")
    loss, _ = solver._train_step(next(solver.batches["train"].epoch(0)))
    assert np.isfinite(float(loss))
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 item 6"):
        Solver(cfg.replace(grad_accum_steps=2), qa, store, device="cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_train_runs_the_other_families_on_the_cpu(data, name):
    """bf16, dropout on (0.5 / 0.3 / 0.1): two steps of ``train()``, with
    finite losses; the running statistics move."""
    qa, store = data
    cfg = small_cfg(qa, model_name=name, compute_dtype="bfloat16",
                    batch_size=24, **WIDTHS)
    solver = Solver(cfg, qa, store, device="cpu")
    before = {n: b.clone() for n, b in solver.model.named_buffers()}
    seen = []
    metrics = solver.train(on_step=lambda step, loss: seen.append(
        float(loss)))
    assert len(seen) == 2 and np.isfinite(seen).all()
    assert all(np.isfinite(v) for v in metrics.values())
    moved = [n for n, b in solver.model.named_buffers()
             if not torch.equal(b, before[n])]
    assert sorted(moved) == sorted(
        n for n in before if n.endswith((".mean", ".var")))


def test_val_after_a_step_scores_the_running_statistics(data):
    """iBOWIMG: ``val()`` after a step normalises by the merged running
    statistics, and a fresh load of ``to_jax_params`` scores the same."""
    qa, store = data
    cfg = small_cfg(qa, model_name="iBOWIMG", **WIDTHS)
    solver = Solver(cfg, qa, store, device="cpu")
    before = solver.val()
    mean = solver.model.img_bn.mean.clone()
    solver._train_step(next(solver.batches["train"].epoch(0)))
    assert not torch.equal(solver.model.img_bn.mean, mean)
    after = solver.val()
    fresh = Solver(cfg, qa, store, params=to_jax_params(solver.model),
                   device="cpu")
    torch.testing.assert_close(fresh.model.img_bn.var,
                               solver.model.img_bn.var, rtol=0, atol=0)
    assert after == fresh.val() and after != before
    # the same trained weights with the initial running statistics score
    # otherwise: val() reads the buffers
    stale = to_jax_params(solver.model)
    stale["img_bn"]["mean"] = mean.numpy()
    assert Solver(cfg, qa, store, params=stale, device="cpu").val() != after


def test_solver_steps_at_the_staircase_rate(data):
    qa, store = data
    cfg = small_cfg(qa, decay_step=2, num_epoch=2)
    solver = Solver(cfg, qa, store, device="cpu")
    rates = []
    solver.train(on_step=lambda step, loss: rates.append(
        solver.optimizer.param_groups[0]["lr"]))
    assert rates == [learning_rate(cfg, s) for s in range(6)]
    assert rates[:3] == [cfg.lr, cfg.lr, cfg.lr * cfg.decay_rate]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_step_replays_its_randomness(data, dtype):
    """Dropout on (LSTM 0.3, fusions 0.1): a solver at step s, as a resumed
    run would be, draws the same masks as another at step s."""
    qa, store = data
    cfg = small_cfg(qa, compute_dtype=dtype)
    batch = next(Solver(cfg, qa, store, device="cpu")
                 .batches["train"].epoch(0))

    def loss_at(step):
        solver = Solver(cfg, qa, store, device="cpu")
        solver.step = step
        return float(solver._train_step(batch)[0])

    assert loss_at(5) == loss_at(5)
    assert loss_at(5) != loss_at(6)


def test_val_after_a_step_scores_the_new_weights(data):
    qa, store = data
    cfg = small_cfg(qa, compute_dtype="bfloat16")  # K1's plain version
    solver = Solver(cfg, qa, store, device="cpu")
    before = solver.val()
    w3 = solver.model.stage1_w3.clone()
    solver._train_step(next(solver.batches["train"].epoch(0)))
    after = solver.val()
    fresh = Solver(cfg, qa, store, params=to_jax_params(solver.model),
                   device="cpu")
    assert after == fresh.val()
    assert after != before
    assert not torch.equal(solver.model.stage1_w3, w3)


def test_non_finite_loss_aborts_the_run(data):
    qa, store = data
    cfg = small_cfg(qa)
    solver = Solver(cfg, qa, store, device="cpu")
    with torch.no_grad():
        solver.model.linear_pred.bias.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite train loss"):
        solver.train()


@pytest.mark.parametrize("switch,item", [
    (dict(grad_accum_steps=2), "item 6"),
    (dict(remat=True), "item 6"),
    (dict(device_feature_bank=True), "item 6"),
    # early stopping and loss_override run now (item 6's done part); the
    # profiler and NaN-trap switches stay refused
    (dict(profile_steps=1), "item 6"),
    (dict(debug_nans=True), "item 6"),
    (dict(data_parallel=2, batch_size=16), "item 10"),
])
def test_unported_switches_name_their_roadmap_item(data, switch, item):
    qa, store = data
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        Solver(small_cfg(qa, **switch), qa, store, device="cpu")


def test_unported_persistence_and_full_val_raise(data, tmp_path):
    """Checkpoints, resume and val(full=True) were refused until the
    command line's slice; they run now. A checkpoint that falls due inside
    the epoch is written, ``restore()`` brings back its step, ``save()``
    adds the final one and the weights export, and ``val(full=True)``
    writes the three results files. What the Solver still refuses names
    its ROADMAP item (``test_unported_switches_name_their_roadmap_item``)."""
    from vqa_attention_networks_tpu_torch.utils import checkpoint as ckpt

    qa, store = data
    cfg = small_cfg(qa, checkpoint_every_steps=2,
                    out_dir=str(tmp_path / "models"),
                    results_dir=str(tmp_path / "results"))
    solver = Solver(cfg, qa, store, device="cpu")
    solver.train()
    assert solver.step == 3
    assert ckpt.all_steps(solver.checkpoint_dir) == [2]
    solver.save()
    assert ckpt.all_steps(solver.checkpoint_dir) == [2, 3]
    fresh = Solver(cfg, qa, store, device="cpu")
    fresh.restore(step=2)
    assert fresh.step == 2
    fresh.restore()
    assert fresh.step == 3
    loss, acc = fresh.val(full=True)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    assert sorted(os.listdir(tmp_path / "results")) == [
        "mhb_coAtt.json", "mhb_coAtt.txt", "mhb_coAtt_predictions.json"]


def test_soft_bce_losses_match_the_jax_solver(data, jax_data, tmp_path):
    """``loss_override="soft_bce"`` (the legacy trainer's loss) trains a
    hard-label family on soft targets, with the JAX Solver's losses."""
    _losses_match_the_jax_solver(data, jax_data, tmp_path,
                                 model_name="iBOWIMG", dropout_default=0.0,
                                 loss_override="soft_bce", **WIDTHS)


def test_default_device_is_the_card(data):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device exists")
    qa, store = data
    with pytest.raises(RuntimeError, match="CUDA"):
        Solver(small_cfg(qa), qa, store)
