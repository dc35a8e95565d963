"""The port's persistence and full evaluation: ``utils/checkpoint.py``,
``Solver.save_checkpoint`` / ``restore`` / ``save``, early stopping,
``val(full=True)`` and ``utils/torch_import.py``.

Port-only (the JAX package's Orbax checkpoints are not read by the port):

- resume, mirroring ``tests/test_resume.py``: a run interrupted at an
  epoch boundary and one interrupted mid-epoch, each restored into a fresh
  Solver, end bit-equal to a straight run (every parameter, buffer and Adam
  moment, the step counters and the last loss), for iBOWIMG at f32 and
  mhb_coAtt at bf16 (K2's plain version, dropout on); the epoch shuffle is
  a function of (seed, epoch);
- retention under ``keep_checkpoints``, and no temporary directory left;
- ``val()`` after ``restore()``, after a weights load and after the best
  snapshot is swapped in scores those weights, not the ones K1's layout
  was built from (mhb_coAtt, bf16: the K1 layout path);
- early stopping on ``loss`` and on ``acc`` (the val metrics scripted), the
  best snapshot a copy taken at the best epoch, exported by ``save()`` and
  carried through a checkpoint.

Against the JAX package:

- ``val(full=True)`` of iBOWIMG and of mhb_coAtt at f32, JAX Solver and
  port Solver on the same weights (``weights.load_jax_params``), the same
  prepared ``tools/gen_corpus.py`` corpus and the same feature store, TF32
  off: the ``.txt`` line, the ``.json``'s counts and the predictions
  equal; each accuracy within one example's share (1 / num_examples) of
  JAX's, the loss within 1e-5 relative;
- ``import_state_dict`` / ``export_state_dict`` / ``load_pth`` for all
  eight families (and mhb_coAtt with its GloVe table), on a ``.pth`` the
  test writes with ``torch.save`` from JAX's export: trees and exports
  equal.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vqa_attention_networks_tpu.config import Config as JaxConfig
from vqa_attention_networks_tpu.data import feature_store as jax_store
from vqa_attention_networks_tpu.data import prepare as jax_prepare
from vqa_attention_networks_tpu.models import get_model as jax_get_model
from vqa_attention_networks_tpu.parallel import make_mesh
from vqa_attention_networks_tpu.train.solver import Solver as JaxSolver
from vqa_attention_networks_tpu.utils import torch_import as jax_import
from vqa_attention_networks_tpu_torch.config import MODEL_NAMES, Config
from vqa_attention_networks_tpu_torch.data import feature_store as port_store
from vqa_attention_networks_tpu_torch.data import prepare as port_prepare
from vqa_attention_networks_tpu_torch.models import get_model
from vqa_attention_networks_tpu_torch.train.solver import Solver, init_params
from vqa_attention_networks_tpu_torch.utils import checkpoint as ckpt
from vqa_attention_networks_tpu_torch.utils import torch_import as \
    port_import
from vqa_attention_networks_tpu_torch.weights import (
    load_jax_params,
    to_jax_params,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 7
WIDTHS = dict(hidden_dim=8, emb_dim=8, embed_size=8, img_feature_channel=16,
              mfb_factor=5, mfb_out=4, att_num=2)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    qa = port_prepare.make_synthetic_qa_data(
        np.random.default_rng(0), n_train=64, n_val=16, num_images=4,
        max_len=T)
    store = port_store.make_synthetic_feature_store(
        str(tmp_path_factory.mktemp("feat")),
        sorted(set(qa.train.image_ids) | set(qa.val.image_ids)), channels=16)
    return qa, store


def _cfg(qa, tmp_path, **kw) -> Config:
    base = dict(model_name="iBOWIMG", q_vocab_size=qa.q_vocab_size,
                a_vocab_size=qa.a_vocab_size, max_question_length=T,
                batch_size=16, num_epoch=1, checkpoint_every_steps=0,
                prefetch_workers=1, out_dir=str(tmp_path / "models"),
                results_dir=str(tmp_path / "results"), **WIDTHS)
    base.update(kw)
    return Config(**base).validate()


def _state(solver) -> dict:
    """Every tensor the run carries: the module's and Adam's state."""
    out = {f"model/{k}": v.clone() for k, v in
           solver.model.state_dict().items()}
    for i, s in solver.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            out[f"adam/{i}/{k}"] = v.clone()
    return out


def _assert_bit_equal(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


RUNS = [("iBOWIMG", "float32"), ("mhb_coAtt", "bfloat16")]


@pytest.mark.parametrize("name,dtype", RUNS)
def test_interrupted_training_matches_straight_run(data, tmp_path, name,
                                                   dtype):
    qa, store = data
    kw = dict(model_name=name, compute_dtype=dtype)
    straight = Solver(_cfg(qa, tmp_path / "s", num_epoch=4, **kw), qa, store,
                      device="cpu")
    last = straight.train()

    first = Solver(_cfg(qa, tmp_path / "r", num_epoch=2, **kw), qa, store,
                   device="cpu")
    first.train()
    first.save_checkpoint()
    second = Solver(_cfg(qa, tmp_path / "r", num_epoch=4, **kw), qa, store,
                    device="cpu")
    second.restore()
    assert second.step == first.step == 8
    resumed = second.train()
    assert second.step == straight.step == 16
    assert resumed["train_loss"] == last["train_loss"]
    _assert_bit_equal(_state(second), _state(straight))


@pytest.mark.parametrize("name,dtype", RUNS)
def test_mid_epoch_resume_matches_straight_run(data, tmp_path, name, dtype):
    """A checkpoint at step 3 of 4-step epochs: the restored run skips the
    trained prefix of its epoch (no batch trained twice) and ends equal."""
    qa, store = data
    kw = dict(model_name=name, compute_dtype=dtype)
    straight = Solver(_cfg(qa, tmp_path / "s", num_epoch=3, **kw), qa, store,
                      device="cpu")
    straight_losses = []
    straight.train(on_step=lambda s, loss: straight_losses.append(
        float(loss)))
    assert straight.step == 12

    first = Solver(_cfg(qa, tmp_path / "r", checkpoint_every_steps=3, **kw),
                   qa, store, device="cpu")
    first.train()  # a checkpoint at step 3, inside epoch 0
    assert ckpt.all_steps(first.checkpoint_dir) == [3]
    second = Solver(_cfg(qa, tmp_path / "r", num_epoch=3, **kw), qa, store,
                    device="cpu")
    second.restore(step=3)
    assert second.step == 3
    losses = []
    second.train(on_step=lambda s, loss: losses.append((s, float(loss))))
    assert [s for s, _ in losses] == list(range(3, 12))
    assert [x for _, x in losses] == straight_losses[3:]
    _assert_bit_equal(_state(second), _state(straight))


def test_epoch_shuffle_is_function_of_seed_and_epoch(data, tmp_path):
    qa, store = data
    s1 = Solver(_cfg(qa, tmp_path), qa, store, device="cpu")
    s2 = Solver(_cfg(qa, tmp_path), qa, store, device="cpu")
    e0_a = [b.answers.copy() for b in s1.batches["train"].epoch(0)]
    e0_b = [b.answers.copy() for b in s2.batches["train"].epoch(0)]
    for x, y in zip(e0_a, e0_b):
        np.testing.assert_array_equal(x, y)
    e1 = [b.answers.copy() for b in s1.batches["train"].epoch(1)]
    assert not all(np.array_equal(x, y) for x, y in zip(e0_a, e1))


@pytest.mark.parametrize("keep", [0, 1, 2])
def test_retention_keeps_the_newest(data, tmp_path, keep):
    qa, store = data
    cfg = _cfg(qa, tmp_path, num_epoch=2, checkpoint_every_steps=3,
               keep_checkpoints=keep)
    solver = Solver(cfg, qa, store, device="cpu")
    solver.train()  # checkpoints at 3 and 6
    solver.save()  # and at 8, with the weights export
    steps = [3, 6, 8] if keep == 0 else [3, 6, 8][-keep:]
    assert ckpt.all_steps(solver.checkpoint_dir) == steps
    assert ckpt.latest_step(solver.checkpoint_dir) == 8
    assert sorted(os.listdir(solver.checkpoint_dir)) == sorted(
        [f"step_{s}" for s in steps] + ["weights"])
    assert os.listdir(os.path.join(solver.checkpoint_dir, "step_8")) == [
        ckpt.STATE_FILE]
    state = ckpt.restore_checkpoint(solver.checkpoint_dir)
    assert state["step"] == 8 and state["best"] is None
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        Solver(cfg.replace(out_dir=str(tmp_path / "none")), qa, store,
               device="cpu").restore()


def test_val_scores_restored_weights_after_k1_layout(data, tmp_path):
    """mhb_coAtt at bf16: the eval forward reads K1's laid-out weights,
    built at construction. After restore(), a weights load and the best
    snapshot's swap, val() must score the loaded weights."""
    qa, store = data
    cfg = _cfg(qa, tmp_path, model_name="mhb_coAtt",
               compute_dtype="bfloat16")
    trained = Solver(cfg, qa, store, device="cpu")
    initial = trained.val()
    trained._train_step(next(trained.batches["train"].epoch(0)))
    trained.step += 1
    after_step = trained.val()
    assert after_step != initial
    trained.save()  # step_1 and the weights export

    fresh = Solver(cfg, qa, store, device="cpu")
    w3 = fresh.model.stage1_w3.clone()
    assert fresh.val() == initial
    fresh.restore()
    assert fresh.step == 1
    assert not torch.equal(fresh.model.stage1_w3, w3)
    assert fresh.val() == after_step

    other = Solver(cfg, qa, store, device="cpu")
    other.set_weights(ckpt.load_weights(trained.checkpoint_dir))
    assert other.val() == after_step
    # the best snapshot swapped in over later weights
    other.best_state = {k: v.clone() for k, v in
                        other.model.state_dict().items()}
    other._train_step(next(other.batches["train"].epoch(1)))
    assert other.val() != after_step
    other.set_weights(other.best_state)
    assert other.val() == after_step


@pytest.mark.parametrize("metric,values,stop_after,best_epoch", [
    ("loss", [(1.0, 0.1), (0.8, 0.1), (0.9, 0.9), (0.95, 0.9), (0.5, 0.9)],
     4, 1),
    ("acc", [(1.0, 0.2), (1.0, 0.5), (0.1, 0.4), (0.1, 0.5), (0.1, 0.9)],
     4, 1),
])
def test_early_stopping_keeps_and_exports_the_best(data, tmp_path, metric,
                                                   values, stop_after,
                                                   best_epoch):
    """Scripted val metrics, patience 2: the run stops after ``stop_after``
    epochs, and the best snapshot is a copy of the weights at
    ``best_epoch``, exported by save() and carried by the checkpoint."""
    qa, store = data
    cfg = _cfg(qa, tmp_path, num_epoch=5, early_stopping=True, patience=2,
               early_stop_metric=metric)
    solver = Solver(cfg, qa, store, device="cpu")
    script, seen = iter(values), []

    def scripted_val(full=False):
        seen.append({k: v.clone() for k, v in
                     solver.model.state_dict().items()})
        return next(script)

    solver.val = scripted_val
    solver.train()
    assert len(seen) == stop_after and solver.step == 4 * stop_after
    assert solver.i_patience == 2
    _assert_bit_equal(solver.best_state, seen[best_epoch])
    live = solver.model.state_dict()
    assert not torch.equal(live["fc.weight"], seen[best_epoch]["fc.weight"])
    solver.save()
    _assert_bit_equal(ckpt.load_weights(solver.checkpoint_dir),
                      seen[best_epoch])
    restored = Solver(cfg, qa, store, device="cpu")
    restored.restore()
    _assert_bit_equal(restored.best_state, seen[best_epoch])
    assert (restored.i_patience, restored.min_val_loss,
            restored.best_val_acc) == (solver.i_patience,
                                       solver.min_val_loss,
                                       solver.best_val_acc)


# ---------------------------------------------------------------------------
# val(full=True) against the JAX Solver
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools/gen_corpus.py"),
                    str(root), "--n_train", "48", "--n_val", "45", "--seed",
                    "1"], check=True, capture_output=True, timeout=120)
    jax_prepare.prepare_training_data(str(root), 2, 10)
    base = jax_prepare.qa_artifact_path(str(root), 2, 10)
    jqa, pqa = jax_prepare.load_qa_data(base), port_prepare.load_qa_data(base)
    ids = sorted(set(pqa.train.image_ids) | set(pqa.val.image_ids))
    jax_store.make_synthetic_feature_store(str(root / "resnet152_all"), ids,
                                           channels=16)
    return (jqa, jax_store.open_feature_store(str(root)), pqa,
            port_store.open_feature_store(str(root)))


@pytest.mark.parametrize("name", ["iBOWIMG", "mhb_coAtt"])
def test_full_val_matches_the_jax_solver(corpus_data, tmp_path, name):
    jqa, jstore, pqa, pstore = corpus_data
    cfg = Config(model_name=name, q_vocab_size=pqa.q_vocab_size,
                 a_vocab_size=pqa.a_vocab_size,
                 max_question_length=pqa.max_question_length, batch_size=16,
                 results_dir=str(tmp_path / "port"), **WIDTHS).validate()
    jax_solver = JaxSolver(
        JaxConfig(**dataclasses.asdict(cfg.replace(
            results_dir=str(tmp_path / "jax")))),
        jqa, jstore, mesh=make_mesh(data=1, model=1),
        log_dir=str(tmp_path / "runs"))
    params = jax.tree_util.tree_map(np.asarray, jax_solver.params)
    port = Solver(cfg, pqa, pstore, params=params, device="cpu")
    want = jax_solver.val(full=True)
    got = port.val(full=True)
    n = len(pqa.val)
    assert n % cfg.batch_size != 0  # the last batch has pad rows
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert abs(got[1] - want[1]) <= 1.0 / n

    def read(d):
        with open(d / f"{name}.txt") as f:
            txt = f.read()
        with open(d / f"{name}.json") as f:
            record = json.load(f)
        with open(d / f"{name}_predictions.json") as f:
            preds = json.load(f)
        return txt, record, preds

    (ptxt, prec, ppred), (jtxt, jrec, jpred) = (read(tmp_path / "port"),
                                                read(tmp_path / "jax"))
    assert ptxt == jtxt and ptxt.startswith("Evaluation accuracy: ")
    assert ppred == jpred
    assert len(ppred) == n
    assert [p["question_id"] for p in ppred] == pqa.val.question_ids.tolist()
    assert sorted(prec) == sorted(jrec)
    assert prec["num_examples"] == jrec["num_examples"] == n
    for key in ("accuracy", "accuracy_reference_denominator",
                "top3_accuracy", "vqa_consensus_accuracy"):
        assert abs(prec[key] - jrec[key]) <= 1.0 / n, key
        assert 0.0 <= prec[key] <= 1.0
    # the reference denominator counts pad rows, the exact one does not
    n_rows = -(-n // cfg.batch_size) * cfg.batch_size
    assert prec["accuracy_reference_denominator"] == pytest.approx(
        prec["accuracy"] * n / n_rows)
    for breakdown in ("per_answer_type", "per_question_type"):
        assert sorted(prec[breakdown]) == sorted(jrec[breakdown])
        assert sum(v["num_examples"] for v in
                   prec[breakdown].values()) == n
        for k, v in prec[breakdown].items():
            w = jrec[breakdown][k]
            assert v["num_examples"] == w["num_examples"]
            for m in ("accuracy", "vqa_consensus_accuracy"):
                assert abs(v[m] - w[m]) <= 1.0 / v["num_examples"]


# ---------------------------------------------------------------------------
# reference .pth import / export against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,glove", [(n, False) for n in MODEL_NAMES]
                         + [("mhb_coAtt", True)])
def test_torch_import_matches_jax(tmp_path, name, glove):
    cfg = Config(model_name=name, q_vocab_size=20, a_vocab_size=9,
                 max_question_length=T, glove=glove, **WIDTHS).validate()
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    jtemplate = jax_get_model(name).init(jax.random.PRNGKey(1), jcfg)
    if glove:
        jtemplate["glove_table"] = np.random.default_rng(2).standard_normal(
            (20, WIDTHS["emb_dim"])).astype(np.float32)
    # the reference .pth: JAX's export of random weights (every leaf,
    # running statistics included, non-zero)
    rng = np.random.default_rng(3)
    source = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(np.shape(x)).astype(np.float32),
        jtemplate)
    exported = jax_import.export_state_dict(name, source)
    pth = str(tmp_path / f"{name}.pth")
    torch.save({f"module.{k}": torch.from_numpy(np.asarray(v))
                for k, v in exported.items()}, pth)

    loaded = port_import.load_pth(pth)
    want_loaded = jax_import.load_pth(pth)
    assert sorted(loaded) == sorted(want_loaded)
    for k in loaded:
        np.testing.assert_array_equal(loaded[k], want_loaded[k])
    ptemplate = init_params(cfg, torch.Generator().manual_seed(0))
    if glove:
        ptemplate["glove_table"] = torch.from_numpy(jtemplate["glove_table"])
    got = port_import.import_state_dict(name, loaded, ptemplate)
    want = jax_import.import_state_dict(name, want_loaded, jtemplate)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_want))
    for path, leaf in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[path]),
                                      np.asarray(leaf), err_msg=str(path))
    back = port_import.export_state_dict(name, got)
    assert sorted(back) == sorted(exported)
    for k in back:
        np.testing.assert_array_equal(back[k], exported[k], err_msg=k)
    # the imported tree loads into the port's module and comes back whole
    module = load_jax_params(get_model(name)(cfg), got)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(
        to_jax_params(module)))
    assert sorted(map(str, flat_back)) == sorted(map(str, flat_want))
    for path, leaf in flat_want.items():
        np.testing.assert_array_equal(flat_back[path], np.asarray(leaf),
                                      err_msg=str(path))
