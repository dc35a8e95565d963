"""The training feature bank (``Config.device_feature_bank``,
``vqa_attention_networks_tpu_torch/train/feature_bank.py``): the twin of
the JAX package's ``tests/test_device_bank_train.py`` on the CPU, less its
data-parallel case, which ``test_torch_port_parallel.py`` holds over two
ranks, and its sharded cases, which ``test_torch_port_sharded_banks.py``
holds over four.

The bank holds exactly the bytes the host feed would ship (int8 rows and
f16 scales, or f16 rows) and applies the same dequant, so training from
it is bit-equal to the host feed: the losses, the accuracies and the full
evaluation equal, not close. Each package's bank batches carry the same
dense row indices.
"""

import numpy as np
import pytest
import torch

from vqa_attention_networks_tpu.data import dataset as jax_dataset
from vqa_attention_networks_tpu.data import feature_store as jax_store
from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.data.dataset import VqaBatches
from vqa_attention_networks_tpu_torch.data.feature_store import (
    CombinedFeatureStore,
    make_synthetic_feature_store,
    quantize_store,
)
from vqa_attention_networks_tpu_torch.data.prepare import (
    make_synthetic_qa_data,
)
from vqa_attention_networks_tpu_torch.train.solver import Solver


def _qa():
    return make_synthetic_qa_data(np.random.default_rng(0), n_train=96,
                                  n_val=24, num_images=6)


def _ids(qa):
    return sorted(set(qa.train.image_ids) | set(qa.val.image_ids))


def _store(tmp_path, qa, quantized):
    f16 = make_synthetic_feature_store(str(tmp_path / "feat"), _ids(qa),
                                       num_regions=196, channels=32)
    if not quantized:
        return f16
    return quantize_store(str(tmp_path / "feat"), str(tmp_path / "feat_q"))


def _cfg(tmp_path, qa, tag, **kw):
    return Config(
        model_name="iBOWIMG", q_vocab_size=qa.q_vocab_size,
        a_vocab_size=qa.a_vocab_size, hidden_dim=16, emb_dim=8,
        embed_size=16, img_feature_channel=32,
        max_question_length=qa.max_question_length, batch_size=16,
        num_epoch=2, checkpoint_every_steps=0, prefetch_workers=1,
        out_dir=str(tmp_path / f"models_{tag}"),
        results_dir=str(tmp_path / f"results_{tag}"), **kw,
    ).validate()


def _run(tmp_path, qa, store, tag, **cfg_kw):
    solver = Solver(_cfg(tmp_path, qa, tag, **cfg_kw), qa, store,
                    device="cpu")
    losses = []
    metrics = solver.train(on_step=lambda s, loss: losses.append(
        float(loss)))
    loss, acc = solver.val(full=True)
    solver.close()
    return losses, metrics, loss, acc


def _assert_same_run(a, b):
    losses_a, m_a, loss_a, acc_a = a
    losses_b, m_b, loss_b, acc_b = b
    assert losses_a == losses_b
    assert m_a["train_loss"] == m_b["train_loss"]
    assert m_a["train_acc"] == m_b["train_acc"]
    assert loss_a == loss_b and acc_a == acc_b


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f16_store", "int8_store"])
def test_bank_training_bit_identical_to_host_feed(tmp_path, quantized,
                                                  compute_dtype):
    qa = _qa()
    store = _store(tmp_path, qa, quantized)
    host = _run(tmp_path, qa, store, "host", compute_dtype=compute_dtype)
    bank = _run(tmp_path, qa, store, "bank", compute_dtype=compute_dtype,
                device_feature_bank=True)
    _assert_same_run(bank, host)


def test_combined_store_bank_uses_dense_rows(tmp_path):
    """A ``CombinedFeatureStore``'s handles are ``(store << 40) | row``:
    the bank is filled in ``all_rows()`` order and the batches carry
    ``dense_rows``, so training is the host feed's."""
    qa = _qa()
    ids = _ids(qa)
    s0 = make_synthetic_feature_store(str(tmp_path / "f0"), ids[:2],
                                      num_regions=196, channels=32)
    s1 = make_synthetic_feature_store(str(tmp_path / "f1"), ids[2:],
                                      num_regions=196, channels=32, seed=1)
    store = CombinedFeatureStore([s0, s1])
    enc = store.rows_for(ids)
    dense = store.dense_rows(enc)
    assert dense.max() < len(store) and dense.min() >= 0
    assert enc.max() >= 1 << 40  # the second store's handles are encoded
    table = store.gather_rows(store.all_rows(), dtype=np.float32)
    np.testing.assert_array_equal(table[dense],
                                  store.gather_rows(enc, dtype=np.float32))
    _assert_same_run(_run(tmp_path, qa, store, "comb_bank",
                          device_feature_bank=True),
                     _run(tmp_path, qa, store, "comb_host"))


def test_f32_compute_bank_stays_f16_resident(tmp_path):
    """An f16 store stays f16 on the device under f32 compute (half the
    bytes; the lookup's upcast is exact) and the lookup emits the f32 the
    host feed ships."""
    qa = _qa()
    store = _store(tmp_path, qa, quantized=False)
    solver = Solver(_cfg(tmp_path, qa, "f16res", device_feature_bank=True,
                         compute_dtype="float32"), qa, store, device="cpu")
    bank = solver.bank
    assert bank.rows.dtype == torch.float16 and bank.scale is None
    assert bank.nbytes == len(store) * 196 * 32 * 2
    out = bank.lookup(torch.zeros(4, dtype=torch.int64))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(
        out.numpy(), store.gather_rows(np.zeros(4, np.int64),
                                       dtype=np.float32))
    qsolver = Solver(_cfg(tmp_path, qa, "q", device_feature_bank=True,
                          compute_dtype="bfloat16"), qa,
                     _store(tmp_path / "q", qa, quantized=True),
                     device="cpu")
    assert qsolver.bank.rows.dtype == torch.int8
    assert qsolver.bank.scale.dtype == torch.float16
    assert qsolver.bank.lookup(torch.zeros(2, dtype=torch.int64)).dtype == \
        torch.bfloat16


def test_bank_over_budget_raises_with_guidance(tmp_path):
    qa = _qa()
    store = _store(tmp_path, qa, quantized=False)
    cfg = _cfg(tmp_path, qa, "budget", device_feature_bank=True,
               device_feature_bank_budget=1024)  # 1 KiB: nothing fits
    with pytest.raises(ValueError, match="quantize_store"):
        Solver(cfg, qa, store, device="cpu")
    # the budget is checked against the bytes of the table it would hold
    need = len(store) * 196 * 32 * 2
    Solver(cfg.replace(device_feature_bank_budget=need), qa, store,
           device="cpu")
    with pytest.raises(ValueError, match="budget"):
        Solver(cfg.replace(device_feature_bank_budget=need - 1), qa, store,
               device="cpu")


def test_rows_mode_batches_carry_indices_not_bytes(tmp_path):
    """Bank-mode batches carry [B] int32 dense rows and no features, equal
    to the JAX package's bank-mode batches on the same store, and the rows
    resolve to the bytes the host gather would read."""
    qa = _qa()
    store = _store(tmp_path, qa, quantized=True)
    kw = dict(batch_size=16, num_answers=qa.a_vocab_size, soft_answer=False,
              shuffle=False, feature_dtype=np.int8, device_bank=True)
    batches = VqaBatches(qa.train, store, **kw)
    b = next(batches.epoch(0))
    assert b.image_features is None and b.feature_scale is None
    assert b.image_rows is not None and b.image_rows.dtype == np.int32
    assert b.image_rows.shape == (16,)
    want, _ = store.gather_rows_quantized(b.image_rows)
    got, _ = store.gather_rows_quantized(
        store.rows_for(qa.train.image_ids[:16]))
    np.testing.assert_array_equal(want, got)
    jax_batches = jax_dataset.VqaBatches(
        qa.train, jax_store.FeatureStore(str(tmp_path / "feat_q")), **kw)
    for g, w in zip(batches.epoch(1), jax_batches.epoch(1)):
        np.testing.assert_array_equal(g.image_rows, w.image_rows)
        np.testing.assert_array_equal(g.valid, w.valid)
