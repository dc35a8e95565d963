"""The port's own ``Config`` and data modules against the JAX package's.

The port keeps copies of what it needs (``vqa_attention_networks_tpu_torch/
config.py`` and ``data/``); only this test imports both. The copies must
mean the same: the same Config fields, defaults and validation errors; the
same synthetic QA arrays and store files from one seed; and the port's
native data plane (its own build of ``csrc/dataplane.cpp``) equal to its
NumPy twins.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

from vqa_attention_networks_tpu import config as jax_config
from vqa_attention_networks_tpu.data import feature_store as jax_store
from vqa_attention_networks_tpu.data import prepare as jax_prepare
from vqa_attention_networks_tpu_torch import config as port_config
from vqa_attention_networks_tpu_torch.data import feature_store as port_store
from vqa_attention_networks_tpu_torch.data import native
from vqa_attention_networks_tpu_torch.data import prepare as port_prepare
from vqa_attention_networks_tpu_torch.data.dataset import VqaBatches


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_config_fields_defaults_and_names_match():
    assert _fields(port_config.Config) == _fields(jax_config.Config)
    assert port_config.MODEL_NAMES == jax_config.MODEL_NAMES
    assert port_config.SOFT_ANSWER_MODELS == jax_config.SOFT_ANSWER_MODELS
    port, ref = port_config.Config(), jax_config.Config()
    for prop in ("soft_answer", "fusion_dim", "lstm_input_dim"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    for kw in (dict(glove=True), dict(model_name="mfb"),
               dict(loss_override="soft_bce")):
        a, b = port.replace(**kw), ref.replace(**kw)
        assert (a.soft_answer, a.lstm_input_dim) == (b.soft_answer,
                                                     b.lstm_input_dim)
    with pytest.raises(dataclasses.FrozenInstanceError):
        port.batch_size = 3


@pytest.mark.parametrize("kw", [
    dict(model_name="nope"), dict(img_feature_dim=100),
    dict(model_name="attentionNet", att_num=1),
    dict(grad_accum_steps=3), dict(prefetch_workers=0),
    dict(early_stop_metric="f1"), dict(mode="serve"),
    dict(compute_dtype="float16"), dict(rng_impl="philox"),
    dict(loss_override="mse"), dict(fast_path="fast"),
    dict(dropout_site="post"),
])
def test_config_validation_errors_match(kw):
    with pytest.raises(ValueError) as want:
        jax_config.Config(**kw).validate()
    with pytest.raises(ValueError) as got:
        port_config.Config(**kw).validate()
    expected = str(want.value)
    if kw.get("model_name") == "nope":
        # the port lists its own families too (PORT_MODEL_NAMES: the JAX
        # package's eight, then mcan)
        expected = expected.replace(str(jax_config.MODEL_NAMES),
                                    str(port_config.PORT_MODEL_NAMES))
    assert str(got.value) == expected


def test_valid_configs_pass_in_both():
    for name in port_config.MODEL_NAMES:
        kw = dict(model_name=name, compute_dtype="bfloat16")
        port_config.Config(**kw).validate()
        jax_config.Config(**kw).validate()


def test_synthetic_qa_data_equal():
    kw = dict(n_train=30, n_val=9, q_vocab_words=20, num_answers=11,
              max_len=7, num_images=5)
    port = port_prepare.make_synthetic_qa_data(np.random.default_rng(3), **kw)
    ref = jax_prepare.make_synthetic_qa_data(np.random.default_rng(3), **kw)
    for split in ("train", "val"):
        got, want = getattr(port, split), getattr(ref, split)
        for field in dataclasses.fields(got):
            a, b = getattr(got, field.name), getattr(want, field.name)
            assert a.dtype == b.dtype, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        np.testing.assert_array_equal(
            port_prepare.densify_soft_np(got.soft_idx, got.soft_val, 11),
            want.soft_dense(11))
    assert port.answer_vocab == ref.answer_vocab
    assert port.question_vocab == ref.question_vocab
    assert (port.q_vocab_size, port.a_vocab_size,
            port.max_question_length) == (ref.q_vocab_size, ref.a_vocab_size,
                                          ref.max_question_length)


@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_synthetic_feature_store_files_equal(tmp_path, dtype):
    ids = [7, 3, 11]
    port = port_store.make_synthetic_feature_store(
        str(tmp_path / "port"), ids, num_regions=6, channels=10, seed=2,
        dtype=dtype)
    ref = jax_store.make_synthetic_feature_store(
        str(tmp_path / "jax"), ids, num_regions=6, channels=10, seed=2,
        dtype=dtype)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "port", tmp_path / "jax", names, shallow=False)
    assert match == names and not mismatch and not errors
    for d in (np.float32, np.float16):
        np.testing.assert_array_equal(port.gather([11, 7], d),
                                      ref.gather([11, 7], d))
    if dtype == "int8":
        for got, want in zip(port.gather_quantized([3, 11]),
                             ref.gather_quantized([3, 11])):
            np.testing.assert_array_equal(got, want)


def test_quantize_features_equal():
    x = np.random.default_rng(4).standard_normal((3, 6, 10)).astype(
        np.float32)
    x[0, :, 2] = 0.0  # an all-zero channel
    for got, want in zip(port_store.quantize_features(x),
                         jax_store.quantize_features(x)):
        np.testing.assert_array_equal(got, want)


def test_native_data_plane_matches_numpy(tmp_path):
    """The port builds its own library (never the JAX package's
    native/libvqa_dataplane.so) and it agrees with the NumPy twins."""
    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C++ compiler on this host: the NumPy twins run")
    path = native.library_path()
    assert os.path.basename(os.path.dirname(path)) == "native"
    assert os.path.basename(os.path.dirname(os.path.dirname(path))) == \
        "build"
    rng = np.random.default_rng(5)
    src = rng.standard_normal((9, 4, 6)).astype(np.float16)
    rows = np.array([8, 0, 3, 3])
    np.testing.assert_array_equal(native.gather_f16(src, rows), src[rows])
    np.testing.assert_array_equal(native.gather_f16_to_f32(src, rows),
                                  src[rows].astype(np.float32))
    q = rng.integers(-127, 128, (9, 4, 6)).astype(np.int8)
    np.testing.assert_array_equal(native.gather_i8(q, rows), q[rows])
    with pytest.raises(IndexError):
        native.gather_f16(src, np.array([9]))
    idx = np.array([[1, 4, -1], [0, -1, -1]], np.int32)
    val = np.array([[0.7, 0.3, 0.0], [1.0, 0.0, 0.0]], np.float32)
    np.testing.assert_array_equal(native.densify_soft(idx, val, 5),
                                  port_prepare.densify_soft_np(idx, val, 5))
    with pytest.raises(IndexError):
        native.densify_soft(idx, val, 4)


def test_batches_match_the_jax_pipeline(tmp_path):
    kw = dict(n_train=21, n_val=4, num_answers=9, max_len=5, num_images=4)
    port_qa = port_prepare.make_synthetic_qa_data(np.random.default_rng(1),
                                                  **kw)
    ref_qa = jax_prepare.make_synthetic_qa_data(np.random.default_rng(1), **kw)
    ids = list(range(4))
    stores = (port_store.make_synthetic_feature_store(
                  str(tmp_path / "p"), ids, num_regions=3, channels=8),
              jax_store.make_synthetic_feature_store(
                  str(tmp_path / "j"), ids, num_regions=3, channels=8))
    from vqa_attention_networks_tpu.data.dataset import VqaBatches as JaxVB

    args = dict(batch_size=8, num_answers=9, soft_answer=True, seed=3,
                feature_dtype=np.float16)
    port = VqaBatches(port_qa.train, stores[0], **args)
    ref = JaxVB(ref_qa.train, stores[1], **args)
    assert len(port) == len(ref) == 3
    got = list(port.parallel_epoch(2, workers=2))
    for a, b in zip(got, ref.epoch(2)):
        for field in ("image_features", "questions", "answers",
                      "ques_length", "valid", "soft_answers"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field), err_msg=field)
    assert not got[-1].valid[5:].any() and got[-1].valid[:5].all()
