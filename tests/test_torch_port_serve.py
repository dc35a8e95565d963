"""The port's InferenceEngine (vqa_attention_networks_tpu_torch/serve.py)
against the JAX engine on the same weights and requests, on the CPU.

Probabilities are compared at atol 2e-4: the engines run bf16 activations,
and the logits agree to a few bf16 ulps (test_torch_port_mhb_coatt.py);
through the softmax over 40 answers (probabilities near 0.025) that moves a
probability by about 1e-4. hieCoAtten and mfb serve through the same
engine: their logits agree to 1e-2 (test_torch_port_hiecoatten.py,
test_torch_port_mfb.py), and a logit difference e moves a probability p
by about p * e: up to 4e-3 at their top probabilities (up to ~0.4 over 20
answers), ``OTHER_PROB_ATOL``. So do mhb, visLstm, iBOWIMG and
attentionNet, with both feeds (test_torch_port_families.py holds their
bf16 logits); MHB's answers follow the ``qlen`` each request carries, in
both engines.
"""

import numpy as np
import pytest
import torch

import test_torch_port_families as fam
import test_torch_port_hiecoatten as hie
import test_torch_port_mfb as mfb
from test_torch_port_mhb_coatt import params_for, port_config, small_cfg
from vqa_attention_networks_tpu.data.feature_store import quantize_features
from vqa_attention_networks_tpu.serve import InferenceEngine as JaxEngine
from vqa_attention_networks_tpu_torch.ops import coattention as co
from vqa_attention_networks_tpu_torch.ops import grid_fusion as gf
from vqa_attention_networks_tpu_torch.ops import wq_fusion as wqf
from vqa_attention_networks_tpu_torch.serve import InferenceEngine

B, TOPK = 8, 5
PROB_ATOL = 2e-4  # measured 1.0e-4 on this data
OTHER_PROB_ATOL = 4e-3  # measured 1.2e-3 (hieCoAtten)


def _requests(cfg, n, seed):
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((n, 196, cfg.img_feature_channel))
           * 0.5).astype(np.float32)
    ques = rng.integers(1, cfg.q_vocab_size,
                        (n, cfg.max_question_length)).astype(np.int32)
    ques[0, 4:] = 0
    return img, ques


def _engines(monkeypatch, fast_path, input_dtype="float16", seed=0):
    if fast_path != "composed":
        # the JAX engine runs K1 in interpret mode on the CPU
        monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    cfg = small_cfg(fast_path=fast_path)
    params = params_for(cfg, seed=seed)
    port = InferenceEngine(port_config(cfg), params, batch_size=B,
                           topk=TOPK, input_dtype=input_dtype, device="cpu")
    ref = JaxEngine(cfg, params, batch_size=B, topk=TOPK,
                    input_dtype=input_dtype)
    return port, ref, cfg


def _assert_same(got, want, atol=PROB_ATOL):
    """Equal top-k ids and close probabilities. Answers whose probabilities
    lie within the tolerance of a neighbour's are a tie that either engine
    may order either way, so the ids are compared at the ranks whose
    neighbours (the unseen rank k+1 counts as one) are clearly apart."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.top_probs, w.top_probs, rtol=0,
                                   atol=atol)
        assert g.top_probs.dtype == np.float32
        gaps = w.top_probs[:-1] - w.top_probs[1:]
        clear = np.minimum(np.r_[np.inf, gaps], np.r_[gaps, 0.0]) > (
            2 * atol)
        np.testing.assert_array_equal(g.top_ids[clear], w.top_ids[clear])
        if clear[0] or gaps[0] > 2 * atol:
            assert g.answer_id == w.answer_id


@pytest.mark.parametrize("fast_path", ["auto", "composed"])
def test_engine_matches_jax_engine(monkeypatch, fast_path):
    port, ref, cfg = _engines(monkeypatch, fast_path)
    img, ques = _requests(cfg, B, seed=1)
    before = wqf.launch_count
    _assert_same(port.predict_batch(img, ques), ref.predict_batch(img, ques))
    assert wqf.launch_count == before
    assert port.cfg.compute_dtype == "bfloat16"


def test_padded_partial_batch_matches_full_batch(monkeypatch):
    port, _, cfg = _engines(monkeypatch, "auto")
    img, ques = _requests(cfg, B, seed=2)
    part = port.predict_batch(img[:5], ques[:5])
    full = port.predict_batch(img, ques)
    assert len(part) == 5
    for a, b in zip(part, full[:5]):
        np.testing.assert_array_equal(a.top_ids, b.top_ids)
        np.testing.assert_array_equal(a.top_probs, b.top_probs)


def test_stream_matches_batch(monkeypatch):
    port, _, cfg = _engines(monkeypatch, "auto")
    reqs = [_requests(cfg, n, seed=3 + n) for n in (B, 3, B)]
    direct = [port.predict_batch(i, q) for i, q in reqs]
    streamed = list(port.predict_stream((i, q, None) for i, q in reqs))
    assert [len(s) for s in streamed] == [B, 3, B]
    for d_batch, s_batch in zip(direct, streamed):
        for d, s in zip(d_batch, s_batch):
            np.testing.assert_array_equal(d.top_ids, s.top_ids)
            np.testing.assert_array_equal(d.top_probs, s.top_probs)


def test_f16_clip(monkeypatch):
    port, ref, cfg = _engines(monkeypatch, "composed")
    img, ques = _requests(cfg, 4, seed=9)
    img[0, :3, :5] = 1e6  # beyond f16: a bare cast would give inf
    img[1, 7, 2] = -1e6
    got = port.predict_batch(img, ques)
    for p in got:
        assert np.isfinite(p.top_probs).all()
    lim = np.finfo(np.float16).max
    clipped = port.predict_batch(np.clip(img, -lim, lim).astype(np.float16),
                                 ques)
    for a, b in zip(got, clipped):
        np.testing.assert_array_equal(a.top_probs, b.top_probs)
    _assert_same(got, ref.predict_batch(img, ques))


def test_int8_feed_matches_jax_engine(monkeypatch):
    port, ref, cfg = _engines(monkeypatch, "auto", input_dtype="int8")
    img, ques = _requests(cfg, 6, seed=10)
    q8, scale, _ = quantize_features(img)
    got = port.predict_batch(q8, ques, feature_scale=scale)
    _assert_same(got, ref.predict_batch(q8, ques, feature_scale=scale))
    streamed = next(port.predict_stream(iter([(q8, ques, None, scale)])))
    for a, b in zip(got, streamed):
        np.testing.assert_array_equal(a.top_probs, b.top_probs)
    with pytest.raises(ValueError, match="feature_scale"):
        port.predict_batch(q8, ques)


def test_unported_options_raise(monkeypatch):
    """The exported artifact and data-parallel serving still raise, each
    naming its ROADMAP item; the device feature cache is ported
    (``test_torch_port_device_cache.py``)."""
    cfg = port_config(small_cfg())
    params = params_for(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 14"):
        InferenceEngine(cfg, params, artifact_dir="x", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
        InferenceEngine(cfg, params, data_parallel=2, device="cpu")
    engine = InferenceEngine(cfg, params, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="larger than"):
        engine.predict_batch(*_requests(cfg, 3, seed=11))
    if not torch.cuda.is_available():
        # the default device is the card, never a silent CPU fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceEngine(cfg, params)


def test_topk_clamped_to_answer_vocab(monkeypatch):
    cfg = small_cfg(a_vocab_size=3)
    engine = InferenceEngine(port_config(cfg), params_for(cfg), batch_size=2,
                             topk=5, device="cpu")
    assert engine.topk == 3
    preds = engine.predict_batch(*_requests(cfg, 2, seed=12))
    assert preds[0].top_ids.shape == (3,)
    assert (np.diff(preds[0].top_probs) <= 0).all()


@pytest.mark.parametrize("family", ["hieCoAtten", "mfb", "mfb-multilayer"])
def test_engine_serves_other_families_like_the_jax_engine(monkeypatch,
                                                         family):
    """hieCoAtten through K4 (JAX's interpreted, the port's plain version);
    mfb and mfb-multilayer, quirks off, through K5 under VQA_FORCE_PALLAS."""
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    if family == "hieCoAtten":
        cfg = hie.small_cfg()
        params = hie.params_for(cfg)
    else:
        monkeypatch.setenv("VQA_FORCE_PALLAS", "1")
        cfg = mfb.small_cfg(model_name=family, keep_reference_quirks=False)
        params = mfb.params_for(cfg)
    port = InferenceEngine(port_config(cfg), params, batch_size=B, topk=TOPK,
                           device="cpu")
    ref = JaxEngine(cfg, params, batch_size=B, topk=TOPK)
    assert type(port.model).__name__ == ("HieCoAtten" if family ==
                                         "hieCoAtten" else "MFB")
    img, ques = _requests(cfg, B, seed=13)
    counts = (co.launch_count, gf.launch_count)
    got = port.predict_batch(img, ques)
    assert (co.launch_count, gf.launch_count) == counts  # CPU: plain
    _assert_same(got, ref.predict_batch(img, ques), atol=OTHER_PROB_ATOL)
    streamed = list(port.predict_stream(
        iter([(img[:5], ques[:5], None), (img, ques, None)])))
    for a, b in zip(streamed[1], got):
        np.testing.assert_array_equal(a.top_probs, b.top_probs)
    for a, b in zip(streamed[0], got[:5]):
        np.testing.assert_array_equal(a.top_ids, b.top_ids)


@pytest.mark.parametrize("input_dtype", ["float16", "int8"])
@pytest.mark.parametrize("family", fam.NEW)
def test_engine_serves_the_last_families_like_the_jax_engine(family,
                                                             input_dtype):
    """mhb, visLstm, iBOWIMG (batch norm at its running statistics) and
    attentionNet: no kernel on their path, the same answers as the JAX
    engine with each feed."""
    cfg = fam.small_cfg(family)
    params = fam.params_for(cfg, seed=15)
    port = InferenceEngine(port_config(cfg), params, batch_size=B, topk=TOPK,
                           input_dtype=input_dtype, device="cpu")
    ref = JaxEngine(cfg, params, batch_size=B, topk=TOPK,
                    input_dtype=input_dtype)
    img, ques = _requests(cfg, B, seed=16)
    feats, kw = img, {}
    if input_dtype == "int8":
        feats, scale, _ = quantize_features(img)
        kw = dict(feature_scale=scale)
    got = port.predict_batch(feats, ques, **kw)
    _assert_same(got, ref.predict_batch(feats, ques, **kw),
                 atol=OTHER_PROB_ATOL)
    item = (feats[:5], ques[:5], None) + ((kw["feature_scale"][:5],)
                                          if kw else ())
    for a, b in zip(next(port.predict_stream(iter([item]))), got[:5]):
        np.testing.assert_array_equal(a.top_ids, b.top_ids)


def test_mhb_answers_follow_the_question_length():
    """The length each request carries reaches MHB through the engine (and
    ``aot.serving_forward``): the same as JAX's with the same lengths, and
    different answers when the lengths change."""
    cfg = fam.small_cfg("mhb")
    params = fam.params_for(cfg, seed=17)
    port = InferenceEngine(port_config(cfg), params, batch_size=B, topk=TOPK,
                           device="cpu")
    ref = JaxEngine(cfg, params, batch_size=B, topk=TOPK)
    img, ques = _requests(cfg, B, seed=18)
    counted = (ques != 0).sum(1).astype(np.int32)
    shifted = np.maximum(counted - 2, 0).astype(np.int32)
    for qlen in (None, counted, shifted):
        _assert_same(port.predict_batch(img, ques, ques_length=qlen),
                     ref.predict_batch(img, ques, ques_length=qlen),
                     atol=OTHER_PROB_ATOL)
    full = port.predict_batch(img, ques)
    short = port.predict_batch(img, ques, ques_length=shifted)
    assert all(np.array_equal(a.top_probs, b.top_probs) for a, b in
               zip(full, port.predict_batch(img, ques, ques_length=counted)))
    differ = sum(not np.array_equal(a.top_probs, b.top_probs)
                 for a, b in zip(full, short))
    assert differ == B
    streamed = next(port.predict_stream(iter([(img, ques, shifted)])))
    for a, b in zip(streamed, short):
        np.testing.assert_array_equal(a.top_probs, b.top_probs)
