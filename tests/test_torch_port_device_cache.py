"""The port's device feature cache and by-id serving
(``vqa_attention_networks_tpu_torch/serve.py`` ``DeviceFeatureCache``,
``InferenceEngine.predict_*_by_id``) against the JAX package's, on the CPU.
Mirrors ``tests/test_serve.py``'s device-cache tests.

- By id, the port's answers are bit-equal to its own per-request int8 feed
  (the same rows and scales reach the same forward), and equal to JAX's
  by-id engine at ``PROB_ATOL`` (``test_torch_port_serve.py``'s bound for
  bf16 mhb_coAtt through K1: JAX's interpreted, the port's plain version).
- The cache's bookkeeping is the JAX cache's: the same slot arrays and the
  same hit, miss and eviction counts on the same id sequence, exactly.
- A batch's misses reach the bank in one upload (JAX ships them in
  power-of-two chunks because ``jit`` compiles one program per shape).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_port_families as fam
from test_torch_port_mhb_coatt import params_for, port_config, small_cfg
from test_torch_port_serve import B, TOPK, _assert_same
from vqa_attention_networks_tpu.data.feature_store import quantize_features
from vqa_attention_networks_tpu.serve import (
    DeviceFeatureCache as JaxCache,
)
from vqa_attention_networks_tpu.serve import InferenceEngine as JaxEngine
from vqa_attention_networks_tpu_torch.serve import (
    DeviceFeatureCache,
    InferenceEngine,
)


def _pool(rng, n_images, channels):
    feats = rng.standard_normal((n_images, 196, channels)).astype(np.float32)
    rows, scale, _ = quantize_features(feats * 0.5)
    return rows, scale.astype(np.float16)


def _engines(monkeypatch, capacity, fetch):
    """bf16 mhb_coAtt (the main path: K1) in both packages, int8 feed, the
    bank attached to each."""
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")  # JAX's K1 on the CPU
    cfg = small_cfg()
    params = params_for(cfg, seed=20)
    port = InferenceEngine(port_config(cfg), params, batch_size=B,
                           topk=TOPK, input_dtype="int8", device="cpu")
    ref = JaxEngine(cfg, params, batch_size=B, topk=TOPK,
                    input_dtype="int8")
    return (port, port.attach_feature_cache(capacity, fetch), ref,
            ref.attach_feature_cache(capacity, fetch), cfg)


def _ibowimg_engine(capacity, fetch):
    cfg = fam.small_cfg("iBOWIMG")
    engine = InferenceEngine(port_config(cfg), fam.params_for(cfg, seed=21),
                             batch_size=B, topk=3, input_dtype="int8",
                             device="cpu")
    return engine, engine.attach_feature_cache(capacity, fetch), cfg


def _ques(rng, cfg, n):
    return rng.integers(1, cfg.q_vocab_size,
                        (n, cfg.max_question_length)).astype(np.int32)


def _bit_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.answer_id == b.answer_id
        np.testing.assert_array_equal(a.top_ids, b.top_ids)
        np.testing.assert_array_equal(a.top_probs, b.top_probs)


def test_by_id_matches_the_int8_feed_and_the_jax_engine(monkeypatch):
    rng = np.random.default_rng(3)
    rows, scale = _pool(rng, 6, small_cfg().img_feature_channel)
    calls = []

    def fetch(ids):
        calls.append(list(ids))
        return rows[ids], scale[ids]

    port, cache, ref, ref_cache, cfg = _engines(monkeypatch, 6, fetch)
    ids = np.array([0, 1, 1, 4, 0])
    ques = _ques(rng, cfg, 5)
    by_id = port.predict_batch_by_id(ids, ques)
    _bit_equal(by_id, port.predict_batch(rows[ids], ques,
                                         feature_scale=scale[ids]))
    _assert_same(by_id, ref.predict_batch_by_id(ids, ques))
    # one fetch per engine, of the distinct missing ids only
    assert calls == [[0, 1, 4], [0, 1, 4]]
    assert (cache.misses, cache.hits) == (ref_cache.misses,
                                          ref_cache.hits) == (3, 2)
    # again: all hits, no fetch, the same answers
    _bit_equal(port.predict_batch_by_id(ids, ques), by_id)
    assert calls == [[0, 1, 4], [0, 1, 4]] and cache.hits == 7


def test_lru_eviction_and_refetch():
    """tests/test_serve.py's sequence: eviction by last use, then a refetch
    whose answers still equal the per-request feed's."""
    rng = np.random.default_rng(4)
    cfg = fam.small_cfg("iBOWIMG")
    rows, scale = _pool(rng, 5, cfg.img_feature_channel)
    fetched = []

    def fetch(ids):
        fetched.extend(ids)
        return rows[ids], scale[ids]

    engine, cache, _ = _ibowimg_engine(2, fetch)
    ques = _ques(rng, cfg, 1)
    for image_id in (0, 1, 0):  # bank {0, 1}; 0 used last
        engine.predict_batch_by_id([image_id], ques)
    engine.predict_batch_by_id([2], ques)  # evicts 1
    assert cache.evictions == 1
    got = engine.predict_batch_by_id([1], ques)  # refetch 1, evicts 0
    assert fetched == [0, 1, 2, 1] and cache.evictions == 2
    _bit_equal(got, engine.predict_batch(rows[[1]], ques,
                                         feature_scale=scale[[1]]))


@pytest.mark.parametrize("capacity", [3, 8])
def test_slots_and_counters_equal_the_jax_cache(capacity):
    """The same id sequence through both caches (the eviction regime at
    capacity 3 over 12 images, and a warm bank at 8 over 8): the same slot
    array from every ``ensure`` and the same counters after it."""
    rng = np.random.default_rng(capacity)
    cfg = fam.small_cfg("iBOWIMG")
    rows, scale = _pool(rng, 12, cfg.img_feature_channel)

    def fetch(ids):
        return rows[ids], scale[ids]

    port = DeviceFeatureCache(port_config(cfg), capacity, num_regions=196,
                              device="cpu")
    ref = JaxCache(cfg, capacity, num_regions=196)
    for step in range(40):
        ids = rng.integers(0, 12 if capacity == 3 else 8,
                           rng.integers(1, capacity + 1))
        np.testing.assert_array_equal(port.ensure(ids, fetch),
                                      ref.ensure(ids, fetch))
        assert (port.hits, port.misses, port.evictions) == (
            ref.hits, ref.misses, ref.evictions), step
        if step == 19:
            assert port.misses > 0 and port.hits > 0
            assert (port.evictions > 0) == (capacity == 3)
            port.reset_stats()
            ref.reset_stats()
    # the banks hold the same bytes in the same slots
    np.testing.assert_array_equal(port.rows.numpy(), np.asarray(ref.rows))
    np.testing.assert_array_equal(port.scale.numpy(),
                                  np.asarray(ref.scale, np.float16))


def test_stream_matches_batch():
    rng = np.random.default_rng(5)
    cfg = fam.small_cfg("iBOWIMG")
    rows, scale = _pool(rng, 12, cfg.img_feature_channel)
    # capacity 6 over 12 images: the stream evicts slots between batches
    engine, cache, _ = _ibowimg_engine(
        6, lambda ids: (rows[ids], scale[ids]))
    reqs = [(rng.integers(0, 12, 6 if i % 2 else 3), _ques(rng, cfg, 6))
            for i in range(4)]
    reqs = [(ids, q[:len(ids)]) for ids, q in reqs]
    direct = [engine.predict_batch(rows[i], q, feature_scale=scale[i])
              for i, q in reqs]
    streamed = list(engine.predict_stream_by_id(
        (i, q, None) for i, q in reqs))
    assert [len(s) for s in streamed] == [len(i) for i, _ in reqs]
    for want, got in zip(direct, streamed):
        _bit_equal(got, want)
    assert cache.evictions > 0


def test_float16_engine_is_refused():
    cfg = fam.small_cfg("iBOWIMG")
    engine = InferenceEngine(port_config(cfg), fam.params_for(cfg),
                             batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        engine.attach_feature_cache(4, fetch=lambda ids: None)
    with pytest.raises(RuntimeError, match="attach_feature_cache"):
        engine.predict_batch_by_id([0], np.ones((1, 7), np.int32))


def test_a_batch_over_the_capacity_is_refused():
    rng = np.random.default_rng(6)
    cfg = fam.small_cfg("iBOWIMG")
    rows, scale = _pool(rng, 4, cfg.img_feature_channel)
    engine, cache, _ = _ibowimg_engine(2, lambda i: (rows[i], scale[i]))
    ques = _ques(rng, cfg, 3)
    with pytest.raises(ValueError, match="distinct images"):
        engine.predict_batch_by_id([0, 1, 2], ques)
    assert (cache.hits, cache.misses) == (0, 0)
    # repeats of two ids fit
    assert len(engine.predict_batch_by_id([0, 1, 0], ques)) == 3
    # split over two devices (JAX's mesh=, once ROADMAP item 10b's
    # refusal): the capacity rounds up to an even count, and the same
    # capacity check holds
    split = DeviceFeatureCache(port_config(cfg), 3, devices=["cpu"] * 2)
    assert split.capacity == 4 and len(split.blocks) == 2
    with pytest.raises(ValueError, match="distinct images"):
        split.ensure(range(5), lambda i: (rows[i], scale[i]))
    with pytest.raises(ValueError, match="capacity"):
        DeviceFeatureCache(port_config(cfg), 0, device="cpu")


def test_one_upload_per_batch_of_misses():
    rng = np.random.default_rng(7)
    cfg = fam.small_cfg("iBOWIMG")
    rows, scale = _pool(rng, 8, cfg.img_feature_channel)
    engine, cache, _ = _ibowimg_engine(8, lambda i: (rows[i], scale[i]))
    calls = []
    upload = cache._upload
    cache._upload = lambda r, s, slots: (calls.append(r.shape),
                                         upload(r, s, slots))
    ques = _ques(rng, cfg, 5)
    c = cfg.img_feature_channel
    got = engine.predict_batch_by_id([0, 5, 2, 2, 7], ques)  # 4 distinct
    assert calls == [(4, 196, c)]
    calls.clear()
    engine.predict_batch_by_id([1, 3, 4], ques[:3])  # JAX: chunks 2 + 1
    assert calls == [(3, 196, c)] and cache.uploads == 2
    calls.clear()
    engine.predict_batch_by_id([1, 3, 4], ques[:3])  # all hits
    assert calls == [] and cache.uploads == 2
    ids = [0, 5, 2, 2, 7]
    _bit_equal(got, engine.predict_batch(rows[ids], ques,
                                         feature_scale=scale[ids]))


def test_jax_pool_bytes_cross_unchanged():
    """The bank stores what the store's ``gather_quantized`` gives, as JAX's
    does: the f16 scales bit for bit (no f32 round trip)."""
    rng = np.random.default_rng(8)
    cfg = fam.small_cfg("iBOWIMG")
    rows, scale = _pool(rng, 3, cfg.img_feature_channel)
    port = DeviceFeatureCache(port_config(cfg), 3, num_regions=196,
                              device="cpu")
    ref = JaxCache(cfg, 3, num_regions=196)
    fetch = lambda ids: (rows[ids], scale[ids])  # noqa: E731
    np.testing.assert_array_equal(port.ensure([2, 0], fetch),
                                  ref.ensure([2, 0], fetch))
    assert port.scale.dtype.itemsize == 2
    np.testing.assert_array_equal(
        port.scale.numpy().view(np.uint16),
        np.asarray(ref.scale).astype(jnp.float16).view(np.uint16))
