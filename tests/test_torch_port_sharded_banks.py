"""The port's sharded feature banks: the training bank split over the data
ranks with its ring lookup (``train/feature_bank.py``, JAX
``train/solver.py:369-534``) and the serving cache split over the split
engine's replicas (``serve.DeviceFeatureCache(devices=...)``,
``aot.serving_forward_banked_sharded``, JAX ``serve.py:51-110`` and
``aot.py:122-185``).

- Training (4 gloo CPU ranks, one spawn): iBOWIMG on a 6-image store,
  which 4 does not divide (the zero-row padding), from the host feed, the
  replicated bank and the sharded bank, f16 and int8 stores: the losses
  and the full evaluation bit-equal (JAX ``test_device_bank_train.py:
  110``); each rank holds 2 of the 8 padded rows. The budget counts a
  rank's rows and names the sharded bank where it would fit.
- Serving: JAX's four ``tests/test_serve_sharded_cache.py`` cases against
  the split engine at N = 2 and 4 replicas on the CPU. By id the answers
  are bit-equal to one replica's cache and to the per-request int8 feed,
  and equal to JAX's sharded engine's at ``OTHER_PROB_ATOL``; the slots,
  hits, misses and evictions are JAX's; capacity rounds up to a multiple
  of N; a miss writes its owner's block alone.
"""

import jax
import numpy as np
import pytest

import test_torch_port_families as fam
from test_torch_port_mhb_coatt import port_config
from test_torch_port_parallel import cfg_fields
from test_torch_port_parallel_ranks import result, run_ranks
from test_torch_port_serve import OTHER_PROB_ATOL, _assert_same
from vqa_attention_networks_tpu.data.feature_store import quantize_features
from vqa_attention_networks_tpu.serve import InferenceEngine as JaxEngine
from vqa_attention_networks_tpu_torch.data import feature_store as port_store
from vqa_attention_networks_tpu_torch.data import prepare as port_prepare
from vqa_attention_networks_tpu_torch.serve import (
    DeviceFeatureCache,
    InferenceEngine,
)

WORLD = 4
FEEDS = ("host", "replicated", "sharded")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_bank")
    qa = port_prepare.make_synthetic_qa_data(np.random.default_rng(0),
                                             n_train=48, n_val=24,
                                             num_images=6, max_len=7)
    port_prepare.save_qa_data(qa, str(root / "qa"))
    f16 = str(root / "feat")
    port_store.make_synthetic_feature_store(
        f16, sorted(set(qa.train.image_ids) | set(qa.val.image_ids)),
        channels=32)
    int8 = str(root / "feat_q")
    port_store.quantize_store(f16, int8)
    out = root / "out"
    out.mkdir()
    base = cfg_fields(qa, model_name="iBOWIMG", embed_size=16)
    feeds = {"host": {}, "replicated": dict(device_feature_bank=True),
             "sharded": dict(device_feature_bank=True,
                             device_feature_bank_shard=True)}
    cases = [dict(name=f"{feed}_{kind}", cfg=dict(base, **kw), train=True,
                  val="full", store=store)
             for kind, store in (("f16", f16), ("int8", int8))
             for feed, kw in feeds.items()]
    run_ranks(dict(qa=str(root / "qa"), store=f16, out=str(out),
                   cases=cases), WORLD, root)
    return dict(root=root, out=str(out), qa=qa, f16=f16)


@pytest.mark.parametrize("kind", ["f16", "int8"])
def test_sharded_bank_bit_identical_to_host_and_replicated(trained, kind):
    runs = {feed: [result(trained["out"], f"{feed}_{kind}", r)
                   for r in range(WORLD)] for feed in FEEDS}
    for r in range(WORLD):
        host = runs["host"][r]
        for feed in ("replicated", "sharded"):
            got = runs[feed][r]
            np.testing.assert_array_equal(got["losses"], host["losses"])
            np.testing.assert_array_equal(got["val"], host["val"])
            for key in (k for k in host if k.startswith("p/")):
                np.testing.assert_array_equal(got[key], host[key])
        # 6 images pad to 8 rows, 2 a rank
        assert runs["sharded"][r]["bank_bytes"] * 3 == \
            runs["replicated"][r]["bank_bytes"]
    assert len(runs["host"][0]["losses"]) == 3


def test_the_budget_counts_a_ranks_rows(trained):
    """The budget check: the whole store on one device names the sharded
    bank, which would fit; a rank's block is what a sharded bank counts."""
    from vqa_attention_networks_tpu_torch.train.feature_bank import (
        FeatureBank,
    )
    import torch

    store = port_store.FeatureStore(trained["f16"])
    row = 196 * 32 * 2
    with pytest.raises(ValueError, match="device_feature_bank_shard"):
        FeatureBank(store, torch.float16, 5 * row, torch.device("cpu"),
                    data_size=4)
    bank = FeatureBank(store, torch.float16, 2 * row, torch.device("cpu"),
                       shard=(1, 4))
    assert bank.rows.shape[0] == 2 and bank.nbytes == 2 * row
    with pytest.raises(ValueError, match="sharded 4-way"):
        FeatureBank(store, torch.float16, row, torch.device("cpu"),
                    shard=(1, 4))


# --------------------------------------------------------------------------
# serving: JAX's tests/test_serve_sharded_cache.py against the split engine
# --------------------------------------------------------------------------

def _cfg():
    return fam.small_cfg("iBOWIMG", q_vocab_size=30, a_vocab_size=12)


def _engines(n, batch_size=8):
    cfg = _cfg()
    params = fam.params_for(cfg, seed=0)
    port = port_config(cfg)
    single = InferenceEngine(port, params, batch_size=batch_size, topk=3,
                             input_dtype="int8", device="cpu")
    sharded = InferenceEngine(port, params, batch_size=batch_size, topk=3,
                              input_dtype="int8", data_parallel=n,
                              device="cpu")
    ref = JaxEngine(cfg, params, batch_size=batch_size, topk=3,
                    input_dtype="int8", data_parallel=jax.device_count())
    return single, sharded, ref, cfg


def _quantized_pool(rng, n_images, cfg):
    feats = rng.standard_normal(
        (n_images, 196, cfg.img_feature_channel)).astype(np.float32)
    rows, scale, _ = quantize_features(feats)
    return rows, scale.astype(np.float16)


def _bit_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.answer_id == b.answer_id
        np.testing.assert_array_equal(a.top_ids, b.top_ids)
        np.testing.assert_array_equal(a.top_probs, b.top_probs)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_bank_matches_single_device_bank_and_direct_feed(n):
    single, sharded, ref, cfg = _engines(n)
    rng = np.random.default_rng(11)
    rows, scale = _quantized_pool(rng, 16, cfg)

    def fetch(ids):
        return rows[ids], scale[ids]

    single.attach_feature_cache(capacity=16, fetch=fetch)
    bank = sharded.attach_feature_cache(capacity=16, fetch=fetch)
    ref.attach_feature_cache(capacity=16, fetch=fetch)
    assert bank.capacity == 16
    # one block of 16 / n slots on each replica's device
    assert [b.shape[0] for b in bank.blocks] == [16 // n] * n

    ids = np.array([0, 3, 3, 9, 15, 0, 7, 12], dtype=np.int64)
    ques = rng.integers(0, cfg.q_vocab_size, size=(8, 7)).astype(np.int32)
    a = single.predict_batch_by_id(ids, ques)
    b = sharded.predict_batch_by_id(ids, ques)
    direct = sharded.predict_batch(rows[ids], ques, feature_scale=scale[ids])
    _bit_equal(b, a)
    _bit_equal(b, direct)
    _assert_same(b, ref.predict_batch_by_id(ids, ques), atol=OTHER_PROB_ATOL)

    b2 = sharded.predict_batch_by_id(ids, ques)
    assert sharded._cache.misses == 6 and sharded._cache.hits == 10
    assert (ref._cache.misses, ref._cache.hits) == (6, 2)
    _bit_equal(b2, b)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_bank_eviction_parity_and_stats(n):
    _, sharded, ref, cfg = _engines(n)
    rng = np.random.default_rng(12)
    rows, scale = _quantized_pool(rng, 24, cfg)
    fetched, fetched_ref = [], []

    def fetch(ids, into=fetched):
        into.extend(int(i) for i in ids)
        return rows[ids], scale[ids]

    bank = sharded.attach_feature_cache(capacity=8, fetch=fetch)
    ref_bank = ref.attach_feature_cache(
        capacity=8, fetch=lambda ids: fetch(ids, fetched_ref))
    ques = rng.integers(0, cfg.q_vocab_size, size=(8, 7)).astype(np.int32)
    writes = []
    upload = bank._upload
    bank._upload = lambda r, s, slots: (writes.append(np.asarray(slots)),
                                        upload(r, s, slots))
    for lo in (0, 8, 16, 4):  # 3 disjoint batches then a re-visit
        ids = np.arange(lo, lo + 8, dtype=np.int64)
        preds = sharded.predict_batch_by_id(ids, ques)
        _bit_equal(preds, sharded.predict_batch(rows[ids], ques,
                                                feature_scale=scale[ids]))
        _assert_same(preds, ref.predict_batch_by_id(ids, ques),
                     atol=OTHER_PROB_ATOL)
        assert dict(bank._slot) == dict(ref_bank._slot)
    assert bank.evictions == ref_bank.evictions == 24
    assert fetched == fetched_ref == list(range(24)) + list(range(4, 12))
    assert all(len(w) for w in writes)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_bank_capacity_rounds_up_to_mesh_multiple(n):
    _, sharded, _, cfg = _engines(n)
    rng = np.random.default_rng(13)
    rows, scale = _quantized_pool(rng, 8, cfg)
    bank = sharded.attach_feature_cache(
        capacity=5, fetch=lambda ids: (rows[ids], scale[ids]))
    assert bank.capacity == -(-5 // n) * n  # 5 -> 6 at N = 2, 8 at N = 4
    ques = rng.integers(0, cfg.q_vocab_size, size=(8, 7)).astype(np.int32)
    ids = np.arange(bank.capacity, dtype=np.int64)
    preds = sharded.predict_batch_by_id(ids, ques[:len(ids)])
    _bit_equal(preds, sharded.predict_batch(
        rows[ids], ques[:len(ids)], feature_scale=scale[ids]))
    # a miss writes its owner's block alone: each slot's row is on the
    # replica holding its block
    per = bank.capacity // n
    for i in ids:
        slot = bank._slot[int(i)]
        np.testing.assert_array_equal(
            bank.blocks[slot // per][slot % per].numpy(), rows[i])
    with pytest.raises(ValueError, match="capacity"):
        DeviceFeatureCache(port_config(cfg), 0, devices=["cpu"] * n)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_bank_stream_matches_batch(n):
    _, sharded, _, cfg = _engines(n)
    rng = np.random.default_rng(14)
    rows, scale = _quantized_pool(rng, 12, cfg)
    sharded.attach_feature_cache(
        capacity=8, fetch=lambda ids: (rows[ids], scale[ids]))
    reqs = []
    for _ in range(3):
        ids = rng.integers(0, 12, size=(8,))
        ques = rng.integers(0, cfg.q_vocab_size,
                            size=(8, 7)).astype(np.int32)
        reqs.append((ids, ques))
    direct = [sharded.predict_batch_by_id(i, q) for i, q in reqs]
    streamed = list(sharded.predict_stream_by_id(
        (i, q, None) for i, q in reqs))
    for batch_a, batch_b in zip(direct, streamed):
        _bit_equal(batch_b, batch_a)
