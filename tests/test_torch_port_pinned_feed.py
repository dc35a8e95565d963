"""The host feed's page-locked gathers and their copies without a wait
(``data/feature_store.host_empty``, ``data/native.py``'s ``out=``,
``serve._host_tensor`` and ``InferenceEngine._to_device``).

On the CPU:

- the native f16 gathers write into a given ``out`` the bits they return
  from their own, and refuse an ``out`` of another shape or dtype;
- in a process that has not initialised CUDA a store's gather returns a
  plain ``ndarray``, as before; where CUDA is initialised, the f16 routes
  (and ``CombinedFeatureStore``'s output) come from torch's host allocator
  and the quantized gathers do not;
- ``_host_tensor`` maps an array on a torch tensor's memory, a shard's
  offset slice too, back to a tensor on the owner's storage at its offset;
- a traced run on the CPU counts no ``serve.h2d_pinned_bytes``.

On the card (skipped here): hieCoAtten's and mhb_coAtt's answers from
page-locked gathers bit-equal to the same batches as pageable copies; a
block whose copy is still queued behind a long kernel is not handed to the
next gather; the counter holds each whole batch's feature bytes. Run them
there with ``python -m pytest tests/test_torch_port_pinned_feed.py -q
--noconftest``.

This file imports neither JAX nor the JAX package.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.data import feature_store as fs
from vqa_attention_networks_tpu_torch.data import native
from vqa_attention_networks_tpu_torch.serve import (
    InferenceEngine,
    _host_tensor,
)
from vqa_attention_networks_tpu_torch.train.solver import init_params
from vqa_attention_networks_tpu_torch.utils import trace

B, T, L, D, IMAGES = 4, 7, 196, 32, 8
SMALL = dict(model_name="mhb_coAtt", q_vocab_size=50, a_vocab_size=16,
             hidden_dim=32, emb_dim=16, img_feature_dim=L,
             img_feature_channel=D, mfb_out=16, max_question_length=T)
GATHERS = {"f16": native.gather_f16, "f16_to_f32": native.gather_f16_to_f32}


@pytest.fixture(autouse=True)
def clean_record():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture
def lib():
    if native.get_lib() is None:
        pytest.skip("native library unavailable (no compiler)")


@pytest.fixture
def store(tmp_path):
    return fs.make_synthetic_feature_store(
        str(tmp_path / "store"), list(range(IMAGES)), num_regions=L,
        channels=D)


def owner_of(a):
    """The object that owns an array's memory."""
    while isinstance(a, np.ndarray):
        a = a.base
    return a


@pytest.fixture
def cuda_initialised(monkeypatch):
    """A CPU stand-in for a process that has initialised CUDA: the host
    allocator's tensors, without page-locking (this build has no CUDA);
    the dtypes asked of it are recorded."""
    asked = []
    empty = torch.empty

    def host_alloc(*shape, pin_memory=False, dtype=None, **kw):
        asked.append((dtype, pin_memory))
        return empty(*shape, dtype=dtype, **kw)

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch, "empty", host_alloc)
    return asked


# ------------------------------------------------------------ native out=

@pytest.mark.parametrize("name", sorted(GATHERS))
def test_native_gather_into_out_gives_the_same_bits(name, lib):
    gather = GATHERS[name]
    rng = np.random.default_rng(0)
    src = rng.standard_normal((10, 4, 8)).astype(np.float16)
    src[0, 0, :3] = [np.inf, -0.0, 6e-8]
    rows = np.array([3, 0, 7, 7, 9], np.int64)
    want = gather(src, rows)
    out = np.full(want.shape, 5, want.dtype)
    got = gather(src, rows, out=out)
    assert got is out
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("wrong", ["shape", "dtype", "strided"])
@pytest.mark.parametrize("name", sorted(GATHERS))
def test_native_gather_refuses_a_wrong_out(name, wrong, lib):
    gather = GATHERS[name]
    src = np.zeros((10, 4, 8), np.float16)
    rows = np.array([1, 2], np.int64)
    dtype = np.float16 if name == "f16" else np.float32
    out = {"shape": np.empty((3, 4, 8), dtype),
           "dtype": np.empty((2, 4, 8),
                             np.float64 if name == "f16" else np.float16),
           "strided": np.empty((2, 4, 16), dtype)[..., ::2]}[wrong]
    with pytest.raises(ValueError):
        gather(src, rows, out=out)


# ------------------------------------------------------------ the stores

@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_gather_without_cuda_is_a_plain_array(store, dtype, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    ids = [5, 0, 5, 3]
    got = store.gather(ids, dtype=dtype)
    assert type(got) is np.ndarray and owner_of(got) is None
    want = np.asarray(store.features[store.rows_for(ids)], dtype=dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_gather_with_cuda_comes_from_the_host_allocator(
        store, dtype, cuda_initialised, lib):
    ids = [5, 0, 5, 3]
    got = store.gather(ids, dtype=dtype)
    owner = owner_of(got)
    assert isinstance(owner, torch.Tensor)
    assert cuda_initialised == [(owner.dtype, True)]
    want = np.asarray(store.features[store.rows_for(ids)], dtype=dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_quantized_gathers_keep_their_own_memory(tmp_path, cuda_initialised):
    q = fs.make_synthetic_feature_store(
        str(tmp_path / "q"), list(range(IMAGES)), num_regions=L, channels=D,
        dtype="int8")
    rows = np.array([1, 4], np.int64)
    feats, scale = q.gather_rows_quantized(rows)
    for got in (feats, scale, q.gather_rows(rows, np.int8),
                q.gather_rows(rows, np.float32)):
        assert not isinstance(owner_of(got), torch.Tensor)
    assert cuda_initialised == []


def test_combined_store_fills_the_same_memory(tmp_path, cuda_initialised,
                                              lib):
    a = fs.make_synthetic_feature_store(str(tmp_path / "a"), [1, 2, 3],
                                        num_regions=L, channels=D, seed=1)
    b = fs.make_synthetic_feature_store(str(tmp_path / "b"), [7, 8],
                                        num_regions=L, channels=D, seed=2)
    both = fs.CombinedFeatureStore([a, b])
    ids = [8, 1, 3, 7]
    got = both.gather(ids, dtype=np.float16)
    assert isinstance(owner_of(got), torch.Tensor)
    want = np.stack([(a if i < 7 else b).gather([i], np.float16)[0]
                     for i in ids])
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ the engine

def test_an_array_on_a_tensor_maps_back_to_its_storage():
    big = torch.arange(9 * 3 * 5, dtype=torch.float32).reshape(9, 3, 5)
    owner = big[1:]  # an owner that starts inside its storage
    arr = owner.numpy()
    shard = arr[2:4]  # as _dispatch's shards slice a batch
    t = _host_tensor(shard)
    assert t.untyped_storage().data_ptr() == big.untyped_storage().data_ptr()
    assert t.storage_offset() == (1 + 2) * 15
    assert t.shape == (2, 3, 5) and t.stride() == (15, 5, 1)
    assert torch.equal(t, owner[2:4])
    whole = _host_tensor(arr.reshape(8, 15))
    assert whole.storage_offset() == 15 and torch.equal(
        whole, owner.reshape(8, 15))
    # an owner of another dtype: the array's own dtype, on the same bytes
    as_u8 = _host_tensor(arr.view(np.uint8)[3])
    assert as_u8.dtype == torch.uint8
    assert as_u8.storage_offset() == (1 + 3) * 15 * 4
    # numpy's own memory, and a strided view (copied): no owner
    plain = np.ones((2, 3), np.float32)
    for a in (plain, arr[:, :, ::2]):
        t = _host_tensor(a)
        assert t.untyped_storage().data_ptr() != \
            big.untyped_storage().data_ptr()
        np.testing.assert_array_equal(t.numpy(), a)


def small_engine():
    cfg = Config(**SMALL).validate()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    return InferenceEngine(cfg, params, batch_size=B, topk=3,
                           input_dtype="float16", device="cpu")


def feed_batches(store, n, seed=2):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (store.gather(rng.integers(0, IMAGES, B).tolist(),
                            dtype=np.float16),
               rng.integers(1, SMALL["q_vocab_size"], (B, T)).astype(
                   np.int32), np.full(B, T, np.int32))


def test_a_traced_cpu_run_counts_no_pinned_bytes(store, cuda_initialised,
                                                 lib):
    engine = small_engine()
    with profile(activities=[ProfilerActivity.CPU]):
        served = [p for batch in engine.predict_stream(
            feed_batches(store, 3)) for p in batch]
    assert len(served) == 3 * B
    counters = trace.counters()
    assert counters["serve.h2d_bytes"] > 0
    assert counters.get("serve.h2d_pinned_bytes", 0) == 0


# ------------------------------------------------------------ the card

CARD_BATCH, CARD_IMAGES = 32, 96


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (page-locked memory and copies "
                    "without a wait have no CPU mode)")
    torch.zeros(1, device="cuda")  # CUDA initialised: gathers pin
    return torch.device("cuda")


@pytest.fixture
def card_store(tmp_path, card):
    return fs.make_synthetic_feature_store(
        str(tmp_path / "card"), list(range(CARD_IMAGES)), seed=5)


def card_items(store, cfg, n, seed=6, last=None):
    """``n`` feed items of CARD_BATCH questions (``last``: the last item's
    count, a partial batch), their grids gathered from ``store``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = last if (last is not None and i == n - 1) else CARD_BATCH
        qlen = rng.integers(1, cfg.max_question_length + 1, k).astype(
            np.int32)
        ques = rng.integers(1, cfg.q_vocab_size,
                            (k, cfg.max_question_length)).astype(np.int32)
        ques[np.arange(cfg.max_question_length)[None, :]
             >= qlen[:, None]] = 0
        feats = store.gather(rng.integers(0, CARD_IMAGES, k).tolist(),
                             dtype=np.float16)
        out.append((feats, ques, qlen))
    return out


@pytest.mark.parametrize("family", ["hieCoAtten", "mhb_coAtt"])
def test_pinned_feed_is_bit_equal_to_the_pageable_feed(card, card_store,
                                                       family):
    cfg = Config(model_name=family).validate()
    params = init_params(cfg, torch.Generator().manual_seed(3))
    engine = InferenceEngine(cfg, params, batch_size=CARD_BATCH, topk=5)
    items = card_items(card_store, cfg, 5, last=CARD_BATCH - 9)
    assert all(owner_of(f).is_pinned() for f, _, _ in items)
    pageable = [(f.copy(), q, l) for f, q, l in items]
    got = [p for b in engine.predict_stream(iter(items)) for p in b]
    want = [p for b in engine.predict_stream(iter(pageable)) for p in b]
    assert len(got) == len(want) == 5 * CARD_BATCH - 9
    for a, b in zip(got, want):
        assert a.answer_id == b.answer_id
        np.testing.assert_array_equal(a.top_ids, b.top_ids)
        np.testing.assert_array_equal(a.top_probs, b.top_probs)


def test_a_block_in_flight_is_not_handed_to_the_next_gather(card,
                                                            card_store):
    engine = types.SimpleNamespace(device=card)
    first = card_store.gather_rows(np.arange(0, 40), np.float16)
    want = first.copy()
    at = first.ctypes.data
    torch.cuda._sleep(2_000_000_000)  # ~1 s of the stream, ahead of the copy
    (on_card,) = InferenceEngine._to_device(engine, [first])
    del first
    second = card_store.gather_rows(np.arange(40, 80), np.float16)
    assert second.ctypes.data != at
    torch.cuda.synchronize()
    np.testing.assert_array_equal(on_card.cpu().numpy(), want)
    assert not np.array_equal(second, want)


def test_the_counter_holds_each_whole_batchs_feature_bytes(card,
                                                           card_store):
    cfg = Config(model_name="hieCoAtten").validate()
    params = init_params(cfg, torch.Generator().manual_seed(3))
    engine = InferenceEngine(cfg, params, batch_size=CARD_BATCH, topk=5)
    items = card_items(card_store, cfg, 4, last=CARD_BATCH - 5)
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in engine.predict_stream(iter(items)):
            pass
    grid = cfg.img_feature_dim * cfg.img_feature_channel * 2
    counters = trace.counters()
    # the partial batch is padded into pageable memory: a blocking copy
    assert counters["serve.h2d_pinned_bytes"] == 3 * CARD_BATCH * grid
    assert counters["serve.h2d_bytes"] > counters["serve.h2d_pinned_bytes"]
