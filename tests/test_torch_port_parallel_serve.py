"""The port's split-batch engine (``serve.InferenceEngine(data_parallel=N)``)
and the data-parallel dry run (``parallel/dryrun.py``), on the CPU.

- ``data_parallel=2`` and ``4`` with an explicit device list (N replicas on
  the CPU, the counterpart of JAX's emulated devices) answer as the
  one-replica engine does, bit for bit: full and partial batches, the f16
  and the int8 feed, iBOWIMG (JAX ``tests/test_serve.py:68-134``) and
  bf16 ``mhb_coAtt`` (K1's plain version on the CPU); and iBOWIMG as the
  JAX engine's 8-way data-parallel one does (its answers and top-k ids).
- JAX's validation errors: a batch that does not split, fewer devices than
  replicas, an artifact; the device feature cache under N > 1 is split
  over the replicas (item 10b; ``test_torch_port_sharded_banks.py``).
- ``cli.serve --data_parallel 8`` answers as the single-device service
  (JAX ``tests/test_serve_http.py:564``): ``test_torch_port_serve_http.py::
  test_data_parallel_is_refused``, named for what it checked before.
- The dry run over 2 and 4 gloo ranks: every rank holds the same step.
"""

import jax
import numpy as np
import pytest

from test_torch_port_mhb_coatt import params_for, port_config, small_cfg
from vqa_attention_networks_tpu.config import Config
from vqa_attention_networks_tpu.models import get_model
from vqa_attention_networks_tpu.serve import InferenceEngine as JaxEngine
from vqa_attention_networks_tpu_torch.parallel.dryrun import (
    MODELS,
    dryrun_data_parallel,
)
from vqa_attention_networks_tpu_torch.serve import InferenceEngine

IBOWIMG = dict(model_name="iBOWIMG", q_vocab_size=30, a_vocab_size=12,
               hidden_dim=16, emb_dim=8, embed_size=16,
               img_feature_channel=32, max_question_length=7)


def _ibowimg():
    cfg = Config(**IBOWIMG)
    params = jax.tree_util.tree_map(
        np.asarray, get_model("iBOWIMG").init(jax.random.PRNGKey(0), cfg))
    return cfg, params


def _requests(rng, n, cfg, int8=False):
    ques = rng.integers(0, cfg.q_vocab_size,
                        (n, cfg.max_question_length)).astype(np.int32)
    if int8:
        img = rng.integers(-127, 128, (n, 196, cfg.img_feature_channel),
                           dtype=np.int8)
        scale = (np.abs(rng.standard_normal((n, cfg.img_feature_channel)))
                 * 0.01 + 1e-3).astype(np.float16)
        return img, ques, scale
    img = rng.standard_normal(
        (n, 196, cfg.img_feature_channel)).astype(np.float32)
    return img, ques, None


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.answer_id == y.answer_id
        np.testing.assert_array_equal(x.top_ids, y.top_ids)
        np.testing.assert_array_equal(x.top_probs, y.top_probs)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("feed", ["float16", "int8"])
def test_split_engine_answers_as_one_replica(n, feed):
    cfg, params = _ibowimg()
    int8 = feed == "int8"
    one = InferenceEngine(port_config(cfg), params, batch_size=8, topk=3,
                          input_dtype=feed, device="cpu")
    split = InferenceEngine(port_config(cfg), params, batch_size=8, topk=3,
                            input_dtype=feed, data_parallel=n,
                            device=["cpu"] * n)
    assert len(split.models) == n
    img, ques, scale = _requests(np.random.default_rng(7), 8, cfg, int8)
    for rows in (8, 3):  # a partial batch rides the pad path
        s = None if scale is None else scale[:rows]
        _same(split.predict_batch(img[:rows], ques[:rows], feature_scale=s),
              one.predict_batch(img[:rows], ques[:rows], feature_scale=s))
    jax_one = JaxEngine(cfg, params, batch_size=8, topk=3, input_dtype=feed,
                        data_parallel=8)
    want = jax_one.predict_batch(img, ques, feature_scale=scale)
    got = split.predict_batch(img, ques, feature_scale=scale)
    for x, y in zip(got, want):
        assert x.answer_id == y.answer_id
        np.testing.assert_array_equal(x.top_ids, y.top_ids)


def test_split_engine_runs_k1_on_each_replica():
    """bf16 mhb_coAtt: each replica runs the K1 path (its plain version on
    the CPU, from its own layout) on its shard; the answers are the
    one-replica engine's, streamed or not."""
    cfg = small_cfg()
    params = params_for(cfg)
    one = InferenceEngine(port_config(cfg), params, batch_size=4, topk=3,
                          device="cpu")
    split = InferenceEngine(port_config(cfg), params, batch_size=4, topk=3,
                            data_parallel=2, device=["cpu", "cpu"])
    rng = np.random.default_rng(3)
    batches = [_requests(rng, rows, cfg)[:2] for rows in (4, 4, 1)]
    got = list(split.predict_stream((i, q, None) for i, q in batches))
    want = list(one.predict_stream((i, q, None) for i, q in batches))
    for a, b in zip(got, want):
        _same(a, b)
    layouts = [m.stage1_w3 for m in split.models]
    assert layouts[0] is not layouts[1]


def test_split_engine_validation():
    cfg, params = _ibowimg()
    port = port_config(cfg)
    with pytest.raises(ValueError, match="not divisible"):
        InferenceEngine(port, params, batch_size=8, data_parallel=3,
                        device="cpu")
    with pytest.raises(ValueError, match="only 2 device"):
        InferenceEngine(port, params, batch_size=8, data_parallel=4,
                        device=["cpu", "cpu"])
    with pytest.raises(ValueError, match="artifact"):
        InferenceEngine(port, params, batch_size=8, data_parallel=2,
                        artifact_dir="/nonexistent", device="cpu")
    engine = InferenceEngine(port, params, batch_size=8, data_parallel=2,
                             input_dtype="int8", device="cpu")
    # the device cache under data_parallel=2 is JAX's sharded bank (ROADMAP
    # item 10b, refused until it was ported): split over the 2 replicas
    bank = engine.attach_feature_cache(5, lambda ids: None)
    assert bank.capacity == 6 and [b.shape[0] for b in bank.blocks] == [3, 3]


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_over_cpu_ranks(n):
    results = dryrun_data_parallel(n, timeout=180.0)
    assert len(results) == n
    for name in MODELS:
        assert all(r[name] == results[0][name] for r in results)
        assert np.isfinite(results[0][name]["loss"])
