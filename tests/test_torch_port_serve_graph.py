"""Serving by id from a CUDA graph (``serve.BankGraph``,
``InferenceEngine._replay_by_id``).

On the CPU:

- an engine on the CPU, and a split engine, serve by id eagerly and count
  no capture and no replay;
- the engine's graph path, with a stand-in for the graph that runs the
  banked forward eagerly, counts ``serve.graph_captures`` and
  ``serve.graph_replays`` only while a profiler records, and serves the
  eager engine's answers;
- ``_collect`` gives the same ``Prediction``s from an event-backed host
  handle as from a handle of tensors still to be copied;
- the graph goes stale when the question length, any of the kernels'
  route switches or a parameter of K1's layout changes, and only then.

On the card (skipped here): for mhb_coAtt and hieCoAtten at full width,
the graph's top-k is bit-equal to ``aot.serving_forward_banked`` called
eagerly on the same bank and inputs, over full batches, a partial one,
batches with misses, two batches in flight through
``predict_stream_by_id``, and a parameter written in place (mhb_coAtt
captures again; hieCoAtten reads it in place). Every family, mcan too,
captures and agrees. Run them there with ``python -m pytest
tests/test_torch_port_serve_graph.py -q --noconftest``.

This file imports neither JAX nor the JAX package.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vqa_attention_networks_tpu_torch import aot
from vqa_attention_networks_tpu_torch.config import PORT_MODEL_NAMES, Config
from vqa_attention_networks_tpu_torch.data.feature_store import (
    quantize_features,
)
from vqa_attention_networks_tpu_torch.ops import ROUTE_SWITCHES
from vqa_attention_networks_tpu_torch.serve import (
    BankGraph,
    InferenceEngine,
    TopK,
)
from vqa_attention_networks_tpu_torch.train.solver import init_params
from vqa_attention_networks_tpu_torch.utils import trace

B, T, L, D, IMAGES = 4, 7, 196, 32, 8
SMALL = dict(model_name="mhb_coAtt", q_vocab_size=50, a_vocab_size=16,
             hidden_dim=32, emb_dim=16, img_feature_dim=L,
             img_feature_channel=D, mfb_out=16, max_question_length=T)
GRAPH_COUNTERS = ("serve.graph_captures", "serve.graph_replays")
ROOT = Path(__file__).resolve().parents[1]


def replay_share(run=None):
    """The benchmark's ``graph_replay_share.serve`` over what the trace
    module holds."""
    from port_bench.harness import load_module

    return load_module(ROOT / "port_bench" / "metrics"
                       / "graph_replay_share.serve.py",
                       "graph_replay_share").read(run)


@pytest.fixture(autouse=True)
def clean_record():
    trace.reset()
    yield
    trace.reset()


def int8_pool(images, channels, seed=1):
    feats = np.random.default_rng(seed).standard_normal(
        (images, L, channels)).astype(np.float32)
    rows, scale, _ = quantize_features(feats * 0.5)
    return rows, scale.astype(np.float16)


def fetch_from(rows, scale):
    return lambda ids: (rows[ids], scale[ids])


def batches(n, images, vocab, seq_len, batch, seed=2, sizes=None):
    """``n`` by-id items of ``batch`` questions (``sizes``: each item's
    count), each question of 1 to ``seq_len`` tokens."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = batch if sizes is None else sizes[i]
        qlen = rng.integers(1, seq_len + 1, k).astype(np.int32)
        ques = rng.integers(1, vocab, (k, seq_len)).astype(np.int32)
        ques[np.arange(seq_len)[None, :] >= qlen[:, None]] = 0
        out.append((rng.integers(0, images, k).tolist(), ques, qlen))
    return out


def small_engine(**kw):
    cfg = Config(**SMALL).validate()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    engine = InferenceEngine(cfg, params, batch_size=B, topk=3,
                             input_dtype="int8", device="cpu", **kw)
    engine.attach_feature_cache(IMAGES, fetch_from(*int8_pool(IMAGES, D)))
    return engine


def served(engine, items):
    return [p for batch in engine.predict_stream_by_id(iter(items))
            for p in batch]


def assert_bit_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.answer_id == b.answer_id
        np.testing.assert_array_equal(a.top_ids, b.top_ids)
        np.testing.assert_array_equal(a.top_probs, b.top_probs)


class Event:
    """A stand-in for ``torch.cuda.Event``: counts its waits."""

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


class EagerGraph(BankGraph):
    """``BankGraph`` on the CPU: "capture" keeps the static buffers,
    "load" copies into them without pinned memory, and "replay" runs the
    banked forward on them eagerly, its top-k copied out behind a
    stand-in event."""

    def capture(self, seq_len):
        b = self.batch_size
        self.inputs = (torch.zeros(b, dtype=torch.int64),
                       torch.zeros((b, seq_len), dtype=torch.int32),
                       torch.ones(b, dtype=torch.int32))
        self._graph = object()
        self._key = self._state(seq_len)
        self.captures += 1

    def load(self, host):
        for dst, t in zip(self.inputs, host):
            dst.copy_(t)

    def replay(self):
        top_i, top_p = self._forward()
        self.replays += 1
        self.events.append(Event())
        return TopK(top_i.clone(), top_p.clone(), self.events[-1])


def eager_graph(engine):
    graph = EagerGraph(engine._fwd_bank, engine.model, engine._cache,
                       engine.batch_size)
    graph.events = []
    engine._graph = graph
    return graph


@pytest.mark.parametrize("split", [1, 2])
def test_cpu_and_split_engines_serve_eagerly(split):
    engine = small_engine(data_parallel=split)
    assert engine._graph is None
    items = batches(3, IMAGES, SMALL["q_vocab_size"], T, B)
    with profile(activities=[ProfilerActivity.CPU]):
        got = served(engine, items)
    assert len(got) == 3 * B
    assert not set(GRAPH_COUNTERS) & set(trace.counters())
    assert sum(s.name == "serve.launch" for s in trace.spans()) == 3
    assert replay_share() is None


def test_graph_counters_record_only_while_profiling():
    items = batches(3, IMAGES, SMALL["q_vocab_size"], T, B,
                    sizes=[B, B, B - 1])
    want = served(small_engine(), items)
    engine = small_engine()
    graph = eager_graph(engine)
    assert_bit_equal(served(engine, items), want)
    assert (graph.captures, graph.replays) == (1, 3)
    assert trace.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        got = served(engine, items)
    assert_bit_equal(got, want)
    assert (graph.captures, graph.replays) == (1, 6)
    counters = trace.counters()
    assert counters["serve.graph_replays"] == 3
    assert "serve.graph_captures" not in counters
    # every batch collected after a wait on its own event
    assert [e.waits for e in graph.events] == [1] * 6
    names = [s.name for s in trace.spans()]
    assert names.count("serve.launch") == names.count("serve.h2d") == 3
    assert replay_share() == 100.0
    # a recapture under the profiler counts
    graph._key = None
    with profile(activities=[ProfilerActivity.CPU]):
        served(engine, items[:1])
    assert trace.counters()["serve.graph_captures"] == 1
    assert graph.captures == 2


@pytest.mark.parametrize("n", [B, B - 3])
def test_collect_reads_an_event_backed_handle(n):
    engine = small_engine()
    rng = np.random.default_rng(5)
    top_i = torch.from_numpy(rng.integers(0, 16, (B, 3)))
    top_p = torch.from_numpy(rng.random((B, 3)).astype(np.float32))
    want = engine._collect([TopK(top_i, top_p)], n)
    event = Event()
    got = engine._collect([TopK(top_i.clone(), top_p.clone(), event)], n)
    assert event.waits == 1 and len(got) == n
    assert_bit_equal(got, want)


@pytest.mark.parametrize("change", ["question_length", *ROUTE_SWITCHES,
                                    "stage1_parameter", "other_parameter"])
def test_the_graph_goes_stale_when_it_would_read_old_state(change,
                                                           monkeypatch):
    engine = small_engine()
    graph = eager_graph(engine)
    assert graph.stale(T)
    graph.capture(T)
    assert not graph.stale(T)
    if change == "question_length":
        assert graph.stale(T + 1)
        return
    if change in ROUTE_SWITCHES:
        monkeypatch.setenv(change, "1")
    else:
        layer = (engine.model.img_conv1d if change == "stage1_parameter"
                 else engine.model.linear_pred)
        with torch.no_grad():
            layer.weight.mul_(2.0)
    # a graph reads every other parameter in place: no new capture
    assert graph.stale(T) == (change != "other_parameter")


# ---------------------------------------------------------------- the card

CARD_BATCH, CARD_IMAGES, CARD_TOPK = 32, 96, 5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


def card_engine(family):
    """``family`` at the port's full widths, the bank of CARD_IMAGES
    images empty, on the card."""
    cfg = Config(model_name=family).validate()
    params = init_params(cfg, torch.Generator().manual_seed(3))
    engine = InferenceEngine(cfg, params, batch_size=CARD_BATCH,
                             topk=CARD_TOPK, input_dtype="int8")
    pool = int8_pool(CARD_IMAGES, cfg.img_feature_channel, seed=4)
    engine.attach_feature_cache(CARD_IMAGES, fetch_from(*pool))
    return engine


def eager_answers(engine, items):
    """``aot.serving_forward_banked`` called eagerly on the engine's bank,
    model and padded inputs (every id of ``items`` already banked, none
    evicted)."""
    fwd = aot.serving_forward_banked(engine.cfg, engine.topk)
    cache = engine._cache
    out = []
    for ids, ques, qlen in items:
        idx, n = engine._pad(np.array([cache._slot[int(i)] for i in ids],
                                      np.int64))
        args = engine._to_device([idx, *engine._question_args(ques, qlen)])
        with torch.inference_mode():
            top_i, top_p = fwd(engine.model, cache.rows, cache.scale, *args)
        out.append(engine._collect([TopK(top_i, top_p)], n))
    return out


@pytest.mark.parametrize("family", ["mhb_coAtt", "hieCoAtten"])
def test_graph_is_bit_equal_to_the_eager_banked_forward(card, family):
    engine = card_engine(family)
    graph = engine._graph
    cfg = engine.cfg
    t = cfg.max_question_length
    # the first batches bank half the images, the later ones miss the rest
    first = batches(3, CARD_IMAGES // 2, cfg.q_vocab_size, t, CARD_BATCH,
                    seed=6)
    later = [([i + CARD_IMAGES // 2 for i in ids], q, l) for ids, q, l in
             batches(2, CARD_IMAGES // 2, cfg.q_vocab_size, t, CARD_BATCH,
                     seed=7, sizes=[CARD_BATCH, CARD_BATCH - 11])]
    items = first + later
    uploads = []
    got = []
    for preds in engine.predict_stream_by_id(iter(items)):
        got.append(preds)
        uploads.append(engine._cache.uploads)
    assert engine._cache.misses and uploads[-1] >= 2
    assert (graph.captures, graph.replays) == (1, len(items))
    assert len(got[-1]) == CARD_BATCH - 11
    for g, w in zip(got, eager_answers(engine, items)):
        assert_bit_equal(g, w)
    # batches of their own in flight: each answered with its own top-k
    assert not all(np.array_equal(a[0].top_probs, b[0].top_probs)
                   for a, b in zip(got, got[1:]))

    # a parameter written in place: K1's layout (mhb_coAtt) is made again
    # and captured again; hieCoAtten's graph reads its weights in place
    layer = (engine.model.img_conv1d if family == "mhb_coAtt"
             else engine.model.fc)
    with torch.no_grad():
        layer.weight.mul_(1.5)
    again = engine.predict_batch_by_id(*items[0])
    assert graph.captures == (2 if family == "mhb_coAtt" else 1)
    assert_bit_equal(again, eager_answers(engine, items[:1])[0])
    assert not all(np.array_equal(a.top_probs, b.top_probs)
                   for a, b in zip(again, got[0]))

    # the counters, under a profiler of the card
    with profile(activities=[ProfilerActivity.CUDA]):
        engine.predict_batch_by_id(*items[1])
    assert trace.counters()["serve.graph_replays"] == 1


@pytest.mark.parametrize("family", PORT_MODEL_NAMES)
def test_every_family_serves_from_the_graph(card, family):
    engine = card_engine(family)
    cfg = engine.cfg
    items = batches(2, CARD_IMAGES, cfg.q_vocab_size,
                    cfg.max_question_length, CARD_BATCH, seed=8,
                    sizes=[CARD_BATCH, 5])
    got = [p for p in engine.predict_stream_by_id(iter(items))]
    assert engine._graph.replays == 2 and engine._graph.captures == 1
    for g, w in zip(got, eager_answers(engine, items)):
        assert_bit_equal(g, w)
