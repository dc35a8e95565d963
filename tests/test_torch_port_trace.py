"""The port's spans and counters (``vqa_attention_networks_tpu_torch/utils/
trace.py``) and the per-layer metrics of ``port_bench/metrics/`` that read
them, on the CPU; one test of the spans' clock on the card.

- With no profiler running, serving and training record nothing.
- A span shares the profiler's clock: under a CPU profile, a span around
  ``torch.mm`` holds the ``aten::mm`` event's absolute time
  (``trace_start_ns()`` plus the event's offset); on the card, a span that
  ends after a synchronise behind a long kernel holds the kernel's device
  end (``test_span_holds_a_kernels_device_times_on_the_card``, which skips
  without a card; the README's card tests run it).
- Parents, per-thread stacks, batch ids and self times.
- The engine's and the Solver's spans, a fixed number per batch or step;
  the Solver's exported Chrome trace holds the ``train.*`` names.
- A traced run of each benchmark cell reports the span metrics.

This file imports neither JAX nor the JAX package, so that the card test
runs where they are absent (``--noconftest``).
"""

import json
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.data.feature_store import (
    make_synthetic_feature_store,
    quantize_features,
)
from vqa_attention_networks_tpu_torch.data.prepare import (
    make_synthetic_qa_data,
)
from vqa_attention_networks_tpu_torch.serve import InferenceEngine
from vqa_attention_networks_tpu_torch.train.solver import Solver, init_params
from vqa_attention_networks_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
B, T, L, D, IMAGES = 4, 7, 196, 32, 8
SMALL = dict(model_name="mhb_coAtt", q_vocab_size=50, a_vocab_size=16,
             hidden_dim=32, emb_dim=16, img_feature_dim=L,
             img_feature_channel=D, mfb_out=16, max_question_length=T)


@pytest.fixture(autouse=True)
def clean_record():
    trace.reset()
    yield
    trace.reset()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def absolute_ns(prof, event, end=False):
    """An event's time on the clock of ``time.time_ns()``."""
    start = prof.profiler.kineto_results.trace_start_ns()
    at = event.time_range.end if end else event.time_range.start
    return start + round(at * 1000)


def names(recorded=None):
    return Counter(s.name for s in (trace.spans() if recorded is None
                                    else recorded))


def small_engine(input_dtype):
    cfg = Config(**SMALL).validate()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    return InferenceEngine(cfg, params, batch_size=B, topk=3,
                           input_dtype=input_dtype, device="cpu")


def int8_pool(seed=1):
    feats = np.random.default_rng(seed).standard_normal(
        (IMAGES, L, D)).astype(np.float32)
    rows, scale, _ = quantize_features(feats)
    return rows, scale.astype(np.float16)


def by_id_batches(n, seed=2):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.integers(0, IMAGES, B).tolist(),
               rng.integers(1, SMALL["q_vocab_size"], (B, T)).astype(
                   np.int32), np.full(B, T, np.int32))


def serve_by_id(n):
    rows, scale = int8_pool()

    def fetch(ids):
        return rows[ids], scale[ids]

    engine = small_engine("int8")
    engine.attach_feature_cache(IMAGES, fetch)
    return [p for batch in engine.predict_stream_by_id(by_id_batches(n))
            for p in batch]


def serve_feed(n, store):
    engine = small_engine("float16")
    items = ((store.gather(ids, dtype=np.float16), ques, qlen)
             for ids, ques, qlen in by_id_batches(n))
    return [p for batch in engine.predict_stream(items) for p in batch]


@pytest.fixture
def store(tmp_path):
    return make_synthetic_feature_store(str(tmp_path / "store"),
                                        list(range(IMAGES)), num_regions=L,
                                        channels=D)


def small_solver(tmp_path, store, **kw):
    cfg = Config(**SMALL, batch_size=B, num_epoch=1, shuffle=False,
                 checkpoint_every_steps=0, out_dir=str(tmp_path / "out"),
                 **kw).validate()
    qa = make_synthetic_qa_data(
        np.random.default_rng(0), n_train=2 * B, n_val=B,
        q_vocab_words=cfg.q_vocab_size - 2, num_answers=cfg.a_vocab_size,
        max_len=T, num_images=IMAGES)
    return Solver(cfg, qa, store, device="cpu")


def test_nothing_recorded_without_a_profiler(tmp_path, store):
    assert not trace.recording()
    assert len(serve_by_id(3)) == 3 * B
    assert len(serve_feed(3, store)) == 3 * B
    solver = small_solver(tmp_path, store)
    solver.train()
    assert solver.step == 2
    with trace.span("outside") as s:
        assert s is None
    trace.count("outside", 5)
    assert trace.spans() == [] and trace.counters() == {}


def test_a_span_shares_the_profilers_clock():
    """The flag the module reads is the profiler's, and a span's times are
    the profiler's event times on one clock."""
    a = torch.randn(256, 256)
    with cpu_profile() as prof:
        assert trace.recording()
        with trace.span("around.mm") as s:
            torch.mm(a, a)
    assert not trace.recording()
    [got] = trace.spans()
    assert got is s and got.end_ns > got.start_ns
    events = {e.name: e for e in prof.events()
              if e.name in ("aten::mm", "around.mm")}
    assert set(events) == {"aten::mm", "around.mm"}
    for e in events.values():  # the span's own range, and the op inside
        assert s.start_ns <= absolute_ns(prof, e)
        assert absolute_ns(prof, e, end=True) <= s.end_ns


def test_parents_threads_batches_and_self_times():
    done = threading.Event()

    def other():
        with trace.span("thread.outer"):
            with trace.span("thread.inner", batch=3):
                pass
        done.set()

    with cpu_profile():
        with trace.span("outer", batch=7) as outer:
            with trace.span("inner") as inner:
                with trace.span("innermost", batch=9) as innermost:
                    worker = threading.Thread(target=other)
                    worker.start()
                    worker.join(timeout=30)
            with trace.span("second") as second:
                pass
    assert done.is_set() and not worker.is_alive()
    by = {s.name: s for s in trace.spans()}
    assert set(by) == {"outer", "inner", "innermost", "second",
                       "thread.outer", "thread.inner"}
    assert (outer.parent, inner.parent, innermost.parent, second.parent) == (
        None, outer.id, inner.id, outer.id)
    assert (outer.batch, inner.batch, innermost.batch, second.batch) == (
        7, 7, 9, 7)
    t_outer, t_inner = by["thread.outer"], by["thread.inner"]
    assert t_outer.parent is None and t_inner.parent == t_outer.id
    assert t_outer.thread == t_inner.thread != outer.thread
    assert (t_outer.batch, t_inner.batch) == (None, 3)
    own = trace.self_ns(trace.spans())
    assert own[outer.id] == (outer.duration_ns - inner.duration_ns
                             - second.duration_ns)
    assert own[inner.id] == inner.duration_ns - innermost.duration_ns
    assert own[innermost.id] == innermost.duration_ns
    assert all(v >= 0 for v in own.values())


def _h2d_bytes(path):
    """The bytes a batch copies to the device: the padded arrays."""
    ques_and_len = B * T * 4 + B * 4
    if path == "by_id":
        return ques_and_len + B * 8  # the bank's slot indices, int64
    return ques_and_len + B * L * D * 2  # the float16 grids


@pytest.mark.parametrize("path", ["by_id", "feed"])
def test_the_engine_records_each_batch_once(path, store):
    n = 3
    with cpu_profile():
        served = serve_by_id(n) if path == "by_id" else serve_feed(n, store)
    assert len(served) == n * B
    recorded = trace.spans()
    by_id = path == "by_id"
    counts = names(recorded)
    assert counts["serve.dispatch"] == counts["serve.collect"] == n
    assert counts["serve.result_wait"] == counts["serve.launch"] == n
    assert counts["bank.ensure"] == (n if by_id else 0)
    assert counts["serve.h2d"] == (2 * n if by_id else n)
    assert counts["store.gather"] == (0 if by_id else n)
    assert trace.counters() == {"serve.h2d_bytes": n * _h2d_bytes(path)}
    parents = {s.id: s for s in recorded}
    for s in recorded:
        if s.name in ("serve.dispatch", "serve.collect"):
            assert s.parent is None
        elif s.name == "serve.result_wait":
            assert parents[s.parent].name == "serve.collect"
        elif s.name != "store.gather":
            assert parents[s.parent].name == "serve.dispatch"
    # each batch's spans under one id, its dispatch's and its collect's
    for name in ("serve.dispatch", "serve.collect", "serve.result_wait"):
        assert sorted(s.batch for s in recorded if s.name == name) == [
            1, 2, 3]
    for s in recorded:
        if s.name in ("serve.h2d", "bank.ensure", "serve.launch"):
            assert s.batch == parents[s.parent].batch


def test_solver_spans_each_step_and_exports_them(tmp_path, store):
    solver = small_solver(tmp_path, store, profile_steps=2,
                          profile_dir=str(tmp_path / "profile"))
    solver.train()
    recorded = trace.spans()
    counts = names(recorded)
    assert counts["train.step"] == counts["train.feed_wait"] == 2
    for name in ("train.device_batch", "train.forward", "train.backward",
                 "train.optimizer"):
        assert counts[name] == 2
    for name in ("train.step", "train.feed_wait"):
        assert sorted(s.batch for s in recorded if s.name == name) == [0, 1]
    steps = {s.id: s for s in recorded if s.name == "train.step"}
    inside = [s for s in recorded if s.name not in ("train.step",
                                                    "train.feed_wait",
                                                    "store.gather")]
    assert all(s.parent in steps and s.batch == steps[s.parent].batch
               for s in inside)
    # the host feed gathers on the prefetch thread, outside any step
    gathers = [s for s in recorded if s.name == "store.gather"]
    assert gathers and all(s.parent is None and s.thread != s0.thread
                           for s in gathers for s0 in steps.values())
    with open(solver.profile_trace) as f:
        exported = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train.step", "train.feed_wait", "train.device_batch",
            "train.forward", "train.backward",
            "train.optimizer"} <= exported


CELL_METRICS = {
    "mhb_coatt.serve_byid": {"dispatch_ms.serve", "result_wait_ms.serve",
                             "bank_ensure_ms"},
    "hiecoatten.serve_feed": {"dispatch_ms.serve", "result_wait_ms.serve"},
    "mhb_coatt.train_prepool": {"feed_wait_ms.train", "step_host_ms.train"},
}


@pytest.mark.parametrize("cell", sorted(CELL_METRICS))
def test_a_traced_cell_reports_the_span_metrics(cell, tmp_path,
                                                monkeypatch):
    """A small traced run of each cell on the CPU: the span metrics, and no
    ``h2d_gb_per_s.serve`` (the CPU has no device copies)."""
    from port_bench import harness, inputs
    from port_bench.run import measure

    conftest = harness.load_module(ROOT / "port_bench" / "tests"
                                   / "conftest.py", "tests_conftest")
    monkeypatch.setattr(inputs, "CACHE", tmp_path / "cache")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    line = measure(conftest.small_cell(cell), 2 ** 31 + 11, 1.5, True,
                   device="cpu")
    got = line["metrics"]
    assert CELL_METRICS[cell] <= set(got)
    assert all(got[m]["value"] > 0 and got[m]["unit"] == "ms"
               for m in CELL_METRICS[cell])
    assert "h2d_gb_per_s.serve" not in got


def test_span_holds_a_kernels_device_times_on_the_card():
    """On the card, CUPTI's kernel times share the spans' clock: a span
    that ends after a synchronise behind a long kernel holds the kernel's
    device start and end."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the device trace has no CPU "
                    "mode)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with trace.span("card.sleep") as s:
            torch.cuda._sleep(200_000_000)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    assert kernels
    k = max(kernels, key=lambda e: e.time_range.end - e.time_range.start)
    start, end = absolute_ns(prof, k), absolute_ns(prof, k, end=True)
    print(f"card clock: kernel {k.name} {(end - start) / 1e6:.3f} ms; "
          f"span start {(start - s.start_ns) / 1e3:.1f} us before it, "
          f"span end {(s.end_ns - end) / 1e3:.1f} us after its end")
    assert s.start_ns <= start < end <= s.end_ns
