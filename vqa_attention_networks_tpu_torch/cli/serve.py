"""HTTP serving CLI (the port's copy of
``vqa_attention_networks_tpu/cli/serve.py``): a dynamic-batching JSON
endpoint over the port's ``InferenceEngine``.

- stdlib only (``ThreadingHTTPServer``);
- requests are micro-batched: a dispatcher thread collects up to the
  engine's batch size within ``--max_wait_ms`` and makes one engine call
  (the fixed-batch pad + mask contract of ``serve.py``);
- features come from the packed store by image_id, questions are
  tokenised on the server with the training vocab;
- ``--device_cache_images N`` serves store-backed requests from the device
  feature bank (``InferenceEngine.predict_batch_by_id``: a repeat image
  ships no feature bytes to the card); requests that carry image bytes
  keep the raw-feature path through a second batcher;
- the weights are the port's own export (``cli.train`` writes
  ``<model_dir>/<model_name>/weights``, read by ``serve.trained_params``).

- ``--aot_artifact DIR`` serves the exported program that
  ``cli.export_serving`` wrote (``aot.save_serving_artifact``) with the
  weights of ``--model_dir``, after the engine checks its metadata; it
  cannot be combined with ``--device_cache_images``.

The same endpoints, JSON contract, status codes and flags as the JAX CLI,
and one flag more: ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions, as the tests do; nothing falls back to the CPU by
itself). ``--data_parallel N`` serves each batch split over N replicas
(``serve.InferenceEngine(data_parallel=N)``: ``cuda:0..N-1``, or N
replicas on the CPU under ``--device cpu``); with ``--device_cache_images``
the device bank is JAX's sharded one, split over the replicas (its
capacity rounded up to a multiple of N).

Endpoints:
  GET  /healthz            -> {"status": "ok", ..., "latency": {...}}
  GET  /metrics            -> same telemetry, Prometheus text format 0.0.4
  POST /predict            -> {"question": str, "image_id": int}
                              or {"requests": [...]} (items may use
                              image_id or image_b64); returns answers+top-k.
  POST /predict_image      -> {"question": str, "image_b64": str} — raw
                              image through the in-process backbone
                              (--backbone_weights; 501 when unconfigured).

Drive:
  python -m vqa_attention_networks_tpu_torch.cli.serve --data_dir data \
      --model_name mhb_coAtt --port 8741
"""

import argparse
import json
import queue
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.data.feature_store import (
    open_feature_store,
    quantize_features,
)
from vqa_attention_networks_tpu_torch.data.text import encode_question
from vqa_attention_networks_tpu_torch.device import cuda_device
from vqa_attention_networks_tpu_torch.serve import (
    InferenceEngine,
    trained_params,
)


class LatencyStats:
    """Thread-safe serving telemetry for /healthz: end-to-end request
    latency, batcher queue wait, engine dispatch time, and batch occupancy.

    Bounded memory by design: fixed-size rings of the most recent samples
    (the operationally useful window — a day-old spike should not dominate
    today's p99), with exact lifetime counters alongside. Percentiles are
    computed on demand at /healthz, keeping the record path O(1) under the
    serving lock."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._request_s = deque(maxlen=window)
        self._wait_s = deque(maxlen=window)
        self._dispatch_s = deque(maxlen=window)
        self._occupancy = deque(maxlen=window)
        self.requests = 0
        self.batches = 0

    def record_request(self, seconds: float, n: int = 1) -> None:
        # lifetime counter is exact; the percentile ring takes at most 8
        # samples per call so one 4096-item bulk request cannot flood the
        # window and erase the interactive-latency history an operator is
        # reading p99 from
        with self._lock:
            self.requests += n
            for _ in range(min(n, 8)):
                self._request_s.append(seconds)

    def record_batch(self, waits_s, dispatch_s: float,
                     occupancy: float) -> None:
        with self._lock:
            self.batches += 1
            self._wait_s.extend(waits_s)
            self._dispatch_s.append(dispatch_s)
            self._occupancy.append(occupancy)

    @staticmethod
    def _pct_ms(samples) -> dict:
        if not samples:
            return {"p50_ms": None, "p95_ms": None, "p99_ms": None,
                    "max_ms": None}
        arr = np.asarray(samples, np.float64) * 1e3
        p50, p95, p99 = np.percentile(arr, (50, 95, 99))
        return {"p50_ms": round(float(p50), 3),
                "p95_ms": round(float(p95), 3),
                "p99_ms": round(float(p99), 3),
                "max_ms": round(float(arr.max()), 3)}

    def snapshot(self) -> dict:
        with self._lock:
            req = list(self._request_s)
            wait = list(self._wait_s)
            disp = list(self._dispatch_s)
            occ = list(self._occupancy)
            requests, batches = self.requests, self.batches
        return {
            "requests": requests,
            "batches": batches,
            "request": self._pct_ms(req),
            "queue_wait": self._pct_ms(wait),
            "dispatch": self._pct_ms(disp),
            "batch_occupancy": (
                round(float(np.mean(occ)), 4) if occ else None
            ),
        }


class _Request:
    __slots__ = ("features", "ids", "qlen", "event", "result", "error",
                 "t_submit")

    def __init__(self, features, ids, qlen):
        self.features = features
        self.ids = ids
        self.qlen = qlen
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_submit = time.monotonic()


class Batcher:
    """Collects concurrent requests into one fixed-batch engine call."""

    def __init__(self, engine: InferenceEngine, max_wait_s: float = 0.005,
                 stats: "LatencyStats | None" = None, by_id: bool = False):
        self.engine = engine
        self.max_wait_s = max_wait_s
        self.stats = stats
        # by_id: requests carry an image id in the features slot and are
        # served from the engine's device feature bank (zero feature
        # bytes host->device on a hit — serve.py DeviceFeatureCache)
        self.by_id = by_id
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, features, ids, qlen):
        req = _Request(features, ids, qlen)
        self._q.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _loop(self):
        while True:
            first = self._q.get()
            batch = [first]
            if self.max_wait_s <= 0:
                # no batching window: dispatch immediately with whatever is
                # already queued (blocking here would strand the request
                # until batch_size-1 others happened to arrive)
                while len(batch) < self.engine.batch_size:
                    try:
                        batch.append(self._q.get_nowait())
                    except queue.Empty:
                        break
            else:
                t_end = time.monotonic() + self.max_wait_s
                while len(batch) < self.engine.batch_size:
                    remaining = t_end - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._q.get(timeout=remaining))
                    except queue.Empty:
                        break
            t_dispatch = time.monotonic()
            try:
                ids = np.stack([r.ids for r in batch])
                qlen = np.asarray([r.qlen for r in batch], np.int32)
                if self.by_id:
                    preds = self.engine.predict_batch_by_id(
                        [r.features for r in batch], ids, qlen
                    )
                else:
                    feats, scales = _stack_features(
                        [r.features for r in batch]
                    )
                    preds = self.engine.predict_batch(
                        feats, ids, qlen, feature_scale=scales
                    )
                for r, p in zip(batch, preds):
                    r.result = p
            except Exception as e:  # surface engine errors to every waiter
                for r in batch:
                    r.error = e
            if self.stats is not None:
                self.stats.record_batch(
                    [t_dispatch - r.t_submit for r in batch],
                    time.monotonic() - t_dispatch,
                    len(batch) / self.engine.batch_size,
                )
            for r in batch:
                r.event.set()


def _stack_features(feats_list):
    """Stack per-request features into a batch. int8-store entries are
    (int8 grid, f16 scale) tuples; float entries are bare f16 grids."""
    if isinstance(feats_list[0], tuple):
        return (np.stack([f[0] for f in feats_list]),
                np.stack([f[1] for f in feats_list]))
    return np.stack(feats_list), None


class FeatureCache:
    """Bounded LRU of feature grids keyed by image_id — f16 arrays
    (~800 KB each at 196x2048), or (int8 grid, f16 scale) tuples at half
    that for quantized stores.

    The store gather is the serving hot path's host-side cost: one request
    re-reads + copies a full grid from the memmap. Real VQA traffic
    repeats images (multiple questions per image is the dataset's own
    shape: ~3 questions/image in VQA v2), so an LRU in front of the store
    turns the steady-state per-request cost into a dict hit. Thread-safe:
    ThreadingHTTPServer handles requests concurrently."""

    def __init__(self, capacity_bytes: int, grid_bytes: int):
        self.capacity = max(capacity_bytes // max(grid_bytes, 1), 0)
        self._map: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, image_id: int):
        if not self.capacity:
            return None
        with self._lock:
            feats = self._map.get(image_id)
            if feats is None:
                self.misses += 1
                return None
            self._map.move_to_end(image_id)
            self.hits += 1
            return feats

    def put(self, image_id: int, feats) -> None:
        if not self.capacity:
            return
        # a row view of a bulk-gather result would pin the ENTIRE
        # [B, 196, 2048] base array (up to ~3 GB for a max bulk call)
        # for as long as the entry lives — the accounted capacity is
        # per-grid, so store owning copies. int8 entries are
        # (grid, scale) tuples.
        if isinstance(feats, tuple):
            feats = tuple(
                f.copy() if f.base is not None else f for f in feats
            )
        elif feats.base is not None:
            feats = feats.copy()
        with self._lock:
            self._map[image_id] = feats
            self._map.move_to_end(image_id)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._map), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses}


class ExtractorUnavailable(RuntimeError):
    """/predict_image hit on a server started without a backbone (501)."""


# Image -> feature-grid extraction is SHARED with cli/predict.py
# (models/extractor.py) so served, predict-time, and offline-extraction
# features cannot drift apart in preprocessing.


class VqaService:
    """Request decode (vocab/features) + the batcher, HTTP-agnostic."""

    def __init__(self, cfg: Config, vocab: dict, params, store,
                 batch_size: int, topk: int, max_wait_s: float,
                 artifact_dir=None, feature_cache_mb: int = 512,
                 data_parallel: int = 1, extractor=None,
                 device_cache_images: int = 0, device=None):
        """``params``: the JAX-layout parameter tree (``serve.
        trained_params`` reads ``cli.train``'s export as one). ``device``
        defaults to the card; the CPU runs only when asked for."""
        self.cfg = cfg
        self.q_vocab = vocab["question_vocab"]
        self.max_len = vocab["max_question_length"]
        self.ans_of = {i: a for a, i in vocab["answer_vocab"].items()}
        self.store = store
        # int8 stores serve the quantized feed end to end: int8 entries in
        # the cache (half the f16 footprint -> 2x the cached images),
        # int8+scales over host->device, dequantised on the device
        self.int8 = bool(getattr(store, "quantized", False))
        grid_bytes = store.num_regions * store.channels * (
            1 if self.int8 else 2
        ) + (store.channels * 2 if self.int8 else 0)
        self.cache = FeatureCache(feature_cache_mb << 20, grid_bytes)
        self.engine = InferenceEngine(
            cfg, params, batch_size=batch_size, topk=topk,
            artifact_dir=artifact_dir,
            input_dtype="int8" if self.int8 else "float16",
            data_parallel=data_parallel, device=device,
        )
        if extractor is not None:
            # grid SHAPE must match the store's: a mismatch would surface
            # inside the shared micro-batcher's np.stack, failing innocent
            # co-batched store-backed requests — refuse at startup instead
            if extractor.channels != store.channels:
                raise ValueError(
                    f"backbone produces {extractor.channels}-channel grids "
                    f"but the feature store (and the checkpoint trained on "
                    f"it) expects {store.channels}"
                )
            regions = getattr(extractor, "regions", None)
            if regions is not None and regions != store.num_regions:
                raise ValueError(
                    f"backbone produces {regions}-region grids but the "
                    f"feature store was extracted with "
                    f"{store.num_regions} regions (a non-default "
                    f"extract_features --size?)"
                )
        self.extractor = extractor
        self.stats = LatencyStats()
        # --device_cache_images: store-backed requests serve from the
        # device-resident feature bank (engine predict_*_by_id) — zero
        # feature bytes host->device on repeat images; b64/extracted
        # requests keep the raw-feature path through a second batcher
        self.bank = None
        if device_cache_images:
            if not self.int8:
                raise ValueError(
                    "--device_cache_images requires an int8 (quantized) "
                    "feature store (data.feature_store.quantize_store) — "
                    "the bank holds the quantized layout"
                )
            self.bank = self.engine.attach_feature_cache(
                device_cache_images, self.store.gather_quantized,
                num_regions=store.num_regions, channels=store.channels,
            )
        self.batcher = Batcher(self.engine, max_wait_s, stats=self.stats,
                               by_id=self.bank is not None)
        self.batcher_raw = (
            Batcher(self.engine, max_wait_s, stats=self.stats)
            if (self.bank is not None and extractor is not None) else None
        )

    def _gather(self, image_ids: list):
        """Raw store gather in the engine's feed dtype: a list of f16
        grids, or of (int8 grid, f16 scale) tuples."""
        if self.int8:
            q, s = self.store.gather_quantized(image_ids)
            return [(q[i], s[i]) for i in range(len(image_ids))]
        return list(self.store.gather(image_ids, dtype=np.float16))

    def _features(self, image_id: int):
        feats = self.cache.get(image_id)
        if feats is None:
            try:
                feats = self._gather([image_id])[0]
            except KeyError:
                raise ValueError(f"unknown image_id {image_id}") from None
            self.cache.put(image_id, feats)
        return feats

    def _features_batch(self, image_ids: list) -> list:
        """One multithreaded store gather for every cache-missing id (the
        native data plane, data/native.py) instead of a per-item read."""
        feats = [self.cache.get(i) for i in image_ids]
        missing = sorted({i for i, f in zip(image_ids, feats) if f is None})
        if missing:
            try:
                gathered = self._gather(missing)
            except KeyError as e:
                raise ValueError(f"unknown image_id {e.args[0]}") from None
            by_id = dict(zip(missing, gathered))
            for i, f in by_id.items():
                self.cache.put(i, f)
            feats = [f if f is not None else by_id[i]
                     for i, f in zip(image_ids, feats)]
        return feats

    def _tokenize(self, question: str):
        # LEFT-aligned, exactly as training encodes (prepare.py): models
        # gather the last-valid LSTM state at ques_length-1, which with a
        # right-aligned layout would index into the leading pad run —
        # served answers must come from the same input contract the
        # checkpoint was trained and evaluated with
        ids = np.asarray(
            encode_question(question, self.q_vocab, self.max_len), np.int32
        )
        return ids, max(int((ids != 0).sum()), 1)

    def _encode(self, item: dict):
        feats = self._features(int(item["image_id"]))
        ids, qlen = self._tokenize(item["question"])
        return feats, ids, qlen

    def _to_dict(self, pred) -> dict:
        return {
            "answer": self.ans_of[pred.answer_id],
            "top": [
                {"answer": self.ans_of[int(i)], "prob": float(p)}
                for i, p in zip(pred.top_ids, pred.top_probs)
            ],
        }

    def _check_known(self, image_id: int) -> int:
        """Unknown ids must 400 BEFORE batching: a bad id failing inside
        the batcher's store fetch would take every co-batched request
        down with it."""
        try:
            self.store.rows_for([image_id])
        except KeyError:
            raise ValueError(f"unknown image_id {image_id}") from None
        return image_id

    def predict_one(self, item: dict) -> dict:
        t0 = time.monotonic()
        if self.bank is not None:
            ids, qlen = self._tokenize(item["question"])
            pred = self.batcher.submit(
                self._check_known(int(item["image_id"])), ids, qlen
            )
        else:
            feats, ids, qlen = self._encode(item)
            pred = self.batcher.submit(feats, ids, qlen)
        self.stats.record_request(time.monotonic() - t0)
        return self._to_dict(pred)

    def predict_image(self, item: dict) -> dict:
        """End-to-end path: {question, image_b64} — no precomputed store
        entry needed. The grid goes through the SAME batcher/engine as
        store-backed requests, converted to the engine's feed dtype
        (f16, or the store's int8+scale quantization scheme). With the
        device bank on, these raw-feature requests use their own batcher
        (the bank path serves ids only)."""
        t0 = time.monotonic()
        feats = self._extract_b64(item["image_b64"])
        ids, qlen = self._tokenize(item["question"])
        batcher = self.batcher_raw or self.batcher
        pred = batcher.submit(feats, ids, qlen)
        self.stats.record_request(time.monotonic() - t0)
        return self._to_dict(pred)

    def _extract_b64(self, image_b64: str):
        """base64 image -> feed-dtype grid via the in-process backbone
        (shared by /predict_image and b64 items on the bulk path)."""
        if self.extractor is None:
            raise ExtractorUnavailable(
                "server started without --backbone_weights; image_b64 "
                "requests are disabled (store-backed requests still work)"
            )
        import base64

        try:
            raw = base64.b64decode(image_b64, validate=True)
        except Exception:
            raise ValueError("image_b64 is not valid base64") from None
        # from_bytes raises ValueError only for undecodable images (a 400
        # client error); backbone execution failures propagate unchanged so
        # they surface as 500s with the real cause, not a blamed client
        grid = self.extractor.from_bytes(raw)  # [regions, C] f32
        if self.int8:
            q, scale, _ = quantize_features(grid)
            return (q[0], scale[0])
        return grid.astype(np.float16)

    def predict_many(self, items: list) -> list:
        """Bulk endpoint path: ONE padded engine call per engine-batch of
        requests (routing each item through the micro-batcher would pay a
        full batching window and a device call per item), and ONE batched
        feature gather per call (the per-item path costs a store read per
        request; the batched gather runs the native multithreaded plane).
        Items may carry ``image_id`` (store-backed) or ``image_b64``
        (extracted in-process, one batch-1 trunk call each)."""
        t0 = time.monotonic()
        tokens = []
        for item in items:
            ids, qlen = self._tokenize(item["question"])
            key = ("b64", self._extract_b64(item["image_b64"])) \
                if "image_b64" in item else ("id", int(item["image_id"]))
            tokens.append((key, ids, qlen))
        bs = self.engine.batch_size

        if self.bank is not None:
            # bank mode: id-backed items gather on device; b64 grids go
            # through the raw feed. Results re-assemble in input order.
            out: list = [None] * len(tokens)
            by_kind = {"id": [], "b64": []}
            for pos, (key, ids, qlen) in enumerate(tokens):
                if key[0] == "id":
                    self._check_known(key[1])
                by_kind[key[0]].append((pos, key[1], ids, qlen))
            for kind, entries in by_kind.items():
                for start in range(0, len(entries), bs):
                    chunk = entries[start:start + bs]
                    ids = np.stack([c[2] for c in chunk])
                    qlen = np.asarray([c[3] for c in chunk], np.int32)
                    t_dispatch = time.monotonic()
                    if kind == "id":
                        preds = self.engine.predict_batch_by_id(
                            [c[1] for c in chunk], ids, qlen
                        )
                    else:
                        feats, scales = _stack_features(
                            [c[1] for c in chunk]
                        )
                        preds = self.engine.predict_batch(
                            feats, ids, qlen, feature_scale=scales
                        )
                    self.stats.record_batch(
                        (), time.monotonic() - t_dispatch, len(chunk) / bs
                    )
                    for c, pr in zip(chunk, preds):
                        out[c[0]] = self._to_dict(pr)
            if tokens:
                self.stats.record_request(
                    time.monotonic() - t0, n=len(tokens)
                )
            return out

        store_ids = [k[1] for k, _, _ in tokens if k[0] == "id"]
        store_feats = iter(self._features_batch(store_ids))
        all_feats = [k[1] if k[0] == "b64" else next(store_feats)
                     for k, _, _ in tokens]
        out = []
        for start in range(0, len(tokens), bs):
            chunk = tokens[start:start + bs]
            feats, scales = _stack_features(all_feats[start:start + bs])
            ids = np.stack([c[1] for c in chunk])
            qlen = np.asarray([c[2] for c in chunk], np.int32)
            t_dispatch = time.monotonic()
            preds = self.engine.predict_batch(
                feats, ids, qlen, feature_scale=scales
            )
            self.stats.record_batch(
                (), time.monotonic() - t_dispatch, len(chunk) / bs
            )
            out.extend(self._to_dict(pr) for pr in preds)
        if tokens:
            # every item in the bulk call experienced the same wall clock
            self.stats.record_request(time.monotonic() - t0, n=len(tokens))
        return out


# request-size guards: a question + image_id is a few hundred bytes, so
# these bounds are generous for real traffic while keeping one oversized
# POST from exhausting host memory on an exposed port
MAX_BODY_BYTES = 8 << 20  # 413 beyond this
MAX_BULK_REQUESTS = 4096  # per /predict call


def _prometheus_text(service: VqaService, model_name: str) -> str:
    """Prometheus exposition (text format 0.0.4) of the serving telemetry —
    the same numbers /healthz reports as JSON, shaped for a scraper.
    Quantiles follow the summary-metric convention (precomputed over the
    recent window, not a true streaming summary)."""
    lat = service.stats.snapshot()
    cache = service.cache.stats()
    label = f'{{model="{model_name}"}}'
    lines = [
        "# HELP vqa_requests_total Requests served (lifetime).",
        "# TYPE vqa_requests_total counter",
        f"vqa_requests_total{label} {lat['requests']}",
        "# HELP vqa_batches_total Engine dispatches (lifetime).",
        "# TYPE vqa_batches_total counter",
        f"vqa_batches_total{label} {lat['batches']}",
        "# HELP vqa_feature_cache_hits_total Feature cache hits.",
        "# TYPE vqa_feature_cache_hits_total counter",
        f"vqa_feature_cache_hits_total{label} {cache['hits']}",
        "# HELP vqa_feature_cache_misses_total Feature cache misses.",
        "# TYPE vqa_feature_cache_misses_total counter",
        f"vqa_feature_cache_misses_total{label} {cache['misses']}",
        "# HELP vqa_feature_cache_entries Cached feature grids.",
        "# TYPE vqa_feature_cache_entries gauge",
        f"vqa_feature_cache_entries{label} {cache['entries']}",
    ]
    if service.bank is not None:
        lines += [
            "# HELP vqa_device_bank_hits_total Device feature-bank hits "
            "(requests needing no feature upload).",
            "# TYPE vqa_device_bank_hits_total counter",
            f"vqa_device_bank_hits_total{label} {service.bank.hits}",
            "# HELP vqa_device_bank_misses_total Device feature-bank "
            "uploads.",
            "# TYPE vqa_device_bank_misses_total counter",
            f"vqa_device_bank_misses_total{label} {service.bank.misses}",
            "# HELP vqa_device_bank_evictions_total Device feature-bank "
            "LRU evictions.",
            "# TYPE vqa_device_bank_evictions_total counter",
            f"vqa_device_bank_evictions_total{label} "
            f"{service.bank.evictions}",
        ]
    if lat["batch_occupancy"] is not None:
        lines += [
            "# HELP vqa_batch_occupancy Mean batch fill over the window.",
            "# TYPE vqa_batch_occupancy gauge",
            f"vqa_batch_occupancy{label} {lat['batch_occupancy']}",
        ]
    for section, metric in (("request", "vqa_request_latency_ms"),
                            ("queue_wait", "vqa_queue_wait_ms"),
                            ("dispatch", "vqa_dispatch_latency_ms")):
        pcts = lat[section]
        if pcts["p50_ms"] is None:
            continue
        lines += [
            f"# HELP {metric} Recent-window latency quantiles (ms).",
            f"# TYPE {metric} summary",
        ]
        for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                       ("0.99", "p99_ms")):
            lines.append(
                f'{metric}{{model="{model_name}",quantile="{q}"}} '
                f"{pcts[key]}"
            )
    return "\n".join(lines) + "\n"


class VqaHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog for bursts of
    concurrent clients: the stdlib's backlog of 5 resets the connections
    past it when more clients connect at once than its accept loop takes
    in (64 clients did, on the card's machine)."""

    request_queue_size = 256


def make_handler(service: VqaService, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {
                    "status": "ok",
                    "model": model_name,
                    "batch_size": service.engine.batch_size,
                    "backend": service.engine.device.type,
                    "feature_cache": service.cache.stats(),
                    "latency": service.stats.snapshot(),
                })
            elif self.path == "/metrics":
                body = _prometheus_text(service, model_name).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path not in ("/predict", "/predict_image"):
                self._reply(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES:
                    # drain (bounded 1 MB chunks, capped) so the client can
                    # finish writing and read the 413 instead of EPIPE; a
                    # body claiming more than 8x the cap just gets the
                    # connection closed mid-write
                    remaining = min(length, 8 * MAX_BODY_BYTES)
                    while remaining > 0:
                        chunk = self.rfile.read(min(1 << 20, remaining))
                        if not chunk:
                            break
                        remaining -= len(chunk)
                    self._reply(413, {
                        "error": f"request body {length} bytes exceeds "
                                 f"{MAX_BODY_BYTES}"
                    })
                    self.close_connection = True
                    return
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/predict_image":
                    self._reply(200, service.predict_image(req))
                    return
                if "requests" in req:
                    items = req["requests"]
                    if not isinstance(items, list):
                        self._reply(400, {"error": "'requests' must be a list"})
                        return
                    if len(items) > MAX_BULK_REQUESTS:
                        self._reply(413, {
                            "error": f"{len(items)} requests exceeds "
                                     f"{MAX_BULK_REQUESTS} per call"
                        })
                        return
                    out = {"results": service.predict_many(items)}
                else:
                    out = service.predict_one(req)
                self._reply(200, out)
            except KeyError as e:
                self._reply(400, {"error": f"missing field {e}"})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except ExtractorUnavailable as e:
                self._reply(501, {"error": str(e)})
            except Exception as e:
                self._reply(500, {"error": str(e)})

    return Handler


def build_service(args) -> VqaService:
    vocab_path = args.vocab or (
        f"{args.data_dir}/qa_v{args.version}_{args.num_answer}answers_all"
        ".vocab.json"
    )
    with open(vocab_path) as f:
        vocab = json.load(f)
    store = open_feature_store(args.data_dir, args.feature_type)
    channels = store.channels
    device = getattr(args, "device", "cuda")
    device = cuda_device() if device == "cuda" else torch.device(device)

    cfg = Config(
        model_name=args.model_name,
        q_vocab_size=vocab["question_vocab"]["UNK"] + 1,
        a_vocab_size=len(vocab["answer_vocab"]),
        max_question_length=vocab["max_question_length"],
        img_feature_channel=channels,
        compute_dtype="bfloat16",
        fast_path=getattr(args, "fast_path", "auto"),
    ).validate()
    params = trained_params(cfg, f"{args.model_dir}/{cfg.model_name}")
    extractor = None
    if getattr(args, "backbone_weights", None) is not None:
        from vqa_attention_networks_tpu_torch.models.extractor import (
            GridExtractor,
        )

        # warm-up at startup: the trunk's first call happens here, not
        # inside the first user request
        extractor = GridExtractor(
            getattr(args, "backbone", "resnet152"), args.backbone_weights,
            device=device,
        )
    return VqaService(cfg, vocab, params, store, args.batch_size, args.topk,
                      args.max_wait_ms / 1000.0,
                      artifact_dir=getattr(args, "aot_artifact", None),
                      feature_cache_mb=getattr(args, "feature_cache_mb", 512),
                      data_parallel=getattr(args, "data_parallel", 1),
                      extractor=extractor,
                      device_cache_images=getattr(
                          args, "device_cache_images", 0),
                      device=device)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", type=str, default="mhb_coAtt")
    parser.add_argument("--model_dir", type=str, default="./models")
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--vocab", type=str, default=None)
    parser.add_argument("--feature_type", type=str, default="resnet152")
    parser.add_argument("--version", type=int, default=2)
    parser.add_argument("--num_answer", type=int, default=1000)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8741)
    parser.add_argument("--batch_size", type=int, default=64,
                        help="engine batch (one fixed batch a call; larger = "
                             "more throughput, more latency under load)")
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--max_wait_ms", type=float, default=5.0,
                        help="micro-batching window")
    parser.add_argument("--fast_path", type=str, default="auto",
                        help="auto|pallas|composed — bf16 mhb_coAtt "
                             "dispatch: the K1 kernel or the composed "
                             "chain (config.py fast_path)")
    parser.add_argument("--feature_cache_mb", type=int, default=512,
                        help="LRU feature cache in front of the store "
                             "(~800 KB per image at 196x2048 for f16 "
                             "stores, ~400 KB for int8 stores); 0 disables")
    parser.add_argument("--device_cache_images", type=int, default=0,
                        help="device-resident feature bank: keep the int8 "
                             "rows + scales of up to N images in device "
                             "memory and serve store-backed requests by a "
                             "gather on the device — no feature bytes to "
                             "the card on a hit (~396 KB per image at "
                             "196x2048). Needs an int8 store and N >= the "
                             "distinct images of a batch")
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="split each served batch over N replicas "
                             "(cuda:0..N-1; N replicas on the CPU under "
                             "--device cpu); with --device_cache_images the "
                             "bank splits over the replicas too")
    parser.add_argument("--aot_artifact", type=str, default=None,
                        help="serve the exported program in this directory "
                             "(cli.export_serving) with the weights of "
                             "--model_dir; incompatible with "
                             "--device_cache_images")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default: the card; an error without "
                             "one) | cpu (the plain PyTorch versions of "
                             "the kernels, for tests)")
    parser.add_argument("--backbone", type=str, default="resnet152",
                        help="resnet152|vgg19 — trunk for /predict_image")
    parser.add_argument("--backbone_weights", type=str, default=None,
                        help=".npz of the torchvision backbone state_dict; "
                             "enables the end-to-end /predict_image "
                             "endpoint (image bytes -> features -> answer)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    service = build_service(args)
    server = VqaHTTPServer(
        (args.host, args.port), make_handler(service, args.model_name)
    )

    # graceful drain on SIGTERM/SIGINT: orchestrators (and operators) send
    # TERM on redeploy — in-flight requests finish, the listener closes,
    # and the process exits 0 instead of dying mid-response.
    # ThreadingHTTPServer marks handler threads daemon by default, which
    # would let the process exit without joining them (killing in-flight
    # responses) — non-daemon + block_on_close makes server_close() the
    # actual drain point.
    server.daemon_threads = False
    import signal

    def _shutdown(signum, frame):
        print(f"received signal {signum}: draining and shutting down",
              flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)

    print(f"serving {args.model_name} on http://{args.host}:{args.port} "
          f"(batch {args.batch_size}, wait {args.max_wait_ms}ms, "
          f"device {service.engine.device})", flush=True)
    server.serve_forever()
    server.server_close()
    print("server stopped", flush=True)


if __name__ == "__main__":
    main()
