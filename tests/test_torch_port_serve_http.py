"""The port's HTTP serving CLI (``vqa_attention_networks_tpu_torch/cli/
serve.py``) against the JAX package's, on the CPU.

Mirrors every test of ``tests/test_serve_http.py``: the real
``ThreadingHTTPServer`` of the port's CLI on port 0, ``--device cpu``,
driven with urllib. The JAX CLI's data-parallel test serves through the
port's split-batch engine (ROADMAP Queue 1 item 10a), its sharded-bank
test through the port's bank split over the replicas (item 10b); its
artifact test serves through the port's artifact. The
served answers are held against JAX's ``VqaService`` built on the same
parameters and store: the same answer wherever the top probability is
clearly above the next, and every probability within ``PROB_ATOL`` (bf16
iBOWIMG in both packages: ``test_torch_port_serve.py``'s
``OTHER_PROB_ATOL``). The model is served from the weights file the port's
``cli.train`` writes (``utils/checkpoint.save_weights``).
"""

import argparse
import base64
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_port_mhb_coatt import port_config
from test_torch_port_serve import OTHER_PROB_ATOL as PROB_ATOL
from vqa_attention_networks_tpu.cli import serve as jax_cli
from vqa_attention_networks_tpu.config import Config
from vqa_attention_networks_tpu.data.feature_store import (
    FeatureStore as JaxStore,
)
from vqa_attention_networks_tpu.models import get_model as jax_model
from vqa_attention_networks_tpu_torch.cli import serve as serve_cli
from vqa_attention_networks_tpu_torch.data.feature_store import (
    FeatureStore,
    make_synthetic_feature_store,
    quantize_store,
)
from vqa_attention_networks_tpu_torch.models import get_model
from vqa_attention_networks_tpu_torch.utils import checkpoint as ckpt
from vqa_attention_networks_tpu_torch.weights import (
    load_jax_params,
    to_jax_params,
)

MODEL = "iBOWIMG"
IMAGE_IDS = [3, 7, 11, 19]
WORDS = ["what", "color", "is", "the", "cat", "dog", "sky"]
ANSWERS = ["black", "white", "blue", "red", "yes"]


def _vocab(words=WORDS, answers=ANSWERS):
    q_vocab = {w: i + 1 for i, w in enumerate(words)}
    q_vocab["UNK"] = len(words) + 1
    return {"question_vocab": q_vocab,
            "answer_vocab": {a: i for i, a in enumerate(answers)},
            "max_question_length": 6}


def _cfg(vocab) -> Config:
    return Config(
        model_name=MODEL, q_vocab_size=vocab["question_vocab"]["UNK"] + 1,
        a_vocab_size=len(vocab["answer_vocab"]), max_question_length=6,
        img_feature_channel=8, compute_dtype="bfloat16",
    ).validate()


def _params(cfg: Config, seed: int = 0) -> dict:
    """A JAX-layout tree (numpy): the init, its answer layer scaled up so
    the served probabilities are well apart."""
    import jax

    tree = jax.tree_util.tree_map(
        lambda x: np.array(x, np.float32),
        jax_model(MODEL).init(jax.random.PRNGKey(seed), cfg))
    tree["fc"]["w"] = tree["fc"]["w"] * 8.0
    return tree


def _workspace(path, n_answers=5, f16_dir="resnet152_all", int8_dir=None,
               regions=4, seed=0, vocab=None):
    """Vocab file, synthetic store(s) and the port's weights file under
    ``path``; returns (vocab, JAX cfg, params)."""
    vocab = vocab or _vocab(answers=ANSWERS[:n_answers])
    with open(path / f"qa_v2_{n_answers}answers_all.vocab.json", "w") as f:
        json.dump(vocab, f)
    make_synthetic_feature_store(str(path / f16_dir), IMAGE_IDS,
                                 num_regions=regions, channels=8)
    if int8_dir is not None:
        quantize_store(str(path / f16_dir), str(path / int8_dir))
    cfg = _cfg(vocab)
    params = _params(cfg, seed)
    model = load_jax_params(get_model(MODEL)(port_config(cfg)), params)
    ckpt.save_weights(str(path / "models" / MODEL), model.state_dict())
    return vocab, cfg, params


def _args(path, n_answers=5, **kw):
    base = dict(model_name=MODEL, model_dir=str(path / "models"),
                data_dir=str(path), vocab=None, feature_type="resnet152",
                version=2, num_answer=n_answers, batch_size=4, topk=3,
                max_wait_ms=30.0, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def _serve(service):
    httpd = serve_cli.VqaHTTPServer(("127.0.0.1", 0),
                                    serve_cli.make_handler(service, MODEL))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """The port's server, and JAX's VqaService on the same params and
    store (the reference for its answers)."""
    path = tmp_path_factory.mktemp("serve_data")
    vocab, cfg, params = _workspace(path)
    service = serve_cli.build_service(_args(path))
    ref = jax_cli.VqaService(cfg, vocab, params,
                             JaxStore(str(path / "resnet152_all")), 4, 3,
                             0.0)
    httpd, url = _serve(service)
    yield SimpleNamespace(url=url, service=service, ref=ref)
    httpd.shutdown()
    httpd.server_close()


def _post(url, payload, path="/predict"):
    req = urllib.request.Request(
        url + path, json.dumps(payload).encode(),
        {"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        e.msg = f"{e.msg}: {e.read().decode(errors='replace')[:500]}"
        raise


def _same_as_jax(got: dict, want: dict) -> None:
    """One served result against JAX's: every top probability within
    PROB_ATOL; the answers at each rank whose neighbours (the unseen next
    rank counts as one) are clearly apart."""
    gp = np.array([t["prob"] for t in got["top"]])
    wp = np.array([t["prob"] for t in want["top"]])
    np.testing.assert_allclose(gp, wp, rtol=0, atol=PROB_ATOL)
    gaps = wp[:-1] - wp[1:]
    clear = np.minimum(np.r_[np.inf, gaps], np.r_[gaps, 0.0]) > 2 * PROB_ATOL
    assert [t["answer"] for t, c in zip(got["top"], clear) if c] == \
        [t["answer"] for t, c in zip(want["top"], clear) if c]
    if clear[0] or gaps[0] > 2 * PROB_ATOL:
        assert got["answer"] == want["answer"]


def _same_result(a: dict, b: dict) -> None:
    """One request served in two different batches: the same answers, and
    probabilities equal up to f32 rounding (the other rows of a batch may
    change the order of a sum)."""
    assert a["answer"] == b["answer"]
    assert [t["answer"] for t in a["top"]] == [t["answer"] for t in b["top"]]
    np.testing.assert_allclose([t["prob"] for t in a["top"]],
                               [t["prob"] for t in b["top"]], rtol=1e-6)


def test_healthz(server):
    with urllib.request.urlopen(server.url + "/healthz", timeout=30) as resp:
        got = json.loads(resp.read())
    assert got["status"] == "ok" and got["model"] == MODEL
    assert got["backend"] == "cpu" and got["batch_size"] == 4


def test_single_predict(server):
    item = {"question": "what color is the cat", "image_id": 3}
    got = _post(server.url, item)
    assert got["answer"] in ANSWERS
    assert len(got["top"]) == 3
    probs = [t["prob"] for t in got["top"]]
    assert probs == sorted(probs, reverse=True)
    _same_as_jax(got, server.ref.predict_one(dict(item)))


def test_batched_predict_and_determinism(server):
    reqs = [{"question": "what color is the sky", "image_id": i}
            for i in IMAGE_IDS]
    got = _post(server.url, {"requests": reqs})
    assert len(got["results"]) == len(IMAGE_IDS)
    again = _post(server.url, {"requests": reqs})
    assert got == again
    for g, w in zip(got["results"], server.ref.predict_many(reqs)):
        _same_as_jax(g, w)


def test_the_listen_backlog_takes_a_burst_of_clients():
    """The stdlib server's backlog of 5 reset connections of 64 clients
    that connected at once; the port's server keeps a larger one."""
    assert ThreadingHTTPServer.request_queue_size == 5
    assert serve_cli.VqaHTTPServer.request_queue_size >= 64
    assert issubclass(serve_cli.VqaHTTPServer, ThreadingHTTPServer)


def test_concurrent_requests_are_microbatched_correctly(server):
    """Many concurrent requests coalesce into fixed-batch engine calls;
    each caller gets the answer it gets alone."""
    solo = {i: _post(server.url, {"question": "is the dog black",
                                  "image_id": i}) for i in IMAGE_IDS}
    with ThreadPoolExecutor(max_workers=8) as pool:
        futures = [pool.submit(_post, server.url,
                               {"question": "is the dog black",
                                "image_id": i}) for i in IMAGE_IDS * 4]
        results = [f.result() for f in futures]
    for i, got in zip(IMAGE_IDS * 4, results):
        _same_result(got, solo[i])


def test_latency_telemetry_on_healthz(server):
    _post(server.url, {"question": "what color is the cat", "image_id": 3})
    _post(server.url, {"requests": [
        {"question": "what color is the sky", "image_id": i}
        for i in IMAGE_IDS]})
    with urllib.request.urlopen(server.url + "/healthz", timeout=30) as r:
        lat = json.loads(r.read())["latency"]
    assert lat["requests"] >= 1 + len(IMAGE_IDS)
    assert lat["batches"] >= 2
    for section in ("request", "dispatch"):
        p = lat[section]
        assert p["p50_ms"] is not None and p["p50_ms"] > 0
        assert p["p50_ms"] <= p["p95_ms"] <= p["p99_ms"] <= p["max_ms"]
    assert 0 < lat["batch_occupancy"] <= 1


def _status(url, path, payload) -> int:
    req = urllib.request.Request(url + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=30)
    return exc.value.code


def test_predict_image_unconfigured_is_501(server):
    assert _status(server.url, "/predict_image",
                   {"question": "what", "image_b64": "aGk="}) == 501


class _StubExtractor:
    """Any image bytes -> store image 3's grid (f32)."""
    channels = 8
    regions = 4

    def __init__(self, store):
        self.grid = np.asarray(store.gather([3], dtype=np.float16)[0],
                               np.float32)

    def from_bytes(self, image_bytes):
        assert image_bytes == b"fake-image"
        return self.grid


@pytest.fixture(scope="module")
def server_img(tmp_path_factory):
    """A second server with a stub extractor whose grid equals store
    image 3's: /predict_image must answer exactly as /predict for 3."""
    path = tmp_path_factory.mktemp("serve_img_data")
    _workspace(path)
    service = serve_cli.build_service(_args(path, max_wait_ms=5.0))
    service.extractor = _StubExtractor(service.store)
    httpd, url = _serve(service)
    yield url
    httpd.shutdown()
    httpd.server_close()


B64 = base64.b64encode(b"fake-image").decode()


def test_predict_image_end_to_end(server_img):
    q = "what color is the cat"
    got = _post(server_img, {"question": q, "image_b64": B64},
                "/predict_image")
    assert got == _post(server_img, {"question": q, "image_id": 3})


def test_bulk_mixed_store_and_image_items(server_img):
    q = "what color is the cat"
    got = _post(server_img, {"requests": [
        {"question": q, "image_id": 3},
        {"question": q, "image_b64": B64},
        {"question": q, "image_id": 7},
    ]})["results"]
    assert got[0] == got[1]  # the same grid in the same batch
    _same_result(got[2], _post(server_img, {"question": q, "image_id": 7}))


def test_bulk_b64_unconfigured_is_501(server):
    assert _status(server.url, "/predict", {"requests": [
        {"question": "what", "image_b64": "aGk="}]}) == 501


def test_predict_image_bad_base64_is_400(server_img):
    assert _status(server_img, "/predict_image",
                   {"question": "what", "image_b64": "!!!"}) == 400


def test_extractor_channel_mismatch_rejected(tmp_path):
    vocab, cfg, params = _workspace(tmp_path, n_answers=2)
    store = FeatureStore(str(tmp_path / "resnet152_all"))
    pcfg = port_config(cfg)

    class WrongWidth:
        channels = 512

    with pytest.raises(ValueError, match="512-channel"):
        serve_cli.VqaService(pcfg, vocab, params, store, 4, 2, 0.0,
                             extractor=WrongWidth(), device="cpu")

    class WrongRegions:
        channels = 8
        regions = 196

    with pytest.raises(ValueError, match="196-region"):
        serve_cli.VqaService(pcfg, vocab, params, store, 4, 2, 0.0,
                             extractor=WrongRegions(), device="cpu")


def test_prometheus_metrics_endpoint(server):
    _post(server.url, {"question": "what color is the cat", "image_id": 3})
    with urllib.request.urlopen(server.url + "/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    assert "# TYPE vqa_requests_total counter" in text
    lines = {ln.split(" ")[0]: ln.split(" ")[-1]
             for ln in text.splitlines() if not ln.startswith("#")}
    assert float(lines[f'vqa_requests_total{{model="{MODEL}"}}']) >= 1
    assert float(lines[f'vqa_batches_total{{model="{MODEL}"}}']) >= 1
    q50 = f'vqa_request_latency_ms{{model="{MODEL}",quantile="0.5"}}'
    assert q50 in lines and float(lines[q50]) > 0
    # the same exposition as JAX's for the same telemetry
    ref = jax_cli._prometheus_text(server.service, MODEL)
    assert serve_cli._prometheus_text(server.service, MODEL) == ref


def test_latency_stats_empty_and_window():
    s = serve_cli.LatencyStats(window=4)
    snap = s.snapshot()
    assert snap["requests"] == 0 and snap["batches"] == 0
    assert snap["request"]["p50_ms"] is None
    assert snap["batch_occupancy"] is None
    for i in range(10):
        s.record_request(0.001 * (i + 1))
    snap = s.snapshot()
    assert snap["requests"] == 10
    assert snap["request"]["max_ms"] == 10.0
    assert snap["request"]["p50_ms"] >= 7.0
    ref = jax_cli.LatencyStats(window=4)
    for i in range(10):
        ref.record_request(0.001 * (i + 1))
    assert ref.snapshot() == snap


def test_error_paths(server):
    assert _status(server.url, "/predict",
                   {"question": "hi", "image_id": 99999}) == 400
    assert _status(server.url, "/predict", {"image_id": 3}) == 400
    assert _status(server.url, "/nope", {}) == 404


def test_oversized_requests_rejected(server):
    big = b'{"question": "' + b"a" * serve_cli.MAX_BODY_BYTES + b'"}'
    req = urllib.request.Request(server.url + "/predict", big,
                                 {"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 413
    many = {"requests": [{"question": "hi", "image_id": 1}] * (
        serve_cli.MAX_BULK_REQUESTS + 1)}
    assert _status(server.url, "/predict", many) == 413
    assert _status(server.url, "/predict", {"requests": "nope"}) == 400
    assert (serve_cli.MAX_BODY_BYTES, serve_cli.MAX_BULK_REQUESTS) == (
        jax_cli.MAX_BODY_BYTES, jax_cli.MAX_BULK_REQUESTS)


def test_aot_artifact_is_refused(tmp_path):
    """JAX's ``test_service_with_aot_artifact_matches_jit``: the service
    serves an exported artifact with the answers of the eager one (the
    port refused the flag until the artifact was ported; the name stays).
    A directory without an artifact is refused."""
    from vqa_attention_networks_tpu_torch.aot import save_serving_artifact

    _, cfg, params = _workspace(tmp_path, n_answers=3, regions=196)
    with pytest.raises(FileNotFoundError):
        serve_cli.build_service(_args(tmp_path, n_answers=3,
                                      aot_artifact=str(tmp_path / "aot")))
    save_serving_artifact(str(tmp_path / "aot"), port_config(cfg), params,
                          4, topk=3, device="cpu")
    served = serve_cli.build_service(_args(
        tmp_path, n_answers=3, aot_artifact=str(tmp_path / "aot")))
    eager = serve_cli.build_service(_args(tmp_path, n_answers=3))
    items = [{"question": "what color is the sky", "image_id": i}
             for i in IMAGE_IDS]
    for a, b in zip(served.predict_many(items), eager.predict_many(items)):
        assert a == b
    with pytest.raises(SystemExit):  # the flag takes a directory
        serve_cli.parse_args(["--aot_artifact"])
    assert serve_cli.parse_args(["--aot_artifact", "x"]).aot_artifact == "x"


def test_serving_encode_matches_training_alignment(server):
    out = _post(server.url, {"question": "what color",
                             "image_id": IMAGE_IDS[0]})
    assert "answer" in out
    ids, qlen = server.service._tokenize("what color")
    assert ids[:2].tolist() == [1, 2] and ids[2:].tolist() == [0] * 4
    assert qlen == 2
    want_ids, want_len = server.ref._tokenize("what color")
    np.testing.assert_array_equal(ids, want_ids)
    assert qlen == want_len


def test_bulk_requests_single_engine_call(server):
    items = [{"question": "what color is the cat",
              "image_id": IMAGE_IDS[i % 4]} for i in range(6)]
    before = server.service.stats.snapshot()["batches"]
    bulk = _post(server.url, {"requests": items})["results"]
    assert server.service.stats.snapshot()["batches"] - before == 2
    single = [_post(server.url, it) for it in items]
    assert len(bulk) == 6
    for a, b in zip(bulk, single):
        _same_result(a, b)


def test_zero_wait_dispatches_immediately():
    from vqa_attention_networks_tpu_torch.serve import InferenceEngine

    cfg = port_config(_cfg(_vocab()))
    engine = InferenceEngine(cfg, _params(_cfg(_vocab())), batch_size=64,
                             topk=3, device="cpu")
    batcher = serve_cli.Batcher(engine, max_wait_s=0.0)
    t0 = time.monotonic()
    pred = batcher.submit(np.zeros((4, 8), np.float16),
                          np.zeros((6,), np.int32), 1)
    assert pred is not None
    assert time.monotonic() - t0 < 30


def test_feature_cache_serves_hits(server):
    item = {"question": "what color is the sky", "image_id": IMAGE_IDS[1]}
    assert _post(server.url, item) == _post(server.url, item)
    with urllib.request.urlopen(server.url + "/healthz") as r:
        stats = json.loads(r.read())["feature_cache"]
    assert stats["hits"] >= 1 and stats["entries"] >= 1


def test_feature_cache_lru_eviction_and_batched_gather(tmp_path):
    store_dir = str(tmp_path / "store")
    make_synthetic_feature_store(store_dir, [1, 2, 3, 4, 5], num_regions=4,
                                 channels=8)
    store = FeatureStore(store_dir)
    grid_bytes = 4 * 8 * 2
    cache = serve_cli.FeatureCache(2 * grid_bytes, grid_bytes)
    svc = SimpleNamespace(cache=cache, store=store, int8=False)
    svc._gather = lambda ids: serve_cli.VqaService._gather(svc, ids)

    feats = serve_cli.VqaService._features_batch(svc, [1, 2, 1, 3])
    np.testing.assert_array_equal(
        np.stack(feats), store.gather([1, 2, 1, 3], dtype=np.float16))
    assert cache.stats()["entries"] == 2
    feats2 = serve_cli.VqaService._features_batch(svc, [3, 3])
    np.testing.assert_array_equal(np.stack(feats2),
                                  store.gather([3, 3], dtype=np.float16))
    assert cache.stats()["hits"] >= 2
    with pytest.raises(ValueError, match="unknown image_id"):
        serve_cli.VqaService._features_batch(svc, [1, 999])
    svc0 = SimpleNamespace(cache=serve_cli.FeatureCache(0, grid_bytes),
                           store=store, int8=False)
    svc0._gather = lambda ids: serve_cli.VqaService._gather(svc0, ids)
    feats3 = serve_cli.VqaService._features_batch(svc0, [4, 4, 5])
    np.testing.assert_array_equal(
        np.stack(feats3), store.gather([4, 4, 5], dtype=np.float16))
    assert svc0.cache.stats()["entries"] == 0


def test_data_parallel_is_refused(tmp_path):
    """JAX's ``test_service_with_data_parallel_matches_single_device``:
    ``--data_parallel 8`` (eight replicas on the CPU here, JAX's emulated
    devices there) answers as the single-device service, over the same
    weights and store. Once the port's refusal, hence the name."""
    _workspace(tmp_path, n_answers=3)
    single, split = (serve_cli.build_service(_args(
        tmp_path, n_answers=3, batch_size=8, data_parallel=n))
        for n in (1, 8))
    assert split.engine.data_parallel == 8
    items = [{"question": q, "image_id": i} for q, i in
             (("what color is the cat", 3), ("is the sky blue", 7),
              ("what is the dog", 11), ("what color", 19), ("the cat", 3))]
    got, want = split.predict_many(items), single.predict_many(items)
    assert got == want and len(got) == len(items)


@pytest.fixture(scope="module")
def server_bank(tmp_path_factory):
    """The port's services over one int8 store, with the device bank
    (--device_cache_images) and without, the bank one over HTTP, and JAX's
    bank service on the same params and store."""
    path = tmp_path_factory.mktemp("serve_bank")
    vocab, cfg, params = _workspace(path, f16_dir="resnet152_f16",
                                    int8_dir="resnet152_all")

    def build(images):
        return serve_cli.build_service(_args(path,
                                             device_cache_images=images))

    bank, plain = build(len(IMAGE_IDS)), build(0)
    assert bank.bank is not None and plain.bank is None
    ref = jax_cli.VqaService(cfg, vocab, params,
                             JaxStore(str(path / "resnet152_all")), 4, 3,
                             0.0, device_cache_images=len(IMAGE_IDS))
    httpd, url = _serve(bank)
    yield SimpleNamespace(url=url, bank=bank, plain=plain, ref=ref)
    httpd.shutdown()
    httpd.server_close()


def test_device_bank_http_matches_plain_int8_service(server_bank):
    s = server_bank
    for image_id in IMAGE_IDS:
        item = {"image_id": image_id, "question": "what color is the cat"}
        got = _post(s.url, item)
        assert got == s.plain.predict_one(dict(item))  # the same bytes
        _same_as_jax(got, s.ref.predict_one(dict(item)))
    _post(s.url, {"image_id": IMAGE_IDS[0],
                  "question": "what color is the cat"})
    assert s.bank.bank.hits > 0
    assert s.bank.bank.misses <= len(IMAGE_IDS)


def test_device_bank_bulk_mixed_order_preserved(server_bank):
    s = server_bank
    items = [{"image_id": i, "question": q} for i, q in zip(
        [IMAGE_IDS[2], IMAGE_IDS[0], IMAGE_IDS[3], IMAGE_IDS[1],
         IMAGE_IDS[2]],
        ["what color is the cat", "is the sky blue", "what is the dog",
         "what color is the sky", "is the cat black"])]
    got = _post(s.url, {"requests": items})["results"]
    for g, it in zip(got, items):
        _same_result(g, s.plain.predict_one(dict(it)))
    for g, w in zip(got, s.ref.predict_many(items)):
        _same_as_jax(g, w)


def test_device_bank_unknown_image_id_is_400(server_bank):
    assert _status(server_bank.url, "/predict",
                   {"image_id": 9999, "question": "what is this"}) == 400


def test_device_bank_metrics_exported(server_bank):
    with urllib.request.urlopen(server_bank.url + "/metrics",
                                timeout=30) as resp:
        body = resp.read().decode()
    assert "vqa_device_bank_hits_total" in body
    assert "vqa_device_bank_evictions_total" in body


def test_sharded_device_bank_is_refused(tmp_path):
    """JAX's test shards the bank over a data mesh: ``--data_parallel 4``
    with ``--device_cache_images`` splits the bank over the 4 replicas
    (capacity rounded up to a multiple of 4) and answers by id as the
    one-replica bank service does. Once the port's refusal (ROADMAP item
    10b), hence the name."""
    _workspace(tmp_path, n_answers=3, f16_dir="resnet152_f16",
               int8_dir="resnet152_all")
    single, split = (serve_cli.build_service(_args(
        tmp_path, n_answers=3, batch_size=8,
        device_cache_images=len(IMAGE_IDS) + 1, data_parallel=n))
        for n in (1, 4))
    bank = split.engine._cache
    assert bank is not None and len(bank.blocks) == 4
    assert bank.capacity == 8  # 5 rounded up to a multiple of 4
    items = [{"question": q, "image_id": i} for q, i in
             (("what color is the cat", 3), ("is the sky blue", 7),
              ("what is the dog", 11), ("what color", 19), ("the cat", 3))]
    got, want = split.predict_many(items), single.predict_many(items)
    assert got == want and len(got) == len(items)
    assert bank.hits + bank.misses == len(items)


def test_device_bank_requires_int8_store(tmp_path):
    _workspace(tmp_path, n_answers=2)
    with pytest.raises(ValueError, match="int8"):
        serve_cli.build_service(_args(tmp_path, n_answers=2,
                                      device_cache_images=8))


def test_the_card_is_the_default_device(tmp_path):
    """``build_service`` and ``VqaService`` default to the card and raise
    without one: no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default would run on it")
    vocab, cfg, params = _workspace(tmp_path)
    args = _args(tmp_path)
    del args.device
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.build_service(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.VqaService(port_config(cfg), vocab, params,
                             FeatureStore(str(tmp_path / "resnet152_all")),
                             4, 3, 0.0)
    assert serve_cli.parse_args([]).device == "cuda"


def test_served_answers_follow_the_weights_file_after_a_training_step(
        tmp_path):
    """A weights file written after a training step (``Solver.save``, the
    export of ``cli.train``) is what the service serves, read as
    ``build_service`` reads it (``serve.trained_params``; at these small
    widths the service is built directly): bf16 mhb_coAtt, whose K1 layout
    (``MHBCoAtt.prepare``) must be laid out again from the loaded weights.
    Its answers are bit-equal to an engine built on the trained module's
    weights, and differ from those of the weights before the step."""
    from test_torch_port_mhb_coatt import params_for, small_cfg
    from vqa_attention_networks_tpu_torch.data.prepare import (
        make_synthetic_qa_data,
    )
    from vqa_attention_networks_tpu_torch.serve import (
        InferenceEngine,
        trained_params,
    )
    from vqa_attention_networks_tpu_torch.train.solver import Solver

    ids = [0, 1, 2, 3]
    jcfg = small_cfg(a_vocab_size=5, q_vocab_size=9, max_question_length=6)
    cfg = port_config(jcfg).replace(
        compute_dtype="bfloat16", batch_size=4, num_epoch=1, lr=0.05,
        out_dir=str(tmp_path / "models"), checkpoint_every_steps=0)
    vocab = _vocab(answers=ANSWERS)
    with open(tmp_path / "qa_v2_5answers_all.vocab.json", "w") as f:
        json.dump(vocab, f)
    store = make_synthetic_feature_store(
        str(tmp_path / "resnet152_all"), ids,
        channels=jcfg.img_feature_channel)
    qa = make_synthetic_qa_data(np.random.default_rng(0), n_train=4,
                                n_val=4, q_vocab_words=7, num_answers=5,
                                max_len=6, num_images=4)
    initial = params_for(jcfg, seed=22)
    solver = Solver(cfg, qa, store, params=initial, device="cpu")
    solver.train()
    solver.save()
    solver.close()
    assert solver.step == 1
    service = serve_cli.VqaService(
        cfg, vocab, trained_params(cfg, f"{cfg.out_dir}/mhb_coAtt"), store,
        4, 5, 0.0, device="cpu")
    items = [{"question": q, "image_id": i} for i, q in zip(
        ids, ["what color is the cat", "is the sky blue", "what is the dog",
              "the cat"])]
    served = service.predict_many(items)
    feats = store.gather(ids, np.float16)
    ques = np.stack([service._tokenize(it["question"])[0] for it in items])

    def tops(tree):
        engine = InferenceEngine(cfg, tree, batch_size=4, topk=5,
                                 device="cpu")
        return [([ANSWERS[i] for i in p.top_ids], p.top_probs.tolist())
                for p in engine.predict_batch(feats, ques)]

    got = [([t["answer"] for t in r["top"]], [t["prob"] for t in r["top"]])
           for r in served]
    assert got == tops(to_jax_params(solver.model))
    assert got != tops(initial)
