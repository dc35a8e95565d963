"""The port's exported serving artifact (``vqa_attention_networks_tpu_torch/
aot.py``, ``serve.InferenceEngine(artifact_dir=...)``,
``cli/export_serving.py`` and ``cli.serve --aot_artifact``) against the
eager engine and the JAX package's artifact, on the CPU, and the six
custom ops the exported graph calls (K1, K4, K5, K7, MCAN's norm, BAN's
attention map).

- The artifact's program and the eager engine run the same ops on the same
  values: their answers are bit-equal, for the f16 and the int8 feed.
- Against JAX's ``load_serving_artifact`` on the same weights: the
  tolerance of ``test_torch_port_serve.py`` (``PROB_ATOL``; bf16
  activations on both sides).
- The program holds no weight: one exported with weights A and served with
  weights B gives B's answers.
- ``torch.library.opcheck`` runs each op's schema, fake-tensor, autograd
  registration and ``torch.compile`` checks on CPU tensors.

JAX's ``test_tpu_platform_*`` tests have no counterpart: they pin the
``platforms=["tpu"]`` export of a build box without a TPU
(``tpu_lowering``), which exists only for the TPU and is not ported
(``aot.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

import test_torch_port_hiecoatten as hie_t
import test_torch_port_serve_http as http_t
from test_torch_port_mhb_coatt import params_for, port_config, small_cfg
from test_torch_port_serve import PROB_ATOL, _assert_same
from vqa_attention_networks_tpu.aot import (
    load_serving_artifact as jax_load_artifact,
    save_serving_artifact as jax_save_artifact,
)
from vqa_attention_networks_tpu.data.feature_store import quantize_features
from vqa_attention_networks_tpu_torch import aot
from vqa_attention_networks_tpu_torch.cli import export_serving
from vqa_attention_networks_tpu_torch.cli import serve as serve_cli
from vqa_attention_networks_tpu_torch.ops import attention as att
from vqa_attention_networks_tpu_torch.ops import coattention as co
from vqa_attention_networks_tpu_torch.ops import grid_fusion as gf
from vqa_attention_networks_tpu_torch.ops import ban_attention, mcan_norm
from vqa_attention_networks_tpu_torch.ops import wq_fusion as wqf
from vqa_attention_networks_tpu_torch.serve import InferenceEngine
from vqa_attention_networks_tpu_torch.train.solver import init_params

B, TOPK = 8, 5


def _cfg(**kw):
    """The JAX and the port's Config of a small bf16 mhb_coAtt."""
    cfg = small_cfg(compute_dtype="bfloat16", **kw)
    return cfg, port_config(cfg)


def _requests(cfg, n, seed):
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((n, 196, cfg.img_feature_channel))
           * 0.5).astype(np.float16)
    ques = rng.integers(1, cfg.q_vocab_size,
                        (n, cfg.max_question_length)).astype(np.int32)
    ques[0, 4:] = 0
    qlen = (ques != 0).sum(axis=1).astype(np.int32)
    return img, ques, qlen


def _save(path, cfg, params, input_dtype="float16", **kw):
    return aot.save_serving_artifact(str(path), cfg, params, B, TOPK,
                                     input_dtype, device="cpu", **kw)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.answer_id == w.answer_id
        np.testing.assert_array_equal(g.top_ids, w.top_ids)
        np.testing.assert_array_equal(g.top_probs, w.top_probs)


@pytest.mark.parametrize("input_dtype", ["float16", "int8"])
def test_artifact_roundtrip_is_bit_equal_to_the_eager_engine(tmp_path,
                                                             input_dtype):
    jcfg, cfg = _cfg()
    params = params_for(jcfg, seed=0)
    _save(tmp_path / "aot", cfg, params, input_dtype)
    program, meta = aot.load_serving_artifact(str(tmp_path / "aot"))
    assert (meta["model_name"], meta["batch_size"], meta["input_dtype"],
            meta["device"]) == ("mhb_coAtt", B, input_dtype, "cpu")
    # the weights stay out: the program file is the graph alone
    size = os.path.getsize(tmp_path / "aot" / "serving.pt2")
    weights = sum(np.asarray(v).nbytes for layer in params.values()
                  for v in (layer.values() if isinstance(layer, dict)
                            else [layer]))
    assert size < weights / 4
    eager = InferenceEngine(cfg, params, batch_size=B, topk=TOPK,
                            input_dtype=input_dtype, device="cpu")
    img, ques, qlen = _requests(cfg, B, seed=1)
    feats = [torch.from_numpy(img)]
    if input_dtype == "int8":
        q8, scale, _ = quantize_features(img.astype(np.float32))
        feats = [torch.from_numpy(q8), torch.from_numpy(scale)]
    args = [*feats, torch.from_numpy(ques), torch.from_numpy(qlen)]
    with torch.inference_mode():
        got = program(aot.model_state(eager.model), *args)
        want = eager._fwd(eager.model, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("input_dtype", ["float16", "int8"])
def test_engine_serves_from_the_artifact(tmp_path, input_dtype):
    jcfg, cfg = _cfg()
    params = params_for(jcfg, seed=0)
    _save(tmp_path / "aot", cfg, params, input_dtype)
    kw = dict(batch_size=B, topk=TOPK, input_dtype=input_dtype, device="cpu")
    served = InferenceEngine(cfg, params, artifact_dir=str(tmp_path / "aot"),
                             **kw)
    eager = InferenceEngine(cfg, params, **kw)
    img, ques, qlen = _requests(cfg, 5, seed=2)  # under the batch: padded
    scale = None
    if input_dtype == "int8":
        img, scale, _ = quantize_features(img.astype(np.float32))
    got = served.predict_batch(img, ques, qlen, feature_scale=scale)
    assert len(got) == 5
    _equal(got, eager.predict_batch(img, ques, qlen, feature_scale=scale))
    item = (img, ques, qlen) + ((scale,) if scale is not None else ())
    _equal(next(served.predict_stream(iter([item]))), got)


# key -> (the engine's Config fields, its keyword arguments) that differ
# from the exported program's
MISMATCHES = {
    "model_name": ({"model_name": "mhb"}, {}),
    "batch_size": ({}, {"batch_size": 2 * B}),
    "topk": ({}, {"topk": 3}),
    "q_vocab_size": ({"q_vocab_size": 51}, {}),
    "a_vocab_size": ({"a_vocab_size": 41}, {}),
    "max_question_length": ({"max_question_length": 8}, {}),
    "img_feature_channel": ({"img_feature_channel": 64}, {}),
    "input_dtype": ({}, {"input_dtype": "int8"}),
}


@pytest.mark.parametrize("key", sorted(MISMATCHES))
def test_each_metadata_mismatch_is_refused(tmp_path, key):
    jcfg, cfg = _cfg()
    _save(tmp_path / "aot", cfg, params_for(jcfg, seed=0))
    fields, engine_kw = MISMATCHES[key]
    other = cfg.replace(**fields)
    params = init_params(other, torch.Generator().manual_seed(0))
    kw = dict(batch_size=B, topk=TOPK, device="cpu")
    kw.update(engine_kw)
    with pytest.raises(ValueError, match=key):
        InferenceEngine(other, params, artifact_dir=str(tmp_path / "aot"),
                        **kw)


def test_metadata_of_another_device_is_refused(tmp_path):
    jcfg, cfg = _cfg()
    params = params_for(jcfg, seed=0)
    _save(tmp_path / "aot", cfg, params)
    meta_path = tmp_path / "aot" / "serving.json"
    meta = json.loads(meta_path.read_text())
    meta_path.write_text(json.dumps(dict(meta, device="cuda")))
    with pytest.raises(ValueError, match="device"):
        InferenceEngine(cfg, params, batch_size=B, topk=TOPK, device="cpu",
                        artifact_dir=str(tmp_path / "aot"))


def test_the_device_cache_is_refused_with_an_artifact(tmp_path):
    jcfg, cfg = _cfg()
    params = params_for(jcfg, seed=0)
    _save(tmp_path / "aot", cfg, params, "int8")
    engine = InferenceEngine(cfg, params, batch_size=B, topk=TOPK,
                             input_dtype="int8", device="cpu",
                             artifact_dir=str(tmp_path / "aot"))
    with pytest.raises(ValueError, match="eager engine"):
        engine.attach_feature_cache(16, lambda ids: None)


def test_weights_come_from_the_weights_file(tmp_path):
    """A program exported with weights A and served with weights B answers
    as B does, and not as A does."""
    jcfg, cfg = _cfg()
    a, b = params_for(jcfg, seed=0), params_for(jcfg, seed=3)
    _save(tmp_path / "aot", cfg, a)
    img, ques, qlen = _requests(cfg, B, seed=4)
    kw = dict(batch_size=B, topk=TOPK, device="cpu")
    got = InferenceEngine(cfg, b, artifact_dir=str(tmp_path / "aot"),
                          **kw).predict_batch(img, ques, qlen)
    _equal(got, InferenceEngine(cfg, b, **kw).predict_batch(img, ques, qlen))
    from_a = InferenceEngine(cfg, a, **kw).predict_batch(img, ques, qlen)
    assert not all(np.array_equal(g.top_probs, w.top_probs)
                   for g, w in zip(got, from_a))


@pytest.mark.parametrize("family", ["mhb_coAtt", "hieCoAtten"])
def test_fast_path_traced_at_bf16(tmp_path, monkeypatch, family):
    """The graph calls K1 (mhb_coAtt) or K4 (hieCoAtten), and the metadata
    says so; exported under VQA_DISABLE_PALLAS it calls neither, and the
    engine, whose own forward would call the kernel, refuses it."""
    if family == "mhb_coAtt":
        jcfg, cfg = _cfg()
        params, op = params_for(jcfg), "vqa.stage1_coattention.default"
    else:
        jcfg = hie_t.small_cfg(compute_dtype="bfloat16")
        cfg, params = port_config(jcfg), hie_t.params_for(jcfg)
        op = "vqa.coattention_core.default"
    monkeypatch.delenv("VQA_DISABLE_PALLAS", raising=False)
    exported = aot.export_serving(cfg, params, B, device="cpu")
    assert op in aot.graph_ops(exported)
    _save(tmp_path / "on", cfg, params)
    meta = json.loads((tmp_path / "on" / "serving.json").read_text())
    assert meta["fast_path_traced"] is True and meta["kernel_ops"] == [op]
    monkeypatch.setenv("VQA_DISABLE_PALLAS", "1")
    _save(tmp_path / "off", cfg, params)
    meta = json.loads((tmp_path / "off" / "serving.json").read_text())
    assert meta["fast_path_traced"] is False and meta["kernel_ops"] == []
    monkeypatch.delenv("VQA_DISABLE_PALLAS")
    with pytest.raises(ValueError, match="fast_path_traced"):
        InferenceEngine(cfg, params, batch_size=B, topk=TOPK, device="cpu",
                        artifact_dir=str(tmp_path / "off"))


@pytest.mark.parametrize("family", ["mhb_coAtt", "hieCoAtten"])
def test_an_f32_artifact_is_refused_for_its_dtype(tmp_path, monkeypatch,
                                                  family):
    """K1 and K4 run at bf16 only, so an f32 graph calls neither
    (``fast_path_traced=false``). The engine serves at bf16, as JAX's does:
    it refuses the artifact for its compute dtype, and not as one exported
    without the kernel."""
    if family == "mhb_coAtt":
        jcfg = small_cfg(compute_dtype="float32")
        cfg, params = port_config(jcfg), params_for(jcfg)
    else:
        jcfg = hie_t.small_cfg(compute_dtype="float32")
        cfg, params = port_config(jcfg), hie_t.params_for(jcfg)
    monkeypatch.delenv("VQA_DISABLE_PALLAS", raising=False)
    _save(tmp_path / "aot", cfg, params)
    meta = json.loads((tmp_path / "aot" / "serving.json").read_text())
    assert meta["fast_path_traced"] is False and meta["kernel_ops"] == []
    with pytest.raises(ValueError, match="compute_dtype='float32'"):
        InferenceEngine(cfg, params, batch_size=B, topk=TOPK, device="cpu",
                        artifact_dir=str(tmp_path / "aot"))


def test_the_artifact_matches_jax_artifact(tmp_path, monkeypatch):
    """The port's and JAX's artifacts on the same weights and requests:
    JAX's runs its composed chain on the CPU, the port's K1's plain
    version; within ``test_torch_port_serve.py``'s tolerance."""
    jcfg, cfg = _cfg()
    params = params_for(jcfg, seed=0)
    _save(tmp_path / "port", cfg, params)
    jax_save_artifact(str(tmp_path / "jax"), jcfg, params, B, topk=TOPK)
    jax_fwd, jax_meta = jax_load_artifact(str(tmp_path / "jax"))
    port = InferenceEngine(cfg, params, batch_size=B, topk=TOPK,
                           device="cpu", artifact_dir=str(tmp_path / "port"))
    port_meta = json.loads((tmp_path / "port" / "serving.json").read_text())
    shared = set(jax_meta) - {"platforms", "fast_path_traced", "config"}
    assert {k: port_meta[k] for k in shared} == \
        {k: jax_meta[k] for k in shared}
    img, ques, qlen = _requests(cfg, B, seed=5)
    top_i, top_p = (np.asarray(x) for x in jax_fwd(params, img, ques, qlen))
    got = port.predict_batch(img, ques, qlen)

    class _Pred:
        def __init__(self, i, p):
            self.top_ids, self.top_probs, self.answer_id = i, p, int(i[0])

    _assert_same(got, [_Pred(i, p) for i, p in zip(top_i, top_p)],
                 atol=PROB_ATOL)


def test_export_then_serve_through_the_clis(tmp_path):
    """``cli.export_serving`` writes the artifact from the weights file
    ``cli.train`` exports (an int8 store gives the int8 feed), then
    ``cli.serve --aot_artifact`` answers as the eager service."""
    # the program's grid is Config's 196 regions, as JAX's
    http_t._workspace(tmp_path, f16_dir="resnet152_f16",
                      int8_dir="resnet152_all", regions=196)
    export_serving.main([
        "--model_name", http_t.MODEL, "--model_dir", str(tmp_path / "models"),
        "--data_dir", str(tmp_path), "--num_answer", "5", "--batch_size",
        "4", "--topk", "3", "--device", "cpu", "--out",
        str(tmp_path / "aot")])
    meta = json.loads((tmp_path / "aot" / "serving.json").read_text())
    assert (meta["input_dtype"], meta["batch_size"], meta["topk"]) == (
        "int8", 4, 3)
    served = serve_cli.build_service(http_t._args(
        tmp_path, aot_artifact=str(tmp_path / "aot")))
    eager = serve_cli.build_service(http_t._args(tmp_path))
    httpd, url = http_t._serve(served)
    try:
        for image_id in http_t.IMAGE_IDS:
            payload = {"question": "what color is the cat",
                       "image_id": image_id}
            got = http_t._post(url, payload)
            want = eager.predict_one(payload)
            assert got["answer"] == want["answer"]
            assert got["top"] == want["top"]
    finally:
        httpd.shutdown()
        httpd.server_close()
    with pytest.raises(ValueError, match="eager engine"):
        serve_cli.build_service(http_t._args(
            tmp_path, aot_artifact=str(tmp_path / "aot"),
            device_cache_images=4))


def _k1_args(g):
    n, l, d, k, o, c = 2, 6, 16, 5, 8, 12
    sw = wqf.prepare_stage1_weights(
        torch.randn(d, o * k, generator=g) * 0.1,
        torch.randn(o * k, generator=g) * 0.1, torch.randn(o, c, generator=g),
        torch.zeros(c), torch.randn(c, 2, generator=g), torch.zeros(2), k)
    img = torch.randn(n, l, d, generator=g).to(torch.bfloat16)
    q = torch.randn(n, o * k, generator=g)
    return (img, q, sw.w3, sw.b3, sw.c1w, sw.c1b, sw.c2w, sw.c2b, sw.o,
            sw.k), wqf.stage1_coattention_reference(img, q, sw)


def _k4_args(g):
    n, l, t, e = 2, 6, 4, 8
    shapes = [(n, l, e), (n, t, e), (n, l, e), (n, t, e), (n, l, e),
              (n, t, e)]
    args = tuple(torch.randn(s, generator=g).to(torch.bfloat16)
                 for s in shapes) + (torch.randn(e, 1, generator=g),
                                     torch.randn(e, 1, generator=g))
    return args, co.coattention_core_reference(*args)


def _k5_args(g):
    img = torch.randn(2, 6, 16, generator=g).to(torch.bfloat16)
    w, b = torch.randn(16, 40, generator=g), torch.randn(40, generator=g)
    q = torch.randn(2, 40, generator=g)
    return (img, w, b, q, 5), gf.grid_fuse_reference(img, w, b, q, 5)


def _k7_args(g):
    x = torch.randn(2, 6, 12, generator=g).to(torch.bfloat16)
    v = torch.randn(2, 6, 16, generator=g).to(torch.bfloat16)
    w1, b1 = torch.randn(10, 12, generator=g), torch.randn(10, generator=g)
    w2, b2 = torch.randn(2, 10, generator=g), torch.randn(2, generator=g)
    return (x, w1, b1, w2, b2, v, True), att.glimpse_attention_reference(
        x, w1, b1, w2, b2, v, uniform_quirk=True)


def _norm_args(g):
    x = torch.randn(2, 5, 16, generator=g).to(torch.bfloat16)
    r = torch.randn(2, 5, 16, generator=g).to(torch.bfloat16)
    w, b = torch.randn(16, generator=g), torch.randn(16, generator=g)
    return (x, r, w, b, 1e-6), mcan_norm.add_layernorm_composed(x, r, w, b)


def _ban_args(g):
    av = torch.relu(torch.randn(2, 7, 64, generator=g)).to(torch.bfloat16)
    aq = torch.relu(torch.randn(2, 3, 64, generator=g)).to(torch.bfloat16)
    h, hb = torch.randn(2, 64, generator=g), torch.randn(2, generator=g)
    mask = torch.zeros(2, 7, dtype=torch.bool)
    mask[1, 2] = True
    return (av, aq, h, hb, mask), ban_attention.attention_map_composed(
        av, aq, h, hb, mask)


@pytest.mark.parametrize("op,make", [
    (wqf.stage1_coattention_op, _k1_args),
    (co.coattention_core_op, _k4_args),
    (gf.inference_fusion_op, _k5_args),
    (att.glimpse_attention_op, _k7_args),
    (mcan_norm.add_layernorm_op, _norm_args),
    (ban_attention.attention_map_op, _ban_args),
], ids=["K1", "K4", "K5", "K7", "mcan_norm", "ban_attention"])
def test_custom_op_passes_opcheck_and_is_its_plain_version(op, make):
    args, plain = make(torch.Generator().manual_seed(0))
    torch.library.opcheck(op, args)
    got = op(*args)
    for g, w in zip(*((got, plain) if isinstance(got, tuple)
                      else ((got,), (plain,)))):
        assert torch.equal(g, w)
