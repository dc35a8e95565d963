"""The port's whole mhb_coAtt eval forward against ``mhb_coatt.apply`` under
``jax.jit``, on one parameter tree loaded into both packages.

- f32: atol 1e-4 on the logits (full f32 on both sides; summation order).
- bf16, kernel path: the JAX side runs K1 in Pallas interpret mode
  (``VQA_PALLAS_INTERPRET=1``), the port its plain version of K1 (a CPU
  tensor). Top-1 must be equal; the logits agree to ``BF16_LOGIT_ATOL``,
  which is a few bf16 ulps of the logit scale: every layer rounds at the
  same points on both sides, but XLA:CPU keeps excess f32 precision inside
  fused bf16 elementwise chains (the LSTM gates, the fusions) where
  PyTorch rounds after each op.
- bf16 with ``fast_path="composed"``: the weight-contracted chain on both.
- ``glove=True``: the frozen table concatenated to the embedding.

The JAX side takes the JAX package's ``Config``, the port its own, built
from the same fields (``port_config``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vqa_attention_networks_tpu.config import Config
from vqa_attention_networks_tpu.models import mhb_coatt as jmhb
from vqa_attention_networks_tpu_torch.config import Config as PortConfig
from vqa_attention_networks_tpu_torch.models import get_model
from vqa_attention_networks_tpu_torch.models.mhb_coatt import (
    MHBCoAtt,
    init_params,
)
from vqa_attention_networks_tpu_torch.ops import wq_fusion as wqf
from vqa_attention_networks_tpu_torch.weights import load_jax_params

N, T = 4, 7
BF16_LOGIT_ATOL = 8e-3  # 4 bf16 ulps at |logit| ~ 0.5; measured 3.2e-3


def small_cfg(**kw) -> Config:
    base = dict(
        model_name="mhb_coAtt", q_vocab_size=50, a_vocab_size=40,
        hidden_dim=128, emb_dim=16, img_feature_channel=128, mfb_out=100,
        max_question_length=T,
    )
    base.update(kw)
    return Config(**base).validate()


def port_config(cfg: Config) -> PortConfig:
    """The port's Config with the same fields as the JAX one."""
    return PortConfig(**dataclasses.asdict(cfg)).validate()


def params_for(cfg: Config, seed: int = 0) -> dict:
    """A JAX-layout numpy tree: xavier weights and small random biases."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda x: np.array(x, np.float32),
        jmhb.init(jax.random.PRNGKey(seed), cfg),
    )
    for layer in tree.values():
        if isinstance(layer, dict):
            for leaf in ("b", "b_ih", "b_hh"):
                if leaf in layer:
                    layer[leaf] = (rng.standard_normal(layer[leaf].shape)
                                   * 0.05).astype(np.float32)
    if cfg.glove:
        tree["glove_table"] = (rng.standard_normal(
            tree["glove_table"].shape) * 0.3).astype(np.float32)
    return tree


def inputs_for(cfg: Config, seed: int = 1, n: int = N):
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((n, 196, cfg.img_feature_channel))
           * 0.5).astype(np.float32)
    ques = rng.integers(1, cfg.q_vocab_size, (n, T)).astype(np.int32)
    ques[0, 5:] = 0  # a padded question
    return img, ques


def jax_logits(cfg, params, img, ques):
    fwd = jax.jit(lambda p, i, q: jmhb.apply(p, cfg, i, q, train=False)[0])
    return np.asarray(fwd(params, img, ques))


def port_logits(cfg, params, img, ques, **kw):
    model = load_jax_params(get_model(cfg.model_name)(port_config(cfg)),
                            params).eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(img), torch.from_numpy(ques), **kw)
    assert out.dtype == torch.float32
    return out.numpy()


def test_f32_forward_matches_jax():
    cfg = small_cfg()
    params = params_for(cfg)
    img, ques = inputs_for(cfg)
    want = jax_logits(cfg, params, img, ques)
    got = port_logits(cfg, params, img, ques)
    assert got.shape == (N, cfg.a_vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_bf16_kernel_path_matches_jax_interpreted_k1(monkeypatch):
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    cfg = small_cfg(compute_dtype="bfloat16")
    params = params_for(cfg, seed=2)
    img, ques = inputs_for(cfg, seed=3)
    want = jax_logits(cfg, params, img, ques)
    before = wqf.launch_count
    got = port_logits(cfg, params, img, ques)
    assert wqf.launch_count == before  # CPU: the plain version, no launch
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LOGIT_ATOL)
    # the explicit plain-version switch gives the same result on the CPU
    again = port_logits(cfg, params, img, ques, reference_kernels=True)
    np.testing.assert_array_equal(again, got)


def test_bf16_composed_path_matches_jax():
    cfg = small_cfg(compute_dtype="bfloat16", fast_path="composed")
    params = params_for(cfg, seed=4)
    img, ques = inputs_for(cfg, seed=5)
    want = jax_logits(cfg, params, img, ques)
    got = port_logits(cfg, params, img, ques)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LOGIT_ATOL)


def test_glove_forward_matches_jax():
    cfg = small_cfg(glove=True)
    params = params_for(cfg, seed=6)
    img, ques = inputs_for(cfg, seed=7)
    want = jax_logits(cfg, params, img, ques)
    got = port_logits(cfg, params, img, ques)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_load_jax_params_is_strict():
    cfg = small_cfg()
    params = params_for(cfg)
    model = MHBCoAtt(port_config(cfg))
    extra = dict(params, bogus={"w": np.zeros((1, 1), np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        load_jax_params(model, extra)
    missing = {k: v for k, v in params.items() if k != "linear_pred"}
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(model, missing)
    bad = dict(params, ques_proj1={"w": params["ques_proj1"]["w"].T,
                                   "b": params["ques_proj1"]["b"]})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, bad)


def test_init_params_loads_into_both_packages():
    # the port's torch.Generator init has the JAX tree's structure and shapes
    cfg = small_cfg(glove=True)
    tree = init_params(port_config(cfg), torch.Generator().manual_seed(0))
    ref = jmhb.init(jax.random.PRNGKey(0), cfg)
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), tree)
    assert shapes == jax.tree_util.tree_map(lambda x: tuple(x.shape), ref)
    load_jax_params(MHBCoAtt(port_config(cfg)), tree)


def test_unported_families_name_their_roadmap_item():
    # every family is ported now: each resolves to its module, and only a
    # name outside the eight raises
    from vqa_attention_networks_tpu_torch.config import MODEL_NAMES

    classes = {name: get_model(name).__name__ for name in MODEL_NAMES}
    assert classes == {
        "mfb": "MFB", "mfb-multilayer": "MFB", "mhb": "MHB",
        "mhb_coAtt": "MHBCoAtt", "hieCoAtten": "HieCoAtten",
        "visLstm": "VisLstm", "iBOWIMG": "IBOWIMG",
        "attentionNet": "AttentionNet"}
    with pytest.raises(ValueError, match="not supported"):
        get_model("vqa")
