"""mfb, mfb-multilayer and the inference fusion K5 in the port against the
JAX package, on the CPU.

- K5's plain version (``ops/grid_fusion.grid_fuse_reference``) against
  ``_grid_fuse_pallas`` in interpret mode: both take the same operands (bf16
  img, W rounded to bf16, f32 b, bf16 q) with f32 accumulation, so pooled =
  out * |out| (before the signed sqrt, which turns an f32 difference e near
  0 into sqrt(e)) agrees within 1e-5 of its largest |value|: summation
  order only.
- ``grid_fuse``'s bf16 dispatch with and without ``VQA_FORCE_PALLAS``.
- The eval forward against ``mfb.apply`` under ``jax.jit``, for both
  families, with the reference quirk on and off: f32 at 1e-5 of the
  largest |logit| (full f32 on both sides); bf16 (weight-contracted fusion
  on both sides, or K5 under ``VQA_FORCE_PALLAS``: JAX's in interpret mode,
  the port's plain version) with equal argmax and logits within
  ``BF16_LOGIT_ATOL``, a few bf16 ulps of the logit scale (XLA:CPU keeps
  excess precision inside fused bf16 chains where PyTorch rounds after
  each op).
- With the quirk on, the stage-1 fusion is value-dead: zeroing its output
  leaves the logits bit-equal.
- The training forward runs; its parity with JAX is in
  ``test_torch_port_train_pooled.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_mhb_coatt import port_config
from vqa_attention_networks_tpu.config import Config
from vqa_attention_networks_tpu.models import mfb as jmfb
from vqa_attention_networks_tpu.ops.pallas_fusion import (
    _grid_fuse_pallas,
)
from vqa_attention_networks_tpu.ops.pallas_fusion import grid_fuse as j_grid
from vqa_attention_networks_tpu_torch.models import get_model
from vqa_attention_networks_tpu_torch.models.mfb import MFB, init_params
from vqa_attention_networks_tpu_torch.ops import grid_fusion as gf
from vqa_attention_networks_tpu_torch.ops.fusion import (
    grid_fuse_weight_contracted,
)
from vqa_attention_networks_tpu_torch.weights import load_jax_params

N, T = 4, 7
K5_RTOL = 1e-5
F32_RTOL = 1e-5
BF16_LOGIT_ATOL = 1e-2  # measured 6.5e-3 at |logit| <= 0.66 (quirk on)


def small_cfg(**kw) -> Config:
    base = dict(model_name="mfb", q_vocab_size=30, a_vocab_size=20,
                hidden_dim=32, emb_dim=16, img_feature_channel=32,
                mfb_out=20, max_question_length=T)
    base.update(kw)
    return Config(**base).validate()


def params_for(cfg: Config, seed: int = 0) -> dict:
    """A JAX-layout numpy tree: xavier weights and small random biases;
    the co-attention logits scaled so the softmax over the regions is
    peaked when the quirk is off."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                  jmfb.init(jax.random.PRNGKey(seed), cfg))
    for layer in tree.values():
        for leaf in ("b", "b_ih", "b_hh"):
            if leaf in layer:
                layer[leaf] = (rng.standard_normal(layer[leaf].shape)
                               * 0.05).astype(np.float32)
    tree["co_att_conv2"]["w"] = tree["co_att_conv2"]["w"] * 20.0
    return tree


def inputs_for(cfg: Config, seed: int = 1, n: int = N):
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((n, 196, cfg.img_feature_channel))
           * 0.5).astype(np.float32)
    ques = rng.integers(1, cfg.q_vocab_size, (n, T)).astype(np.int32)
    ques[0, 5:] = 0
    return img, ques


def jax_logits(cfg, params, img, ques):
    fwd = jax.jit(lambda p, i, q: jmfb.apply(p, cfg, i, q, train=False)[0])
    return np.asarray(fwd(params, img, ques))


def port_logits(cfg, params, img, ques, **kw):
    model = load_jax_params(get_model(cfg.model_name)(port_config(cfg)),
                            params).eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(img), torch.from_numpy(ques), **kw)
    assert out.dtype == torch.float32 and out.shape == (N, cfg.a_vocab_size)
    return out.numpy()


def fusion_inputs(n=4, l=196, d=32, o=20, k=5, seed=0):
    rng = np.random.default_rng(seed)

    def f(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return (f((n, l, d), 0.5), f((d, o * k), 0.1), f((o * k,), 0.1),
            f((n, o * k), 0.5))


def _pooled(x):
    x = np.asarray(x, np.float64)
    return x * np.abs(x)


def test_k5_plain_version_matches_pallas_interpreted(monkeypatch):
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    img, w, b, q = fusion_inputs()
    want = np.asarray(_grid_fuse_pallas(
        jnp.asarray(img).astype(jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(b), jnp.asarray(q).astype(jnp.bfloat16), 5))
    got = gf.grid_fuse_reference(
        torch.from_numpy(img).to(torch.bfloat16), torch.from_numpy(w),
        torch.from_numpy(b), torch.from_numpy(q).to(torch.bfloat16), 5)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(_pooled(got) - _pooled(want)).max()
    assert err <= K5_RTOL * np.abs(_pooled(want)).max()
    # control: q permuted across samples is rejected
    perm = gf.grid_fuse_reference(
        torch.from_numpy(img).to(torch.bfloat16), torch.from_numpy(w),
        torch.from_numpy(b), torch.from_numpy(q[::-1].copy())
        .to(torch.bfloat16), 5)
    err = np.abs(_pooled(perm) - _pooled(want)).max()
    assert err > 100 * K5_RTOL * np.abs(_pooled(want)).max()


def test_grid_fuse_dispatch_at_bf16(monkeypatch):
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    arrays = fusion_inputs(seed=1)
    img, w, b, q = (torch.from_numpy(a) for a in arrays)
    img, q = img.to(torch.bfloat16), q.to(torch.bfloat16)
    monkeypatch.delenv("VQA_FORCE_PALLAS", raising=False)
    # without the switch: the weight-contracted formulation, bf16
    plain = gf.grid_fuse(img, w, b, q, 5)
    assert plain.dtype == torch.bfloat16
    assert torch.equal(plain, grid_fuse_weight_contracted(img, w, b, q, 5))
    # with it: K5, here its plain version (a CPU tensor), f32, no launch
    monkeypatch.setenv("VQA_FORCE_PALLAS", "1")
    before = gf.launch_count
    got = gf.grid_fuse(img, w, b, q, 5)
    assert gf.launch_count == before
    assert got.dtype == torch.float32
    assert torch.equal(got, gf.grid_fuse_reference(img, w, b, q, 5))
    assert torch.equal(got, gf.grid_fuse(img, w, b, q, 5,
                                         reference_kernel=True))
    jimg = jnp.asarray(arrays[0]).astype(jnp.bfloat16)
    jq = jnp.asarray(arrays[3]).astype(jnp.bfloat16)
    want = np.asarray(j_grid(jimg, {"w": jnp.asarray(arrays[1]),
                                    "b": jnp.asarray(arrays[2])}, jq, 5))
    assert want.dtype == np.float32  # JAX took its K5 too
    err = np.abs(_pooled(got) - _pooled(want)).max()
    assert err <= K5_RTOL * np.abs(_pooled(want)).max()


@pytest.mark.parametrize("quirk", [True, False], ids=["quirk", "no_quirk"])
@pytest.mark.parametrize("name", ["mfb", "mfb-multilayer"])
def test_f32_forward_matches_jax(name, quirk):
    cfg = small_cfg(model_name=name, keep_reference_quirks=quirk)
    params = params_for(cfg)
    img, ques = inputs_for(cfg)
    want = jax_logits(cfg, params, img, ques)
    got = port_logits(cfg, params, img, ques)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_RTOL * np.abs(want).max())


@pytest.mark.parametrize("force_k5", [False, True], ids=["contracted", "k5"])
@pytest.mark.parametrize("quirk", [True, False], ids=["quirk", "no_quirk"])
@pytest.mark.parametrize("name", ["mfb", "mfb-multilayer"])
def test_bf16_forward_matches_jax(monkeypatch, name, quirk, force_k5):
    if force_k5:
        monkeypatch.setenv("VQA_FORCE_PALLAS", "1")
        monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("VQA_FORCE_PALLAS", raising=False)
    cfg = small_cfg(model_name=name, keep_reference_quirks=quirk,
                    compute_dtype="bfloat16")
    params = params_for(cfg, seed=2)
    img, ques = inputs_for(cfg, seed=3)
    want = jax_logits(cfg, params, img, ques)
    got = port_logits(cfg, params, img, ques)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LOGIT_ATOL)
    if force_k5:
        np.testing.assert_array_equal(
            port_logits(cfg, params, img, ques, reference_kernels=True), got)


def test_quirk_makes_the_stage1_fusion_value_dead(monkeypatch):
    monkeypatch.setenv("VQA_FORCE_PALLAS", "1")
    cfg = small_cfg(compute_dtype="bfloat16")
    params = params_for(cfg, seed=4)
    img, ques = inputs_for(cfg, seed=5)
    zero = dict(params, img_conv1d={
        "w": np.zeros_like(params["img_conv1d"]["w"]),
        "b": np.zeros_like(params["img_conv1d"]["b"])})  # fusion output 0
    np.testing.assert_array_equal(port_logits(cfg, params, img, ques),
                                  port_logits(cfg, zero, img, ques))
    # with the quirk off the fusion reaches the logits
    cfg = cfg.replace(keep_reference_quirks=False)
    assert not np.array_equal(port_logits(cfg, params, img, ques),
                              port_logits(cfg, zero, img, ques))


def test_training_forward_is_not_ported():
    """The training forward runs (the test keeps the name it had while the
    forward raised): with its dropout rates at 0 at the pre-pool site it
    gives the eval forward's logits (the same composed chain at f32); with
    dropout on, other finite logits, a function of the generator's seed."""
    cfg = small_cfg(dropout_lstm=0.0, dropout_fusion=0.0)
    model = load_jax_params(MFB(port_config(cfg)), params_for(cfg))
    img, ques = (torch.from_numpy(x) for x in inputs_for(cfg, n=2))
    with torch.no_grad():
        eval_logits = model(img, ques)
        train_logits = model(img, ques, train=True,
                             generator=torch.Generator(), fusion_seed=0)
    assert torch.equal(train_logits, eval_logits)
    cfg = small_cfg()
    model = load_jax_params(MFB(port_config(cfg)), params_for(cfg))

    def train(seed):
        with torch.no_grad():
            return model(img, ques, train=True,
                         generator=torch.Generator().manual_seed(seed),
                         fusion_seed=0)

    out = train(0)
    assert torch.isfinite(out).all() and out.shape == eval_logits.shape
    assert torch.equal(out, train(0))
    assert not torch.equal(out, train(1))
    assert not torch.equal(out, eval_logits)


@pytest.mark.parametrize("name", ["mfb", "mfb-multilayer"])
def test_init_params_loads_into_both_packages(name):
    cfg = small_cfg(model_name=name)
    tree = init_params(port_config(cfg), torch.Generator().manual_seed(0))
    ref = jmfb.init(jax.random.PRNGKey(0), cfg)
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), tree)
    assert shapes == jax.tree_util.tree_map(lambda x: tuple(x.shape), ref)
    load_jax_params(MFB(port_config(cfg)), tree)


@pytest.mark.parametrize("name", ["mfb", "mfb-multilayer"])
def test_aux_attention_logits_match_jax(name):
    """``aux=True`` gives the two glimpses' attention logits, as JAX's
    ``apply`` does (``cli.predict --dump_attention`` writes them): the
    question's [N, T, 2] and the co-attention's [N, 196, 2], f32 at
    ``F32_RTOL`` of each map's largest |value|. (The port returned an empty
    dict here, so a dump of mfb wrote nothing.)"""
    cfg = small_cfg(model_name=name, keep_reference_quirks=False)
    params = params_for(cfg, seed=6)
    img, ques = inputs_for(cfg, seed=7)
    _, want = jmfb.apply(params, cfg, img, ques, train=False)
    model = load_jax_params(MFB(port_config(cfg)), params).eval()
    with torch.inference_mode():
        logits, got = model(torch.from_numpy(img), torch.from_numpy(ques),
                            aux=True)
    assert logits.shape == (N, cfg.a_vocab_size)
    assert sorted(got) == sorted(want) == ["co_att_logits", "q_att_logits"]
    assert got["q_att_logits"].shape == (N, T, 2)
    assert got["co_att_logits"].shape == (N, 196, 2)
    for key, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[key].float().numpy(), w, rtol=0,
                                   atol=F32_RTOL * np.abs(w).max())
