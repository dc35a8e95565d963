"""hieCoAtten and its co-attention core K4 in the port against the JAX
package, on the CPU.

- K4's plain version (``ops/coattention.coattention_core_reference``)
  against ``coattention_core_pallas`` in interpret mode, bf16 in, N=8, L=16,
  T=5, E=64: av and aq within 2^-7 of their largest value, v and q within
  2^-7 of theirs. The two share their rounding points (C, Hv, Hq rounded to
  bf16 after an f32 tanh); the f32 sums run in another order, which moves
  an element of C, Hv or Hq across a bf16 rounding boundary now and then
  (one bf16 ulp, 2^-8 relative), and that moves a logit and so the maps.
- The whole eval forward against ``hiecoatten.apply`` under ``jax.jit``:
  f32 composed on both sides at 1e-5 of the largest |logit| (summation
  order only), f64 at 1e-10; bf16 through K4's plain version against the
  JAX K4 (interpret): equal argmax and logits within ``BF16_LOGIT_ATOL``,
  a few bf16 ulps of the logit scale (every layer rounds at the same
  points, but XLA:CPU keeps excess precision inside fused bf16 chains).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_mhb_coatt import port_config
from vqa_attention_networks_tpu.config import Config
from vqa_attention_networks_tpu.models import hiecoatten as jhie
from vqa_attention_networks_tpu.ops.pallas_coattention import (
    coattention_core_pallas,
)
from vqa_attention_networks_tpu_torch.models import get_model
from vqa_attention_networks_tpu_torch.models.hiecoatten import (
    HieCoAtten,
    init_params,
)
from vqa_attention_networks_tpu_torch.ops import coattention as co
from vqa_attention_networks_tpu_torch.weights import load_jax_params

N, T = 8, 7
K4_RTOL = 2.0 ** -7
BF16_LOGIT_ATOL = 1e-2  # a few bf16 ulps at |logit| ~ 2.6; measured 5.7e-3


def small_cfg(**kw) -> Config:
    base = dict(model_name="hieCoAtten", q_vocab_size=30, a_vocab_size=20,
                embed_size=64, img_feature_channel=32, max_question_length=T)
    base.update(kw)
    return Config(**base).validate()


def params_for(cfg: Config, seed: int = 0) -> dict:
    """A JAX-layout numpy tree: xavier weights, small random biases, and
    the attention vectors whv/whq scaled so both softmaxes are peaked."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                  jhie.init(jax.random.PRNGKey(seed), cfg))
    for name, layer in tree.items():
        if "b" in layer:
            layer["b"] = (rng.standard_normal(layer["b"].shape)
                          * 0.05).astype(np.float32)
        if name in ("fc_Whv", "fc_Whq"):
            layer["w"] = layer["w"] * 8.0
    tree["que_emb"]["table"] = tree["que_emb"]["table"] * 8.0
    return tree


def inputs_for(cfg: Config, seed: int = 1, n: int = N):
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((n, 196, cfg.img_feature_channel))
           * 0.5).astype(np.float32)
    ques = rng.integers(1, cfg.q_vocab_size, (n, T)).astype(np.int32)
    ques[0, 5:] = 0
    return img, ques


def jax_apply(cfg, params, img, ques):
    fwd = jax.jit(lambda p, i, q: jhie.apply(p, cfg, i, q, train=False))
    logits, aux = fwd(params, img, ques)
    return (np.asarray(logits, np.float64),
            {k: np.asarray(v, np.float64) for k, v in aux.items()})


def port_model(cfg, params):
    return load_jax_params(get_model("hieCoAtten")(port_config(cfg)),
                           params).eval()


def core_inputs(n, l, t, e, seed):
    """bf16-exact core inputs whose two softmaxes are peaked."""
    rng = np.random.default_rng(seed)

    def b(shape, scale):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return np.array(jnp.asarray(x).astype(jnp.bfloat16)
                        .astype(jnp.float32))

    return (b((n, l, e), 0.5), b((n, t, e), 0.5), b((n, l, e), 0.3),
            b((n, t, e), 0.3), b((n, l, e), 0.5), b((n, t, e), 0.5),
            b((e, 1), 0.4), b((e, 1), 0.4))


def test_k4_plain_version_matches_pallas_interpreted(monkeypatch):
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    arrays = core_inputs(8, 16, 5, 64, seed=0)
    want = [np.asarray(x) for x in coattention_core_pallas(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in arrays))]
    before = co.launch_count
    got = co.coattention_core(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in arrays))
    assert co.launch_count == before  # CPU: the plain version
    for name, g, w in zip(("v", "q", "av", "aq"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        g = g.numpy()
        assert np.abs(g - w).max() <= K4_RTOL * np.abs(w).max(), name
    # the inputs peak both softmaxes (uniform would be 1/16 and 1/5)
    assert want[2].max() > 4 / 16 and want[3].max() > 2 / 5
    # control: with whv, whq zeroed the maps are uniform, and the check
    # rejects them
    flat = co.coattention_core(*(torch.from_numpy(a).to(torch.bfloat16)
                                 for a in arrays[:6]),
                               torch.zeros(64, 1), torch.zeros(64, 1))
    for g, w in zip(flat[2:], want[2:]):
        assert np.abs(g.numpy() - w).max() > K4_RTOL * np.abs(w).max()


def test_f32_forward_matches_jax():
    cfg = small_cfg()
    params = params_for(cfg)
    img, ques = inputs_for(cfg)
    want, want_aux = jax_apply(cfg, params, img, ques)
    with torch.inference_mode():
        got, aux = port_model(cfg, params)(
            torch.from_numpy(img), torch.from_numpy(ques), aux=True)
    assert got.dtype == torch.float32 and got.shape == (N, cfg.a_vocab_size)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    for name in ("av", "aq"):
        np.testing.assert_allclose(aux[name].numpy(), want_aux[name],
                                   rtol=0, atol=1e-5)


def test_f64_forward_matches_jax():
    cfg = small_cfg(compute_dtype="float64")
    params = jax.tree_util.tree_map(lambda x: x.astype(np.float64),
                                    params_for(cfg, seed=2))
    img, ques = inputs_for(cfg, seed=3)
    jax.config.update("jax_enable_x64", True)
    try:
        want, want_aux = jax_apply(cfg, params, img.astype(np.float64), ques)
    finally:
        jax.config.update("jax_enable_x64", False)
    model = load_jax_params(HieCoAtten(port_config(cfg)).double(), params)
    with torch.inference_mode():
        got, aux = model(torch.from_numpy(img.astype(np.float64)),
                         torch.from_numpy(ques), aux=True)
    # the logits are cast to f32 on both sides, the maps stay f64
    assert got.dtype == torch.float32 and aux["av"].dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    for name in ("av", "aq"):
        np.testing.assert_allclose(aux[name].numpy(), want_aux[name],
                                   rtol=0, atol=1e-10)


def test_bf16_forward_matches_jax_interpreted_k4(monkeypatch):
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    cfg = small_cfg(compute_dtype="bfloat16")
    params = params_for(cfg, seed=4)
    img, ques = inputs_for(cfg, seed=5)
    want, want_aux = jax_apply(cfg, params, img, ques)
    model = port_model(cfg, params)
    before = co.launch_count
    with torch.inference_mode():
        got, aux = model(torch.from_numpy(img), torch.from_numpy(ques),
                         aux=True)
        again = model(torch.from_numpy(img), torch.from_numpy(ques),
                      reference_kernels=True)
    assert co.launch_count == before
    np.testing.assert_array_equal(got.numpy(), again.numpy())
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BF16_LOGIT_ATOL)
    # the maps are peaked (uniform: 1/196 and 1/7) and agree with JAX's
    assert want_aux["av"].max() > 10 / 196
    for name in ("av", "aq"):
        assert aux[name].dtype == torch.float32
        err = np.abs(aux[name].numpy() - want_aux[name]).max()
        assert err <= 2 * K4_RTOL * want_aux[name].max(), (name, err)


def test_training_forward_is_not_ported(monkeypatch):
    """The training forward is ported now, as the composed chain at any
    dtype (JAX's ``supported`` refuses ``train``): at bf16 it never calls
    K4's dispatch, and with the dropout rate at 0 it gives the composed
    eval forward's logits (``VQA_DISABLE_PALLAS``)."""
    from vqa_attention_networks_tpu_torch.models import hiecoatten as thie

    cfg = small_cfg(compute_dtype="bfloat16", dropout_default=0.0)
    model = port_model(cfg, params_for(cfg))
    img, ques = inputs_for(cfg, n=2)
    args = (torch.from_numpy(img), torch.from_numpy(ques))
    with torch.no_grad():
        with monkeypatch.context() as m:
            m.setattr(thie, "coattention_core", None)  # a call would raise
            trained = model(*args, train=True,
                            generator=torch.Generator())
        with monkeypatch.context() as m:
            m.setenv("VQA_DISABLE_PALLAS", "1")
            composed = model(*args)
    torch.testing.assert_close(trained, composed, rtol=0, atol=0)


def test_init_params_loads_into_both_packages():
    cfg = small_cfg()
    tree = init_params(port_config(cfg), torch.Generator().manual_seed(0))
    ref = jhie.init(jax.random.PRNGKey(0), cfg)
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), tree)
    assert shapes == jax.tree_util.tree_map(lambda x: tuple(x.shape), ref)
    load_jax_params(HieCoAtten(port_config(cfg)), tree)
    jax.jit(lambda p: jhie.apply(p, cfg, *inputs_for(cfg, n=2))[0])(
        jax.tree_util.tree_map(np.asarray, tree))


# K4's shape gate (``coattention.check_shape``, the gate the wrapper and
# ``coattention_launch`` share) against the range of the kernel it
# replaced, whose gate was 1 <= L <= 1024, 1 <= T <= 32, an even E and
# 4 (T L + 9 L + 9 T + 8) + 2 T E bytes of shared memory within 232448.
# The new kernel streams E in slices, so its shared memory does not grow
# with E: it takes every shape the old one took.
def _old_gate_takes(l, t, e):
    return (1 <= l <= 1024 and 1 <= t <= 32 and e >= 2 and e % 2 == 0
            and 4 * (t * l + 9 * l + 9 * t + 8) + 2 * t * e <= 232448)


def _old_gate_max_e(l, t):
    e = (232448 - 4 * (t * l + 9 * l + 9 * t + 8)) // (2 * t)
    return e - e % 2


@pytest.mark.parametrize("n,l,t,e", [
    (256, 196, 22, 512), (3, 1024, 32, 512), (1, 1, 1, 2), (5, 196, 22, 2),
    (7, 1024, 1, 2), (1, 1, 32, 3610), (1, 1, 1, 116170),
    (1, 1024, 32, 970), (2 ** 31 - 1, 196, 22, 512)],
    ids=["production", "l1024_t32_e512", "l1_t1_e2", "e2", "l1024_t1_e2",
         "l1_t32_widest", "l1_t1_widest", "l1024_t32_widest", "n_max"])
def test_k4_gate_takes_the_old_range(n, l, t, e):
    assert _old_gate_takes(l, t, e)
    co.check_shape(n, l, t, e)


@pytest.mark.parametrize("l", [1, 2, 17, 31, 32, 33, 196, 511, 1000, 1024])
def test_k4_gate_takes_every_old_shape_at(l):
    # at each T, E = 2 and the widest even E the old gate took
    for t in range(1, 33):
        for e in (2, _old_gate_max_e(l, t)):
            assert _old_gate_takes(l, t, e), (t, e)
            co.check_shape(1, l, t, e)
    assert co.smem_bytes(l) <= co._MAX_SMEM


@pytest.mark.parametrize("n,l,t,e,match", [
    (8, 196, 33, 512, "T <="), (8, 1025, 22, 512, "L <="),
    (8, 196, 22, 511, "E % 2"), (8, 196, 22, 1, "E % 2"),
    (8, 196, 22, 0, "E % 2"), (8, 196, 0, 512, "T <="),
    (8, 0, 22, 512, "L <="), (0, 196, 22, 512, "N <"),
    (2 ** 31, 196, 22, 512, "N <")],
    ids=["t33", "l1025", "odd_e", "e1", "e0", "t0", "l0", "n0", "n_2_31"])
def test_k4_gate_refuses(n, l, t, e, match):
    with pytest.raises(ValueError, match=match):
        co.check_shape(n, l, t, e)
