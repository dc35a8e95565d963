"""Pooled-site training (``Config.dropout_site="pooled"``) of mhb_coAtt, and
the training forward of mfb and mfb-multilayer at both sites, against the
JAX package on the same weights and batches, dropout off (the two packages
draw their masks from different generators).

- mhb_coAtt, f64: per-step losses over 8 steps at rtol 1e-6 and the
  parameters after 1 and 8 steps, as ``test_torch_port_train_step.py``
  holds the pre-pool site (the same ``UPDATE_RTOL``). At f64 the pooled
  chain passes through f32 on both sides (JAX's
  ``preferred_element_type=f32``), with the same roundings.
- mhb_coAtt, bf16: one step's gradients with K3 on both sides (the port's
  plain version, JAX's kernel in interpret mode), per leaf within
  ``BF16_GRAD_RTOL`` in relative norm, but the leaves whose bf16 gradient
  is rounding noise through a signed sqrt near 0, which are checked finite
  (``test_torch_port_train_step.py`` says why). At the pooled site the
  co-attention convs compute in bf16 on both sides.
- mfb and mfb-multilayer, f32, at both sites and both quirk settings: one
  step's loss at rtol 1e-5 and every gradient within ``F32_GRAD_RTOL`` of
  JAX's in relative norm (full f32 on both sides; summation order). With the quirk
  on the stage-1 fusion is gradient-dead: img_conv1d, ques_proj1 and both
  attention stacks get no gradient in the port (None) and exactly zero in
  JAX.
- mfb and mfb-multilayer, bf16, quirk off, at both sites (K3 on both sides
  at the pooled site; the composed chain on both at the pre-pool site,
  whose K2 needs a dropout rate above 0): one step's gradients, per leaf
  within ``BF16_GRAD_RTOL`` of JAX's or within twice the distance between
  JAX's own bf16 and f32 gradients, whichever is larger. mfb's small
  attention-stack leaves carry bf16 noise of 10-40% in both packages (JAX
  bf16 against JAX f32), so a fixed bound cannot be tighter there; a
  wrong gradient lands far outside both. Seed 4: at seeds whose final
  fusion has a |pooled| near 0 the gradients after it are rounding noise
  (seed 1: ques_proj2/b 16% from JAX's, whose own bf16 gradient is 1.4%
  from its f32 one).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_mhb_coatt import port_config
from test_torch_port_mfb import params_for as mfb_params_for
from test_torch_port_mfb import small_cfg as mfb_small_cfg
from test_torch_port_train_step import (
    BF16_GRAD_RTOL,
    BF16_NOISE_LEAVES,
    LR,
    UPDATE_RTOL,
    _x64,
    batches,
)
from test_torch_port_train_step import small_cfg as mhb_small_cfg
from vqa_attention_networks_tpu.models import get_model as j_get_model
from vqa_attention_networks_tpu.train.losses import (
    soft_cross_entropy as j_soft_ce,
)
from vqa_attention_networks_tpu_torch.models import get_model
from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf
from vqa_attention_networks_tpu_torch.train.losses import soft_cross_entropy
from vqa_attention_networks_tpu_torch.train.solver import (
    make_optimizer,
    train_step,
)
from vqa_attention_networks_tpu_torch.weights import (
    load_jax_params,
    to_jax_params,
)

# f32: the stage-1 fusion's pooled values include some near 0, where the
# signed sqrt's derivative 0.5/sqrt|pooled| amplifies an f32 summation-order
# difference into its projections' gradients (measured 2.5e-4, img_conv1d/b)
F32_LOSS_RTOL, F32_GRAD_RTOL = 1e-5, 1e-3
# the layers a quirk-on mfb never reaches from the loss: both attention
# stacks (a softmax over a singleton axis weighs every position 1) and with
# the co-attention the stage-1 fusion
DEAD_WITH_QUIRK = ("img_conv1d", "ques_proj1", "co_att_conv1", "co_att_conv2",
                   "co_att_multiconv", "ques_att_conv1", "ques_att_conv2",
                   "ques_att_multiconv")


def _port_grads(model):
    """The gradients of ``model`` as a JAX-layout tree of numpy arrays, and
    the layers that got none (``grad is None``), whose leaves read 0."""
    holder = copy.deepcopy(model)
    none = set()
    with torch.no_grad():
        for (name, p), h in zip(model.named_parameters(),
                                holder.parameters()):
            if p.grad is None:
                none.add(name.split(".")[0])
                h.zero_()
            else:
                h.copy_(p.grad)
    return to_jax_params(holder), none


def _port_step_grads(cfg, params, img, ques, soft):
    model = load_jax_params(get_model(cfg.model_name)(port_config(cfg)),
                            params)
    logits = model(torch.from_numpy(img), torch.from_numpy(ques), train=True,
                   generator=torch.Generator(), fusion_seed=0)
    loss = soft_cross_entropy(logits, torch.from_numpy(soft))
    loss.backward()
    grads, none = _port_grads(model)
    return float(loss.detach()), grads, none


def _jax_step_grads(cfg, params, img, ques, soft):
    model_j = j_get_model(cfg.model_name)

    def loss_fn(p):
        out, _ = model_j.apply(p, cfg, jnp.asarray(img), jnp.asarray(ques),
                               train=True, rng=jax.random.PRNGKey(0))
        return j_soft_ce(out, jnp.asarray(soft))

    loss, grads = jax.value_and_grad(loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params))
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _compare(got, want, rtol, skip=()):
    """Per leaf: finite, the same shape, and (but for ``skip``) the norm of
    the difference within ``rtol`` of the norm of JAX's gradient. Returns
    the number of leaves compared."""
    compared = 0
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            g, w = got[layer][leaf], np.asarray(w, np.float64)
            assert g.shape == w.shape and np.isfinite(g).all(), (layer, leaf)
            if (layer, leaf) in skip:
                continue
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= rtol, (layer, leaf, err)
            compared += 1
    return compared


# --------------------------------------------------------------------------
# mhb_coAtt at the pooled site
# --------------------------------------------------------------------------

def test_mhb_coatt_pooled_site_f64_trajectory_matches_jax():
    cfg = mhb_small_cfg(dropout_site="pooled")
    model_j = j_get_model("mhb_coAtt")
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64),
        model_j.init(jax.random.PRNGKey(0), cfg))
    imgs, quess, softs = batches(8, 0)
    cfg64 = cfg.replace(compute_dtype="float64")

    model = load_jax_params(
        get_model("mhb_coAtt")(port_config(cfg64)).double(), params)
    opt = make_optimizer(model, port_config(cfg))
    port_losses, port_params = [], {}
    for s in range(8):
        soft = torch.from_numpy(softs[s])
        loss, _ = train_step(
            model, opt, lambda out, rows: soft_cross_entropy(out, soft),
            torch.from_numpy(imgs[s]), torch.from_numpy(quess[s]), lr=LR,
            randomness=lambda i: (torch.Generator, 0))
        port_losses.append(float(loss))
        if s + 1 in UPDATE_RTOL:
            port_params[s + 1] = to_jax_params(model)

    def jax_run():
        import optax

        p = jax.tree_util.tree_map(jnp.asarray, params)
        tx = optax.adam(LR)
        o = tx.init(p)
        key = jax.random.PRNGKey(1)  # dropout rates are 0: the key is inert

        @jax.jit
        def step(p, o, img, ques, soft):
            def loss_fn(p):
                logits, _ = model_j.apply(p, cfg64, img, ques, train=True,
                                          rng=key)
                return j_soft_ce(logits, soft)

            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, o = tx.update(grads, o, p)
            return optax.apply_updates(p, updates), o, loss

        losses, trees = [], {}
        for s in range(8):
            p, o, loss = step(p, o, jnp.asarray(imgs[s]),
                              jnp.asarray(quess[s]), jnp.asarray(softs[s]))
            losses.append(float(loss))
            if s + 1 in UPDATE_RTOL:
                trees[s + 1] = jax.tree_util.tree_map(np.asarray, p)
        return losses, trees

    jax_losses, jax_params = _x64(jax_run)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-6)
    assert jax_losses[-1] != jax_losses[0]
    for steps, rtol in UPDATE_RTOL.items():
        for a, b, p0 in zip(jax.tree_util.tree_leaves(port_params[steps]),
                            jax.tree_util.tree_leaves(jax_params[steps]),
                            jax.tree_util.tree_leaves(params)):
            assert a.dtype == np.float64
            moved = np.linalg.norm(b - p0)
            assert np.linalg.norm(a - b) <= rtol * moved + 1e-10, steps


def test_mhb_coatt_pooled_site_bf16_gradients_match_jax(monkeypatch):
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")  # JAX's K3 interpreted
    cfg = mhb_small_cfg(compute_dtype="bfloat16", dropout_site="pooled")
    params = jax.tree_util.tree_map(
        np.asarray, j_get_model("mhb_coAtt").init(jax.random.PRNGKey(4), cfg))
    imgs, quess, softs = batches(1, 4)
    before = dict(pf.launch_count)
    loss, got, none = _port_step_grads(cfg, params, imgs[0], quess[0],
                                       softs[0])
    assert pf.launch_count == before and not none
    want_loss, want = _jax_step_grads(cfg, params, imgs[0], quess[0],
                                      softs[0])
    np.testing.assert_allclose(loss, want_loss, rtol=1e-3)
    assert _compare(got, want, BF16_GRAD_RTOL, BF16_NOISE_LEAVES) == 21


# --------------------------------------------------------------------------
# mfb and mfb-multilayer
# --------------------------------------------------------------------------

def _mfb_case(name, site, quirk, dtype, seed):
    cfg = mfb_small_cfg(model_name=name, keep_reference_quirks=quirk,
                        compute_dtype=dtype, dropout_site=site,
                        dropout_lstm=0.0, dropout_fusion=0.0)
    params = mfb_params_for(cfg, seed=seed)
    rng = np.random.default_rng(seed + 10)
    img = (rng.standard_normal((4, 196, cfg.img_feature_channel))
           * 0.5).astype(np.float32)
    ques = rng.integers(1, cfg.q_vocab_size, (4, cfg.max_question_length))
    soft = rng.random((4, cfg.a_vocab_size))
    return cfg, params, img, ques.astype(np.int32), soft


@pytest.mark.parametrize("quirk", [True, False], ids=["quirk", "no_quirk"])
@pytest.mark.parametrize("site", ["prepool", "pooled"])
@pytest.mark.parametrize("name", ["mfb", "mfb-multilayer"])
def test_mfb_f32_training_step_matches_jax(name, site, quirk):
    cfg, params, img, ques, soft = _mfb_case(name, site, quirk, "float32", 0)
    loss, got, none = _port_step_grads(cfg, params, img, ques, soft)
    want_loss, want = _jax_step_grads(cfg, params, img, ques, soft)
    np.testing.assert_allclose(loss, want_loss, rtol=F32_LOSS_RTOL)
    dead = {layer for layer in DEAD_WITH_QUIRK if layer in want}
    if quirk:
        assert none == dead
        for layer in dead:
            assert all((np.asarray(x) == 0).all()
                       for x in want[layer].values()), layer
        skip = {(layer, leaf) for layer in dead for leaf in want[layer]}
    else:
        assert not none
        skip = set()
    # the two biases a softmax over positions ignores have a gradient of 0
    # up to rounding in both packages
    skip |= {("ques_att_conv2", "b"), ("co_att_conv2", "b")}
    assert _compare(got, want, F32_GRAD_RTOL, skip) == \
        sum(len(v) for v in want.values()) - len(skip)


# leaves whose bf16 gradient is rounding noise through a signed sqrt near 0
# (the stage-1 grid fusion's projections), and the biases a softmax over
# positions ignores
MFB_BF16_NOISE = {("img_conv1d", "w"), ("img_conv1d", "b"),
                  ("ques_proj1", "w"), ("ques_proj1", "b"),
                  ("ques_att_conv2", "b"), ("co_att_conv2", "b")}


@pytest.mark.parametrize("site", ["prepool", "pooled"])
@pytest.mark.parametrize("name", ["mfb", "mfb-multilayer"])
def test_mfb_bf16_training_step_matches_jax(monkeypatch, name, site):
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")  # JAX's K3 interpreted
    cfg, params, img, ques, soft = _mfb_case(name, site, False, "bfloat16",
                                             4)
    loss, got, none = _port_step_grads(cfg, params, img, ques, soft)
    assert not none
    want_loss, want = _jax_step_grads(cfg, params, img, ques, soft)
    _, f32 = _jax_step_grads(cfg.replace(compute_dtype="float32"), params,
                             img, ques, soft)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-3)
    compared = 0
    for layer, leaves in want.items():
        for leaf, w in leaves.items():
            g, w = got[layer][leaf], np.asarray(w, np.float64)
            assert g.shape == w.shape and np.isfinite(g).all(), (layer, leaf)
            if (layer, leaf) in MFB_BF16_NOISE:
                continue
            noise = np.linalg.norm(w - f32[layer][leaf]) / np.linalg.norm(
                f32[layer][leaf])
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= max(BF16_GRAD_RTOL, 2 * noise), (layer, leaf, err,
                                                           noise)
            compared += 1
    assert compared == sum(len(v) for v in want.values()) - \
        len(MFB_BF16_NOISE)
