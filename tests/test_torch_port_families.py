"""The four families ported last (mhb, visLstm, iBOWIMG, attentionNet) and
hieCoAtten's training forward, against the JAX package on the CPU, on one
numpy-seeded parameter tree loaded into both (``weights.load_jax_params``)
and the same inputs.

- Eval forward at f32 (JAX at ``Precision.HIGHEST``, the port with TF32
  off): logits within ``F32_ATOL`` of the largest |logit| (measured
  1.2e-7 to 5.2e-7), summation order only. At bf16: logits within
  ``BF16_ATOL`` of the largest |logit|, a few bf16 ulps (measured 2.5e-3
  to 9.4e-3): every layer rounds at the same points on both sides, but
  XLA:CPU keeps excess f32 precision inside fused bf16 elementwise chains
  (the LSTM gates, the attention sums) where PyTorch rounds after each op.
- Training forward at f32 with the dropout rates at 0 and a ``valid``
  mask with pad rows: logits and batch-norm statistics, the same bound.
- One Adam step (optax's defaults, the JAX Solver's step with
  ``_merge_batch_stats``) at f32 and f64 on the same batch, then a second
  step on a padded batch (its last rows duplicates with ``valid`` = 0, as
  the data pipeline pads an epoch's last batch): both losses, the
  parameters and running statistics after the first step, and for iBOWIMG
  and attentionNet the running statistics after the second (the running
  mean within what a noise leaf, below, moves it: ``BN_MOMENTUM`` times 2
  ``LR``). Parameters are held per leaf: the
  norm of the difference within ``STEP_RTOL`` of the norm of JAX's update.
  At f32 a bias whose gradient is 0 up to rounding (a softmax over
  positions ignores it, or a train-mode batch norm subtracts it) takes an
  Adam step of noise/(|noise| + eps), anywhere up to the learning rate, on
  both sides: those leaves are held only to move at most ``LR``. So are
  attentionNet's first two attention vectors at f32: in the decomposed
  score the query's term is constant over the softmax's axis, so a layer's
  map depends on its attended features alone, and the first two layers
  reach the output only through the residual features, with gradients of
  ~1e-8, the size of Adam's eps, where f32 rounding sets the step. At f64
  those gradients are ~1e-17 (or agree to f32 precision) and the leaves
  are held, except attentionNet's ``fc`` bias: its batch norm runs on the
  f32 logits at any compute dtype.
- MHB with a zero-length question reads step 0 (the clamp), and a length
  changes its answer; visLstm with the image token first and last.
- Dropout: each family draws its masks at the JAX function's sites, in its
  order, with the same shapes and rates (both packages' ``dropout``
  recorded); the port's keep rate is held by statistics, and every kept
  element is x / keep (the two packages' mask bits differ by design).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_mhb_coatt import port_config
from vqa_attention_networks_tpu.config import Config
from vqa_attention_networks_tpu.models import get_model as j_get_model
from vqa_attention_networks_tpu.models import layers as JL
from vqa_attention_networks_tpu.train import losses as j_losses
from vqa_attention_networks_tpu.train.solver import _merge_batch_stats
from vqa_attention_networks_tpu_torch.models import get_model
from vqa_attention_networks_tpu_torch.models import layers as TL
from vqa_attention_networks_tpu_torch.train import losses as t_losses
from vqa_attention_networks_tpu_torch.train.solver import (
    BN_MOMENTUM,
    make_optimizer,
    train_step,
)
from vqa_attention_networks_tpu_torch.weights import (
    load_jax_params,
    to_jax_params,
)

N, T, D = 8, 7, 32
NEW = ("mhb", "visLstm", "iBOWIMG", "attentionNet")
TRAINED = NEW + ("hieCoAtten",)
BATCH_NORM = {"iBOWIMG": ("img_bn",), "attentionNet": ("batchnorm",)}
F32_ATOL = 1e-5  # of the largest |logit|
BF16_ATOL = 2.0 ** -5  # of the largest |logit|: a few bf16 ulps
LR = 7e-4
STEP_RTOL = {"float32": 2e-3, "float64": 1e-4}
STEP_ATOL = {"float32": 1e-12, "float64": 1e-10}
LOSS_RTOL = {"float32": 1e-5, "float64": 1e-6}  # f32 logits on both sides
# leaves whose Adam step is set by rounding (see the module docstring)
NOISE_LEAVES = {
    "float32": {
        "hieCoAtten": {("fc_Whv", "b"), ("fc_Whq", "b")},
        "iBOWIMG": {("img_emb", "b")},
        "attentionNet": {("fc", "b")}
        | {(f"att{i}", "att", "fc", "b") for i in range(4)}
        | {(f"att{i}", "att", "fc", "w") for i in range(2)},
    },
    # attentionNet's batch norm runs on the f32 logits at any dtype
    "float64": {"attentionNet": {("fc", "b")}},
}


def small_cfg(name: str, **kw) -> Config:
    base = dict(model_name=name, q_vocab_size=30, a_vocab_size=20,
                hidden_dim=16, emb_dim=8, img_feature_channel=D,
                embed_size=16, mfb_factor=5, mfb_out=8,
                max_question_length=T, att_num=4, dropout_default=0.0,
                dropout_lstm=0.0, dropout_fusion=0.0)
    base.update(kw)
    return Config(**base).validate()


def params_for(cfg: Config, seed: int = 0) -> dict:
    """A JAX-layout numpy tree: the family's init, small random biases and
    batch-norm leaves away from their defaults."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda x: np.array(x, np.float32),
        j_get_model(cfg.model_name).init(jax.random.PRNGKey(seed), cfg))

    def visit(node):
        for key, value in node.items():
            if isinstance(value, dict):
                visit(value)
            elif key in ("b", "b_ih", "b_hh", "bias", "mean"):
                node[key] = (rng.standard_normal(value.shape)
                             * 0.05).astype(np.float32)
            elif key == "scale":
                node[key] = (1 + 0.1 * rng.standard_normal(
                    value.shape)).astype(np.float32)
            elif key == "var":
                node[key] = rng.uniform(0.5, 1.5, value.shape).astype(
                    np.float32)

    visit(tree)
    return tree


def inputs_for(cfg: Config, seed: int = 1, n: int = N):
    """(img [n, 196, D], ques [n, T], qlen [n]); rows 0 and 1 padded."""
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((n, 196, D)) * 0.5).astype(np.float32)
    ques = rng.integers(1, cfg.q_vocab_size, (n, T)).astype(np.int32)
    ques[0, 3:] = 0
    ques[1, 5:] = 0
    qlen = (ques != 0).sum(1).astype(np.int32)
    return img, ques, qlen


def port_model(cfg: Config, params) -> torch.nn.Module:
    model = get_model(cfg.model_name)(port_config(cfg))
    if cfg.compute_dtype == "float64":
        model = model.double()
    return load_jax_params(model, params)


def jax_apply(cfg, params, img, ques, qlen, train=False, valid=None):
    fn = jax.jit(lambda p, i, q, l, v: j_get_model(cfg.model_name).apply(
        p, cfg, i, q, ques_length=l, train=train,
        rng=jax.random.PRNGKey(0) if train else None, valid=v))
    logits, aux = fn(params, jnp.asarray(img), jnp.asarray(ques),
                     jnp.asarray(qlen), None if valid is None
                     else jnp.asarray(valid))
    return np.asarray(logits, np.float64), aux


def _x64(fn):
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NEW)
def test_eval_forward_matches_jax(name, dtype):
    cfg = small_cfg(name, compute_dtype=dtype)
    params = params_for(cfg)
    img, ques, qlen = inputs_for(cfg)
    want, _ = jax_apply(cfg, params, img, ques, qlen)
    with torch.inference_mode():
        got = port_model(cfg, params).eval()(
            torch.from_numpy(img), torch.from_numpy(ques),
            torch.from_numpy(qlen))
    assert got.dtype == torch.float32 and got.shape == (N, cfg.a_vocab_size)
    atol = (F32_ATOL if dtype == "float32" else BF16_ATOL) * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      want.argmax(-1))


@pytest.mark.parametrize("name", TRAINED)
def test_train_forward_matches_jax(name):
    """Dropout rates 0, pad rows in ``valid``: the logits, and the batch
    statistics (raw mean and unbiased variance over the valid rows)."""
    cfg = small_cfg(name)
    params = params_for(cfg, seed=2)
    img, ques, qlen = inputs_for(cfg, seed=3)
    valid = np.ones(N, bool)
    valid[-3:] = False
    want, want_aux = jax_apply(cfg, params, img, ques, qlen, train=True,
                               valid=valid)
    got, aux = port_model(cfg, params)(
        torch.from_numpy(img), torch.from_numpy(ques), torch.from_numpy(qlen),
        train=True, valid=torch.from_numpy(valid),
        generator=torch.Generator(), fusion_seed=0, aux=True)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=F32_ATOL * np.abs(want).max())
    layers = BATCH_NORM.get(name, ())
    assert sorted(aux.get("batch_stats", {})) == sorted(layers)
    for layer in layers:
        for key in ("mean", "var"):
            w = np.asarray(want_aux["batch_stats"][layer][key])
            g = aux["batch_stats"][layer][key]
            assert g.dtype == torch.float32 and not g.requires_grad
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max())


def _padded(img, ques, qlen, n_valid):
    """The data pipeline's padding: the last valid row repeated."""
    idx = np.minimum(np.arange(N), n_valid - 1)
    return img[idx], ques[idx], qlen[idx], np.arange(N) < n_valid


def _leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", TRAINED)
def test_adam_steps_match_the_jax_solver_step(name, dtype):
    cfg = small_cfg(name, compute_dtype=dtype)
    np_dt = np.float64 if dtype == "float64" else np.float32
    params = jax.tree_util.tree_map(lambda x: x.astype(np_dt),
                                    params_for(cfg, seed=4))
    rng = np.random.default_rng(5)
    img, ques, qlen = inputs_for(cfg, seed=6)
    batches = [(img, ques, qlen, np.ones(N, bool)),
               _padded(*inputs_for(cfg, seed=7), n_valid=5)]
    answers = rng.integers(0, cfg.a_vocab_size, (2, N)).astype(np.int32)
    soft = rng.random((2, N, cfg.a_vocab_size))
    soft /= soft.sum(-1, keepdims=True)

    model = port_model(cfg, params)
    opt = make_optimizer(model, port_config(cfg))
    port_losses, after_one = [], None
    for s, (i, q, l, v) in enumerate(batches):
        ans, sft, vt = (torch.from_numpy(answers[s]).long(),
                        torch.from_numpy(soft[s].astype(np_dt)),
                        torch.from_numpy(v))

        def loss_fn(out, rows, ans=ans, sft=sft, vt=vt):
            if cfg.soft_answer:
                return t_losses.soft_cross_entropy(out, sft, vt)
            return t_losses.cross_entropy(out, ans, vt)

        loss, _ = train_step(
            model, opt, loss_fn, torch.from_numpy(i.astype(np_dt)),
            torch.from_numpy(q), torch.from_numpy(l), lr=LR,
            randomness=lambda i: (torch.Generator, 0),
            valid=torch.from_numpy(v))
        port_losses.append(float(loss))
        if s == 0:
            after_one = to_jax_params(model)
    after_two = to_jax_params(model)

    def jax_run():
        model_j = j_get_model(name)
        tx = optax.adam(LR)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        o = tx.init(p)

        @jax.jit
        def step(p, o, i, q, l, v, ans, sft):
            def loss_fn(p):
                logits, aux = model_j.apply(
                    p, cfg, i, q, ques_length=l, train=True,
                    rng=jax.random.PRNGKey(1), valid=v)
                if cfg.soft_answer:
                    return j_losses.soft_cross_entropy(logits, sft, v), aux
                return j_losses.cross_entropy(logits, ans, v), aux

            (loss, aux), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(p)
            updates, o = tx.update(grads, o, p)
            p = optax.apply_updates(p, updates)
            return _merge_batch_stats(p, aux), o, loss

        losses, trees = [], []
        for s, (i, q, l, v) in enumerate(batches):
            p, o, loss = step(p, o, jnp.asarray(i.astype(np_dt)),
                              jnp.asarray(q), jnp.asarray(l), jnp.asarray(v),
                              jnp.asarray(answers[s]),
                              jnp.asarray(soft[s].astype(np_dt)))
            losses.append(float(loss))
            trees.append(jax.tree_util.tree_map(np.asarray, p))
        return losses, trees

    jax_losses, (jax_one, jax_two) = (
        _x64(jax_run) if dtype == "float64" else jax_run())
    np.testing.assert_allclose(port_losses, jax_losses,
                               rtol=LOSS_RTOL[dtype])
    assert jax_losses[1] != jax_losses[0]

    want = dict(_leaves(jax_one))
    got = dict(_leaves(after_one))
    assert sorted(got) == sorted(want)
    start = dict(_leaves(params))
    noise = NOISE_LEAVES[dtype].get(name, set())
    for path, w in want.items():
        g, p0 = got[path], start[path]
        assert g.dtype == np_dt and g.shape == w.shape, path
        if path[-1] in ("mean", "var"):
            # one EMA of statistics from the same parameters
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=str(path))
            continue
        if path in noise:
            assert np.abs(g - p0).max() <= LR * (1 + 1e-3), path
            continue
        moved = np.linalg.norm(w - p0)
        assert moved > 0, path
        assert np.linalg.norm(g - w) <= (STEP_RTOL[dtype] * moved
                                         + STEP_ATOL[dtype]), \
            (path, np.linalg.norm(g - w) / moved)
    want_two, got_two = dict(_leaves(jax_two)), dict(_leaves(after_two))
    stats = [p for p in want_two if p[-1] in ("mean", "var")]
    assert len(stats) == 2 * len(BATCH_NORM.get(name, ()))
    for path in stats:
        # two EMAs of masked statistics, the second over 5 valid rows of 8.
        # Where the bias just before the batch norm is a noise leaf, the
        # two packages' first steps leave it up to 2 LR apart, which moves
        # the second batch's mean (not its variance) by as much, and the
        # running mean by BN_MOMENTUM times that
        atol = 1e-6
        if path[-1] == "mean" and noise:
            atol += BN_MOMENTUM * 2 * LR
        assert not np.allclose(want_two[path], start[path]), path
        np.testing.assert_allclose(got_two[path], want_two[path], rtol=1e-5,
                                   atol=atol, err_msg=str(path))


def test_mhb_reads_the_last_valid_step_clamped_at_one():
    cfg = small_cfg("mhb")
    params = params_for(cfg, seed=8)
    img, ques, _ = inputs_for(cfg, seed=9)
    ques[2] = 0  # a zero-token question: its length is 0
    model = port_model(cfg, params).eval()

    def port(qlen):
        with torch.inference_mode():
            return model(torch.from_numpy(img), torch.from_numpy(ques),
                         torch.from_numpy(qlen)).numpy()

    zero = np.full(N, 0, np.int32)
    one = np.full(N, 1, np.int32)
    full = np.full(N, T, np.int32)
    got = port(zero)
    np.testing.assert_array_equal(got, port(one))  # step 0
    want, _ = jax_apply(cfg, params, img, ques, zero)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_ATOL * np.abs(want).max())
    # the length selects the step, row by row
    assert (np.abs(port(full) - got).max(-1) > 1e-3).all()
    with pytest.raises(ValueError, match="ques_length"):
        model(torch.from_numpy(img), torch.from_numpy(ques))


@pytest.mark.parametrize("image_first", [True, False])
def test_vis_lstm_image_token_first_or_last(image_first):
    cfg = small_cfg("visLstm", image_first=image_first)
    params = params_for(cfg, seed=10)
    img, ques, qlen = inputs_for(cfg, seed=11)
    want, _ = jax_apply(cfg, params, img, ques, qlen)
    other, _ = jax_apply(cfg.replace(image_first=not image_first), params,
                         img, ques, qlen)
    with torch.inference_mode():
        got = port_model(cfg, params).eval()(
            torch.from_numpy(img), torch.from_numpy(ques)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_ATOL * np.abs(want).max())
    assert np.abs(other - want).max() > 100 * F32_ATOL * np.abs(want).max()


def test_lstm_attention_matches_jax():
    from vqa_attention_networks_tpu.models import vis_lstm as jvis
    from vqa_attention_networks_tpu_torch.models.vis_lstm import (
        LSTMAttention,
        lstm_attention_init,
    )

    params = jax.tree_util.tree_map(
        np.asarray, jvis.lstm_attention_init(jax.random.PRNGKey(0), 30, 8, 16))
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 30, (4, T)).astype(np.int32)
    img = (rng.standard_normal((4, 10, 16)) * 0.3).astype(np.float32)
    want = np.asarray(jax.jit(jvis.lstm_attention_apply)(params, ids, img))
    model = load_jax_params(LSTMAttention(30, 8, 16), params)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(img)).numpy()
    assert got.shape == (4, T, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    tree = lstm_attention_init(torch.Generator().manual_seed(0), 30, 8, 16)
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), tree) == \
        jax.tree_util.tree_map(lambda x: tuple(x.shape), params)


@pytest.mark.parametrize("name", TRAINED)
def test_init_params_loads_into_both_packages(name):
    from vqa_attention_networks_tpu_torch.train.solver import init_params

    cfg = small_cfg(name)
    tree = init_params(port_config(cfg), torch.Generator().manual_seed(0))
    ref = j_get_model(name).init(jax.random.PRNGKey(0), cfg)
    assert jax.tree_util.tree_map(lambda x: tuple(np.shape(x)), tree) == \
        jax.tree_util.tree_map(lambda x: tuple(x.shape), ref)
    model = load_jax_params(get_model(name)(port_config(cfg)), tree)
    back = to_jax_params(model)
    for (path, a), (_, b) in zip(_leaves(back), _leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))


@pytest.mark.parametrize("name", TRAINED)
def test_dropout_sites_rates_and_scaling(monkeypatch, name):
    """The port's training forward draws its masks where JAX's does, in
    the same order, shapes and rates; the keep rate (by statistics over 8
    forwards) and the scaling of every kept element."""
    cfg = small_cfg(name, dropout_default=0.5, dropout_lstm=0.3,
                    dropout_fusion=0.1)
    params = params_for(cfg, seed=13)
    img, ques, qlen = inputs_for(cfg, seed=14)
    j_sites, t_calls = [], []
    j_dropout, t_dropout = JL.dropout, TL.dropout

    def j_record(rng, x, rate, train):
        if train and rate > 0:
            j_sites.append((tuple(x.shape), rate))
        return j_dropout(rng, x, rate, train)

    def t_record(x, rate, train, generator=None):
        y = t_dropout(x, rate, train, generator)
        if train and rate > 0:
            t_calls.append((x.detach(), y.detach(), rate))
        return y

    monkeypatch.setattr(JL, "dropout", j_record)
    monkeypatch.setattr(TL, "dropout", t_record)
    j_get_model(name).apply(params, cfg, jnp.asarray(img), jnp.asarray(ques),
                            ques_length=jnp.asarray(qlen), train=True,
                            rng=jax.random.PRNGKey(0))
    model = port_model(cfg, params)
    runs = 8
    for seed in range(runs):
        model(torch.from_numpy(img), torch.from_numpy(ques),
              torch.from_numpy(qlen), train=True,
              generator=torch.Generator().manual_seed(seed), fusion_seed=0)
    sites = len(j_sites)
    assert sites >= 2 and len(t_calls) == runs * sites
    assert [(tuple(x.shape), r) for x, _, r in t_calls[:sites]] == j_sites
    kept = {}
    for x, y, rate in t_calls:
        live = x != 0
        keep = y[live] != 0
        # every kept element is x / keep, keep rounded to x's dtype
        np.testing.assert_array_equal(
            y[live][keep].numpy(), (x[live][keep] / (1.0 - rate)).numpy())
        n, k = kept.get(rate, (0, 0))
        kept[rate] = (n + int(live.sum()), k + int(keep.sum()))
    for rate, (n, k) in kept.items():
        p = 1.0 - rate
        assert abs(k / n - p) <= 5 * (p * rate / n) ** 0.5, (rate, k / n)
