"""The port's batch norm and LSTM cell (vqa_attention_networks_tpu_torch
models/layers.py ``BatchNorm``, ``lstm_cell``), the running-statistics
merge (train/solver.py ``merge_batch_stats``) and their weight mapping
(weights.py), against the JAX functions they port (``layers.batchnorm``,
``layers.lstm_cell``, ``solver._merge_batch_stats``), on the same numpy
inputs.

- Train mode: the output and the raw statistics (mean and unbiased
  variance over the valid rows, in f32 even at bf16), with and without a
  ``valid`` mask, and the gradients of x, scale and bias through the batch
  statistics. Eval mode: the running buffers normalise. f32 at rtol 1e-6 /
  atol 1e-6 (summation order only); the bf16 output at 2 bf16 ulps.
- The layer never writes its buffers; the merge EMAs at momentum 0.1.
- ``load_jax_params`` / ``to_jax_params`` carry the four leaves both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_attention_networks_tpu.models import layers as JL
from vqa_attention_networks_tpu.train.solver import _merge_batch_stats
from vqa_attention_networks_tpu_torch.models import layers as TL
from vqa_attention_networks_tpu_torch.train.solver import (
    BN_MOMENTUM,
    merge_batch_stats,
)
from vqa_attention_networks_tpu_torch.weights import (
    load_jax_params,
    to_jax_params,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_RTOL = 2.0 ** -7  # 2 bf16 ulps
N, C = 12, 24


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"scale": (1 + 0.2 * rng.standard_normal(C)).astype(np.float32),
            "bias": (0.2 * rng.standard_normal(C)).astype(np.float32),
            "mean": (0.3 * rng.standard_normal(C)).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}


def _x(seed, n=N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, C)) * 1.5 + 0.7).astype(np.float32)


def _layer(params):
    return load_jax_params(_Holder(), {"bn": params}).bn


class _Holder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.bn = TL.BatchNorm(C)


def _valid(n_valid):
    return np.arange(N) < n_valid


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_valid", [None, 7, 1, 0],
                         ids=["no_mask", "padded", "one_row", "all_pad"])
def test_train_mode_matches_jax(dtype, n_valid):
    jd, td = DTYPES[dtype]
    params, x = _params(0), _x(1)
    valid = None if n_valid is None else _valid(n_valid)
    want, want_stats = JL.batchnorm(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x).astype(jd), True,
        valid=None if valid is None else jnp.asarray(valid))
    layer = _layer(params)
    got, stats = layer(torch.from_numpy(x).to(td), True,
                       None if valid is None else torch.from_numpy(valid))
    assert got.dtype == td and got.shape == (N, C)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=BF16_RTOL, atol=1e-2)
    for key in ("mean", "var"):
        # statistics in f32 at either dtype, detached
        assert stats[key].dtype == torch.float32
        assert not stats[key].requires_grad
        np.testing.assert_allclose(stats[key].numpy(),
                                   np.asarray(want_stats[key]), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    # the layer never writes its running buffers
    np.testing.assert_array_equal(layer.mean.numpy(), params["mean"])
    np.testing.assert_array_equal(layer.var.numpy(), params["var"])


def test_pad_rows_do_not_move_the_statistics():
    params, x = _params(2), _x(3)
    layer = _layer(params)
    valid = torch.from_numpy(_valid(5))
    _, stats = layer(torch.from_numpy(x), True, valid)
    x2 = x.copy()
    x2[5:] = 1e3  # pad rows, whatever they hold
    _, stats2 = layer(torch.from_numpy(x2), True, valid)
    for key in ("mean", "var"):
        torch.testing.assert_close(stats[key], stats2[key], rtol=0, atol=0)
    # over the valid rows: the unbiased variance
    np.testing.assert_allclose(stats["var"].numpy(),
                               x[:5].var(0, ddof=1), rtol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_eval_mode_uses_the_running_buffers(dtype):
    jd, td = DTYPES[dtype]
    params, x = _params(4), _x(5)
    want, want_stats = JL.batchnorm(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x).astype(jd), False)
    got, stats = _layer(params)(torch.from_numpy(x).to(td), False)
    want = np.asarray(want.astype(jnp.float32))
    rtol = 1e-6 if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=rtol,
                               atol=1e-6 if dtype == "float32" else 1e-2)
    for key in ("mean", "var"):
        np.testing.assert_array_equal(stats[key].numpy(), params[key])
        np.testing.assert_array_equal(np.asarray(want_stats[key]),
                                      params[key])


def test_train_mode_gradients_match_jax():
    """The gradients of x, scale and bias flow through the batch mean and
    variance, as ``jax.grad`` of ``layers.batchnorm`` does."""
    params, x = _params(6), _x(7)
    valid = _valid(9)
    g = np.random.default_rng(8).standard_normal((N, C)).astype(np.float32)

    def jax_loss(p, x):
        y, _ = JL.batchnorm(p, x, True, valid=jnp.asarray(valid))
        return jnp.sum(y * g)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want_p, want_x = jax.grad(jax_loss, argnums=(0, 1))(jp, jnp.asarray(x))
    layer = _layer(params)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = layer(xt, True, torch.from_numpy(valid))
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                               rtol=1e-5, atol=1e-5)
    for key in ("scale", "bias"):
        np.testing.assert_allclose(getattr(layer, key).grad.numpy(),
                                   np.asarray(want_p[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    assert layer.mean.grad is None and layer.var.grad is None


def test_merge_batch_stats_matches_jax():
    params = _params(9)
    rng = np.random.default_rng(10)
    batch = {"mean": rng.standard_normal(C).astype(np.float32),
             "var": rng.uniform(0.1, 3.0, C).astype(np.float32)}
    holder = load_jax_params(_Holder(), {"bn": params})
    merge_batch_stats(holder, {"bn": {k: torch.from_numpy(v)
                                      for k, v in batch.items()}})
    want = _merge_batch_stats(
        {"bn": {k: jnp.asarray(v) for k, v in params.items()}},
        {"batch_stats": {"bn": {k: jnp.asarray(v)
                                for k, v in batch.items()}}})
    for key in ("mean", "var"):
        np.testing.assert_array_equal(getattr(holder.bn, key).numpy(),
                                      np.asarray(want["bn"][key]))
        np.testing.assert_allclose(
            getattr(holder.bn, key).numpy(),
            (1 - BN_MOMENTUM) * params[key] + BN_MOMENTUM * batch[key],
            rtol=1e-6)
    # scale and bias are the optimizer's: the merge leaves them
    np.testing.assert_array_equal(holder.bn.scale.detach().numpy(),
                                  params["scale"])
    merge_batch_stats(holder, None)  # a family without batch norm
    merge_batch_stats(holder, {})


def test_weights_round_trip_the_running_statistics():
    params = _params(11)
    holder = load_jax_params(_Holder(), {"bn": params})
    assert [n for n, _ in holder.named_parameters()] == ["bn.scale",
                                                         "bn.bias"]
    assert holder.bn.mean.dtype == holder.bn.var.dtype == torch.float32
    back = to_jax_params(holder)
    assert sorted(back["bn"]) == ["bias", "mean", "scale", "var"]
    for key, value in params.items():
        np.testing.assert_array_equal(back["bn"][key], value, err_msg=key)
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(_Holder(), {"bn": {k: v for k, v in params.items()
                                           if k != "var"}})
    # the initial tree matches batchnorm_init's
    init = TL.batchnorm_init(C)
    want = JL.batchnorm_init(C)
    for key in want:
        np.testing.assert_array_equal(init[key].numpy(),
                                      np.asarray(want[key]))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lstm_cell_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(12)
    n, h = 5, 16
    x_proj = (rng.standard_normal((n, 4 * h)) * 0.7).astype(np.float32)
    h0 = (rng.standard_normal((n, h)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((n, h)) * 0.5).astype(np.float32)
    w_hh = (rng.standard_normal((h, 4 * h)) * 0.3).astype(np.float32)
    want_h, want_c = JL.lstm_cell(
        {"w_hh": jnp.asarray(w_hh)}, jnp.asarray(x_proj).astype(jd),
        jnp.asarray(h0).astype(jd), jnp.asarray(c0).astype(jd))
    got_h, got_c = TL.lstm_cell(
        torch.from_numpy(x_proj).to(td), torch.from_numpy(h0).to(td),
        torch.from_numpy(c0).to(td), torch.from_numpy(w_hh).to(td))
    for got, want in ((got_h, want_h), (got_c, want_c)):
        assert got.dtype == td and got.shape == (n, h)
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=BF16_RTOL, atol=2.0 ** -8)
