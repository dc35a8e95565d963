"""Parity of the port's primitives (vqa_attention_networks_tpu_torch
models/layers.py, ops/fusion.py, ops/grid_fusion.py, ops/attention.py)
against the JAX functions they port, on the same numpy inputs.

Tolerances:
- f32: atol 1e-5. Both sides compute in full f32 (JAX at
  Precision.HIGHEST); only summation order differs.
- bf16: each output is compared at 2 bf16 ulps (rtol 2^-6) plus a small
  atol. Both sides round at the same points, but XLA:CPU keeps excess f32
  precision inside fused bf16 elementwise chains where PyTorch rounds after
  every op, and the two BLAS libraries sum in another order; either moves
  a value across a bf16 rounding boundary now and then.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_attention_networks_tpu.models import layers as JL
from vqa_attention_networks_tpu.ops import fusion as JF
from vqa_attention_networks_tpu.ops.pallas_attention import (
    glimpse_attention as j_glimpse,
)
from vqa_attention_networks_tpu.ops.pallas_fusion import grid_fuse as j_grid
from vqa_attention_networks_tpu_torch.models import layers as TL
from vqa_attention_networks_tpu_torch.ops import fusion as TF
from vqa_attention_networks_tpu_torch.ops.attention import glimpse_attention
from vqa_attention_networks_tpu_torch.ops.grid_fusion import grid_fuse

DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}
BF16_RTOL = 2.0 ** -6


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(shape, rng, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _close(got, want, dtype, atol_bf16=1e-3):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=atol_bf16)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dense(dtype):
    jd, td = DTYPES[dtype]
    rng = _rng(0)
    x, w, b = _f32((6, 48), rng), _f32((48, 40), rng, 0.2), _f32(40, rng)
    want = JL.dense({"w": _j(w), "b": _j(b)}, _j(x, jd))
    got = TL.dense(_t(x, td), _t(w).t(), _t(b))
    assert got.dtype == td
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lstm(dtype):
    jd, td = DTYPES[dtype]
    rng = _rng(1)
    n, t, d_in, h = 4, 7, 16, 32
    p = {"w_ih": _f32((d_in, 4 * h), rng, 0.3),
         "w_hh": _f32((h, 4 * h), rng, 0.3),
         "b_ih": _f32(4 * h, rng, 0.1), "b_hh": _f32(4 * h, rng, 0.1)}
    x = _f32((n, t, d_in), rng)
    want = JL.lstm({k: _j(v) for k, v in p.items()}, _j(x, jd))
    got = TL.lstm(_t(x, td), _t(p["w_ih"]).t(), _t(p["w_hh"]).t(),
                  _t(p["b_ih"]), _t(p["b_hh"]))
    assert got.dtype == td and got.shape == (n, t, h)
    # bf16: both carries round to bf16 at every step, so a flip compounds
    # over T=7 steps; 2 ulps of the gate range (|h| < 1) bounds it
    _close(got, want, dtype, atol_bf16=2 * 2.0 ** -8)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_l2_normalize_and_signed_sqrt(dtype):
    jd, td = DTYPES[dtype]
    x = _f32((5, 300), _rng(2))
    _close(TL.l2_normalize(_t(x, td)), JL.l2_normalize(_j(x, jd)), dtype)
    _close(TL.signed_sqrt(_t(x, td)), JL.signed_sqrt(_j(x, jd)), dtype)
    tiny = np.zeros((2, 8), np.float32)  # eps guards the zero vector
    _close(TL.l2_normalize(_t(tiny)), JL.l2_normalize(_j(tiny)), "float32")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("uniform_quirk", [False, True])
def test_two_glimpse_pool(dtype, uniform_quirk):
    jd, td = DTYPES[dtype]
    rng = _rng(3)
    logits, values = _f32((3, 22, 2), rng, 2.0), _f32((3, 22, 24), rng)
    want = JF.two_glimpse_pool(_j(logits), _j(values, jd),
                               uniform_quirk=uniform_quirk)
    got = TF.two_glimpse_pool(_t(logits), _t(values, td),
                              uniform_quirk=uniform_quirk)
    assert got.shape == (3, 2 * 24)
    _close(got, want, dtype, atol_bf16=2e-2 if uniform_quirk else 1e-3)


def test_grid_fuse_weight_contracted():
    rng = _rng(4)
    n, l, d, k, o = 3, 196, 64, 5, 20
    img, w = _f32((n, l, d), rng), _f32((d, o * k), rng, 0.05)
    b, q = _f32(o * k, rng, 0.05), _f32((n, o * k), rng)
    want = JF.grid_fuse_weight_contracted(
        _j(img, jnp.bfloat16), _j(w), _j(b), _j(q, jnp.bfloat16), k)
    got = TF.grid_fuse_weight_contracted(
        _t(img, torch.bfloat16), _t(w), _t(b), _t(q, torch.bfloat16), k)
    assert got.dtype == torch.bfloat16 and got.shape == (n, l, o)
    # near 0 the signed sqrt turns a 1-ulp wq flip into a large relative
    # change: the atol is sqrt of one ulp of the pooled scale
    _close(got, want, "bfloat16", atol_bf16=2e-2)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_glimpse_attention(dtype):
    jd, td = DTYPES[dtype]
    rng = _rng(5)
    x, v = _f32((4, 22, 32), rng), _f32((4, 22, 32), rng)
    w1, b1 = _f32((32, 512), rng, 0.1), _f32(512, rng, 0.1)
    w2, b2 = _f32((512, 2), rng, 0.1), _f32(2, rng, 0.1)
    want = j_glimpse(_j(x, jd), {"w": _j(w1), "b": _j(b1)},
                     {"w": _j(w2), "b": _j(b2)}, _j(v, jd),
                     uniform_quirk=False)
    got = glimpse_attention(_t(x, td), _t(w1).t(), _t(b1), _t(w2).t(),
                            _t(b2), _t(v, td), uniform_quirk=False)
    assert got.dtype == td and got.shape == (4, 64)
    _close(got, want, dtype)


def test_grid_fuse_f32_branch():
    rng = _rng(6)
    n, l, d, k, o = 2, 196, 32, 5, 12
    img, w = _f32((n, l, d), rng), _f32((d, o * k), rng, 0.1)
    b, q = _f32(o * k, rng, 0.1), _f32((n, o * k), rng)
    want = j_grid(_j(img), {"w": _j(w), "b": _j(b)}, _j(q), k)
    got = grid_fuse(_t(img), _t(w), _t(b), _t(q), k)
    assert got.dtype == torch.float32 and got.shape == (n, l, o)
    _close(got, want, "float32")


def test_refactor_output_major_and_sumpool():
    x = _f32((3, 7 * 5), _rng(7))
    want = JF.refactor_output_major(_j(x), 7, 5, 16)
    np.testing.assert_array_equal(
        TF.refactor_output_major(_t(x), 7, 5, 16).numpy(), np.asarray(want))
    _close(TF.mfb_sumpool(_t(x), 5), JF.mfb_sumpool(_j(x), 5), "float32")
    assert jax.default_backend() == "cpu"
