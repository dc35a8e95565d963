"""Parity of the port's K6 entry (vqa_attention_networks_tpu_torch/ops/
wq_grid_fusion.py) against the JAX package's standalone wq fusion: the
forward against ``_wq_grid_fuse_pallas`` run in interpret mode on the CPU,
the gradients against ``jax.vjp`` of the custom-VJP entry
``_wq_grid_fuse_tpu`` (whose forward also runs in interpret mode here).

The port's plain version keeps the kernel's rounding points (bf16 W and q,
wq's f32 chain over j rounded to bf16 once, f32 accumulation, the norm in
f32 over the whole grid), so it gives the kernel's bits on almost every
element, and one bf16 ulp where the two BLAS libraries sum in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_attention_networks_tpu.ops.pallas_wq_fusion import (
    _composed_reference,
    _wq_grid_fuse_pallas,
    _wq_grid_fuse_tpu,
)
from vqa_attention_networks_tpu_torch.ops import wq_grid_fusion as wqg

# tests/test_wq_fusion.py's shapes (O = 128, one lane tile), and O = 100,
# which the TPU kernel pads to 128 and slices back
N, L, D, K = 3, 8, 128, 5


def _data(seed, o):
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((N, L, D)) * 0.5).astype(np.float32)
    img = np.array(jnp.asarray(img, jnp.bfloat16).astype(jnp.float32))
    w = (rng.standard_normal((D, o * K)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(o * K) * 0.05).astype(np.float32)
    q = (rng.standard_normal((N, o * K)) * 0.5).astype(np.float32)
    return img, w, b, q


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("o", [128, 100], ids=["one_tile", "padded"])
def test_plain_k6_equals_pallas_kernel_interpret(o):
    img, w, b, q = _data(0, o)
    want = np.asarray(_wq_grid_fuse_pallas(
        jnp.asarray(img, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(q), K, interpret=True).astype(jnp.float32))
    t = torch.from_numpy
    before = wqg.launch_count
    got = wqg.wq_grid_fuse(t(img).to(torch.bfloat16), t(w), t(b), t(q), K)
    assert wqg.launch_count == before  # a CPU tensor takes the plain version
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (N, L, o)
    got = got.float().numpy()
    # both round at the same points; another f32 summation order in the
    # product or the norm can move an element across a bf16 boundary
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    assert (got == want).mean() >= 0.95
    # the norm is grid-flat: each sample's whole [L, O] grid has norm 1
    norms = np.sqrt((want.astype(np.float64) ** 2).sum(axis=(1, 2)))
    np.testing.assert_allclose(norms, 1.0, atol=1e-2)


def test_plain_k6_sees_q_and_the_grid_norm():
    # controls: q permuted across samples, or a per-row norm in place of
    # the grid-flat one, move most elements past one bf16 ulp
    img, w, b, q = _data(1, 128)
    t = torch.from_numpy
    x = t(img).to(torch.bfloat16)
    want = wqg.wq_grid_fuse_reference(x, t(w), t(b), t(q), K).float()
    perm = wqg.wq_grid_fuse_reference(x, t(w), t(b), t(q).roll(1, 0),
                                      K).float()
    row = want / want.norm(dim=-1, keepdim=True)
    for control in (perm, row):
        far = (control - want).abs() > torch.from_numpy(
            _bf16_ulp(want.numpy()))
        assert far.float().mean() > 0.9


def test_composed_reference_matches_jax():
    # the differentiable twin, at f32 (both at full f32 precision)
    img, w, b, q = _data(2, 100)
    want = np.asarray(_composed_reference(
        jnp.asarray(img), jnp.asarray(w), jnp.asarray(b), jnp.asarray(q), K))
    t = torch.from_numpy
    got = wqg.composed_reference(t(img), t(w), t(b), t(q), K).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# the gradients of the entry against jax.vjp of _wq_grid_fuse_tpu, with the
# same bf16 cotangent. Both run the composed chain's VJP on the same inputs
# and differ only in the order of f32 sums. f32 inputs: held at 1e-4 of each
# gradient's largest magnitude (the signed sqrt's 0.5 / sqrt|pooled| turns
# a summation-order difference of a pooled value near 0 into a larger one).
# bf16 img: d_img leaves in bf16 and d_W is rounded to bf16 on its way
# through W's cast, so those two are held at one bf16 ulp (2^-7 of each
# value, the ulp's largest relative size) plus that 1e-4 of their largest.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_vjp(dtype):
    img, w, b, q = _data(3, 100)
    rng = np.random.default_rng(4)
    ct = np.array(jnp.asarray(rng.standard_normal((N, L, 100)),
                              jnp.bfloat16).astype(jnp.float32))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    args = (jnp.asarray(img, jdt), jnp.asarray(w), jnp.asarray(b),
            jnp.asarray(q))
    out, vjp = jax.vjp(lambda i, ww, bb, qq: _wq_grid_fuse_tpu(
        i, ww, bb, qq, K), *args)
    want = [np.asarray(gr.astype(jnp.float32))
            for gr in vjp(jnp.asarray(ct, out.dtype))]

    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    t = torch.from_numpy
    inputs = [t(img).to(tdt), t(w), t(b), t(q)]
    for x in inputs:
        x.requires_grad_(True)
    got_out = wqg.wq_grid_fuse(*inputs, K)
    np.testing.assert_array_equal(got_out.detach().float().numpy() != 0,
                                  np.asarray(out.astype(jnp.float32)) != 0)
    grads = torch.autograd.grad(got_out, inputs,
                                t(ct).to(got_out.dtype))
    for name, gr, x, ref in zip(("img", "W", "b", "q"), grads, inputs, want):
        assert gr.dtype == x.dtype, name
        gr = gr.float().numpy()
        assert np.isfinite(gr).all(), name
        tol = 1e-4 * np.abs(ref).max()
        if dtype == "bfloat16" and name in ("img", "W"):
            tol = tol + 2.0 ** -7 * np.abs(ref)
        assert (np.abs(gr - ref) <= tol).all(), name


def test_backward_skips_inputs_without_grad():
    img, w, b, q = _data(5, 128)
    t = torch.from_numpy
    w_t = t(w).requires_grad_(True)
    out = wqg.wq_grid_fuse(t(img).to(torch.bfloat16), w_t, t(b), t(q), K)
    (d_w,) = torch.autograd.grad(out.float().sum(), [w_t])
    assert d_w.shape == w_t.shape and torch.isfinite(d_w).all()
    assert float(d_w.abs().max()) > 0


def test_cuda_wrapper_refuses_a_cpu_tensor():
    # the kernel entry itself never runs the plain version
    img, w, b, q = _data(6, 128)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA"):
        wqg.wq_grid_fuse_cuda(t(img).to(torch.bfloat16), t(w), t(b), t(q), K)
