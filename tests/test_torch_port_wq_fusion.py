"""Parity of the port's K1 (vqa_attention_networks_tpu_torch/ops/wq_fusion.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

The port's plain version keeps K1's rounding points, so on the CPU it gives
the kernel's bits on almost every element, and at most one bf16 ulp where
the two BLAS libraries sum in another order. The inputs make the attention
over the L regions peaked, so the output depends on every stage of K1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_attention_networks_tpu.ops.pallas_wq_fusion import (
    fused_stage1_coattention_pallas,
    fused_stage1_coattention_pallas_pair,
)
from vqa_attention_networks_tpu_torch.ops import wq_fusion as wqf

# L as Config.validate requires it; O=100 pads to O_pad=128; C, G as the
# model has them
N, L, D, K, O, C, G = 4, 196, 128, 5, 100, 512, 2


def _data(seed, n=N, c=C):
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((n, L, D)) * 0.5).astype(np.float32)
    img = np.array(jnp.asarray(img, jnp.bfloat16).astype(jnp.float32))
    w = (rng.standard_normal((D, O * K)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(O * K) * 0.05).astype(np.float32)
    q = (rng.standard_normal((n, O * K)) * 0.5).astype(np.float32)
    # after the grid-flat L2 norm zb is ~7e-3 per element: these scales
    # give logits that span several units over the L regions, so the
    # attention is peaked and the output depends on every stage
    c1w = rng.standard_normal((O, c)).astype(np.float32)
    c1b = np.zeros(c, np.float32)
    c2w = (rng.standard_normal((c, G)) * 3.0).astype(np.float32)
    c2b = (rng.standard_normal(G) * 0.1).astype(np.float32)
    return img, w, b, q, c1w, c1b, c2w, c2b


def _jax_kernel(fn, img, w, b, q, c1w, c1b, c2w, c2b):
    out = fn(
        jnp.asarray(img, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(q), jnp.asarray(c1w), jnp.asarray(c1b),
        jnp.asarray(c2w), jnp.asarray(c2b), K, interpret=True,
    )
    return np.asarray(out.astype(jnp.float32)).reshape(img.shape[0], G * D)


def _port_reference(img, w, b, q, c1w, c1b, c2w, c2b):
    t = torch.from_numpy
    sw = wqf.prepare_stage1_weights(t(w), t(b), t(c1w), t(c1b), t(c2w),
                                    t(c2b), K)
    out = wqf.stage1_coattention(t(img).to(torch.bfloat16), t(q), sw)
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _assert_bf16_equal_or_one_ulp(got, want):
    """Both sides round at the same points, so almost every element is
    bit-equal. The f32 sums inside the products run in another order on the
    two BLAS libraries (Eigen under XLA, MKL/oneDNN under PyTorch), which
    can move an intermediate (wq, zb, h1, att) across a bf16 rounding
    boundary. Such a flip reaches the output as at most 1 bf16 ulp of the
    output row's largest magnitude (an output near 0 is a cancelling sum of
    terms of that size)."""
    row_ulp = _bf16_ulp(np.abs(want).max(axis=-1, keepdims=True))
    tol = np.maximum(_bf16_ulp(want), row_ulp)
    assert (np.abs(got - want) <= tol).all()
    assert (got == want).mean() >= 0.95


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k1_equals_pallas_kernel_interpret(seed):
    data = _data(seed)
    want = _jax_kernel(fused_stage1_coattention_pallas, *data)
    got = _port_reference(*data)
    assert got.shape == want.shape == (N, G * D)
    assert np.isfinite(got).all()
    _assert_bf16_equal_or_one_ulp(got, want)


def test_plain_k1_on_padded_c1w_equals_pallas_kernel_interpret():
    # C = 150 is not a multiple of 8: prepare_stage1_weights pads c1w's
    # columns with zeros, as the kernel's TMA loads read it, and the plain
    # version reads only the first C of them
    data = _data(8, n=2, c=150)
    t = torch.from_numpy
    sw = wqf.prepare_stage1_weights(*(t(x) for x in data[1:3] + data[4:]),
                                    K)
    assert sw.c == 150 and sw.c1w.shape == (128, 152)
    assert float(sw.c1w[:, 150:].abs().sum()) == 0.0
    np.testing.assert_array_equal(
        sw.c1w[:O, :150].float().numpy(),
        t(data[4]).to(torch.bfloat16).float().numpy())
    want = _jax_kernel(fused_stage1_coattention_pallas, *data)
    _assert_bf16_equal_or_one_ulp(_port_reference(*data), want)


def test_plain_k1_equals_pair_kernel_interpret():
    data = _data(2, n=2 * (N // 2))
    want = _jax_kernel(fused_stage1_coattention_pallas_pair, *data)
    _assert_bf16_equal_or_one_ulp(_port_reference(*data), want)


def test_parity_inputs_give_peaked_attention():
    # control: with near-uniform attention the output is about the mean of
    # img over L whatever the fusion, the norm and the hidden layer compute,
    # and the parity above would not see a fault in them
    img, *rest = _data(0)
    got = _port_reference(img, *rest).reshape(N, G, D)
    uniform = img.mean(axis=1, keepdims=True)
    assert np.abs(got - uniform).mean() >= 0.02


def test_reference_intermediates_feed_its_output():
    # the z and h1 that the card's checks hold against the kernel's scratch
    # are the ones the plain version's output is made from
    img, w, b, q, c1w, c1b, c2w, c2b = _data(7)
    t = torch.from_numpy
    sw = wqf.prepare_stage1_weights(t(w), t(b), t(c1w), t(c1b), t(c2w),
                                    t(c2b), K)
    x = t(img).to(torch.bfloat16)
    out, z, h1 = wqf.stage1_coattention_reference(x, t(q), sw,
                                                  intermediates=True)
    assert torch.equal(out, wqf.stage1_coattention_reference(x, t(q), sw))
    assert z.shape == (N, L, 128) and z.dtype == torch.float32
    assert h1.shape == (N, L, C) and h1.dtype == torch.bfloat16
    assert float(z[..., O:].abs().max()) == 0.0
    norm = torch.sqrt(torch.sum(z * z, dim=(1, 2), keepdim=True))
    zb = (z * (1.0 / norm)).to(torch.bfloat16).float()
    assert torch.equal(
        h1, torch.relu(zb @ sw.c1w.float() + sw.c1b).to(torch.bfloat16))
    logits = h1.float() @ sw.c2w.float() + sw.c2b
    att = torch.softmax(logits, dim=1).to(torch.bfloat16).float()
    pooled = (att.transpose(1, 2) @ x.float()).to(torch.bfloat16)
    torch.testing.assert_close(pooled.reshape(N, G * D).float(),
                               out.float(), atol=0, rtol=2 ** -8)


def test_cpu_tensor_never_counts_a_launch():
    before = wqf.launch_count
    _port_reference(*_data(4, n=2))
    assert wqf.launch_count == before


def test_cuda_wrapper_refuses_a_cpu_tensor():
    # the kernel entry itself never runs the plain version
    img, w, b, q, c1w, c1b, c2w, c2b = _data(5, n=1)
    t = torch.from_numpy
    sw = wqf.prepare_stage1_weights(t(w), t(b), t(c1w), t(c1b), t(c2w),
                                    t(c2b), K)
    with pytest.raises(ValueError, match="CUDA"):
        wqf.stage1_coattention_cuda(t(img).to(torch.bfloat16), t(q), sw)


def test_prepared_layout_matches_jax_refactor():
    # the load-time layout is the one fused_stage1_coattention_pallas
    # builds on every call (pallas_wq_fusion.py:232-238)
    from vqa_attention_networks_tpu.ops.fusion import refactor_output_major

    _, w, b, _, c1w, c1b, c2w, c2b = _data(6, n=1)
    t = torch.from_numpy
    sw = wqf.prepare_stage1_weights(t(w), t(b), t(c1w), t(c1b), t(c2w),
                                    t(c2b), K)
    o_pad = 128
    w3 = np.asarray(jnp.moveaxis(refactor_output_major(
        jnp.asarray(w), O, K, o_pad), 1, 0))
    np.testing.assert_array_equal(sw.w3.numpy(), w3)
    assert sw.b3.shape == (K, o_pad) and sw.c1w.shape == (o_pad, C)
    assert float(sw.c1w[O:].abs().sum()) == 0.0
    assert sw.o == O and sw.o_pad == o_pad
