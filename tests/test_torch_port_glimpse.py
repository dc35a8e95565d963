"""The glimpse block K7 in the port against the JAX package, on the CPU.

- K7's plain version (``ops/attention.glimpse_attention_reference``)
  against ``_glimpse_pallas`` in interpret mode, at bf16, in both
  ``uniform_quirk`` modes. Held per glimpse row of D outputs at 2^-7 of the
  row's largest |value|: the TPU kernel pools with f32 weights and writes
  f32, the port rounds the weights to bf16 before the pool (as the composed
  ``_glimpse_reference`` does) and the output to bf16, one bf16 rounding
  each (2^-9 relative); the hidden layer is rounded to bf16 at the same
  point on both sides, but another f32 summation order can move an element
  across a rounding boundary.
- The dispatch under ``VQA_PALLAS_GLIMPSE``: on a CPU tensor the plain
  version, no launch.
- The whole mhb_coAtt eval forward with ``VQA_PALLAS_GLIMPSE=1`` (the JAX
  side with the same switch, K1 and K7 interpreted), and with
  ``fast_path="composed"`` plus ``VQA_FORCE_PALLAS=1`` (K5 and K7 on both
  sides): equal argmax, logits within ``BF16_LOGIT_ATOL``
  (``test_torch_port_mhb_coatt.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_mhb_coatt import (
    BF16_LOGIT_ATOL,
    inputs_for,
    jax_logits,
    params_for,
    port_logits,
    small_cfg,
)
from vqa_attention_networks_tpu.ops.pallas_attention import _glimpse_pallas
from vqa_attention_networks_tpu_torch.ops import attention as att
from vqa_attention_networks_tpu_torch.ops import grid_fusion as gf
from vqa_attention_networks_tpu_torch.ops import wq_fusion as wqf

K7_RTOL_ROW = 2.0 ** -7
N, P, C, A, G, D = 8, 22, 48, 64, 2, 40


def glimpse_inputs(seed=0, p=P, a=A, g=G):
    """bf16-exact x, v; W1, b1, W2, b2 in PyTorch's layout, scaled so the
    softmax over P is peaked."""
    rng = np.random.default_rng(seed)

    def f(shape, scale, bf16=False):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        if bf16:
            x = np.array(jnp.asarray(x).astype(jnp.bfloat16)
                         .astype(jnp.float32))
        return x

    return (f((N, p, C), 1.0, True), f((a, C), 0.3), f((a,), 0.1),
            f((g, a), 1.0), f((g,), 0.1), f((N, p, D), 0.5, True))


def _within(got, want, g=G):
    got = np.asarray(got, np.float64).reshape(N, g, D)
    want = np.asarray(want, np.float64).reshape(N, g, D)
    return np.abs(got - want) <= K7_RTOL_ROW * np.abs(want).max(
        -1, keepdims=True)


# (quirk, P, A, G): the default shape, then the edges the CUDA kernel
# tiles: one region (its softmax weight is exactly 1), a hidden width that
# ends inside a tile of the MLP launch, one glimpse
_EDGES = [(q, *shape) for shape in ((P, A, G), (1, A, G), (P, 100, G),
                                    (P, A, 1)) for q in (False, True)]
_EDGE_IDS = [f"{'quirk' if q else 'softmax'}{tag}" for tag in
             ("", "-p1", "-a100", "-g1") for q in (False, True)]


@pytest.mark.parametrize("quirk,p,a,g", _EDGES, ids=_EDGE_IDS)
def test_k7_plain_version_matches_pallas_interpreted(monkeypatch, quirk, p,
                                                     a, g):
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    x, w1, b1, w2, b2, v = glimpse_inputs(p=p, a=a, g=g)
    want = np.asarray(_glimpse_pallas(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w1.T),
        jnp.asarray(b1), jnp.asarray(w2.T), jnp.asarray(b2),
        jnp.asarray(v).astype(jnp.bfloat16), quirk))
    t = [torch.from_numpy(arr) for arr in (x, w1, b1, w2, b2, v)]
    t[0], t[5] = t[0].to(torch.bfloat16), t[5].to(torch.bfloat16)
    got = att.glimpse_attention_reference(*t, uniform_quirk=quirk)
    assert got.dtype == torch.bfloat16 and got.shape == (N, g * D)
    assert _within(got.float(), want, g).all()
    if not quirk and p > 1:
        # control: the uniform mean pool (what a dead MLP gives) is
        # rejected on most elements; the inputs peak the softmax (over one
        # region the softmax is the uniform pool)
        uniform = np.repeat(v.mean(1, keepdims=True), g, axis=1)
        assert (~_within(uniform, want, g)).mean() > 0.5


def test_dispatch_under_the_switch_on_the_cpu(monkeypatch):
    x, w1, b1, w2, b2, v = (torch.from_numpy(a) for a in glimpse_inputs(1))
    x, v = x.to(torch.bfloat16), v.to(torch.bfloat16)
    want = att.glimpse_attention_reference(x, w1, b1, w2, b2, v,
                                           uniform_quirk=False)
    for switch in ("1", None):
        if switch:
            monkeypatch.setenv("VQA_PALLAS_GLIMPSE", switch)
        else:
            monkeypatch.delenv("VQA_PALLAS_GLIMPSE", raising=False)
        before = att.launch_count
        got = att.glimpse_attention(x, w1, b1, w2, b2, v,
                                    uniform_quirk=False)
        assert att.launch_count == before
        assert torch.equal(got, want)


@pytest.mark.parametrize("composed", [False, True],
                         ids=["k1_k7", "composed_k5_k7"])
def test_mhb_coatt_eval_under_the_glimpse_switch_matches_jax(monkeypatch,
                                                             composed):
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VQA_PALLAS_GLIMPSE", "1")
    kw = dict(compute_dtype="bfloat16")
    if composed:
        monkeypatch.setenv("VQA_FORCE_PALLAS", "1")
        kw["fast_path"] = "composed"
    cfg = small_cfg(**kw)
    params = params_for(cfg, seed=8)
    img, ques = inputs_for(cfg, seed=9, n=N)
    want = jax_logits(cfg, params, img, ques)
    counts = (wqf.launch_count, att.launch_count, gf.launch_count)
    got = port_logits(cfg, params, img, ques)
    assert (wqf.launch_count, att.launch_count, gf.launch_count) == counts
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LOGIT_ATOL)
    np.testing.assert_array_equal(
        port_logits(cfg, params, img, ques, reference_kernels=True), got)
