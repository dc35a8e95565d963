"""K3's plain version (vqa_attention_networks_tpu_torch ops/pooled_fusion.py)
and the pooled-site training branch of ``grid_fuse``, against the JAX
package on the same numpy inputs.

The TPU kernels have no in-kernel random bits (the pooled-site mask lives
outside them), so JAX's side is ``pooled_grid_fuse`` itself, run by the
Pallas interpreter (``VQA_PALLAS_INTERPRET=1``, as
``tests/test_pooled_fusion.py`` runs it). Both take W and q rounded to
bf16, b in f32, build wq in f32 and round it to bf16, and accumulate their
products in f32, so they differ in the order of their f32 sums only.
Tolerances, per tensor, relative to the largest |value| of JAX's result:

- the forward as pooled = out * |out| (the signed sqrt would turn an f32
  difference e near 0 into sqrt(e)), d_W and d_b: 1e-5 (f32 on both
  sides, summation order only);
- d_img and d_q: 2^-7. Both are returned in their inputs' dtype, bf16: a
  summation-order difference can move an element across a bf16 rounding
  boundary, one bf16 ulp (2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_attention_networks_tpu.models.layers import signed_sqrt as j_ssqrt
from vqa_attention_networks_tpu.ops import pallas_pooled_fusion as ppf
from vqa_attention_networks_tpu.ops.fusion import (
    grid_fuse_pooled as j_grid_fuse_pooled,
)
from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf
from vqa_attention_networks_tpu_torch.ops.fusion import grid_fuse_pooled
from vqa_attention_networks_tpu_torch.ops.grid_fusion import grid_fuse

N, L, D, O, K = 3, 7, 64, 20, 5
RTOL = {"out": 1e-5, "d_img": 2.0 ** -7, "d_w": 1e-5, "d_b": 1e-5,
        "d_q": 2.0 ** -7}
NAMES = ("out", "d_img", "d_w", "d_b", "d_q")


def _inputs(seed=0, n=N, l=L, d=D, o=O, k=K):
    """img and q bf16-valued, W and b f32 (W rounds to bf16 inside both),
    an f32 cotangent g."""
    rng = np.random.default_rng(seed)

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).to(
            torch.bfloat16).float().numpy()

    img = bf16(rng.standard_normal((n, l, d)) * 0.5)
    w = (rng.standard_normal((d, o * k)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(o * k) * 0.05).astype(np.float32)
    q = bf16(rng.standard_normal((n, o * k)) * 0.5)
    g = rng.standard_normal((n, l, o)).astype(np.float32)
    return img, w, b, q, g


def _port_value_and_grads(img, w, b, q, g, k=K):
    ti = torch.from_numpy(img).to(torch.bfloat16).requires_grad_(True)
    tw, tb = (torch.from_numpy(x).requires_grad_(True) for x in (w, b))
    tq = torch.from_numpy(q).to(torch.bfloat16).requires_grad_(True)
    before = dict(pf.launch_count)
    out = pf.pooled_grid_fuse(ti, tw, tb, tq, k)
    assert pf.launch_count == before  # a CPU tensor: the plain version
    out.backward(torch.from_numpy(g))
    assert (ti.grad.dtype, tw.grad.dtype, tb.grad.dtype, tq.grad.dtype) == (
        torch.bfloat16, torch.float32, torch.float32, torch.bfloat16)
    return {"out": out.detach().numpy(), "d_img": ti.grad.float().numpy(),
            "d_w": tw.grad.numpy(), "d_b": tb.grad.numpy(),
            "d_q": tq.grad.float().numpy()}


def _jax_value_and_grads(img, w, b, q, g, k=K):
    args = (jnp.asarray(img, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
            jnp.asarray(q, jnp.bfloat16))
    out, vjp = jax.vjp(lambda *a: ppf.pooled_grid_fuse(*a, k), *args)
    grads = vjp(jnp.asarray(g))
    return dict(zip(NAMES, [np.asarray(x, np.float32)
                            for x in (out, *grads)]))


def _errors(got, want):
    """name -> (max |diff| / max |want|), the forward as out * |out|."""
    errs = {}
    for name in NAMES:
        a, b = got[name], want[name]
        assert a.shape == b.shape and np.isfinite(a).all(), name
        if name == "out":
            a, b = a * np.abs(a), b * np.abs(b)
        errs[name] = np.abs(a - b).max() / np.abs(b).max()
    return errs


def _assert_close(got, want):
    for name, err in _errors(got, want).items():
        assert err <= RTOL[name], (name, err)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_matches_interpreted_tpu_kernel(monkeypatch, seed):
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    img, w, b, q, g = _inputs(seed)
    _assert_close(_port_value_and_grads(img, w, b, q, g),
                  _jax_value_and_grads(img, w, b, q, g))


def test_plain_version_takes_a_ragged_batch_and_width(monkeypatch):
    """N, L and O of no particular multiple (the TPU pads O to 128)."""
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    img, w, b, q, g = _inputs(2, n=2, l=13, d=24, o=7)
    _assert_close(_port_value_and_grads(img, w, b, q, g),
                  _jax_value_and_grads(img, w, b, q, g))


@pytest.mark.parametrize("l", [1, 208])
def test_plain_version_matches_interpreted_tpu_kernel_at_edge_shapes(
        monkeypatch, l):
    """L = 1 and 208 (the fewest and the most rows the K3 kernels take) at
    k = 7 (the largest). The backward's plain version is held on JAX's own
    forward output: over 208 rows some |out| comes near 0.01, where
    g_pooled's 0.5 / |out| turns the two forwards' last-ulp difference
    (summation order) into ~2e-5 of d_b's largest value; on the same out
    the two backwards agree to ~1e-7."""
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    k = 7
    img, w, b, q, g = _inputs(6 + l, n=2, l=l, d=24, o=9, k=k)
    want = _jax_value_and_grads(img, w, b, q, g, k=k)
    got = _port_value_and_grads(img, w, b, q, g, k=k)
    w_bf16, bf, qb = pf.operands(torch.from_numpy(w), torch.from_numpy(b),
                                 torch.from_numpy(q))
    tg, out = torch.from_numpy(g), torch.from_numpy(want["out"])
    d_w, d_b, d_q = pf.d_w_reference(
        tg, out, torch.from_numpy(img).to(torch.bfloat16), w_bf16, bf, qb, k)
    got.update(d_w=d_w.numpy(), d_b=d_b.numpy(), d_q=d_q.numpy(),
               d_img=pf.d_img_reference(tg, out, w_bf16, qb, k).numpy())
    _assert_close(got, want)


def test_wq_rounds_once_after_an_f32_sum_in_j_order():
    """wq's bits: the f32 chain over j, then one bf16 rounding. Summed in
    f64 first (a single rounding of the exact sum) the bf16 wq differs on
    some elements, so the order is observable."""
    img, w, b, q, _ = _inputs(3)
    w_bf16, _, qb = pf.operands(torch.from_numpy(w), torch.from_numpy(b),
                                torch.from_numpy(q))
    wq = pf.contracted_weights(w_bf16, qb, K)
    w3 = w_bf16.float().reshape(D, O, K)
    q3 = qb.float().reshape(N, O, K)
    chain = torch.zeros(N, D, O)
    for j in range(K):
        chain = chain + w3[None, :, :, j] * q3[:, None, :, j]
    assert torch.equal(wq, chain)
    exact = torch.einsum("dok,nok->ndo", w3.double(), q3.double()).float()
    assert not torch.equal(wq, exact)


def test_zero_cotangent_rule_at_pooled_zero(monkeypatch):
    """pooled == 0 -> the cotangent through the signed sqrt is 0, as
    jax.grad of the composed chain gives (relu'(0) = 0). b is 0, region 0
    of sample 0 is all zeros and the last output's weights are 0, so that
    row and that output pool to exactly 0. A clamped 1/|out| would put
    0.5e20 * g into d_img at the zero row, into d_W at the dead output
    (its img rows are not 0), and into d_b through d_bq. (d_q cannot see
    the rule: where pooled is 0 by construction, the W or b that made it 0
    multiplies g_pooled in its terms.)"""
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    img, w, b, q, g = _inputs(4)
    img[0, 0] = 0.0
    b[:] = 0.0
    w[:, -K:] = 0.0
    got = _port_value_and_grads(img, w, b, q, g)
    want = _jax_value_and_grads(img, w, b, q, g)
    for side in (got, want):
        assert (side["out"][0, 0] == 0).all()
        assert (side["out"][..., -1] == 0).all()
        assert (side["d_img"][0, 0] == 0).all()
    _assert_close(got, want)
    # control: without the rule (out == 0 taken as 1e-20, the clamp alone)
    # d_W, d_b and d_img are far off, d_q is not
    w_bf16, bf, qb = pf.operands(torch.from_numpy(w), torch.from_numpy(b),
                                 torch.from_numpy(q))
    ti = torch.from_numpy(img).to(torch.bfloat16)
    tg = torch.from_numpy(g)
    out = torch.from_numpy(got["out"])
    clamped = torch.where(out == 0, torch.full_like(out, 1e-20), out)
    d_w, d_b, d_q = pf.d_w_reference(tg, clamped, ti, w_bf16, bf, qb, K)
    no_rule = {"d_w": d_w, "d_b": d_b, "d_q": d_q,
               "d_img": pf.d_img_reference(tg, clamped, w_bf16, qb, K)}
    far = {name: float((x - torch.tensor(want[name])).abs().max())
           > 1e6 * np.abs(want[name]).max() for name, x in no_rule.items()}
    assert far == {"d_w": True, "d_b": True, "d_q": False, "d_img": True}
    # the rule against the composed derivative elsewhere
    x = jnp.asarray([-4.0, -0.25, 0.0, 0.25, 4.0])
    composed = jax.vmap(jax.grad(j_ssqrt))(x)
    rule = pf.g_pooled(torch.ones(5), torch.from_numpy(np.array(j_ssqrt(x))))
    np.testing.assert_allclose(np.asarray(composed), rule.numpy(), rtol=1e-6)


def test_control_another_samples_q_is_rejected(monkeypatch):
    """The tolerances see a q permuted across samples, in the forward and
    in d_W."""
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    img, w, b, q, g = _inputs(5)
    want = _jax_value_and_grads(img, w, b, q, g)
    errs = _errors(_port_value_and_grads(img, w, b, q[::-1].copy(), g),
                   want)
    assert errs["out"] > 100 * RTOL["out"] and errs["d_w"] > 100 * RTOL["d_w"]


def _bf16_fusion_inputs(seed):
    img, w, b, q, _ = _inputs(seed)
    return (torch.from_numpy(img).to(torch.bfloat16), torch.from_numpy(w),
            torch.from_numpy(b), torch.from_numpy(q).to(torch.bfloat16))


def test_grid_fuse_pooled_bf16_matches_jax_with_the_gate_open(monkeypatch):
    """``grid_fuse(site="pooled")`` at bf16 and rate 0 against
    JAX ``grid_fuse_pooled`` with its kernel gate open: both bf16, the
    kernels' f32 map rounded once. The f32 maps differ in summation order
    (1e-5 above), so an element may round one bf16 ulp apart: 2^-8 of its
    magnitude, and near 0 (where the signed sqrt amplifies) 2^-7 of the
    largest |value|."""
    monkeypatch.setenv("VQA_PALLAS_INTERPRET", "1")
    img, w, b, q = _bf16_fusion_inputs(6)
    got = grid_fuse(img, w, b, q, K, train=True, rate=0.0, site="pooled")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, pf.pooled_grid_fuse_reference(img, w, b, q, K)
                       .to(torch.bfloat16))
    assert torch.equal(got, grid_fuse(img, w, b, q, K, train=True, rate=0.0,
                                      site="pooled", reference_kernel=True))
    assert ppf.supported(N, O * K, K, D)
    want = j_grid_fuse_pooled(
        jnp.asarray(img.float().numpy(), jnp.bfloat16), jnp.asarray(w.numpy()),
        jnp.asarray(b.numpy()), jnp.asarray(q.float().numpy(), jnp.bfloat16),
        K, rng=jax.random.PRNGKey(0), dropout_rate=0.0, train=True)
    assert want.dtype == jnp.bfloat16
    a, e = got.float().numpy(), np.asarray(want, np.float32)
    assert (np.abs(a - e) <= 2.0 ** -8 * np.abs(e)
            + 2.0 ** -7 * np.abs(e).max()).all()
    # the gradients flow through the cast and reach every input
    for x in (img, w, b, q):
        x.requires_grad_(True)
    grid_fuse(img, w, b, q, K, train=True, rate=0.0, site="pooled") \
        .float().sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad.float()).all()
               and x.grad.abs().sum() > 0 for x in (img, w, b, q))


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("float64", 1e-12)])
def test_grid_fuse_pooled_wide_dtypes_match_jax_composed_chain(dtype, rtol):
    """At f32 and f64 the composed weight-contracted chain in img's dtype,
    bq and the pooled map in f32 as JAX's ``preferred_element_type=f32``
    gives them (at f64 the products run in f64 and round to f32, the same
    rounding on both sides, so f64 agrees to summation order in f64)."""
    img, w, b, q, _ = _inputs(7)
    x64 = dtype == "float64"
    jax.config.update("jax_enable_x64", x64)
    try:
        want = np.asarray(j_grid_fuse_pooled(
            *(jnp.asarray(x.astype(dtype)) for x in (img, w, b, q)), K,
            rng=None, dropout_rate=0.0, train=True))
    finally:
        jax.config.update("jax_enable_x64", False)
    tdt = getattr(torch, dtype)
    got = grid_fuse(*(torch.from_numpy(x.astype(dtype)) for x in
                      (img, w, b, q)), K, train=True, rate=0.0,
                    site="pooled")
    assert got.dtype == tdt and str(want.dtype) == dtype
    # the pooled map is f32 on both sides: compare it before the sqrt
    a, e = got.numpy() * np.abs(got.numpy()), want * np.abs(want)
    assert np.abs(a - e).max() <= rtol * np.abs(e).max()


def test_pooled_site_dropout_keep_rate_scaling_and_dtype():
    """The mask on the pooled map: keep rate within 5 sigma, kept values
    are the rate-0 map divided by bf16(keep) (JAX rounds the Python scalar
    to bf16), identity at rate 0, bf16 out at bf16."""
    img, w, b, q, _ = _inputs(8, n=4, l=196, d=16, o=64)
    img, w, b, q = (torch.from_numpy(img).to(torch.bfloat16),
                    torch.from_numpy(w), torch.from_numpy(b),
                    torch.from_numpy(q).to(torch.bfloat16))
    base = grid_fuse_pooled(img, w, b, q, K, rate=0.0)
    assert base.dtype == torch.bfloat16
    assert torch.equal(base, grid_fuse_pooled(
        img, w, b, q, K, rate=0.0,
        generator=torch.Generator().manual_seed(1)))
    rate = 0.3
    out = grid_fuse_pooled(img, w, b, q, K, rate=rate,
                           generator=torch.Generator().manual_seed(2))
    assert out.dtype == torch.bfloat16
    kept = out != 0
    live = base != 0
    share = float(kept[live].float().mean())
    n_live = int(live.sum())
    assert abs(share - (1 - rate)) < 5 * ((1 - rate) * rate / n_live) ** 0.5
    scale = torch.tensor(1 - rate, dtype=torch.bfloat16)
    assert torch.equal(out[kept], base[kept] / scale)
    with pytest.raises(ValueError, match="Generator"):
        grid_fuse_pooled(img, w, b, q, K, rate=rate)


def test_kernel_wrappers_refuse_cpu_tensors():
    img, w, b, q, g = _inputs(9)
    w_bf16, bf, qb = pf.operands(torch.from_numpy(w), torch.from_numpy(b),
                                 torch.from_numpy(q))
    ti = torch.from_numpy(img).to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        pf.forward_cuda(ti, w_bf16, bf, qb, K)
    out = pf.forward_reference(ti, w_bf16, bf, qb, K)
    for fn in (pf.d_img_cuda, pf.d_w_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(torch.from_numpy(g), out, ti, w_bf16, bf, qb, K)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_dispatch_sends_a_device_tensor_to_the_kernels(monkeypatch, rate):
    """A tensor that is not on the CPU goes to the kernels' autograd
    function at any rate: here a tensor on the meta device (shapes, no
    data), with the CUDA checks and the library call stubbed out, so that
    the wrappers' allocations and launch counts run as on the card. img
    needs no gradient: g_pooled is formed once and d_img is not launched;
    with img needing one, the same g_pooled feeds both d_img and d_W."""
    launched = []

    def fake_launch(name, pointers, dims, device):
        launched.append(name)
        pf.launch_count[name] += 1

    monkeypatch.setattr(pf, "_launch", fake_launch)
    monkeypatch.setattr(pf, "check_inputs", lambda *a: None)
    monkeypatch.setattr(pf, "_check_grad", lambda *a: None)
    meta = torch.device("meta")
    img = torch.empty(N, L, D, dtype=torch.bfloat16, device=meta)
    w = torch.empty(D, O * K, device=meta, requires_grad=True)
    b = torch.empty(O * K, device=meta, requires_grad=True)
    q = torch.empty(N, O * K, dtype=torch.bfloat16, device=meta,
                    requires_grad=True)
    before = dict(pf.launch_count)
    out = grid_fuse(img, w, b, q, K, train=True, rate=rate, site="pooled",
                    generator=torch.Generator())
    assert out.shape == (N, L, O) and out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert launched == ["forward", "g_pooled", "d_w"]
    assert {k: pf.launch_count[k] - before[k] for k in before} == \
        {"forward": 1, "g_pooled": 1, "d_img": 0, "d_w": 1}
    assert (w.grad.dtype, b.grad.dtype, q.grad.dtype) == (
        torch.float32, torch.float32, torch.bfloat16)
    # with img needing a gradient, d_img is launched too
    img.requires_grad_(True)
    grid_fuse(img, w, b, q, K, train=True, rate=rate, site="pooled",
              generator=torch.Generator()).float().sum().backward()
    assert launched[3:] == ["forward", "g_pooled", "d_img", "d_w"]
    assert img.grad.dtype == torch.bfloat16


# d_img on the card is two launches, the g_pooled build (shared with d_W)
# and the product over its bf16 operand gp [N, L, O8]; their plain versions
# composed are d_img_reference, bit for bit: the same bf16 g_pooled, the
# same bf16 wq and the same f32 product
@pytest.mark.parametrize("n,l,o,k", [(N, L, O, K), (2, 9, 18, 4)],
                         ids=["o20_k5", "o18_k4"])
def test_d_img_reference_is_the_g_pooled_build_then_the_product(n, l, o, k):
    img, w, b, q, g = _inputs(10, n=n, l=l, o=o, k=k)
    w_bf16, bf, qb = pf.operands(torch.from_numpy(w), torch.from_numpy(b),
                                 torch.from_numpy(q))
    ti = torch.from_numpy(img).to(torch.bfloat16)
    out = pf.forward_reference(ti, w_bf16, bf, qb, k)
    out[0, 0, :3] = 0.0  # the zero rule reaches the operand
    tg = torch.from_numpy(g)
    gp, d_bq = pf.g_pooled_reference(tg, out)
    o8 = -(-o // 8) * 8
    assert gp.dtype == torch.bfloat16 and gp.shape == (n, l, o8)
    assert (gp[..., o:] == 0).all() and (gp[0, 0, :3] == 0).all()
    assert torch.equal(gp[..., :o], pf.g_pooled(tg, out).to(torch.bfloat16))
    assert d_bq.dtype == torch.float32 and d_bq.shape == (n, o)
    assert torch.equal(d_bq, pf.g_pooled(tg, out).sum(dim=1))
    got = pf.d_img_from_gp_reference(gp, w_bf16, qb, k)
    assert got.dtype == torch.float32 and got.shape == (n, l, img.shape[2])
    assert torch.equal(got, pf.d_img_reference(tg, out, w_bf16, qb, k))


def test_g_pooled_launch_wrappers_refuse_cpu_tensors():
    img, w, b, q, g = _inputs(11)
    w_bf16, bf, qb = pf.operands(torch.from_numpy(w), torch.from_numpy(b),
                                 torch.from_numpy(q))
    ti = torch.from_numpy(img).to(torch.bfloat16)
    tg = torch.from_numpy(g)
    out = pf.forward_reference(ti, w_bf16, bf, qb, K)
    with pytest.raises(ValueError, match="CUDA"):
        pf.g_pooled_cuda(tg, out, ti, w_bf16, bf, qb, K)
    gp, d_bq = pf.g_pooled_reference(tg, out)
    with pytest.raises(ValueError, match="CUDA"):
        pf.d_img_from_gp_cuda(gp, ti, w_bf16, bf, qb, K)
    with pytest.raises(ValueError, match="CUDA"):
        pf.d_w_from_gp_cuda(gp, d_bq, ti, w_bf16, bf, qb, K)
