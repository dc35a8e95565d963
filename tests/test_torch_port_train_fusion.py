"""K2's mask and plain version (vqa_attention_networks_tpu_torch
ops/train_fusion.py) and the training branches of ``grid_fuse``, against the
JAX package on the same numpy inputs.

The TPU kernel's mask comes from the TPU's own generator, which neither runs
on the CPU nor can be reproduced, so JAX's side is its composed chain
``_grid_fuse_reference`` at rate 0, and at rate > 0 a JAX transcription of
that chain that takes the port's mask as numpy (the pattern of
``tests/test_train_fusion.py:95-105``). JAX runs in f32 on inputs that are
bf16 values, so its forward is the port's up to summation order.

Tolerances, per tensor, relative to the largest |value| of JAX's result:
- the forward as pooled = out * |out| (the signed sqrt would turn an f32
  difference e near 0 into sqrt(e)) and d_b: 1e-5 (f32 on both sides,
  summation order only);
- d_q: 2^-8. It is f32 on both sides but returned in q's dtype, bf16: one
  rounding, 2^-9 relative;
- d_W: 2^-8, d_img: 2^-7. The port rounds the f32 operand g_prod to bf16
  before these two products (one bf16 rounding, 2^-9 relative, per term),
  and d_img to bf16 after; JAX differentiates in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_attention_networks_tpu.models.layers import signed_sqrt as j_ssqrt
from vqa_attention_networks_tpu.ops.fusion import mfb_sumpool as j_sumpool
from vqa_attention_networks_tpu.ops.pallas_fusion import (
    _grid_fuse_reference as j_grid_ref,
)
from vqa_attention_networks_tpu_torch.ops import train_fusion as tf
from vqa_attention_networks_tpu_torch.ops.fusion import grid_fuse_pooled
from vqa_attention_networks_tpu_torch.ops.grid_fusion import (
    grid_fuse,
    grid_fuse_reference,
)

K = 5
RTOL = {"out": 1e-5, "d_img": 2.0 ** -7, "d_w": 2.0 ** -8, "d_b": 1e-5,
        "d_q": 2.0 ** -8}

# Random123's published answers for Philox4x32-10: (counter, key) -> word 0
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), 0x6627E8D5),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, 0x408F276D),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), 0xD16CFE09),
]


def philox_python(counter, key):
    """Philox4x32-10 in plain Python integers: all four output words."""
    m32 = 0xFFFFFFFF
    c, k = list(counter), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & m32, (k[1] + 0xBB67AE85) & m32]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & m32, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & m32]
    return c


def test_philox_python_transcription_matches_published_answers():
    for counter, key, word0 in PHILOX_KAT:
        assert philox_python(counter, key)[0] == word0


def test_philox_torch_matches_python_transcription():
    rng = np.random.default_rng(0)
    counters = np.concatenate([
        np.arange(64), rng.integers(0, 2 ** 32, 200),
        rng.integers(2 ** 32, 2 ** 40, 100),  # the high counter word
    ]).astype(np.int64)
    for seed in (0, 1234, 2 ** 31 - 1):
        got = tf.philox_word0(seed, torch.from_numpy(counters)).numpy()
        want = [philox_python((int(i) & 0xFFFFFFFF, int(i) >> 32, 0, 0),
                              (seed, 0))[0] for i in counters]
        np.testing.assert_array_equal(got, np.array(want, np.int64))
    assert int(tf.philox_word0(0, torch.zeros(1, dtype=torch.int64))[0]) \
        == PHILOX_KAT[0][2]


def test_mask_keep_rate_within_five_sigma():
    rate, n = 0.1, 1 << 21
    mask = tf.dropout_mask(7, 1, 1, n, rate)
    keep = 1.0 - rate
    sigma = (keep * rate / n) ** 0.5
    assert abs(float(mask.float().mean()) - keep) < 5 * sigma


def test_mask_is_a_function_of_seed_and_element_only(monkeypatch):
    base = tf.dropout_mask(3, 2, 3, 40, 0.3).flatten()
    assert torch.equal(base, tf.dropout_mask(3, 6, 1, 40, 0.3).flatten())
    assert torch.equal(base, tf.dropout_mask(3, 1, 1, 240, 0.3).flatten())
    # the plain version draws in chunks: another chunk size, the same bits
    monkeypatch.setattr(tf, "_MASK_CHUNK", 7)
    assert torch.equal(base, tf.dropout_mask(3, 2, 3, 40, 0.3).flatten())
    other = tf.dropout_mask(4, 2, 3, 40, 0.3).flatten()
    assert not torch.equal(base, other)
    assert float((base != other).float().mean()) > 0.2


def _inputs(n=3, l=12, d=48, o=8, seed=0, k=K):
    """bf16-valued numpy inputs: img, W, q on the bf16 grid, b f32."""
    rng = np.random.default_rng(seed)

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).to(
            torch.bfloat16).float().numpy()

    img = bf16(rng.standard_normal((n, l, d)) * 0.5)
    w = bf16(rng.standard_normal((d, o * k)) * 0.2)
    b = (rng.standard_normal(o * k) * 0.05).astype(np.float32)
    q = bf16(rng.standard_normal((n, o * k)) * 0.5)
    g = rng.standard_normal((n, l, o)).astype(np.float32)
    return img, w, b, q, g


def _port_value_and_grads(img, w, b, q, g, seed, rate, k=K):
    ti = torch.from_numpy(img).to(torch.bfloat16).requires_grad_(True)
    tw, tb = (torch.from_numpy(x).requires_grad_(True) for x in (w, b))
    tq = torch.from_numpy(q).to(torch.bfloat16).requires_grad_(True)
    before = dict(tf.launch_count)
    out = tf.train_grid_fuse(ti, tw, tb, tq, seed, k, rate)
    assert tf.launch_count == before  # a CPU tensor: the plain version
    out.backward(torch.from_numpy(g))
    return {"out": out.detach().numpy(), "d_img": ti.grad.float().numpy(),
            "d_w": tw.grad.numpy(), "d_b": tb.grad.numpy(),
            "d_q": tq.grad.float().numpy()}


def _jax_value_and_grads(fn, img, w, b, q, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (img, w, b, q)))
    grads = vjp(jnp.asarray(g))
    return dict(zip(("out", "d_img", "d_w", "d_b", "d_q"),
                    [np.asarray(x) for x in (out, *grads)]))


def _assert_close(got, want):
    for name, tol in RTOL.items():
        a, b = got[name], want[name]
        if name == "out":
            a, b = a * np.abs(a), b * np.abs(b)
        assert a.shape == b.shape and np.isfinite(a).all(), name
        err = np.abs(a - b).max()
        assert err <= tol * np.abs(b).max(), (name, err, np.abs(b).max())


def test_plain_version_matches_jax_composed_chain_at_rate_0():
    img, w, b, q, g = _inputs()
    got = _port_value_and_grads(img, w, b, q, g, seed=5, rate=0.0)
    want = _jax_value_and_grads(
        lambda i, ww, bb, qq: j_grid_ref(i, ww, bb, qq, K), img, w, b, q, g)
    _assert_close(got, want)


def _jax_masked_chain(mask, rate, k=K):
    """The composed chain with the dropout mask injected; the scale as
    the port applies it, z * (m * inv_keep)."""
    scale = jnp.asarray(mask.astype(np.float32) * (1.0 / (1.0 - rate)))

    def fn(img, w, b, q):
        z = jnp.dot(img, w, precision=jax.lax.Precision.HIGHEST)
        z = (z + b) * q[:, None, :]
        return j_ssqrt(j_sumpool(z * scale, k))

    return fn


def test_plain_version_matches_mask_injected_jax_chain_at_rate_0_3():
    rate, seed = 0.3, 11
    img, w, b, q, g = _inputs(seed=1)
    n, l, _ = img.shape
    mask = tf.dropout_mask(seed, n, l, w.shape[1], rate).numpy()
    got = _port_value_and_grads(img, w, b, q, g, seed, rate)
    want = _jax_value_and_grads(_jax_masked_chain(mask, rate), img, w, b, q,
                                g)
    _assert_close(got, want)
    # the mask is live: with another seed the output moves
    other = _port_value_and_grads(img, w, b, q, g, seed + 1, rate)["out"]
    assert np.abs(other - got["out"]).max() > 0.1 * np.abs(got["out"]).max()


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("l", [1, 208])
def test_plain_version_matches_jax_at_the_kernels_edge_shapes(l, rate):
    """L = 1 and 208 (the fewest and the most rows the K2 kernels take) at
    k = 8 (the largest): the composed chain at rate 0, the mask-injected
    chain at rate 0.3."""
    k, seed = 8, 13
    img, w, b, q, g = _inputs(n=2, l=l, d=40, o=3, seed=l, k=k)
    got = _port_value_and_grads(img, w, b, q, g, seed, rate, k=k)
    if rate == 0:
        fn = lambda i, ww, bb, qq: j_grid_ref(i, ww, bb, qq, k)  # noqa: E731
    else:
        mask = tf.dropout_mask(seed, 2, l, w.shape[1], rate).numpy()
        fn = _jax_masked_chain(mask, rate, k=k)
    _assert_close(got, _jax_value_and_grads(fn, img, w, b, q, g))


def test_zero_cotangent_rule_at_pooled_zero():
    """pooled == 0 -> the cotangent through the signed sqrt is 0, as
    jax.grad of the composed chain gives (relu'(0) = 0). Region 0 of sample
    0 is all zeros and b is 0, so that row pools to exactly 0 with the mask
    on, and its d_img and its share of d_b must be 0: a clamped 1/|out|
    would put 0.5e20 * g there."""
    rate, seed = 0.3, 2
    img, w, b, q, g = _inputs(seed=3)
    img[0, 0] = 0.0
    b[:] = 0.0
    n, l, _ = img.shape
    mask = tf.dropout_mask(seed, n, l, w.shape[1], rate).numpy()
    got = _port_value_and_grads(img, w, b, q, g, seed, rate)
    assert (got["out"][0, 0] == 0).all()
    assert (got["d_img"][0, 0] == 0).all()
    want = _jax_value_and_grads(_jax_masked_chain(mask, rate), img, w, b, q,
                                g)
    _assert_close(got, want)
    # the rule against the composed derivative elsewhere
    x = jnp.asarray([-4.0, -0.25, 0.0, 0.25, 4.0])
    composed = jax.vmap(jax.grad(j_ssqrt))(x)
    out = torch.from_numpy(np.array(j_ssqrt(x)))
    rule = tf._g_zd(torch.ones(1, 5), out[None], 1, None)[0].numpy()
    np.testing.assert_allclose(np.asarray(composed), rule, rtol=1e-6)


def test_grid_fuse_training_dispatch():
    img, w, b, q, _ = _inputs(seed=4)
    ti = torch.from_numpy(img).to(torch.bfloat16)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    # bf16 with rate > 0: K2 (its plain version on a CPU tensor)
    got = grid_fuse(ti, tw, tb, tq, K, train=True, rate=0.1, seed=9)
    want = tf.train_grid_fuse_reference(ti, tw, tb, tq, 9, K, 0.1)
    assert torch.equal(got, want)
    assert torch.equal(got, grid_fuse(ti, tw, tb, tq, K, train=True,
                                      rate=0.1, seed=9,
                                      reference_kernel=True))
    with pytest.raises(ValueError, match="seed"):
        grid_fuse(ti, tw, tb, tq, K, train=True, rate=0.1)
    # bf16 at rate 0 and f32: the composed chain, as JAX dispatches
    for x in (ti, ti.float()):
        out = grid_fuse(x, tw, tb, tq, K, train=True, rate=0.0)
        assert out.dtype == torch.float32
        ref = np.asarray(j_grid_ref(jnp.asarray(x.float().numpy()),
                                    jnp.asarray(w), jnp.asarray(b),
                                    jnp.asarray(q), K))
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    # f32 with rate > 0: the composed chain with its dropout
    gen = torch.Generator().manual_seed(0)
    out = grid_fuse(ti.float(), tw, tb, tq, K, train=True, rate=0.5,
                    generator=gen)
    again = grid_fuse_reference(ti.float(), tw, tb, tq, K, rate=0.5,
                                generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    # site="pooled": grid_fuse_pooled (K3 at bf16, its plain version on a
    # CPU tensor), whatever the rate, its mask from the generator
    for rate in (0.0, 0.1):
        out = grid_fuse(ti, tw, tb, tq, K, train=True, rate=rate, seed=1,
                        site="pooled", generator=torch.Generator()
                        .manual_seed(3))
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, grid_fuse_pooled(
            ti, tw, tb, tq, K, rate=rate,
            generator=torch.Generator().manual_seed(3)))


def test_kernel_wrappers_refuse_cpu_tensors():
    img, w, b, q, g = _inputs(seed=5)
    w_bf16, bf, qf = tf.operands(torch.from_numpy(w), torch.from_numpy(b),
                                 torch.from_numpy(q))
    ti = torch.from_numpy(img).to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tf.forward_cuda(ti, w_bf16, bf, qf, 0, K, 0.1)
    out = tf.forward_reference(ti, w_bf16, bf, qf, K, None)
    for fn in (tf.d_img_cuda, tf.d_w_cuda, tf.d_q_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(torch.from_numpy(g), out, ti, w_bf16, bf, qf, 0, K, 0.1)


# d_W/d_b in two launches on the card: the g_prod build, then the product
# over its bf16 operand. Their plain versions composed are d_w_reference,
# whose d_W is the same product on the same bf16 operand as before the
# split (bit-equal), and whose d_b is summed in chunks of DB_CHUNK rows: a
# reordering of an f32 sum over M rows, within (M - 1) * 2^-24 * sum |x| of
# any other order.
def _d_w_before_the_split(g, out, img, q, keep):
    n, l, d = img.shape
    g_prod = tf._g_prod(g, out, q, K, keep)
    x = img.to(torch.bfloat16).float().reshape(n * l, d)
    d_w = torch.matmul(x.t(), g_prod.to(torch.bfloat16).float()
                       .reshape(n * l, -1))
    return d_w, g_prod.sum(dim=(0, 1)), g_prod


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_d_w_reference_is_the_g_prod_build_then_the_product(rate):
    img, w, b, q, g = _inputs(n=3, l=50, seed=6)  # M = 150: 3 chunks, ragged
    w_bf16, bf, qf = tf.operands(torch.from_numpy(w), torch.from_numpy(b),
                                 torch.from_numpy(q))
    ti = torch.from_numpy(img).to(torch.bfloat16)
    n, l, _ = img.shape
    mask = tf.dropout_mask(11, n, l, w.shape[1], rate) if rate > 0 else None
    keep = tf.keep_scale(mask, rate)
    out = tf.forward_reference(ti, w_bf16, bf, qf, K, keep)
    tg = torch.from_numpy(g)
    g_prod, partials = tf.g_prod_reference(tg, out, qf, K, keep)
    m, f = n * l, w.shape[1]
    assert g_prod.dtype == torch.bfloat16 and g_prod.shape == (m, f)
    assert partials.dtype == torch.float32
    assert partials.shape == (-(-m // tf.DB_CHUNK), f)
    want_w, want_b, g32 = _d_w_before_the_split(tg, out, ti, qf, keep)
    g32 = g32.reshape(m, f)
    assert torch.equal(g_prod, g32.to(torch.bfloat16))
    for i in range(partials.shape[0]):
        rows = g32[i * tf.DB_CHUNK:(i + 1) * tf.DB_CHUNK]
        bound = rows.shape[0] * 2.0 ** -24 * rows.abs().sum(0)
        assert ((partials[i] - rows.sum(0)).abs() <= bound).all()
    assert torch.equal(tf.d_w_from_operand_reference(ti, g_prod), want_w)
    d_w, d_b = tf.d_w_reference(tg, out, ti, qf, K, keep)
    assert torch.equal(d_w, want_w)
    bound = m * 2.0 ** -24 * g32.abs().sum(0)
    assert ((d_b - want_b).abs() <= bound).all()
    # the zero rule and the mask reach the operand: rows that pool to 0 and
    # dropped elements are 0 in g_prod
    if mask is not None:
        assert (g_prod.reshape(n, l, f)[~mask] == 0).all()


def test_d_w_launch_wrappers_refuse_cpu_tensors():
    img, w, b, q, g = _inputs(seed=7)
    w_bf16, bf, qf = tf.operands(torch.from_numpy(w), torch.from_numpy(b),
                                 torch.from_numpy(q))
    ti = torch.from_numpy(img).to(torch.bfloat16)
    out = tf.forward_reference(ti, w_bf16, bf, qf, K, None)
    with pytest.raises(ValueError, match="CUDA"):
        tf.g_prod_cuda(torch.from_numpy(g), out, ti, w_bf16, bf, qf, 0, K,
                       0.1)
    g_prod, partials = tf.g_prod_reference(torch.from_numpy(g), out, qf, K,
                                           None)
    with pytest.raises(ValueError, match="on the card"):
        tf.d_w_from_operand_cuda(ti, g_prod, partials)


# d_img on the card is two launches, the g_prod build (shared with d_W) and
# the product over its bf16 operand; their plain versions composed are
# d_img_reference, bit for bit: the same bf16 g_prod and the same product
@pytest.mark.parametrize("rate", [0.1, 0.0])
def test_d_img_reference_is_the_g_prod_build_then_the_product(rate):
    img, w, b, q, g = _inputs(n=3, l=50, seed=8)
    w_bf16, bf, qf = tf.operands(torch.from_numpy(w), torch.from_numpy(b),
                                 torch.from_numpy(q))
    ti = torch.from_numpy(img).to(torch.bfloat16)
    n, l, d = img.shape
    mask = tf.dropout_mask(12, n, l, w.shape[1], rate) if rate > 0 else None
    keep = tf.keep_scale(mask, rate)
    out = tf.forward_reference(ti, w_bf16, bf, qf, K, keep)
    tg = torch.from_numpy(g)
    g_prod, _ = tf.g_prod_reference(tg, out, qf, K, keep)
    got = tf.d_img_from_operand_reference(g_prod, w_bf16, n, l)
    assert got.dtype == torch.bfloat16 and got.shape == (n, l, d)
    assert torch.equal(got.view(torch.int16),
                       tf.d_img_reference(tg, out, w_bf16, qf, K, keep)
                       .view(torch.int16))


def test_d_img_launch_wrapper_refuses_cpu_tensors():
    img, w, b, q, g = _inputs(seed=9)
    w_bf16, bf, qf = tf.operands(torch.from_numpy(w), torch.from_numpy(b),
                                 torch.from_numpy(q))
    ti = torch.from_numpy(img).to(torch.bfloat16)
    out = tf.forward_reference(ti, w_bf16, bf, qf, K, None)
    g_prod, _ = tf.g_prod_reference(torch.from_numpy(g), out, qf, K, None)
    n, l, _ = img.shape
    with pytest.raises(ValueError, match="on the card"):
        tf.d_img_from_operand_cuda(g_prod, w_bf16, n, l)


@pytest.mark.parametrize("img_grad", [False, True],
                         ids=["img_is_data", "img_needs_a_gradient"])
def test_backward_builds_g_prod_once(monkeypatch, img_grad):
    """TrainGridFuse with each launch wrapper replaced by a recorder that
    returns zeros of its output's shape (there is no card here): the
    backward builds g_prod once, and d_img, when img needs a gradient,
    reads the very tensor that d_W reads."""
    n, l, d, o = 3, 12, 48, 8
    f = o * K
    calls = []

    def record(name, result):
        def wrapper(*args):
            calls.append((name, args, result(*args)))
            return calls[-1][2]
        monkeypatch.setattr(tf, name, wrapper)

    record("forward_cuda", lambda *a: torch.zeros(n, l, o))
    record("g_prod_cuda", lambda *a: (
        torch.zeros(n * l, f, dtype=torch.bfloat16),
        torch.zeros(-(-n * l // tf.DB_CHUNK), f)))
    record("d_img_from_operand_cuda",
           lambda *a: torch.zeros(n, l, d, dtype=torch.bfloat16))
    record("d_w_from_operand_cuda",
           lambda *a: (torch.zeros(d, f), torch.zeros(f)))
    record("d_q_cuda", lambda *a: torch.zeros(n, f))
    img = torch.zeros(n, l, d, dtype=torch.bfloat16, requires_grad=img_grad)
    w = torch.zeros(d, f, requires_grad=True)
    b = torch.zeros(f, requires_grad=True)
    q = torch.zeros(n, f, dtype=torch.bfloat16, requires_grad=True)
    tf.TrainGridFuse.apply(img, w, b, q, 3, K, 0.1).sum().backward()
    names = [name for name, _, _ in calls]
    assert names == ["forward_cuda", "g_prod_cuda"] + [
        "d_img_from_operand_cuda"] * img_grad + ["d_w_from_operand_cuda",
                                                 "d_q_cuda"]
    g_prod, partials = calls[1][2]
    d_w_args = calls[-2][1]
    assert d_w_args[1] is g_prod and d_w_args[2] is partials
    if img_grad:
        assert calls[2][1][0] is g_prod and calls[2][1][2:] == (n, l)
        assert img.grad.dtype == torch.bfloat16 and img.grad.shape == (n, l, d)
    else:
        assert img.grad is None


# K2's plain mask at row0 = 0 before the row offset existed (dropout_mask(5,
# 4, 196, 520, 0.1)): the offset keeps these bits
MASK_ROW0_ZERO_DIGEST = (
    "e8ad4d3f48b2692f6924373d0860e0976202a0348db7bbba84c83901e633a464")


def test_mask_keeps_its_bits_at_row0_zero():
    import hashlib

    for mask in (tf.dropout_mask(5, 4, 196, 520, 0.1),
                 tf.dropout_mask(5, 4, 196, 520, 0.1, row0=0)):
        assert hashlib.sha256(mask.numpy().tobytes()).hexdigest() == \
            MASK_ROW0_ZERO_DIGEST


@pytest.mark.parametrize("row0", [1, 3])
def test_row0_draws_the_global_rows(row0):
    """A rank holding samples [row0, row0 + n) of a global batch draws
    those rows of the global mask (counter ((row0 + n)*L + l)*F + c), in
    the mask, the plain forward and every gradient; at another row0 it
    draws other bits."""
    n_all, n, l, d, f, k, seed, rate = 5, 2, 9, 16, 40, 5, 7, 0.3
    whole = tf.dropout_mask(seed, n_all, l, f, rate)
    part = tf.dropout_mask(seed, n, l, f, rate, row0=row0)
    assert torch.equal(part, whole[row0:row0 + n])
    assert not torch.equal(tf.dropout_mask(seed, n, l, f, rate), part)
    g = torch.Generator().manual_seed(row0)
    img = torch.randn(n_all, l, d, generator=g).to(torch.bfloat16)
    w = torch.randn(d, f, generator=g, requires_grad=True)
    b = torch.randn(f, generator=g, requires_grad=True)
    q = torch.randn(n_all, f, generator=g, requires_grad=True)
    cot = torch.randn(n_all, l, f // k, generator=g)
    rows = slice(row0, row0 + n)
    full = tf.train_grid_fuse(img, w, b, q, seed, k, rate)
    (full[rows] * cot[rows]).sum().backward()
    want = [x.grad.clone() for x in (w, b, q)]
    for x in (w, b, q):
        x.grad = None
    got = tf.train_grid_fuse(img[rows], w, b, q[rows], seed, k, rate, row0)
    (got * cot[rows]).sum().backward()
    np.testing.assert_allclose(got.detach(), full[rows].detach(), rtol=1e-6,
                               atol=1e-6)
    for x, wg in zip((w, b), want[:2]):
        np.testing.assert_allclose(x.grad, wg, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(q.grad[rows], want[2][rows], rtol=1e-5,
                               atol=1e-6)
