"""The hand-written kernels (K1 to K8) on the card against their plain
PyTorch versions.

These need an NVIDIA card (sm_90a) and the CUDA toolkit; without a card
they skip. Kernel and plain version share their rounding points and differ
only in the order of their f32 sums, which can move an intermediate across
a bf16 boundary. Each kernel is held to its tolerance in
``ops/card_cases.py``, where each is explained, and its inputs come from
there too (``chip_smoke.py`` and ``step_time.py`` use the same): K1's
scratch z before its signed sqrt, and h1, to one bf16 ulp plus a little;
its output per glimpse row at atol + four bf16 ulps of the row's largest
magnitude, on inputs that peak the attention over the L regions, so that
a fault upstream of the softmax moves the output well past the tolerance.

K2 (forward, d_img, d_W/d_b, d_q) shares every rounding point with its
plain version and differs in the order of its f32 sums only; each launch
is held per tensor at ``card_cases.K2_RTOL`` of the plain result's largest
|value| (the forward as pooled = out * |out|), the backward launches on
the kernel's own forward output. d_W/d_b's first launch, the g_prod build,
is elementwise with no sum but the d_b partials: its bf16 operand is held
bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vqa_attention_networks_tpu_torch.ops import card_cases as cc
from vqa_attention_networks_tpu_torch.ops import train_fusion as tf
from vqa_attention_networks_tpu_torch.ops import wq_fusion as wqf

pytestmark = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs an NVIDIA card (the CUDA kernel has no CPU mode)",
)

K, C, G, L = cc.K, cc.C, 2, cc.L


def _inputs(n, d, o, seed=0, device="cuda", l=L, k=K, g=G, c=C):
    rng = np.random.default_rng(seed)

    def t(shape, scale):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * scale
        ).to(device)

    img = t((n, l, d), 0.5).to(torch.bfloat16)
    q = t((n, o * k), 0.5)
    # zb is a few 1e-3 per element after the grid-flat norm: c1w ~ N(0, 1)
    # with no bias and c2w ~ 3 N(0, 1) make the logits span several units
    sw = wqf.prepare_stage1_weights(
        t((d, o * k), 0.05), t((o * k,), 0.05), t((o, c), 1.0), t((c,), 0.0),
        t((c, g), 3.0), t((g,), 0.05), k,
    )
    return img, q, sw


@pytest.mark.parametrize("n,d,o", [(4, 128, 100), (8, 2048, 1000)],
                         ids=["small", "production"])
def test_kernel_matches_plain_version(n, d, o):
    torch.backends.cuda.matmul.allow_tf32 = False
    img, q, sw = _inputs(n, d, o)
    before = wqf.launch_count
    got, z, h1 = wqf.stage1_coattention_cuda(img, q, sw, intermediates=True)
    torch.cuda.synchronize()
    assert wqf.launch_count == before + 1
    want, want_z, want_h1 = wqf.stage1_coattention_reference(
        img, q, sw, intermediates=True)
    assert got.dtype == torch.bfloat16 and got.shape == (n, G * d)
    assert torch.isfinite(got.float()).all()
    # control: the check rejects most of a uniform-attention output
    uniform = img.float().mean(1, keepdim=True).expand(n, G, d)
    assert (~cc.within(uniform, want, d)).float().mean() >= 0.5
    torch.testing.assert_close(z * z.abs(), want_z * want_z.abs(),
                               atol=cc.POOLED_ATOL,
                               rtol=cc.POOLED_RTOL)
    torch.testing.assert_close(h1.float(), want_h1.float(),
                               atol=cc.H1_ATOL, rtol=cc.H1_RTOL)
    assert cc.within(got, want, d).all()
    # no atomics: a rerun gives the same bits
    assert torch.equal(got, wqf.stage1_coattention(img, q, sw))


# K1 at the edges of what it takes: N not a multiple of the two samples a
# block owns (1, 3, 257), L short of and at the 208-row limit, D not a
# multiple of the 32-deep ring stage, k at 1 and 16 (one ring stage), and C
# neither a multiple of the 128-column tile nor of 8 (prepare_stage1_weights
# pads c1w's columns to 8 for TMA)
@pytest.mark.parametrize("n,l,d,o,k,c", [
    (1, 196, 256, 100, 5, C), (3, 196, 256, 100, 5, C),
    (257, 196, 128, 64, 5, C), (2, 100, 256, 100, 5, C),
    (2, 208, 264, 100, 5, C), (3, 196, 256, 100, 1, C),
    (2, 196, 128, 64, 16, C), (3, 196, 256, 100, 5, 150)],
    ids=["n1", "n3", "n257", "l100", "l208", "k1", "k16", "c150"])
def test_k1_edges_match_plain_version(n, l, d, o, k, c):
    torch.backends.cuda.matmul.allow_tf32 = False
    img, q, sw = _inputs(n, d, o, seed=n + l + k, l=l, k=k, c=c)
    got, z, h1 = wqf.stage1_coattention_cuda(img, q, sw, intermediates=True)
    want, want_z, want_h1 = wqf.stage1_coattention_reference(
        img, q, sw, intermediates=True)
    assert got.shape == (n, G * d) and torch.isfinite(got.float()).all()
    torch.testing.assert_close(z * z.abs(), want_z * want_z.abs(),
                               atol=cc.POOLED_ATOL,
                               rtol=cc.POOLED_RTOL)
    torch.testing.assert_close(h1.float(), want_h1.float(),
                               atol=cc.H1_ATOL, rtol=cc.H1_RTOL)
    assert cc.within(got, want, d).all()
    assert torch.equal(got, wqf.stage1_coattention_cuda(img, q, sw))


def test_wrapper_raises_on_inputs_it_does_not_take():
    img, q, sw = _inputs(2, 128, 100)
    with pytest.raises(TypeError):
        wqf.stage1_coattention_cuda(img.float(), q, sw)
    with pytest.raises(ValueError, match="CUDA"):
        wqf.stage1_coattention_cuda(img.cpu(), q.cpu(), sw)
    with pytest.raises(ValueError, match="on"):
        wqf.stage1_coattention_cuda(img, q.cpu(), sw)
    strided = img.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        wqf.stage1_coattention_cuda(strided, q, sw)
    img124, q124, sw124 = _inputs(2, 124, 100)
    with pytest.raises(ValueError, match="D % 8"):
        wqf.stage1_coattention_cuda(img124, q124, sw124)
    shifted = torch.empty(img.numel() + 1, dtype=img.dtype,
                          device=img.device)[1:].view(img.shape)
    shifted.copy_(img)
    assert shifted.is_contiguous()
    with pytest.raises(ValueError, match="aligned"):
        wqf.stage1_coattention_cuda(shifted, q, sw)
    # c1w as prepare_stage1_weights does not lay it out (511 columns)
    unpadded = dataclasses.replace(sw, c1w=sw.c1w[:, :-1].contiguous(),
                                   c1b=sw.c1b[:-1].contiguous())
    with pytest.raises(ValueError, match="prepare_stage1_weights"):
        wqf.stage1_coattention_cuda(img, q, unpadded)
    # and it takes the smallest and largest shapes it took before: N = 1,
    # L = 1, D = 8, k = 16, G = 8; L = 208, D = 2056
    for n, l, d, k, g in ((1, 1, 8, 16, 8), (2, 208, 2056, 1, 1)):
        img, q, sw = _inputs(n, d, 10, l=l, k=k, g=g)
        assert wqf.stage1_coattention_cuda(img, q, sw).shape == (n, g * d)


def _k2_inputs(n, d, o, seed=0, device="cuda", l=L, k=K):
    """``card_cases.k2_inputs`` without the forced zeros, as K2's launches
    take them: bf16 img, the operands (bf16 W, f32 b and q), f32 g."""
    img, w, b, q, g = cc.k2_inputs(n, seed, device, l=l, d=d, o=o, k=k,
                                   zeros=0)
    return (img, *tf.operands(w, b, q), g)


# besides the small and production shapes, d_q's edges: N = 1, 3, 65; L =
# 1, 100 and 208 (past 200 the kernel takes its 208-row form); k = 1 and 8
@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("n,l,d,o,k", [
    (4, L, 128, 128, K), (8, L, 2048, 1000, K), (1, 1, 128, 16, 8),
    (3, 100, 136, 40, 1), (65, 208, 256, 104, K), (3, 208, 72, 17, 8)],
    ids=["small", "production", "n1_l1_k8", "n3_l100_k1", "n65_l208",
         "l208_k8"])
def test_k2_launches_match_plain_versions(n, l, d, o, k, rate):
    torch.backends.cuda.matmul.allow_tf32 = False
    img, w_bf16, b, q, g = _k2_inputs(n, d, o, l=l, k=k)
    seed = 77
    mask = tf.dropout_mask(seed, n, l, o * k, rate, img.device) \
        if rate > 0 else None
    keep = tf.keep_scale(mask, rate)

    def launches():
        out = tf.forward_cuda(img, w_bf16, b, q, seed, k, rate)
        args = (g, out, img, w_bf16, b, q, seed, k, rate)
        g_prod, partials = tf.g_prod_cuda(*args)
        d_w, d_b = tf.d_w_from_operand_cuda(img, g_prod, partials)
        return {"forward": out, "d_img": tf.d_img_cuda(*args), "d_w": d_w,
                "d_b": d_b, "d_q": tf.d_q_cuda(*args), "g_prod": g_prod}

    before = dict(tf.launch_count)
    got = launches()
    torch.cuda.synchronize()
    # d_img_cuda builds its own g_prod, then the product over it
    assert {k: tf.launch_count[k] - before[k] for k in before} == \
        {"forward": 1, "d_img": 1, "g_prod": 2, "d_w": 1, "d_q": 1}
    out = got["forward"]
    # the bf16 operand, bit for bit (as int16: a -0 is not a +0)
    g_prod = tf.g_prod_reference(g, out, q, k, keep)[0]
    assert torch.equal(got["g_prod"].view(torch.int16),
                       g_prod.view(torch.int16))
    d_w, d_b = tf.d_w_reference(g, out, img, q, k, keep)
    want = {"forward": tf.forward_reference(img, w_bf16, b, q, k, keep),
            "d_img": tf.d_img_reference(g, out, w_bf16, q, k, keep),
            "d_w": d_w, "d_b": d_b,
            "d_q": tf.d_q_reference(g, out, img, w_bf16, b, k, keep)}
    again = launches()
    for name in want:
        assert torch.isfinite(got[name].float()).all(), name
        assert cc.k2_within(name, got[name], want[name]).all(), name
        # no atomics: a rerun gives the same bits
        assert torch.equal(got[name], again[name]), name
    assert torch.equal(got["g_prod"], again["g_prod"])
    # the mask replays: pooled is 0 exactly where all k factors dropped
    # (elsewhere an f32 sum may cancel to exactly 0 on one side only)
    if mask is not None:
        dropped = ~mask.reshape(n, l, o, k).any(-1)
        assert bool((out[dropped] == 0).all())
        assert bool((want["forward"][dropped] == 0).all())


# the forward kernel (K2's, and with the mask compiled out K5's) at the
# edges of its tiles: M = N*L short of one row tile and not a multiple of
# it, D not a multiple of the 64-deep ring stage, O not a multiple of the
# 32-output tile (1000; 17 at K = 8, as F % 8 == 0 asks), K = 1 and 8
@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("n,l,d,o,k", [
    (3, 37, 136, 1000, 5), (2, 196, 2048, 17, 8), (5, 50, 64, 40, 1),
    (7, 196, 200, 24, 5)], ids=["short_m", "o17_k8", "k1", "ragged"])
def test_forward_kernel_edges_match_plain_version(n, l, d, o, k, rate):
    from vqa_attention_networks_tpu_torch.ops import grid_fusion as gf

    torch.backends.cuda.matmul.allow_tf32 = False
    img, w_bf16, b, q, _ = _k2_inputs(n, d, o, seed=n + k, l=l, k=k)
    seed = 99
    keep = tf.keep_scale(tf.dropout_mask(seed, n, l, o * k, rate, img.device),
                         rate) if rate > 0 else None
    got = tf.forward_cuda(img, w_bf16, b, q, seed, k, rate)
    want = tf.forward_reference(img, w_bf16, b, q, k, keep)
    if rate == 0:  # K5: the same kernel with its mask compiled out
        k5 = gf.inference_fusion_cuda(img, w_bf16.float(), b, q, k)
        assert torch.equal(k5, got)
    assert got.shape == (n, l, o) and torch.isfinite(got).all()
    assert cc.k2_within("forward", got, want).all()
    assert torch.equal(got, tf.forward_cuda(img, w_bf16, b, q, seed, k, rate))
    if rate > 0:  # the mask replays: all k factors dropped gives 0
        dropped = ~tf.dropout_mask(seed, n, l, o * k, rate,
                                   img.device).reshape(n, l, o, k).any(-1)
        assert bool((got[dropped] == 0).all())


def test_k2_autograd_launches_the_kernels():
    img, w_bf16, b, q, g = _k2_inputs(4, 128, 128, seed=1)
    w = w_bf16.float().requires_grad_(True)
    bb = b.clone().requires_grad_(True)
    qq = q.to(torch.bfloat16).requires_grad_(True)
    before = dict(tf.launch_count)
    out = tf.train_grid_fuse(img, w, bb, qq, 5, K, 0.1)
    out.backward(g)
    torch.cuda.synchronize()
    # img needs no gradient: d_img is not launched
    assert {k: tf.launch_count[k] - before[k] for k in before} == \
        {"forward": 1, "d_img": 0, "g_prod": 1, "d_w": 1, "d_q": 1}
    assert w.grad.dtype == torch.float32 and qq.grad.dtype == torch.bfloat16
    assert all(torch.isfinite(x.grad.float()).all() for x in (w, bb, qq))


def test_k2_backward_with_img_grad_builds_g_prod_once():
    """With img needing a gradient, the backward builds g_prod once and
    both d_img and d_W read it; d_img agrees with the plain version."""
    img, w_bf16, b, q, g = _k2_inputs(4, 128, 128, seed=2)
    img = img.requires_grad_(True)
    w = w_bf16.float().requires_grad_(True)
    bb = b.clone().requires_grad_(True)
    qq = q.to(torch.bfloat16).requires_grad_(True)
    before = dict(tf.launch_count)
    out = tf.train_grid_fuse(img, w, bb, qq, 5, K, 0.1)
    out.backward(g)
    torch.cuda.synchronize()
    assert {k: tf.launch_count[k] - before[k] for k in before} == \
        {"forward": 1, "d_img": 1, "g_prod": 1, "d_w": 1, "d_q": 1}
    keep = tf.keep_scale(tf.dropout_mask(5, *img.shape[:2], w.shape[1], 0.1,
                                         img.device), 0.1)
    want = tf.d_img_reference(g, out.detach(), w_bf16, q, K, keep)
    assert img.grad.dtype == torch.bfloat16
    assert cc.k2_within("d_img", img.grad, want).all()


@pytest.mark.parametrize("rate", [0.1, 0.0])
def test_k2_d_img_matches_plain_version_at_chip_smoke_inputs(rate):
    """K2's d_img product over the g_prod operand at the card inputs of
    N = 64 that ``chip_smoke.py``'s K2 check and ``step_time.py`` take
    (``card_cases.k2_inputs``): within K2's tolerance of the plain version,
    the same as the build-and-product call, and a rerun gives the same
    sha256."""
    import hashlib

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, n, seed = torch.device("cuda"), 64, 7
    img, w, b, q, g = cc.k2_inputs(n, 3, dev)
    w_bf16, bf, qf = tf.operands(w, b, q)
    l, f = img.shape[1], w.shape[1]
    keep = tf.keep_scale(tf.dropout_mask(seed, n, l, f, rate, dev), rate) \
        if rate > 0 else None
    out = tf.forward_cuda(img, w_bf16, bf, qf, seed, K, rate)
    args = (g, out, img, w_bf16, bf, qf, seed, K, rate)
    g_prod, _ = tf.g_prod_cuda(*args)
    got = tf.d_img_from_operand_cuda(g_prod, w_bf16, n, l)
    want = tf.d_img_reference(g, out, w_bf16, qf, K, keep)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert bool(cc.k2_within("d_img", got, want).all())
    assert torch.equal(got, tf.d_img_cuda(*args))

    def digest(x):
        return hashlib.sha256(x.view(torch.int16).cpu().numpy().tobytes()
                              ).hexdigest()

    again = tf.d_img_from_operand_cuda(g_prod, w_bf16, n, l)
    assert digest(got) == digest(again)


def test_k2_wrappers_raise_on_inputs_they_do_not_take():
    img, w_bf16, b, q, g = _k2_inputs(2, 128, 128)
    with pytest.raises(TypeError):
        tf.forward_cuda(img.float(), w_bf16, b, q, 0, K, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tf.forward_cuda(img.cpu(), w_bf16.cpu(), b.cpu(), q.cpu(), 0, K, 0.1)
    with pytest.raises(ValueError, match="on"):
        tf.forward_cuda(img, w_bf16, b, q.cpu(), 0, K, 0.1)
    with pytest.raises(ValueError, match="rate"):
        tf.forward_cuda(img, w_bf16, b, q, 0, K, 1.0)
    with pytest.raises(ValueError, match="k <="):
        tf.forward_cuda(img, w_bf16, b, q, 0, 10, 0.1)
    i124, w124, b124, q124, _ = _k2_inputs(2, 124, 128)
    with pytest.raises(ValueError, match="D % 8"):
        tf.forward_cuda(i124, w124, b124, q124, 0, K, 0.1)
    out = tf.forward_cuda(img, w_bf16, b, q, 0, K, 0.1)
    with pytest.raises(ValueError, match="contiguous f32"):
        tf.d_w_cuda(g.double(), out, img, w_bf16, b, q, 0, K, 0.1)
    # and it takes the smallest and largest shapes it took before: N = 1,
    # L = 1, D = 8, F = 8 at K = 8 (one output); L = 208 at K = 1; and
    # d_q takes them too, and L = 201 (its 208-row form)
    for n, l, d, o, k in ((1, 1, 8, 1, 8), (2, 208, 72, 8, 1),
                          (3, 201, 64, 8, 1)):
        img, w_bf16, b, q, g = _k2_inputs(n, d, o, l=l, k=k)
        out = tf.forward_cuda(img, w_bf16, b, q, 0, k, 0.1)
        assert out.shape == (n, l, o)
        d_q = tf.d_q_cuda(g, out, img, w_bf16, b, q, 0, k, 0.1)
        keep = tf.keep_scale(tf.dropout_mask(0, n, l, o * k, 0.1,
                                             img.device), 0.1)
        want = tf.d_q_reference(g, out, img, w_bf16, b, k, keep)
        assert d_q.shape == (n, o * k) and torch.isfinite(d_q).all()
        assert cc.k2_within("d_q", d_q, want).all()


# --------------------------------------------------------------------------
# K4, K5, K7 (the hieCoAtten core, the inference fusion, the glimpse block)
# --------------------------------------------------------------------------

# K4, K5 and K7 against their plain versions: ``card_cases``' K4 (v and q
# at 2^-7 of the largest value, the maps element by element at 2^-6 of
# each value plus 1e-6, so that a uniform map cannot pass on the near-zero
# elements of a peaked one), K5 (K2's forward) and K7 (each glimpse row at
# 2^-7 of its largest value) tolerances
K4_NAMES = ("v", "q", "av", "aq")


def _bf16(rng, shape, scale, device="cuda"):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            * scale).to(device).to(torch.bfloat16)


def _k4_inputs(n, l, t, e, seed=0, misalign=False):
    """K4's inputs; ``misalign`` places each activation 4 bytes past a
    16-byte boundary (contiguous all the same), so the kernel copies rows
    4 bytes at a time. A draw of this test's own, not
    ``card_cases.k4_inputs``: at ``k4_inputs(8, 0)`` the plain f32
    version, which these cases hold K4 to, puts one av element 1.8% from
    the f64 version (``k4_precision.f64_version``), past the map
    tolerance, where K4 agrees with the f64 version to 1e-8 (ROADMAP,
    Queue 3, K4's precision)."""
    rng = np.random.default_rng(seed)

    def act(shape, scale):
        x = _bf16(rng, shape, scale)
        if not misalign:
            return x
        buf = torch.empty(x.numel() + 2, dtype=x.dtype, device=x.device)
        y = buf[2:].view(shape)
        y.copy_(x)
        return y

    return (act((n, l, e), 0.5), act((n, t, e), 0.5),
            act((n, l, e), 0.3), act((n, t, e), 0.3),
            act((n, l, e), 0.5), act((n, t, e), 0.5),
            _bf16(rng, (e, 1), 0.4), _bf16(rng, (e, 1), 0.4))


# the padding edges of the kernel: T padded to 32 (T = 1, 8, 22, 32), L to
# 32-row chunks (L = 1, 17, 196, 1024), E to 128-column slices (E = 2, 62:
# 4-byte copies; 512; 600: a partial last slice), odd N, and inputs that
# are 4-byte but not 16-byte aligned
@pytest.mark.parametrize("n,l,t,e,misalign", [
    (3, 20, 5, 62, False), (8, 196, 22, 512, False),
    (5, 1, 1, 2, False), (7, 17, 8, 62, False), (3, 1024, 32, 512, False),
    (9, 17, 22, 2, False), (5, 196, 1, 512, False), (1, 196, 32, 62, False),
    (3, 1024, 8, 2, False), (5, 1, 32, 512, False), (3, 50, 22, 600, False),
    (3, 196, 22, 512, True)],
    ids=["ragged", "production", "t1_l1_e2", "t8_l17_e62",
         "t32_l1024_e512", "t22_l17_e2", "t1_l196_e512", "n1_t32_l196_e62",
         "t8_l1024_e2", "t32_l1_e512", "t22_l50_e600", "misaligned"])
def test_k4_matches_plain_version(n, l, t, e, misalign):
    from vqa_attention_networks_tpu_torch.ops import coattention as co

    args = _k4_inputs(n, l, t, e, misalign=misalign)
    before = co.launch_count
    got = co.coattention_core(*args)
    torch.cuda.synchronize()
    assert co.launch_count == before + 1
    want = co.coattention_core_reference(*args)
    flat = co.coattention_core_reference(*args[:6], torch.zeros_like(args[6]),
                                         torch.zeros_like(args[7]))
    # a softmax over one position is 1 whatever its logits: the controls of
    # av and v need L > 1, those of aq and q T > 1
    controlled = (l > 1, t > 1, l > 1, t > 1)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and g.shape == w.shape, i
        assert torch.isfinite(g).all(), i
        assert cc.k4_within(K4_NAMES[i], g, w).all(), i
        if controlled[i]:
            # control: uniform maps are rejected on most elements
            assert (~cc.k4_within(K4_NAMES[i], flat[i], w)).float().mean() \
                > 0.5, i
    if l > 1 and e > 2:
        # the inputs peak the region map. Not at E = 2, where a logit sums
        # two products of |Hv| <= 1 with whv: there the uniform control
        # above is the check that the map is held
        assert float(want[2].max()) > 4.0 / l
    again = co.coattention_core(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_k4_gate_reckons_the_kernels_shared_memory():
    # the gate's reckoning (ops/coattention.py) against the kernel's own
    from vqa_attention_networks_tpu_torch.ops import coattention as co

    lib = co._library()
    for l in range(1, 1025):
        assert co.smem_bytes(l) == lib.coattention_smem_bytes(l), l


def test_k4_wrapper_raises_on_inputs_it_does_not_take():
    from vqa_attention_networks_tpu_torch.ops import coattention as co

    args = list(_k4_inputs(2, 10, 4, 64))
    with pytest.raises(TypeError):
        co.coattention_core_cuda(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="CUDA"):
        co.coattention_core_cuda(*(a.cpu() for a in args))
    with pytest.raises(ValueError, match="T <="):
        co.coattention_core_cuda(*_k4_inputs(2, 10, 40, 64))
    odd = _k4_inputs(2, 10, 4, 63)
    with pytest.raises(ValueError, match="E % 2"):
        co.coattention_core_cuda(*odd)


# K4's mean |error| against the f64 version as a ratio to the plain f32
# version's (k4_precision.py's formula), over the 8 (seed, output) pairs of
# seeds 4 and 5: their geometric mean at most K4_F64_GEO_MARGIN, each at
# most K4_F64_PAIR_MARGIN. Measured on an H100: this kernel 1.61 (1.07 to
# 2.85); with the products chained on one accumulator inside the tensor
# cores instead, 2.83 (0.93 to 6.32)
K4_F64_GEO_MARGIN, K4_F64_PAIR_MARGIN = 2.0, 4.0


def test_k4_matches_plain_version_at_chip_smoke_inputs():
    """At ``card_cases.k4_inputs(256, seed=4)`` (``chip_smoke.py``'s K4
    inputs), where K4 with its mma.sync products summed inside the tensor
    cores put 2 aq elements past the tolerance, every output within K4's
    tolerance."""
    from vqa_attention_networks_tpu_torch.ops import coattention as co

    args = cc.k4_inputs(256, 4, torch.device("cuda"))
    got = co.coattention_core_cuda(*args)
    want = co.coattention_core_reference(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(K4_NAMES, got, want):
        outside = int((~cc.k4_within(name, g, w)).sum())
        assert outside == 0, (name, outside)


def test_k4_error_against_f64_is_no_more_than_the_plain_versions():
    """``k4_precision.py``'s comparison at seeds 4 and 5: per output (v,
    q, av, aq), the mean |error| against the f64 version with K4's bf16
    rounding points, of the kernel as a ratio to the plain version's."""
    from vqa_attention_networks_tpu_torch.k4_precision import f64_version
    from vqa_attention_networks_tpu_torch.ops import coattention as co

    torch.backends.cuda.matmul.allow_tf32 = False
    ratios = {}
    for seed in (4, 5):
        args = cc.k4_inputs(256, seed, torch.device("cuda"))
        ref = f64_version(*args)
        kernel = co.coattention_core_cuda(*args)
        plain = co.coattention_core_reference(*args)
        for name, k, p, r in zip(K4_NAMES, kernel, plain, ref):
            k_err = float((k.double() - r).abs().mean())
            p_err = float((p.double() - r).abs().mean())
            ratios[(seed, name)] = k_err / p_err
    geo = float(np.exp(np.mean(np.log(list(ratios.values())))))
    assert geo <= K4_F64_GEO_MARGIN, (geo, ratios)
    assert max(ratios.values()) <= K4_F64_PAIR_MARGIN, ratios


@pytest.mark.parametrize("n,d,o", [(3, 64, 24), (4, 2048, 1000)],
                         ids=["ragged", "production"])
def test_k5_matches_plain_version(n, d, o):
    from vqa_attention_networks_tpu_torch.ops import grid_fusion as gf

    rng = np.random.default_rng(1)
    img = _bf16(rng, (n, L, d), 0.5)
    w = torch.from_numpy(rng.standard_normal((d, o * K)).astype(
        np.float32)).cuda() * 0.02
    b = torch.from_numpy(rng.standard_normal(o * K).astype(
        np.float32)).cuda() * 0.05
    q = _bf16(rng, (n, o * K), 0.5)
    before = gf.launch_count
    got = gf.inference_fusion_cuda(img, w, b, q, K)
    torch.cuda.synchronize()
    assert gf.launch_count == before + 1
    want = gf.grid_fuse_reference(img, w, b, q, K)
    assert got.dtype == torch.float32 and got.shape == (n, L, o)
    pooled, want_pooled = got * got.abs(), want * want.abs()
    assert (pooled - want_pooled).abs().max() <= \
        cc.K5_RTOL * want_pooled.abs().max()
    assert torch.equal(got, gf.inference_fusion_cuda(img, w, b, q, K))
    # control: q permuted across samples is rejected
    perm = gf.grid_fuse_reference(img, w, b, q.flip(0), K)
    assert (perm * perm.abs() - want_pooled).abs().max() > \
        100 * cc.K5_RTOL * want_pooled.abs().max()


def _k7_inputs(n, p, c, a, g, d, seed=2):
    rng = np.random.default_rng(seed)

    def f(shape, scale):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda() * scale

    return (_bf16(rng, (n, p, c), 1.0), f((a, c), 0.3 / (c / 48) ** 0.5),
            f((a,), 0.1), f((g, a), 1.0), f((g,), 0.1),
            _bf16(rng, (n, p, d), 0.5))


def _check_k7(n, p, c, a, g, d, quirk):
    """K7 against its plain version, a bit-equal rerun, one launch counted,
    and (softmax over more than one region) the uniform-pool control."""
    from vqa_attention_networks_tpu_torch.ops import attention as att

    args = _k7_inputs(n, p, c, a, g, d)
    before = att.launch_count
    got = att.glimpse_attention_cuda(*args, uniform_quirk=quirk)
    torch.cuda.synchronize()
    assert att.launch_count == before + 1
    want = att.glimpse_attention_reference(*args, uniform_quirk=quirk)
    assert got.dtype == torch.bfloat16 and got.shape == (n, g * d)
    assert cc.k7_within(got, want, g).all()
    assert torch.equal(got, att.glimpse_attention_cuda(
        *args, uniform_quirk=quirk))
    if not quirk and p > 1:  # a uniform pool is rejected on most elements
        uniform = args[5].float().mean(1, keepdim=True).expand(n, g, d)
        assert (~cc.k7_within(uniform, want, g)).float().mean() > 0.5


@pytest.mark.parametrize("quirk", [False, True], ids=["softmax", "quirk"])
@pytest.mark.parametrize("n,p,c,a,d", [(3, 22, 48, 100, 40),
                                       (8, 196, 1000, 512, 2048)],
                         ids=["ragged", "co_attention"])
def test_k7_matches_plain_version(n, p, c, a, d, quirk):
    _check_k7(n, p, c, a, 2, d, quirk)


# the kernel's geometry: one region and the most (P = 1024, the pool's
# shared weights), one glimpse and the most (G = 4, with D = 42 not a
# multiple of 4: v read in bf16 pairs), a hidden width that ends inside an
# MLP tile (A = 100, 260) with C less than one 64-deep stage (C = 48)
@pytest.mark.parametrize("quirk", [False, True], ids=["softmax", "quirk"])
@pytest.mark.parametrize("n,p,c,a,g,d", [
    (4, 1, 64, 96, 2, 48), (2, 1024, 64, 300, 2, 136),
    (3, 22, 1024, 512, 1, 1024), (3, 22, 104, 260, 4, 42),
    (5, 30, 48, 100, 2, 64)],
    ids=["p1", "p1024", "g1", "g4_d42", "a100_c48"])
def test_k7_edges_match_plain_version(n, p, c, a, g, d, quirk):
    _check_k7(n, p, c, a, g, d, quirk)


def test_k7_wrapper_raises_on_inputs_it_does_not_take():
    from vqa_attention_networks_tpu_torch.ops import attention as att

    args = list(_k7_inputs(2, 5, 48, 64, 2, 40))
    with pytest.raises(TypeError):
        att.glimpse_attention_cuda(args[0].float(), *args[1:],
                                   uniform_quirk=False)
    with pytest.raises(ValueError, match="CUDA"):
        att.glimpse_attention_cuda(*(x.cpu() for x in args),
                                   uniform_quirk=False)
    with pytest.raises(ValueError, match="C % 8"):
        att.glimpse_attention_cuda(*_k7_inputs(2, 5, 44, 64, 2, 40),
                                   uniform_quirk=False)
    with pytest.raises(ValueError, match="G <="):
        att.glimpse_attention_cuda(*_k7_inputs(2, 5, 48, 64, 5, 40),
                                   uniform_quirk=False)


# --------------------------------------------------------------------------
# K3 (the pooled-site training fusion: forward, d_img, d_W/d_b/d_q)
# --------------------------------------------------------------------------

# K3 shares every rounding point with its plain version and differs in the
# order of its f32 sums only: each launch is held per tensor at
# ``card_cases.K3_RTOL`` of the plain result's largest |value|, the forward
# as pooled = out * |out|; the backward launches on the kernel's own
# forward output


def _k3_inputs(n, l, d, o, seed=0, k=K):
    from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf

    rng = np.random.default_rng(seed)

    def t(shape, scale):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * scale).cuda()

    img = t((n, l, d), 0.5).to(torch.bfloat16)
    w_bf16, b, q = pf.operands(t((d, o * k), 0.02), t((o * k,), 0.05),
                               t((n, o * k), 0.5))
    return img, w_bf16, b, q, t((n, l, o), 1.0)


# the largest k the d_W kernel's registers hold (7), with ragged L, D and
# O, at the first k-pool width; d_W's edges: N = 1 and 65, L = 1 and 208,
# k = 1 and 7, O = 1000 and 18 (O % 8 != 0 with F % 8 == 0 needs an even
# k), D = 72 (its last D tile one 8-row group deep)
@pytest.mark.parametrize("n,l,d,o,k", [
    (3, 37, 64, 24, K), (2, 50, 72, 40, 7), (8, 196, 2048, 1000, K),
    (1, 1, 136, 1000, 1), (65, 208, 72, 40, 7), (3, 50, 200, 18, 4)],
    ids=["ragged", "k7", "production", "n1_l1_k1", "n65_l208_k7", "o18"])
def test_k3_launches_match_plain_versions(n, l, d, o, k):
    from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf

    torch.backends.cuda.matmul.allow_tf32 = False
    img, w_bf16, b, q, g = _k3_inputs(n, l, d, o, k=k)

    def launches():
        out = pf.forward_cuda(img, w_bf16, b, q, k)
        args = (g, out, img, w_bf16, b, q, k)
        d_w, d_b, d_q = pf.d_w_cuda(*args)
        return {"forward": out, "d_img": pf.d_img_cuda(*args), "d_w": d_w,
                "d_b": d_b, "d_q": d_q}

    before = dict(pf.launch_count)
    got = launches()
    torch.cuda.synchronize()
    # d_w_cuda and d_img_cuda each form their own g_pooled, then the product
    assert {key: pf.launch_count[key] - before[key] for key in before} == \
        {"forward": 1, "g_pooled": 2, "d_img": 1, "d_w": 1}
    out = got["forward"]
    d_w, d_b, d_q = pf.d_w_reference(g, out, img, w_bf16, b, q, k)
    want = {"forward": pf.forward_reference(img, w_bf16, b, q, k),
            "d_img": pf.d_img_reference(g, out, w_bf16, q, k), "d_w": d_w,
            "d_b": d_b, "d_q": d_q}
    again = launches()
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert torch.isfinite(got[name].float()).all(), name
        assert cc.k3_within(name, got[name], want[name]).all(), name
        # no atomics: a rerun gives the same bits
        assert torch.equal(got[name], again[name]), name
    # control: q permuted across samples (across channels at N = 1) is
    # rejected
    perm = pf.forward_reference(img, w_bf16, b,
                                q.flip(0) if n > 1 else q.roll(1, 1), k)
    pooled = out * out.abs()
    assert (perm * perm.abs() - pooled).abs().max() > \
        100 * cc.K3_RTOL * pooled.abs().max()


# the forward's geometry: every K (1 to 7, one template each), an O tile
# that ends past O (O = 18, 100, 1000), an odd N (the last block's second
# warpgroup holds no sample), D not a multiple of the 32-deep stage (40,
# 72, 136, 200), L = 1 and 208
@pytest.mark.parametrize("n,l,d,o,k", [
    (3, 50, 200, 18, 4), (5, 196, 136, 1000, 7), (7, 208, 72, 64, 1),
    (1, 1, 40, 100, 2), (2, 13, 96, 40, 3), (3, 100, 64, 24, 6),
    (4, 196, 2048, 1000, K)],
    ids=["o18_k4", "o1000_k7", "k1_odd_n_l208", "k2_n1_l1", "k3", "k6",
         "production"])
def test_k3_forward_edges_match_plain_version(n, l, d, o, k):
    from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf

    torch.backends.cuda.matmul.allow_tf32 = False
    img, w_bf16, b, q, _ = _k3_inputs(n, l, d, o, k=k)
    out = pf.forward_cuda(img, w_bf16, b, q, k)
    want = pf.forward_reference(img, w_bf16, b, q, k)
    assert out.shape == want.shape and torch.isfinite(out).all()
    assert cc.k3_within("forward", out, want).all()
    assert torch.equal(out, pf.forward_cuda(img, w_bf16, b, q, k))
    # control: q permuted across samples (across channels at N = 1)
    perm = pf.forward_reference(img, w_bf16, b,
                                q.flip(0) if n > 1 else q.roll(1, 1), k)
    want_pooled = want * want.abs()
    assert (perm * perm.abs() - want_pooled).abs().max() > \
        100 * cc.K3_RTOL * want_pooled.abs().max()


# K3's own forward (``pooled_fusion_forward``) at N = 64 and production
# widths: the sha256 of its f32 output's bytes, as the kernel of the
# commit before K6's epilogue moved into the forward gave them on an
# "NVIDIA H100 80GB HBM3". The signed sqrt of its epilogue has since
# changed form (one square root instead of two, as in K6's instantiation);
# its output keeps these bits.
K3_FORWARD_DIGEST = (
    "bd71fbc77629e355c76c41e1b5798468d43e53c3345498b2149c8c332b9393c7")


def test_k3_forward_keeps_its_bits():
    import hashlib

    from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf

    img, w_bf16, b, q, _ = _k3_inputs(64, 196, 2048, 1000, seed=2)
    out = pf.forward_cuda(img, w_bf16, b, q, K)
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    assert digest == K3_FORWARD_DIGEST


def test_k3_autograd_launches_the_kernels():
    from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf

    img, w_bf16, b, q, g = _k3_inputs(4, 196, 128, 128, seed=1)
    w = w_bf16.float().requires_grad_(True)
    bb = b.clone().requires_grad_(True)
    qq = q.clone().requires_grad_(True)
    before = dict(pf.launch_count)
    out = pf.pooled_grid_fuse(img, w, bb, qq, K)
    out.backward(g)
    torch.cuda.synchronize()
    # img needs no gradient: d_img is not launched
    assert {k: pf.launch_count[k] - before[k] for k in before} == \
        {"forward": 1, "g_pooled": 1, "d_img": 0, "d_w": 1}
    assert w.grad.dtype == torch.float32 and qq.grad.dtype == torch.bfloat16
    assert all(torch.isfinite(x.grad.float()).all() for x in (w, bb, qq))


def test_k3_backward_with_img_grad_forms_g_pooled_once():
    """With img needing a gradient, the backward forms g_pooled once and
    both d_img and d_W read it; d_img agrees with the plain version."""
    from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf

    img, w_bf16, b, q, g = _k3_inputs(4, 196, 128, 128, seed=3)
    img = img.requires_grad_(True)
    w = w_bf16.float().requires_grad_(True)
    bb = b.clone().requires_grad_(True)
    qq = q.clone().requires_grad_(True)
    before = dict(pf.launch_count)
    out = pf.pooled_grid_fuse(img, w, bb, qq, K)
    out.backward(g)
    torch.cuda.synchronize()
    assert {k: pf.launch_count[k] - before[k] for k in before} == \
        {"forward": 1, "g_pooled": 1, "d_img": 1, "d_w": 1}
    want = pf.d_img_reference(g, out.detach(), w_bf16, q, K)
    assert img.grad.dtype == torch.bfloat16
    # the gradient leaves in img's dtype: one bf16 rounding of each value
    assert (img.grad.float() - want).abs().max() <= \
        2.0 ** -7 * want.abs().max()


def test_k3_d_img_matches_plain_version_at_chip_smoke_inputs():
    """K3's d_img product over the g_pooled operand at the card inputs of
    N = 64 that ``step_time.py`` times it on (``card_cases.k2_inputs``):
    within K3's tolerance of the plain version, the same as the
    build-and-product call, and a rerun gives the same sha256."""
    import hashlib

    from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    img, w, b, q, g = cc.k2_inputs(64, 3, dev)
    w_bf16, bf, qb = pf.operands(w, b, q)
    out = pf.forward_cuda(img, w_bf16, bf, qb, K)
    args = (g, out, img, w_bf16, bf, qb, K)
    gp, _ = pf.g_pooled_cuda(*args)
    assert torch.equal(gp, pf.g_pooled_reference(g, out)[0])
    got = pf.d_img_from_gp_cuda(gp, img, w_bf16, bf, qb, K)
    want = pf.d_img_reference(g, out, w_bf16, qb, K)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert bool(cc.k3_within("d_img", got, want).all())
    assert torch.equal(got, pf.d_img_cuda(*args))

    def digest(x):
        return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()

    assert digest(got) == digest(pf.d_img_from_gp_cuda(gp, img, w_bf16, bf,
                                                       qb, K))


def test_k3_wrappers_raise_on_inputs_they_do_not_take():
    from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf

    img, w_bf16, b, q, g = _k3_inputs(2, 196, 128, 128)
    with pytest.raises(TypeError):
        pf.forward_cuda(img.float(), w_bf16, b, q, K)
    with pytest.raises(TypeError):
        pf.forward_cuda(img, w_bf16, b, q.float(), K)
    with pytest.raises(ValueError, match="CUDA"):
        pf.forward_cuda(img.cpu(), w_bf16.cpu(), b.cpu(), q.cpu(), K)
    with pytest.raises(ValueError, match="on"):
        pf.forward_cuda(img, w_bf16, b, q.cpu(), K)
    with pytest.raises(ValueError, match="k <= 7"):
        pf.forward_cuda(*_k3_inputs(2, 196, 128, 128, k=8)[:4], 8)
    with pytest.raises(ValueError, match="L <="):
        pf.forward_cuda(torch.cat([img, img], 1), w_bf16, b, q, K)
    i124, w124, b124, q124, _ = _k3_inputs(2, 196, 124, 128)
    with pytest.raises(ValueError, match="D % 8"):
        pf.forward_cuda(i124, w124, b124, q124, K)
    out = pf.forward_cuda(img, w_bf16, b, q, K)
    with pytest.raises(ValueError, match="contiguous f32"):
        pf.d_w_cuda(g.double(), out, img, w_bf16, b, q, K)
    # and d_W/d_b/d_q takes the shapes it took before: N = 1, L = 1, D = 8,
    # F = 8 at k = 1; L = 208 at k = 7; O = 1000 at k = 7 (F = 7000)
    for n, l, d, o, k in ((1, 1, 8, 8, 1), (2, 208, 72, 8, 7),
                          (1, 3, 8, 1000, 7)):
        img, w_bf16, b, q, g = _k3_inputs(n, l, d, o, k=k)
        out = pf.forward_cuda(img, w_bf16, b, q, k)
        got = pf.d_w_cuda(g, out, img, w_bf16, b, q, k)
        want = pf.d_w_reference(g, out, img, w_bf16, b, q, k)
        for name, a, b_ in zip(("d_w", "d_b", "d_q"), got, want):
            assert a.shape == b_.shape and torch.isfinite(a).all()
            assert cc.k3_within(name, a, b_).all()


# --------------------------------------------------------------------------
# K6 (the standalone wq fusion + grid L2) and K8 (the LSTM scan)
# --------------------------------------------------------------------------

# K6 (the forward per element of pooled = out * |out|, the backward the
# composed chain's VJP) and K8 (each step against the plain recurrence fed
# the kernel's own h carry, the free-running outputs at K8_FREE_ATOL) are
# held at ``card_cases``' tolerances


def _k6_inputs(n, l, d, o, seed=0, k=K):
    return cc.k6_inputs(n, seed, "cuda", l=l, d=d, o=o, k=k)


# O tiles of 64 (O = 104, 200, 1000: a partial last tile), odd L, N = 1,
# and k = 4 with L * O not a multiple of 4 (the scale launch's scalar path)
@pytest.mark.parametrize("n,l,d,o,k", [
    (3, 37, 64, 104, K), (4, 196, 2048, 1000, K), (1, 37, 64, 104, K),
    (5, 195, 128, 200, K), (1, 196, 2048, 1000, K), (3, 37, 64, 102, 4)],
    ids=["ragged", "production", "n1_l37_o104", "l195_o200",
         "n1_production", "k4_scalar_scale"])
def test_k6_matches_plain_version(n, l, d, o, k):
    from vqa_attention_networks_tpu_torch.ops import wq_grid_fusion as wqg

    torch.backends.cuda.matmul.allow_tf32 = False
    img, w, b, q = _k6_inputs(n, l, d, o, k=k)
    before = wqg.launch_count
    got = wqg.wq_grid_fuse_cuda(img, w, b, q, k)
    torch.cuda.synchronize()
    assert wqg.launch_count == before + 1
    want = wqg.wq_grid_fuse_reference(img, w, b, q, k)
    assert got.dtype == torch.bfloat16 and got.shape == (n, l, o)
    assert torch.isfinite(got.float()).all()
    assert cc.k6_within(got, want).all()
    # no atomics: a rerun gives the same bits
    assert torch.equal(got, wqg.wq_grid_fuse_cuda(img, w, b, q, k))
    # controls: a per-row norm, and q permuted across samples (N > 1)
    controls = [want.float() / want.float().norm(dim=-1, keepdim=True)]
    if n > 1:
        controls.append(wqg.wq_grid_fuse_reference(img, w, b, q.roll(1, 0),
                                                   k))
    for control in controls:
        assert (~cc.k6_within(control, want)).float().mean() > 0.5


def test_k6_backward_is_the_composed_chain():
    from vqa_attention_networks_tpu_torch.ops import wq_grid_fusion as wqg

    torch.backends.cuda.matmul.allow_tf32 = False
    args = [x.requires_grad_(True) for x in _k6_inputs(3, 196, 128, 104, 1)]
    g = torch.randn(3, 196, 104, device="cuda").to(torch.bfloat16)
    before = wqg.launch_count
    grads = torch.autograd.grad(wqg.wq_grid_fuse(*args, K), args, g)
    assert wqg.launch_count == before + 1
    want = torch.autograd.grad(wqg.composed_reference(*args, K), args, g)
    for got, ref, x in zip(grads, want, args):
        assert got.dtype == x.dtype and torch.isfinite(got.float()).all()
        assert (got.float() - ref.float()).abs().max() <= \
            cc.K6_GRAD_RTOL * ref.float().abs().max()


def test_k6_wrapper_raises_on_inputs_it_does_not_take():
    from vqa_attention_networks_tpu_torch.ops import wq_grid_fusion as wqg

    img, w, b, q = _k6_inputs(2, 20, 64, 104)
    with pytest.raises(TypeError):
        wqg.wq_grid_fuse_cuda(img.float(), w, b, q, K)
    with pytest.raises(ValueError, match="CUDA"):
        wqg.wq_grid_fuse_cuda(img.cpu(), w.cpu(), b.cpu(), q.cpu(), K)
    with pytest.raises(ValueError, match="on"):
        wqg.wq_grid_fuse_cuda(img, w, b, q.cpu(), K)
    with pytest.raises(ValueError, match="L <="):
        wqg.wq_grid_fuse_cuda(torch.cat([img] * 11, 1), w, b, q, K)
    with pytest.raises(ValueError, match="F % 8"):
        wqg.wq_grid_fuse_cuda(*_k6_inputs(2, 20, 64, 100), K)


def _k8_inputs(n, t, h, seed=0):
    """The scan's inputs from ``card_cases.k8_inputs`` at (T, H): xp
    without its bias, W_hh and the bf16 bias."""
    return cc.k8_scan_inputs(*cc.k8_inputs(n, seed, "cuda", t=t, h=h))


@pytest.mark.parametrize("n,t,h", [(5, 3, 128), (70, 22, 1024),
                                   (1024, 22, 1024), (2048, 22, 1024),
                                   (40, 6, 1280)],
                         ids=["ragged", "production", "four_row_tiles",
                              "eight_row_tiles", "widest"])
def test_k8_matches_plain_version(n, t, h):
    from vqa_attention_networks_tpu_torch.ops import lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    xp, w_hh, bias = _k8_inputs(n, t, h)
    geo = lstm.geometry(n, t, h, torch.cuda.get_device_properties(
        0).multi_processor_count)
    counter = torch.zeros(geo.blocks // (h // geo.units_per_block),
                          dtype=torch.int32, device="cuda")
    before = lstm.launch_count
    got = lstm.lstm_scan_cuda(xp, w_hh, bias, counter=counter)
    torch.cuda.synchronize()
    assert lstm.launch_count == before + 1
    # one persistent launch: T - 1 barriers, every block at each
    assert int(counter.sum()) == (t - 1) * geo.blocks
    xpb = xp + bias  # the bias added in bf16, as the kernel adds it
    want = lstm.lstm_scan_reference(xpb, w_hh)
    forced = lstm.lstm_scan_reference(xpb, w_hh, h_carry=got)
    assert got.dtype == torch.bfloat16 and got.shape == (n, t, h)
    assert torch.isfinite(got.float()).all()
    assert cc.k8_within(got, forced).all()
    assert (got.float() - want.float()).abs().max() <= cc.K8_FREE_ATOL
    assert torch.equal(got, lstm.lstm_scan_cuda(xp, w_hh, bias))
    # control: a carry off by one step is rejected on most elements
    shifted = torch.cat([torch.zeros_like(want[:, :1]), want[:, :-1]], 1)
    forced = lstm.lstm_scan_reference(xpb, w_hh, h_carry=shifted)
    assert (~cc.k8_within(shifted, forced)).float().mean() > 0.5


def test_k8_entry_launches_the_kernel():
    from vqa_attention_networks_tpu_torch.ops import lstm

    h = 128
    x, w_ih, w_hh, b_ih, b_hh = cc.k8_inputs(6, 3, "cuda", t=4, e=30, h=h)
    assert lstm.supported(x, h)
    before = lstm.launch_count
    got = lstm.lstm_seq(x, w_ih, w_hh, b_ih, b_hh)
    assert lstm.launch_count == before + 1
    forced = lstm.lstm_scan_reference(
        lstm.input_projection(x, w_ih, b_ih, b_hh), w_hh, h_carry=got)
    assert cc.k8_within(got, forced).all()


def test_k8_wrapper_raises_on_inputs_it_does_not_take():
    from vqa_attention_networks_tpu_torch.ops import lstm

    xp, w_hh, bias = _k8_inputs(2, 3, 96)
    with pytest.raises(TypeError):
        lstm.lstm_scan_cuda(xp.float(), w_hh, bias)
    with pytest.raises(ValueError, match="CUDA"):
        lstm.lstm_scan_cuda(xp.cpu(), w_hh.cpu(), bias.cpu())
    with pytest.raises(ValueError, match="on"):
        lstm.lstm_scan_cuda(xp, w_hh.cpu(), bias)
    with pytest.raises(ValueError, match="H % 128"):
        lstm.lstm_scan_cuda(*_k8_inputs(2, 3, 100))
    with pytest.raises(ValueError, match="shared memory"):
        lstm.lstm_scan_cuda(*_k8_inputs(8, 2, 1408))
    with pytest.raises(ValueError, match="agree"):
        lstm.lstm_scan_cuda(xp, w_hh[:, :64], bias)
    with pytest.raises(ValueError, match="bias"):
        lstm.lstm_scan_cuda(xp, w_hh, bias.float())
    with pytest.raises(ValueError, match="counter"):  # one group at N=2
        lstm.lstm_scan_cuda(*_k8_inputs(2, 3, 128),
                            counter=torch.zeros(3, dtype=torch.int32,
                                                device="cuda"))


@pytest.mark.parametrize("h", [1408, 2048])
def test_k8_gate_refuses_shapes_the_kernel_does_not_take(h):
    # JAX's gate (bf16, H % 128 == 0) holds, but W_hh's slice does not fit
    # in a block's shared memory: lstm_seq's callers take the composed scan
    from vqa_attention_networks_tpu_torch.ops import lstm

    x = torch.zeros(8, 4, 300, dtype=torch.bfloat16, device="cuda")
    assert lstm.supported(x, 1280)
    assert not lstm.supported(x, h)


# K2's forward before its row offset existed, on _k2_bits_inputs (an H100,
# CUDA 12.8): the output, and the mask it draws at k = 1 on zero features
# and weights with unit bias and q (out = sqrt(1 / keep) where it keeps)
K2_FORWARD_DIGEST = (
    "df55a610ba80499c4a1416532b1db83581ad8f424fb49255947d3df6b4fd0f00")
K2_MASK_DIGEST = (
    "1a30573f6c4676d90674ba6d2752a0960a4eca679ea2046c47e3ebea7816f5c5")


def _k2_bits_inputs(seed=11, n=8, l=196, d=2048, f=5000):
    g = torch.Generator().manual_seed(seed)
    img = (torch.randn(n, l, d, generator=g) * 0.5).to(torch.bfloat16).cuda()
    w = (torch.randn(d, f, generator=g) * 0.02).to(torch.bfloat16).cuda()
    b = (torch.randn(f, generator=g) * 0.1).cuda()
    q = torch.randn(n, f, generator=g).cuda()
    return img, w, b, q


@pytest.mark.parametrize("row0", [None, 0])
def test_k2_forward_keeps_its_bits(row0):
    import hashlib

    img, w, b, q = _k2_bits_inputs()
    extra = () if row0 is None else (row0,)
    out = tf.forward_cuda(img, w, b, q, 5, K, 0.1, *extra)
    mask = cc.k2_kernel_mask(5, 8, 0)
    torch.cuda.synchronize()
    assert hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest() == \
        K2_FORWARD_DIGEST
    assert hashlib.sha256(mask.cpu().numpy().tobytes()).hexdigest() == \
        K2_MASK_DIGEST


def test_k2_row0_draws_the_global_rows():
    """Samples [4, 8) launched on their own with row0 = 4 give rows 4..7 of
    the whole batch's launch, forward bit for bit and the mask's g_prod;
    with row0 = 0 they draw rows 0..3's mask."""
    img, w, b, q = _k2_bits_inputs(seed=3)
    full = tf.forward_cuda(img, w, b, q, 9, K, 0.1)
    tail = (img[4:].contiguous(), w, b, q[4:].contiguous(), 9, K, 0.1)
    half = tf.forward_cuda(*tail, 4)
    wrong = tf.forward_cuda(*tail, 0)
    whole_mask = cc.k2_kernel_mask(9, 8, 0)
    torch.cuda.synchronize()
    assert torch.equal(full[4:], half)
    assert not torch.equal(full[4:], wrong)
    assert torch.equal(cc.k2_kernel_mask(9, 4, 4), whole_mask[4:])
    g = torch.randn(4, 196, 1000, generator=torch.Generator().manual_seed(
        5)).cuda()
    keep = tf.keep_scale(tf.dropout_mask(9, 4, 196, 5000, 0.1, "cuda",
                                         row0=4), 0.1)
    gp, _ = tf.g_prod_cuda(g, half, tail[0], w, b, tail[3], 9, K, 0.1, 4)
    want, _ = tf.g_prod_reference(g, half, tail[3], K, keep)
    torch.cuda.synchronize()
    assert torch.equal(gp, want)


def test_kernels_launch_on_their_tensors_card():
    """A launch on a card other than the current device (a replica of the
    split engine) runs there: K1's and K2's forwards on ``cuda:1`` with
    ``cuda:0`` current give what they give on ``cuda:0``, and leave
    ``cuda:1`` usable by cuBLAS after them."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards")
    torch.cuda.set_device(0)
    img, w, b, q = _k2_bits_inputs(n=2)
    want = (tf.forward_cuda(img, w, b, q, 5, K, 0.1),
            wqf.stage1_coattention_cuda(*_inputs(2, 2048, 1000, seed=3)))
    one = torch.device("cuda", 1)
    got = (tf.forward_cuda(*(x.to(one) for x in (img, w, b, q)), 5, K, 0.1),
           wqf.stage1_coattention_cuda(*_inputs(2, 2048, 1000, seed=3,
                                                device=one)))
    after = torch.randn(64, 64, device=one) @ torch.randn(64, 64, device=one)
    torch.cuda.synchronize(one)
    assert torch.cuda.current_device() == 0
    for g, w_ in zip(got, want):
        assert g.device == one and torch.equal(g.cpu(), w_.cpu())
    assert torch.isfinite(after).all()


@pytest.mark.parametrize("m", [0, 1])
def test_k2_shard_launches_draw_their_columns_of_one_processes(m):
    """Tensor-parallel rank m of 2 holds 2500 of the 5000 fusion columns,
    which K2 takes zero-padded to 2520 (``ops/fusion.on_padded_columns``,
    as the dispatcher pads them). At ``col0`` = 2500 m and ``f_total`` =
    5000 its mask is the whole launch's columns bit for bit, and so is the
    g_prod build; the forward, d_W, d_b and d_q hold the whole launch's
    columns at ``card_cases.K2_RTOL``. At ``col0`` = 0 rank 1 would draw
    rank 0's mask."""
    from vqa_attention_networks_tpu_torch.ops.fusion import (
        on_padded_columns,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    n, f, k, seed, rate = 4, 5000, K, 21, 0.1
    img, w, b, q = _k2_bits_inputs(seed=5, n=n)
    cols, outs = slice(m * 2500, (m + 1) * 2500), slice(m * 500, (m + 1) * 500)
    whole = cc.k2_kernel_mask(seed, n, col0=0, f_total=f, f=f)
    assert torch.equal(whole, cc.k2_kernel_mask(seed, n, 0)[..., :f])
    part = cc.k2_kernel_mask(seed, n, col0=m * 2500, f_total=f, f=2500)
    assert torch.equal(part, whole[..., cols])
    if m == 1:
        assert not torch.equal(cc.k2_kernel_mask(seed, n, col0=0, f_total=f,
                                                 f=2500), part)
    g = torch.randn(n, 196, f // k, generator=torch.Generator().manual_seed(
        6)).cuda()

    def launches(w_, b_, q_, g_, col0, f_total):
        out = tf.forward_cuda(img, w_, b_, q_, seed, k, rate, 0, col0,
                              f_total)
        args = (g_, out, img, w_, b_, q_, seed, k, rate, 0, col0, f_total)
        g_prod, partials = tf.g_prod_cuda(*args)
        d_w, d_b = tf.d_w_from_operand_cuda(img, g_prod, partials)
        return {"forward": out, "g_prod": g_prod.reshape(n, 196, -1),
                "d_w": d_w, "d_b": d_b, "d_q": tf.d_q_cuda(*args)}

    full = launches(w, b, q, g, 0, f)
    widths = []
    on_padded_columns(lambda w_, b_, q_: widths.append(w_.shape[1]) or q_,
                      w[:, cols], b[cols], q[:, cols], k)
    pad = widths[0] - 2500  # the dispatcher's padding: 20 columns

    def padded(x):
        return torch.nn.functional.pad(x, (0, pad)).contiguous()

    shard = launches(padded(w[:, cols]), padded(b[cols]), padded(q[:, cols]),
                     torch.nn.functional.pad(g[..., outs], (0, pad // k)),
                     m * 2500, f)
    torch.cuda.synchronize()
    assert shard["forward"].shape[-1] == 504  # the padded launch's width
    assert torch.equal(shard["g_prod"][..., :2500].view(torch.int16),
                       full["g_prod"][..., cols].view(torch.int16))
    for name in ("forward", "d_w", "d_b", "d_q"):
        got = shard[name][..., :2500 if name != "forward" else 500]
        want = full[name][..., cols if name != "forward" else outs]
        assert cc.k2_within(name, got, want).all(), name


def test_k3_on_a_padded_shard_gives_its_columns_of_one_processes():
    """K3 on rank 1's 2500 of 5000 columns, zero-padded to 2520 by
    ``on_padded_columns``: its pooled outputs are the whole launch's
    outputs 500..999 (K3 draws no mask; its f32 sums per output are the
    same), and the padded outputs are 0."""
    from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf
    from vqa_attention_networks_tpu_torch.ops.fusion import (
        on_padded_columns,
    )

    img, w_bf16, b, q, _ = _k3_inputs(8, 196, 2048, 1000, seed=4)
    full = pf.forward_cuda(img, w_bf16, b, q, K)
    cols = slice(2500, 5000)
    padded = []

    def shard(w_, b_, q_):
        out = pf.forward_cuda(img, w_.contiguous(), b_.contiguous(),
                              q_.contiguous(), K)
        padded.append(out)
        return out

    got = on_padded_columns(shard, w_bf16[:, cols], b[cols], q[:, cols], K)
    torch.cuda.synchronize()
    assert padded[0].shape[-1] == 504 and bool((padded[0][..., 500:] == 0)
                                               .all())
    want = full[..., 500:]
    assert (got * got.abs() - want * want.abs()).abs().max() <= \
        1e-4 * (want * want.abs()).abs().max()
