"""What each hand-written kernel is checked on, and held to, on the card.

For K1 to K8, N1 and N2: the inputs its check and its timing draw, at the
shapes the port runs (from a seed, on the device given, any device), and
the tolerance of the kernel against its plain version. ``chip_smoke.py``
gates on them, ``step_time.py`` times on them (its ``agrees``),
``k4_precision.py`` holds K4 to an f64 version on them and the card tests
(``tests/test_torch_port_kernels.py``) run their cases on them, so a
tolerance changed here changes it for all four. Controls that one gate
alone uses stay beside that gate. Nothing on the serving or training path
imports this module, and it needs no card to import.
"""

from __future__ import annotations

import math
import subprocess
import sys

import numpy as np
import torch

from ..config import Config
from . import lstm as k8
from . import train_fusion as tf
from . import wq_fusion as wqf

_WIDTHS = Config()
# the widths the kernels run at: mhb_coAtt's grid (L x D), its fusion (F =
# K * O), K1's co-attention hidden width C; the serving and training batch
L, D = _WIDTHS.img_feature_dim, _WIDTHS.img_feature_channel
F, K, O = _WIDTHS.fusion_dim, _WIDTHS.mfb_factor, _WIDTHS.mfb_out
C = 512
BATCH, TRAIN_BATCH = 256, 64

# K1's output against its plain version, per glimpse row of D outputs:
# |diff| <= ATOL + RTOL_ROW * max |row|. The two share their rounding points
# and differ only in the order of their f32 sums, so ~0.7% of h1 lands one
# bf16 ulp apart. Through c2w such a flip moves the logits, and with them
# the (peaked) attention, which moves every output of the row by up to
# ~1.2% of the row's largest magnitude: an output near 0 from cancellation
# moves as much as a large one. RTOL_ROW is four bf16 ulps (2^-5).
ATOL, RTOL_ROW = 2e-3, 2.0 ** -5
# the kernel's scratch: z is held before its signed sqrt (z * |z| is
# img @ wq + bq, f32; near 0 the sqrt would turn an f32 summation-order
# difference e into sqrt(e)); h1 (bf16) to one bf16 ulp plus H1_ATOL: the
# two norms of z differ by an f32 ulp (another summation order), so a zb
# at a bf16 rounding boundary rounds apart, and each such flip moves h1 by
# |c1w| * ulp(zb), about 1.2e-4 at most at these inputs
POOLED_ATOL, POOLED_RTOL = 1e-4, 1e-4
H1_ATOL, H1_RTOL = 5e-4, 2.0 ** -7
# K2 against its plain version, per tensor: |diff| <= RTOL * max |plain|.
# The two share every rounding point and differ only in the order of
# their f32 sums: the forward's D=2048 contraction, d_W's and d_b's sums
# over N*L rows, d_q's over L rows and its recomputed z0. Those orders
# move a result by a few f32 ulps of the largest terms, far below 1e-4 of
# the tensor's largest value. The forward is held as pooled = out * |out|
# (before the signed sqrt, which turns an f32 difference e near 0 into
# sqrt(e)). d_img is bf16: a summation-order difference can move an
# element across a bf16 rounding boundary, one bf16 ulp (2^-8 relative),
# so its bound is 2^-7 of the largest |d_img|.
K2_RTOL = {"forward": 1e-4, "d_w": 1e-4, "d_b": 1e-4, "d_q": 1e-4,
           "d_img": 2.0 ** -7, "d_b_partials": 1e-4}
K2_FORCED_ZEROS = 100  # outputs of region 0 of sample 0 that pool to 0
# K3 against its plain version, per tensor: |diff| <= K3_RTOL * max |plain|.
# The two share every rounding point (wq's f32 sum over j in order and its
# bf16 rounding, bf16 g_pooled, f32 products) and differ only in the order
# of their f32 sums: the D=2048 contraction of the forward, the O=1000 of
# d_img, the L=196 of d_wq, and d_W's, d_b's and d_q's sums over N and D.
# That moves a result by a few f32 ulps of its largest terms, far below 1e-4
# of the tensor's largest value; the forward is held as pooled = out * |out|.
# d_img stays f32 here (the autograd function casts it to img's dtype).
K3_RTOL = 1e-4
# K4 and K7 against their plain versions: the two share their rounding
# points and differ in the order of their f32 sums, which can move an
# element of C, Hv or Hq (K4), or of the hidden layer or the bf16 output
# (K7), across a bf16 rounding boundary (2^-8 relative) and with it a
# logit of a peaked softmax by ~2^-8 |whv| ~ 1.5e-3. 2^-7 of the largest
# value bounds what that does to K4's pooled v and q and to each glimpse
# row of K7. K4's maps are held element by element, at 2^-6 of each value
# (a logit shift d moves av[l] by at most ~2 d av[l]) plus 1e-6: held at
# 2^-7 of the largest value instead, a uniform map would pass on most
# elements of a peaked one. K5 is the K2 forward without the mask: pooled
# = out * |out| within K2's 1e-4.
K4_RTOL = K7_RTOL_ROW = 2.0 ** -7
K4_MAP_RTOL, K4_MAP_ATOL = 2.0 ** -6, 1e-6
K5_RTOL = K2_RTOL["forward"]
K4_SHAPE = dict(l=196, t=22, e=512)
# (N, P, C, A, D) of K7's two call shapes on mhb_coAtt's eval path
K7_SHAPES = {"question": (BATCH, 22, 1024, 512, 1024),
             "co_attention": (BATCH, 196, 1000, 512, 2048)}
# K6 against its plain version, per element of pooled = out * |out|: the
# two share their rounding points and differ in the order of their f32
# sums (the D=2048 contraction and the norm over 196,000 values), which
# can move an element of the bf16 output across a rounding boundary: one
# ulp, at most 2^-7 of its value, 2^-6 once squared. K6_ATOL of the
# largest value covers the f32 difference of a pooled value near 0. The
# backward is the composed chain's VJP on the same inputs, on the same
# card, in both runs: held at K6_GRAD_RTOL of each gradient's largest value.
K6_RTOL, K6_ATOL = 2.0 ** -6, 1e-4
K6_GRAD_RTOL = 1e-6
# K8 against its plain version. Each step is held on its own: the plain
# recurrence fed the kernel's own h carry (``h_carry``) must give the
# kernel's output within one bf16 ulp plus K8_STEP_ATOL. The two share their
# rounding points (bf16 xp and h, f32 gates and c) and differ in the order
# of the recurrent product's f32 sums (H=1024) and in the last bits of
# expf/tanhf: a few f32 ulps of a gate, which can round an h the other way
# at a bf16 boundary. Run free, the two scans drift further apart, because
# such a flip feeds the later steps through W_hh (2^-8 at most over 22
# steps on an H100, on ~12% of the outputs), so the free-running
# outputs are held at K8_FREE_ATOL only.
K8_STEP_ATOL, K8_FREE_ATOL = 1e-6, 2.0 ** -6
K8_SHAPE = dict(t=22, e=300, h=1024)  # mhb_coAtt: T, emb_dim, hidden_dim
# MCAN-large's three norm shapes (N1, rows x d) and three attention shapes
# (N2, heads x Lq x Lk) at N = BATCH
N1_SHAPES = {"grid": (BATCH * 196, 1024), "words": (BATCH * 14, 1024),
             "head": (BATCH, 2048)}
N2_SHAPES = {"grid_self": (16, 196, 196), "guided": (16, 196, 14),
             "words_self": (16, 14, 14)}


def card() -> tuple:
    """(torch's name of card 0, nvidia-smi's name and power limit); exits
    non-zero where no card is visible."""
    if not torch.cuda.is_available():
        print(f"{sys.argv[0]}: no CUDA device visible; this needs an NVIDIA "
              "card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(0), smi


def randn(rng, shape, scale, device, dtype=torch.float32) -> torch.Tensor:
    x = rng.standard_normal(shape, dtype=np.float32) * scale
    return torch.from_numpy(x).to(device).to(dtype)


def k1_inputs(n: int, seed: int, device, *, l: int = L, d: int = D,
              f: int = F, k: int = K, c: int = C) -> tuple:
    """Random K1 inputs: bf16 img, f32 q and weights."""
    rng = np.random.default_rng(seed)
    img = randn(rng, (n, l, d), 0.5, device, torch.bfloat16)
    q = randn(rng, (n, f), 0.5, device)
    # after the grid-flat L2 norm zb is ~2.5e-3 per element: c1w ~ N(0, 1)
    # with no bias and c2w ~ 3 N(0, 1) make the logits span several units
    # over the 196 regions, so the attention is peaked
    w = [randn(rng, shape, scale, device) for shape, scale in (
        ((d, f), 0.02), ((f,), 0.05), ((f // k, c), 1.0), ((c,), 0.0),
        ((c, 2), 3.0), ((2,), 0.05))]
    return img, q, wqf.prepare_stage1_weights(*w, k)


def within(got: torch.Tensor, want: torch.Tensor, d: int) -> torch.Tensor:
    """Elementwise: is K1's ``got`` within the tolerance of ``want``
    [N, G*D]?"""
    got = got.float().reshape(got.shape[0], -1, d)
    want = want.float().reshape(got.shape)
    scale = want.abs().amax(-1, keepdim=True)
    return (got - want).abs() <= ATOL + RTOL_ROW * scale


def k2_inputs(n: int, seed: int, device, *, l: int = L, d: int = D,
              o: int = O, k: int = K, zeros: int = K2_FORCED_ZEROS) -> tuple:
    """Random K2 (and K3) inputs: bf16 img and q (q_proj is bf16 in the
    bf16 model), f32 W and b, and an f32 cotangent g. With ``zeros``,
    region 0 of sample 0 is all zeros and the bias of the first ``zeros``
    outputs is 0 (the model's initial bias), so those outputs pool to
    exactly 0 with the mask on: where pooled is 0 because all k factors
    were dropped the mask zeroes g_prod anyway, and only these show
    g_pooled's zero rule (in d_b and d_img)."""
    rng = np.random.default_rng(seed)
    f = o * k
    img = randn(rng, (n, l, d), 0.5, device)
    b = randn(rng, (f,), 0.05, device)
    if zeros:
        img[0, 0] = 0.0
        b[:zeros * k] = 0.0
    q = randn(rng, (n, f), 0.5, device, torch.bfloat16)
    g = randn(rng, (n, l, o), 1.0, device)
    return img.to(torch.bfloat16), randn(rng, (d, f), 0.02, device), b, q, g


def k2_view(name: str, x: torch.Tensor) -> torch.Tensor:
    """What the check compares: f32, and the forward as pooled =
    out * |out|."""
    x = x.float()
    return x * x.abs() if name == "forward" else x


def k2_within(name: str, got: torch.Tensor,
              want: torch.Tensor) -> torch.Tensor:
    """Elementwise: is K2's ``got`` within K2_RTOL[name] of ``want``'s
    largest magnitude? (K5 is held as K2's forward.)"""
    got, want = k2_view(name, got), k2_view(name, want)
    return (got - want).abs() <= K2_RTOL[name] * want.abs().max()


def k2_kernel_mask(seed: int, n: int, row0: int = 0, rate: float = 0.1, *,
                   col0: int = 0, f_total: int = None, f: int = F,
                   l: int = L, d: int = D, device="cuda") -> torch.Tensor:
    """The mask K2's forward kernel draws for ``n`` samples from ``row0``
    and ``f`` columns from ``col0`` of ``f_total`` (by default ``f``): its
    output at k = 1 on zero features and weights, unit bias and q, is
    sqrt(1 / keep) where it keeps an element and 0 where it drops one (a
    width the kernel refuses launches zero-padded to a multiple of 8, as
    the dispatcher pads a shard)."""
    f_pad = f + (-f % 8)
    out = tf.forward_cuda(
        torch.zeros(n, l, d, dtype=torch.bfloat16, device=device),
        torch.zeros(d, f_pad, dtype=torch.bfloat16, device=device),
        torch.ones(f_pad, device=device), torch.ones(n, f_pad, device=device),
        seed, 1, rate, row0, col0, f if f_total is None else f_total)
    return out[..., :f] != 0


def k3_within(name: str, got: torch.Tensor,
              want: torch.Tensor) -> torch.Tensor:
    """Elementwise: is K3's ``got`` within K3_RTOL of ``want``'s largest
    magnitude (the forward as pooled = out * |out|)?"""
    got, want = k2_view(name, got), k2_view(name, want)
    return (got - want).abs() <= K3_RTOL * want.abs().max()


def k4_inputs(n: int, seed: int, device, *, l: int = K4_SHAPE["l"],
              t: int = K4_SHAPE["t"], e: int = K4_SHAPE["e"]) -> tuple:
    """bf16 K4 inputs whose two softmaxes are peaked."""
    rng = np.random.default_rng(seed)
    return tuple(randn(rng, shape, scale, device, torch.bfloat16)
                 for shape, scale in (
                     ((n, l, e), 0.5), ((n, t, e), 0.5), ((n, l, e), 0.3),
                     ((n, t, e), 0.3), ((n, l, e), 0.5), ((n, t, e), 0.5),
                     ((e, 1), 0.4), ((e, 1), 0.4)))


def k4_within(name: str, got: torch.Tensor,
              want: torch.Tensor) -> torch.Tensor:
    """Elementwise: is K4's output ``name`` (v, q, av, aq) within its
    tolerance?"""
    if name in ("av", "aq"):
        return (got - want).abs() <= K4_MAP_RTOL * want.abs() + K4_MAP_ATOL
    return (got - want).abs() <= K4_RTOL * want.abs().max()


def k5_inputs(n: int, seed: int, device, *, l: int = L, d: int = D,
              f: int = F) -> tuple:
    """K5 inputs: bf16 img and q, f32 W and b."""
    rng = np.random.default_rng(seed)
    return (randn(rng, (n, l, d), 0.5, device, torch.bfloat16),
            randn(rng, (d, f), 0.02, device), randn(rng, (f,), 0.05, device),
            randn(rng, (n, f), 0.5, device, torch.bfloat16))


def k6_inputs(n: int, seed: int, device, *, l: int = L, d: int = D,
              o: int = O, k: int = K) -> tuple:
    """K6 inputs, drawn on the device from a seeded generator (N=1024's
    img is 411M values, seconds of a host draw): bf16 img, f32 W, b and
    q."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def t(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    f = o * k
    return (t((n, l, d), 0.5).to(torch.bfloat16), t((d, f), 0.02),
            t((f,), 0.05), t((n, f), 0.5))


def k6_within(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Elementwise: is K6's ``got`` within the tolerance of ``want``, held
    as pooled = out * |out|?"""
    got, want = got.float(), want.float()
    got, want = got * got.abs(), want * want.abs()
    return (got - want).abs() <= K6_RTOL * want.abs() + \
        K6_ATOL * want.abs().max()


def k7_inputs(shape: tuple, seed: int, device, g: int = 2) -> tuple:
    """K7 inputs at one call shape (N, P, C, A, D), with the softmax over P
    peaked: bf16 x and v (the question glimpse pools x itself, as
    mhb_coAtt pools h_seq), f32 W1 [A, C], b1, W2 [G, A], b2."""
    n, p, c, a, d = shape
    rng = np.random.default_rng(seed)
    x = randn(rng, (n, p, c), 1.0, device, torch.bfloat16)
    v = x if d == c else randn(rng, (n, p, d), 0.5, device, torch.bfloat16)
    return (x, randn(rng, (a, c), 2.0 / c ** 0.5, device),
            randn(rng, (a,), 0.1, device), randn(rng, (g, a), 0.2, device),
            randn(rng, (g,), 0.1, device), v)


def k7_within(got: torch.Tensor, want: torch.Tensor,
              g: int = 2) -> torch.Tensor:
    """Elementwise, per glimpse row [N, G, D]: is K7's ``got`` within
    K7_RTOL_ROW of the row's largest |value| in ``want``?"""
    n = got.shape[0]
    got, want = got.float().reshape(n, g, -1), want.float().reshape(n, g, -1)
    return (got - want).abs() <= K7_RTOL_ROW * want.abs().amax(-1,
                                                               keepdim=True)


def k8_inputs(n: int, seed: int, device, *, t: int = K8_SHAPE["t"],
              e: int = K8_SHAPE["e"], h: int = K8_SHAPE["h"]) -> tuple:
    """x [n, T, E] bf16 and the LSTM's weights in layers.LSTM's layout
    (f32): xp ~ N(0, 1) and W_hh ~ N(0, 4/H), so that h @ W_hh^T is about
    half a unit: the gates stay off the sigmoid's flat tails, and W_hh's
    blocks matter (its i and f blocks swapped move most outputs)."""
    rng = np.random.default_rng(seed)
    return (randn(rng, (n, t, e), 1.0, device, torch.bfloat16),
            randn(rng, (4 * h, e), e ** -0.5, device),
            randn(rng, (4 * h, h), 2.0 * h ** -0.5, device),
            randn(rng, (4 * h,), 0.1, device),
            randn(rng, (4 * h,), 0.1, device))


def k8_scan_inputs(x, w_ih, w_hh, b_ih, b_hh) -> tuple:
    """The scan's inputs as ``lstm_seq`` gives them on the card: the
    projection without its bias, W_hh, and the bias, which the kernel adds
    in bf16 -> (xp, W_hh, bias)."""
    return k8._project(x, w_ih), w_hh, (b_ih + b_hh).to(torch.bfloat16)


def k8_within(got: torch.Tensor, forced: torch.Tensor) -> torch.Tensor:
    """Elementwise: is each step of K8's ``got`` within one bf16 ulp plus
    K8_STEP_ATOL of ``forced``, the plain steps fed ``got``'s carry?"""
    got, forced = got.float(), forced.float()
    ulp = torch.exp2(torch.floor(torch.log2(forced.abs().clamp_min(1e-30)))
                     - 7)
    return (got - forced).abs() <= ulp + K8_STEP_ATOL


def n1_inputs(rows: int, d: int, seed: int, device, spread: float = 1.0):
    """N1 inputs: bf16 x and r of the given spread, f32 gains about 1 and
    biases."""
    g = torch.Generator(device=device).manual_seed(seed)
    x, r = (spread * torch.randn(rows, d, generator=g, device=device)
            for _ in range(2))
    w = 1.0 + 0.5 * torch.randn(d, generator=g, device=device)
    b = 0.1 * torch.randn(d, generator=g, device=device)
    return x.to(torch.bfloat16), r.to(torch.bfloat16), w, b


def n1_within(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """N1 against its composed form: both round z = x + r to bf16 and keep
    the statistics in f32, so they differ in the order of the f32 sums
    alone: one bf16 ulp of the output, and 2^-16 besides near 0, where the
    output is the difference of terms of order 1."""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(2.0 ** -126))) - 7)
    return (got - want).abs() <= ulp + 2.0 ** -16


def n2_inputs(n: int, heads: int, lq: int, lk: int, seed: int,
              device) -> tuple:
    """N2 inputs: bf16 q [N, Lq, 64 heads], k and v [N, Lk, 64 heads] of
    unit variance and a random key mask (each sample its own masked
    share), sample 0's keys all masked."""
    g = torch.Generator(device=device).manual_seed(seed)
    d = 64 * heads
    q, k, v = (torch.randn(n, length, d, generator=g, device=device)
               .to(torch.bfloat16) for length in (lq, lk, lk))
    share = torch.rand(n, 1, generator=g, device=device)
    mask = torch.rand(n, lk, generator=g, device=device) < share
    mask[0] = True
    return q, k, v, mask


def n2_within(got: torch.Tensor, want: torch.Tensor,
              composed: torch.Tensor) -> bool:
    """Is N2's ``got`` no further from ``want`` (the f32 composed
    attention, TF32 off) than the composed bf16 form ``composed`` is, plus
    one bf16 ulp of the output's magnitude?"""
    err = float((got.float() - want).abs().max())
    composed_err = float((composed.float() - want).abs().max())
    ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    return err <= composed_err + ulp
