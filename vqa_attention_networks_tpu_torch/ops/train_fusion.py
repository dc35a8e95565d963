"""Training-mode grid fusion with pre-pool dropout (port of
``vqa_attention_networks_tpu/ops/pallas_train_fusion.py``), kernel K2.

With F = O*k and channel c = o*k + j (output-major):

    z0[n,l,c] = bf16(img)[n,l,:] @ bf16(W)[:,c]   (f32 accumulate) + b[c]
    zd[n,l,c] = (z0 * q[n,c]) * (m[n,l,c] * inv_keep)   m a 0/1 mask
    pooled    = sum_j zd[n,l,o*k+j]   (j = 0..k-1, in order)
    out       = sqrt(relu(pooled)) - sqrt(relu(-pooled))          [N, L, O] f32

The backward takes g = d out:

    g_pooled  = g * where(out == 0, 0, 0.5 / max(|out|, 1e-20))
    g_prod    = (g_pooled[n,l,o] * (m * inv_keep)) * q[n,c]        f32
    d_img     = bf16(g_prod) @ bf16(W)^T                 f32 sum, to img's dtype
    d_W       = bf16(img)^T @ bf16(g_prod)               f32
    d_b       = sum_{n,l} g_prod                         f32, of the f32 g_prod
    d_q       = sum_l (g_pooled * (m * inv_keep)) * z0   z0 recomputed, to q's dtype

The zero branch of g_pooled is the composed chain's gradient at pooled == 0
(relu'(0) = 0): pooled is exactly 0 wherever dropout removed all k factors,
and a clamped 1/|out| there blew the upstream gradients up 1e10x
(``pallas_train_fusion.py:103-112``).

Rounding points (the kernel and the plain version share them): W rounds to
bf16, as the TPU wrapper casts W to img's dtype; the f32 operand g_prod
rounds to bf16 before the d_img and d_W products, with f32 accumulation
(what XLA's DEFAULT precision does with f32 operands on the TPU); all other
arithmetic is f32, with the multiplies and adds unfused.

The mask: Philox4x32-10 with key (seed, 0) and counter (i mod 2^32,
i >> 32, 0, 0), where i = ((row0 + n)*L + l)*F_total + col0 + c is the
flat element index in the global batch and the global fusion width; the
element is kept iff word 0 of the output is below ``thr_keep =
min(int((1 - rate) * 2^32), 2^32 - 1)``. ``row0`` is the global index of
the call's first sample: 0 in one process, and a rank's first row in a
data-parallel run. ``col0`` and ``f_total`` place the call's F columns in
the global width: 0 and F in one process, a rank's first column and the
whole width in a tensor-parallel run (``parallel/tensor.py``). So the ranks
draw exactly the mask one process draws (JAX's mask over a sharded array
is the global array's). At row0 = col0 = 0 and f_total = F these are the
bits K2 always drew. The mask depends on the element and the seed only,
so the forward, the backward launches and the plain version replay the
same bits whatever their tiling. (The TPU kernel seeded its on-core
generator per tile; those bits cannot be reproduced here.) At rate 0 no
bits are drawn.

d_W/d_b and d_img share one operand on the card: ``g_prod_cuda`` builds
g_prod once as bf16 [N*L, F], with the f32 d_b partial of each chunk of
``DB_CHUNK`` rows; ``d_w_from_operand_cuda`` is the d_W product over it
(its first D tile also sums the partials in chunk order), and
``d_img_from_operand_cuda`` the d_img product. Their plain versions are
``g_prod_reference``, ``d_w_from_operand_reference`` and
``d_img_from_operand_reference``; ``d_w_reference`` composes the first two,
and ``d_img_reference`` computes what the first and the third compose to.
``d_w_cuda`` and ``d_img_cuda`` are the build followed by the product.

- ``train_grid_fuse`` dispatches: a CPU tensor goes to the plain version,
  a CUDA tensor to the kernels (``csrc/train_fusion.cu``), which raise on
  an input they do not take. Nothing catches an error to fall back. (The
  training dispatch in ``ops/grid_fusion.py`` takes neither under
  ``VQA_DISABLE_PALLAS`` or ``VQA_COMPOSED_TRAIN_FUSION``.)
- ``train_grid_fuse_reference`` is the plain version: PyTorch ops with the
  backward above, as an ``autograd.Function``.
- ``launch_count`` counts the kernel launches, by kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from vqa_attention_networks_tpu_torch.models.layers import signed_sqrt
from vqa_attention_networks_tpu_torch.ops import on_card

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_MAX_K = 8  # the forward kernel is instantiated for k = 1..8
_MAX_ROWS = 208  # d_q holds one sample's L rows in 13 row tiles of 16
_MASK_CHUNK = 1 << 24  # elements per step of the plain mask (memory)
DB_CHUNK = 64  # rows per d_b partial of the g_prod build (kBuildRows)

# kernel launches made by TrainGridFuse, by kernel
launch_count: Dict[str, int] = {"forward": 0, "d_img": 0, "g_prod": 0,
                                "d_w": 0, "d_q": 0}


def thr_keep(rate: float) -> int:
    """The keep threshold on a 32-bit word (``pallas_train_fusion.py:212``)."""
    return min(int((1.0 - rate) * 4294967296.0), 4294967295)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and int64 x in
    [0, 2^32), without leaving int64: x splits into 16-bit halves."""
    p_lo = m * (x & 0xFFFF)  # < 2^48
    p_hi = m * (x >> 16)  # < 2^48
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    hi = ((p_hi + (p_lo >> 16)) >> 16) & _MASK32
    return hi, lo


def philox_word0(seed: int, counter: torch.Tensor) -> torch.Tensor:
    """Word 0 of Philox4x32-10 with key (seed, 0) at counter
    (counter mod 2^32, counter >> 32, 0, 0); int64 in, int64 in [0, 2^32)
    out."""
    c0 = counter & _MASK32
    c1 = counter >> 32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = int(seed) & _MASK32, 0
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def dropout_mask(seed: int, n: int, l: int, f: int, rate: float,
                 device=None, row0: int = 0, col0: int = 0,
                 f_total: Optional[int] = None) -> torch.Tensor:
    """The K2 keep mask [n, l, f] (bool) for ``seed``: element (n, l, c)
    is drawn at counter ((row0 + n)*l_dim + l)*f_total + col0 + c
    (``f_total`` defaults to f)."""
    f_total = f if f_total is None else int(f_total)
    total = n * l * f
    thr = thr_keep(rate)
    out = torch.empty(total, dtype=torch.bool, device=device)
    if f_total == f and col0 == 0:  # one run of counters
        base = int(row0) * l * f
        for s in range(0, total, _MASK_CHUNK):
            idx = torch.arange(base + s, base + min(s + _MASK_CHUNK, total),
                               dtype=torch.int64, device=device)
            out[s:s + idx.numel()] = philox_word0(seed, idx) < thr
        return out.reshape(n, l, f)
    cols = torch.arange(f, dtype=torch.int64, device=device) + int(col0)
    rows = max(1, _MASK_CHUNK // f)
    for s in range(0, n * l, rows):
        m = torch.arange(s, min(s + rows, n * l), dtype=torch.int64,
                         device=device) + int(row0) * l
        idx = (m[:, None] * f_total + cols).reshape(-1)
        out[s * f:s * f + idx.numel()] = philox_word0(seed, idx) < thr
    return out.reshape(n, l, f)


def _z0(img: torch.Tensor, w_bf16: torch.Tensor,
        b: torch.Tensor) -> torch.Tensor:
    """bf16(img) @ bf16(W) in f32, + b: [N, L, F] f32."""
    x = img.to(torch.bfloat16).float()
    return torch.matmul(x, w_bf16.float()) + b.float()


def _pool(zd: torch.Tensor, k: int) -> torch.Tensor:
    """sum over the k factors of each output, in j order: [..., O*k] ->
    [..., O]."""
    z = zd.reshape(*zd.shape[:-1], -1, k)
    pooled = z[..., 0]
    for j in range(1, k):
        pooled = pooled + z[..., j]
    return pooled


def operands(w: torch.Tensor, b: torch.Tensor, q: torch.Tensor):
    """The kernels' operands: (bf16 W [D, F], f32 b, f32 q), contiguous."""
    return (w.detach().to(torch.bfloat16).contiguous(),
            b.detach().float().contiguous(), q.detach().float().contiguous())


def keep_scale(mask: Optional[torch.Tensor],
               rate: float) -> Optional[torch.Tensor]:
    """m * inv_keep as f32 (0 or inv_keep), or None at rate 0."""
    if mask is None:
        return None
    return mask.float() * (1.0 / (1.0 - rate))


def _g_zd(g, out, k: int, keep):
    """g_pooled * (m * inv_keep), repeated over the k factors: [N, L, F]."""
    g_pooled = g.float() * torch.where(
        out == 0, torch.zeros_like(out),
        0.5 / torch.clamp_min(out.abs(), 1e-20))
    g_zd = g_pooled.repeat_interleave(k, dim=-1)
    return g_zd if keep is None else g_zd * keep


def _g_prod(g, out, q, k: int, keep):
    return _g_zd(g, out, k, keep) * q[:, None, :]


# the plain version of each launch; ``keep`` is keep_scale(mask, rate)

def forward_reference(img, w_bf16, b, q, k: int, keep) -> torch.Tensor:
    zd = _z0(img, w_bf16, b) * q[:, None, :]
    if keep is not None:
        zd = zd * keep
    return signed_sqrt(_pool(zd, k))


def d_img_reference(g, out, w_bf16, q, k: int, keep) -> torch.Tensor:
    g_prod = _g_prod(g, out, q, k, keep).to(torch.bfloat16).float()
    return torch.matmul(g_prod, w_bf16.float().t()).to(torch.bfloat16)


def d_img_from_operand_reference(g_prod_bf16, w_bf16, n: int,
                                 l: int) -> torch.Tensor:
    """d_img = g_prod [N*L, F] (bf16) @ bf16(W)^T, bf16 [N, L, D]."""
    g_prod = g_prod_bf16.float().reshape(n, l, -1)
    return torch.matmul(g_prod, w_bf16.float().t()).to(torch.bfloat16)


def g_prod_reference(g, out, q, k: int, keep):
    """-> (bf16 g_prod [N*L, F], f32 d_b partials [ceil(N*L / DB_CHUNK), F]):
    the g_prod build's plain version, each partial the sum of its chunk's
    rows of the f32 g_prod."""
    g_prod = _g_prod(g, out, q, k, keep)
    f = g_prod.shape[-1]
    g_prod = g_prod.reshape(-1, f)
    pad = -g_prod.shape[0] % DB_CHUNK
    partials = torch.cat([g_prod, g_prod.new_zeros(pad, f)]).reshape(
        -1, DB_CHUNK, f).sum(1)
    return g_prod.to(torch.bfloat16), partials


def d_w_from_operand_reference(img, g_prod_bf16) -> torch.Tensor:
    """d_W = bf16(img)^T @ g_prod [N*L, F] (bf16), f32 [D, F]."""
    x = img.to(torch.bfloat16).float().reshape(-1, img.shape[-1])
    return torch.matmul(x.t(), g_prod_bf16.float())


def d_w_reference(g, out, img, q, k: int, keep):
    g_prod, partials = g_prod_reference(g, out, q, k, keep)
    return d_w_from_operand_reference(img, g_prod), partials.sum(0)


def d_q_reference(g, out, img, w_bf16, b, k: int, keep) -> torch.Tensor:
    return (_g_zd(g, out, k, keep) * _z0(img, w_bf16, b)).sum(dim=1)


def _no_grads(ctx) -> tuple:
    """None for each non-tensor input after (img, w, b, q): seed, k, rate
    and, where the caller passed them, row0, col0 and f_total."""
    return (None,) * (len(ctx.needs_input_grad) - 4)


class _TrainGridFusePlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, w, b, q, seed, k, rate, row0=0, col0=0,
                f_total=None):
        n, l, _ = img.shape
        w_bf16, bf, qf = operands(w, b, q)
        mask = dropout_mask(seed, n, l, w.shape[1], rate, img.device, row0,
                            col0, f_total) if rate > 0 else None
        out = forward_reference(img, w_bf16, bf, qf, k, keep_scale(mask, rate))
        ctx.save_for_backward(img, w_bf16, bf, qf, out, mask)
        ctx.k, ctx.rate = k, rate
        ctx.dtypes = (w.dtype, b.dtype, q.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        img, w_bf16, bf, qf, out, mask = ctx.saved_tensors
        k, keep = ctx.k, keep_scale(mask, ctx.rate)
        d_img = None
        if ctx.needs_input_grad[0]:
            d_img = d_img_reference(g, out, w_bf16, qf, k, keep).to(img.dtype)
        d_w, d_b = d_w_reference(g, out, img, qf, k, keep)
        d_q = d_q_reference(g, out, img, w_bf16, bf, k, keep)
        w_dtype, b_dtype, q_dtype = ctx.dtypes
        return (d_img, d_w.to(w_dtype), d_b.to(b_dtype), d_q.to(q_dtype),
                *_no_grads(ctx))


def train_grid_fuse_reference(img, w, b, q, seed: int, k: int,
                              rate: float, row0: int = 0, col0: int = 0,
                              f_total: Optional[int] = None) -> torch.Tensor:
    """K2's plain PyTorch version -> [N, L, O] f32, on any device."""
    return _TrainGridFusePlain.apply(img, w, b, q, int(seed), k, float(rate),
                                     int(row0), int(col0),
                                     _width(w, f_total))


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    from vqa_attention_networks_tpu_torch.ops import _build

    lib = _build.load("train_fusion")
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    f = ctypes.c_float
    # pointers, then n, l, d, f, k, seed, thr, inv_keep, row0, col0,
    # f_total, stream
    ll = ctypes.c_longlong
    tail = [i] * 5 + [u, u, f, ll, ll, i, p]
    lib.train_fusion_forward.argtypes = [p] * 5 + tail  # img w b q out
    # g_prod w d_img, n, l, d, f, stream
    lib.train_fusion_d_img.argtypes = [p] * 3 + [i] * 4 + [p]
    lib.train_fusion_g_prod.argtypes = [p] * 5 + tail  # g out q gp partials
    # img gp partials d_w d_b, n, l, d, f, stream
    lib.train_fusion_d_w.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.train_fusion_d_q.argtypes = [p] * 6 + tail  # g out img w b d_q
    # K5 (ops/grid_fusion.py): img w b q out, n, l, d, f, k, stream
    lib.train_fusion_inference_forward.argtypes = [p] * 5 + [i] * 5 + [p]
    for name in ("forward", "d_img", "g_prod", "d_w", "d_q",
                 "inference_forward"):
        getattr(lib, f"train_fusion_{name}").restype = ctypes.c_int
    lib.train_fusion_error_string.argtypes = [ctypes.c_int]
    lib.train_fusion_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(img, w_bf16, b, q, k: int, rate: float) -> None:
    """Raise on operands the forward kernel (K2's, and K5's, which is the
    same kernel with the mask compiled out) does not take."""
    if img.device.type != "cuda":
        raise ValueError(f"the K2 kernels need a CUDA tensor, got {img.device}")
    if img.dtype != torch.bfloat16 or w_bf16.dtype != torch.bfloat16:
        raise TypeError(f"the K2 kernels take bf16 img and W, got "
                        f"{img.dtype} and {w_bf16.dtype}")
    if b.dtype != torch.float32 or q.dtype != torch.float32:
        raise TypeError(f"the K2 kernels take f32 b and q, got {b.dtype} and "
                        f"{q.dtype}")
    if img.dim() != 3 or w_bf16.dim() != 2:
        raise ValueError(f"img must be [N, L, D] and W [D, F], got "
                         f"{tuple(img.shape)} and {tuple(w_bf16.shape)}")
    n, l, d = img.shape
    f = w_bf16.shape[1]
    for name, t in (("W", w_bf16), ("b", b), ("q", q)):
        if t.device != img.device:
            raise ValueError(f"img is on {img.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"the K2 kernels need a contiguous {name}")
    if w_bf16.shape[0] != d or tuple(b.shape) != (f,) or \
            tuple(q.shape) != (n, f):
        raise ValueError(
            f"shapes do not agree: img {tuple(img.shape)}, "
            f"W {tuple(w_bf16.shape)}, b {tuple(b.shape)}, q {tuple(q.shape)}")
    if not 1 <= l <= _MAX_ROWS:
        raise ValueError(f"the K2 kernels take 1 <= L <= {_MAX_ROWS}, got {l}")
    if not 1 <= k <= _MAX_K or f % k:
        raise ValueError(f"the K2 kernels take 1 <= k <= {_MAX_K} with "
                         f"F % k == 0, got k={k}, F={f}")
    if d % 8 or f % 8:
        # rows of img and W are read as 16-byte vectors
        raise ValueError(f"the K2 kernels need D % 8 == 0 and F % 8 == 0, "
                         f"got D={d}, F={f}")
    if not img.is_contiguous():
        raise ValueError("the K2 kernels need a contiguous img")
    if img.data_ptr() % 16 or w_bf16.data_ptr() % 16:
        raise ValueError("the K2 kernels need img and W 16-byte aligned")
    if not 1 <= n <= 65535 or n * l >= 2 ** 31 // max(f, d):
        raise ValueError(f"N*L*max(D, F) must stay below 2^31, got N={n}, "
                         f"L={l}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"the K2 kernels take 0 <= rate < 1, got {rate}")


def _call(name: str, device, *args) -> None:
    """Launch ``train_fusion_<name>`` on ``device``'s card and count it;
    raises on a refused launch."""
    lib = library()
    with on_card(device):
        rc = getattr(lib, f"train_fusion_{name}")(*args)
    if rc != 0:
        raise RuntimeError(
            f"train_fusion {name} launch failed: CUDA error {rc} "
            f"({lib.train_fusion_error_string(rc).decode()})")
    launch_count[name] += 1


def _width(w, f_total: Optional[int]) -> int:
    """The global fusion width: W's own unless a shard names it."""
    return int(w.shape[-1] if f_total is None else f_total)


def _launch(name: str, pointers, img, w_bf16, seed: int, k: int,
            rate: float, row0: int, col0: int, f_total: Optional[int]
            ) -> None:
    n, l, d = img.shape
    thr = thr_keep(rate) if rate > 0 else 0  # 0: rate 0, no bits drawn
    f_total = _width(w_bf16, f_total)
    if row0 < 0:
        raise ValueError(f"row0 is a sample index, got {row0}")
    if not 0 <= col0 < f_total:
        raise ValueError(f"col0 {col0} is not a column of the global width "
                         f"{f_total}")
    _call(name, img.device, *pointers, n, l, d, w_bf16.shape[1], k,
          int(seed) & _MASK32, thr, 1.0 / (1.0 - rate), int(row0), int(col0),
          f_total, torch.cuda.current_stream(img.device).cuda_stream)


def _check_grad(g, out, img, w_bf16, k: int) -> None:
    n, l, _ = img.shape
    want = (n, l, w_bf16.shape[1] // k)
    for name, t in (("g", g), ("out", out)):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                tuple(t.shape) != want or t.device != img.device:
            raise ValueError(f"{name} must be contiguous f32 {want} on "
                             f"{img.device}")


# the kernel of each launch: operands as ``operands`` makes them; ``row0``,
# ``col0`` and ``f_total`` place the mask in the global batch and width
# (the module's docstring)

def forward_cuda(img, w_bf16, b, q, seed: int, k: int,
                 rate: float, row0: int = 0, col0: int = 0,
                 f_total: Optional[int] = None) -> torch.Tensor:
    check_inputs(img, w_bf16, b, q, k, rate)
    n, l, _ = img.shape
    out = torch.empty(n, l, w_bf16.shape[1] // k, dtype=torch.float32,
                      device=img.device)
    _launch("forward", (img.data_ptr(), w_bf16.data_ptr(), b.data_ptr(),
                        q.data_ptr(), out.data_ptr()), img, w_bf16, seed, k,
            rate, row0, col0, f_total)
    return out


def g_prod_cuda(g, out, img, w_bf16, b, q, seed: int, k: int, rate: float,
                row0: int = 0, col0: int = 0, f_total: Optional[int] = None):
    """Launch the g_prod build -> (bf16 g_prod [N*L, F], f32 d_b partials
    [ceil(N*L / DB_CHUNK), F]), in scratch allocated here."""
    check_inputs(img, w_bf16, b, q, k, rate)
    _check_grad(g, out, img, w_bf16, k)
    n, l, _ = img.shape
    f = w_bf16.shape[1]
    g_prod = torch.empty(n * l, f, dtype=torch.bfloat16, device=img.device)
    partials = torch.empty(-(-n * l // DB_CHUNK), f, dtype=torch.float32,
                           device=img.device)
    _launch("g_prod", (g.data_ptr(), out.data_ptr(), q.data_ptr(),
                       g_prod.data_ptr(), partials.data_ptr()), img, w_bf16,
            seed, k, rate, row0, col0, f_total)
    return g_prod, partials


def d_img_from_operand_cuda(g_prod, w_bf16, n: int, l: int) -> torch.Tensor:
    """Launch the d_img product over ``g_prod_cuda``'s g_prod -> bf16
    [N, L, D]."""
    d, f = w_bf16.shape
    if g_prod.device.type != "cuda" or w_bf16.device != g_prod.device:
        raise ValueError("d_img takes g_prod and W on the card")
    if g_prod.dtype != torch.bfloat16 or tuple(g_prod.shape) != (n * l, f) \
            or not g_prod.is_contiguous():
        raise ValueError(f"g_prod must be contiguous bf16 [{n * l}, {f}], as "
                         "g_prod_cuda makes it")
    if w_bf16.dtype != torch.bfloat16 or not w_bf16.is_contiguous() or \
            w_bf16.data_ptr() % 16 or g_prod.data_ptr() % 16:
        raise ValueError("d_img takes a contiguous bf16 W, and W and g_prod "
                         "16-byte aligned")
    d_img = torch.empty(n, l, d, dtype=torch.bfloat16, device=g_prod.device)
    _call("d_img", g_prod.device, g_prod.data_ptr(), w_bf16.data_ptr(),
          d_img.data_ptr(), n, l, d, f,
          torch.cuda.current_stream(g_prod.device).cuda_stream)
    return d_img


def d_img_cuda(g, out, img, w_bf16, b, q, seed: int, k: int,
               rate: float, row0: int = 0, col0: int = 0,
               f_total: Optional[int] = None) -> torch.Tensor:
    """d_img: the g_prod build, then the product over it."""
    g_prod, _ = g_prod_cuda(g, out, img, w_bf16, b, q, seed, k, rate, row0,
                            col0, f_total)
    return d_img_from_operand_cuda(g_prod, w_bf16, *img.shape[:2])


def d_w_from_operand_cuda(img, g_prod, partials):
    """Launch the d_W product over ``g_prod_cuda``'s output -> (f32 d_W
    [D, F], f32 d_b [F], the partials summed in chunk order)."""
    n, l, d = img.shape
    f = g_prod.shape[1]
    if img.device.type != "cuda" or img.dtype != torch.bfloat16 or \
            not img.is_contiguous():
        raise ValueError("d_W takes a contiguous bf16 img on the card")
    if g_prod.dtype != torch.bfloat16 or tuple(g_prod.shape) != (n * l, f) \
            or tuple(partials.shape) != (-(-n * l // DB_CHUNK), f) or \
            partials.dtype != torch.float32 or g_prod.device != img.device:
        raise ValueError(f"g_prod must be bf16 [{n * l}, F] and partials f32 "
                         f"[{-(-n * l // DB_CHUNK)}, F] on {img.device}, as "
                         "g_prod_cuda makes them")
    d_w = torch.empty(d, f, dtype=torch.float32, device=img.device)
    d_b = torch.empty(f, dtype=torch.float32, device=img.device)
    _call("d_w", img.device, img.data_ptr(), g_prod.data_ptr(),
          partials.data_ptr(), d_w.data_ptr(), d_b.data_ptr(), n, l, d, f,
          torch.cuda.current_stream(img.device).cuda_stream)
    return d_w, d_b


def d_w_cuda(g, out, img, w_bf16, b, q, seed: int, k: int, rate: float,
             row0: int = 0, col0: int = 0, f_total: Optional[int] = None):
    """d_W and d_b: the g_prod build, then the product over it."""
    return d_w_from_operand_cuda(
        img, *g_prod_cuda(g, out, img, w_bf16, b, q, seed, k, rate, row0,
                          col0, f_total))


def d_q_cuda(g, out, img, w_bf16, b, q, seed: int, k: int,
             rate: float, row0: int = 0, col0: int = 0,
             f_total: Optional[int] = None) -> torch.Tensor:
    check_inputs(img, w_bf16, b, q, k, rate)
    _check_grad(g, out, img, w_bf16, k)
    d_q = torch.empty(img.shape[0], w_bf16.shape[1], dtype=torch.float32,
                      device=img.device)
    _launch("d_q", (g.data_ptr(), out.data_ptr(), img.data_ptr(),
                    w_bf16.data_ptr(), b.data_ptr(), d_q.data_ptr()), img,
            w_bf16, seed, k, rate, row0, col0, f_total)
    return d_q


class TrainGridFuse(torch.autograd.Function):
    """K2 on the card: the forward and each backward product are launches
    of the hand-written kernels. The backward builds g_prod once, for d_W
    and, only when img needs a gradient (in the training step img is data
    and does not), for d_img."""

    @staticmethod
    def forward(ctx, img, w, b, q, seed, k, rate, row0=0, col0=0,
                f_total=None):
        w_bf16, bf, qf = operands(w, b, q)
        out = forward_cuda(img, w_bf16, bf, qf, seed, k, rate, row0, col0,
                           f_total)
        ctx.save_for_backward(img, w_bf16, bf, qf, out)
        ctx.seed, ctx.k, ctx.rate = seed, k, rate
        ctx.place = (row0, col0, f_total)
        ctx.dtypes = (w.dtype, b.dtype, q.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        img, w_bf16, bf, qf, out = ctx.saved_tensors
        args = (g.float().contiguous(), out, img, w_bf16, bf, qf, ctx.seed,
                ctx.k, ctx.rate, *ctx.place)
        g_prod, partials = g_prod_cuda(*args)
        d_img = d_img_from_operand_cuda(g_prod, w_bf16, *img.shape[:2]) \
            if ctx.needs_input_grad[0] else None
        d_w, d_b = d_w_from_operand_cuda(img, g_prod, partials)
        d_q = d_q_cuda(*args)
        w_dtype, b_dtype, q_dtype = ctx.dtypes
        return (d_img, d_w.to(w_dtype), d_b.to(b_dtype), d_q.to(q_dtype),
                *_no_grads(ctx))


def train_grid_fuse(img, w, b, q, seed: int, k: int, rate: float,
                    row0: int = 0, col0: int = 0,
                    f_total: Optional[int] = None) -> torch.Tensor:
    """Dispatching entry -> [N, L, O] f32: the plain version for a CPU
    tensor, the kernels for a CUDA tensor. ``row0``: the global index of
    img's first sample; ``col0`` and ``f_total``: the global index of W's
    first column and the global width (the mask's place)."""
    if img.device.type == "cpu":
        return train_grid_fuse_reference(img, w, b, q, seed, k, rate, row0,
                                         col0, f_total)
    return TrainGridFuse.apply(img, w, b, q, int(seed), k, float(rate),
                               int(row0), int(col0), _width(w, f_total))
