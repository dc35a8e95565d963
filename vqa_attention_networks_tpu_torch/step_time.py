"""Time a checkout's kernels on the card: the port's one kernel timer.

    python3 vqa_attention_networks_tpu_torch/step_time.py [--root DIR] [--kernels [NAME ...]]

imports the port from DIR (by default the checkout that holds this file),
so that two checkouts of the port, one of them unpacked with
``git archive``, can be timed by turns on the same card: run it for each,
in the order A, B, B, A, and compare within the one machine. DIR's port
must hold ``ops/card_cases.py``, whose inputs and tolerances it times and
checks on. (A training step or a served batch is the benchmark's:
``port_bench``; ``chip_smoke.py`` gates and times nothing.)

One JSON line a timed call, K1 to K8, N1 and N2 at the shapes the port
runs (``KERNELS``; names after ``--kernels`` time only those): K1 and K5
at N = 256; K2's forward, d_q, d_img (the g_prod build and the product)
and d_W/d_b (the build and ``d_w_gemm_kernel``) at N = 64, rate 0.1; K3's
d_W/d_b/d_q (the g_pooled build and three launches) and d_img at N = 64
and its forward at N = 64 and 256; K4 at N = 256 (its elements outside
the tolerance by output); K6 at N = 256; K7 at its two call shapes; K8's
scan and its entry ``lstm_seq`` at N = 256; N1 at MCAN-large's three norm
shapes and N2 at its three attention shapes, N = 256; N3 at BAN-8's
shape, N = 256 (``library`` the map as ban-vqa composes it, one
``torch.einsum`` and the masked softmax). Each line says
whether the kernel agreed with its plain version on the same inputs
(``agrees``, by ``card_cases``' tolerance) and whether a rerun gave the
same bits, and gives the call's time three ways: ``events_ms``, calls
enqueued back to back; ``device_ms``, each call's events queued behind a
spin on the card (``launch_ms``); ``device_ms_by_launch``, each launch's
device time from the profiler (``device_ms_by_kernel``). Beside them:
``plain_ms``, the plain version by events; ``bound_ms`` and ``bound_by``,
the least time this card could take for the call's bytes (each input read
once, each output written once, at HBM_BYTES_PER_S) or its operations (at
PEAK_OPS_PER_S for their type); and, where one PyTorch call computes a
comparable product, ``library`` and ``library_ms`` (for information where
it is not the kernel's function). Every line carries the card's name and
power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

ITERS = 10  # timed calls of each kernel, after one warm-up
# the lines each name of --kernels prints
KERNELS = {
    "K1": ("K1",),
    "K5": ("K5",),
    "K2": ("K2_forward", "K2_d_q", "K2_d_img", "K2_d_w"),
    "K3": ("K3_d_w", "K3_d_img", "K3_forward"),
    "K4": ("K4",),
    "K6": ("K6",),
    "K7": ("K7_question", "K7_co_attention"),
    "K8": ("K8", "K8_lstm_seq"),
    "N1": ("N1_grid", "N1_words", "N1_head"),
    "N2": ("N2_grid_self", "N2_guided", "N2_words_self"),
    "N3": ("N3",),
}
# the card's rates for the bounds (H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}


def time_ms(fn, iters: int = ITERS) -> float:
    """ms a call of ``fn``: CUDA events around ``iters`` calls enqueued
    back to back."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def launch_ms(fn, iters: int = ITERS) -> float:
    """The device ms of one call of ``fn`` (all its launches): CUDA events
    around each call, both queued behind a spin on the card so that the
    host's enqueue falls outside the interval, averaged over ``iters``
    calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / iters


def device_ms_by_kernel(fn, iters: int = ITERS) -> dict:
    """Each kernel's device time per call of ``fn`` (ms) from one
    torch.profiler trace of ``iters`` calls after a warm-up, by kernel
    name (its first 60 characters; kernels whose names agree that far are
    summed): the time of each launch of a multi-launch kernel, apart.
    The profiler can drop records, so each kernel's time is its mean per
    recorded launch times its launches per call (round(count / iters));
    it can also drop every record of a kernel, which then is missing. A
    call's whole device time is ``launch_ms``'s, which needs no profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if getattr(e, "self_device_time_total", 0) > 0:
            key = e.key[:60]
            times[key] = times.get(key, 0.0) + (
                e.self_device_time_total / e.count
                * max(1, round(e.count / iters)) / 1e3)
    return times


def nbytes(*tensors) -> int:
    """Bytes of the distinct tensors given (a tensor passed twice, as the
    question glimpse passes h_seq as x and v, is read once)."""
    seen = {t.data_ptr(): t for t in tensors}
    return sum(t.numel() * t.element_size() for t in seen.values())


def bound(moved: int, ops: dict) -> tuple:
    """(ms, "bytes" or "operations"): the least time this card could take
    for work that moves ``moved`` bytes and does ``ops`` operations by
    type, each type at its peak rate."""
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()) * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def main() -> None:
    package = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(package),
                        help="the checkout whose port is timed")
    parser.add_argument("--kernels", nargs="*", default=[],
                        metavar="NAME",
                        help=f"time the kernels named ({' '.join(KERNELS)});"
                             " all of them without a name")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    names = set(args.kernels) or set(KERNELS)
    unknown = names - set(KERNELS)
    if unknown:
        raise SystemExit(f"unknown kernels {sorted(unknown)}; the names "
                         f"are {list(KERNELS)}")
    # the port from ``root``, and none of this file's neighbours as
    # top-level modules
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") != package]
    time_kernels(root, names)


def time_kernels(root: str, names: set) -> None:
    """Time and check the kernels of ``names`` on the port that
    ``sys.path`` reaches first."""
    from vqa_attention_networks_tpu_torch.ops import attention as att
    from vqa_attention_networks_tpu_torch.ops import ban_attention as ban
    from vqa_attention_networks_tpu_torch.ops import card_cases as cc
    from vqa_attention_networks_tpu_torch.ops import coattention as co
    from vqa_attention_networks_tpu_torch.ops import grid_fusion as gf
    from vqa_attention_networks_tpu_torch.ops import lstm as k8
    from vqa_attention_networks_tpu_torch.ops import mcan_attention as mha
    from vqa_attention_networks_tpu_torch.ops import mcan_norm
    from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf
    from vqa_attention_networks_tpu_torch.ops import train_fusion as tf
    from vqa_attention_networks_tpu_torch.ops import wq_fusion as wqf
    from vqa_attention_networks_tpu_torch.ops import wq_grid_fusion as wqg

    _, smi = cc.card()  # exits when no card is visible
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def say(kernel, call, plain, agrees, cost, library=None, **fields):
        """One line: ``call`` timed three ways and checked for a bit-equal
        rerun, ``plain`` timed, ``cost`` (bytes, ops) as its bound;
        ``library``: (name, call)."""
        got, again = call(), call()
        if isinstance(got, torch.Tensor):
            got, again = (got,), (again,)
        plain()  # warm-up
        line = dict(
            kernel=kernel, root=root, agrees=bool(agrees),
            rerun_bit_equal=all(torch.equal(a, b)
                                for a, b in zip(got, again)),
            events_ms=time_ms(call), device_ms=launch_ms(call),
            device_ms_by_launch=device_ms_by_kernel(call),
            plain_ms=time_ms(plain))
        line["bound_ms"], line["bound_by"] = bound(*cost)
        if library is not None:
            library[1]()  # warm-up
            line.update(library=library[0], library_ms=time_ms(library[1]))
        print(json.dumps(dict(line, **fields, card=smi)), flush=True)
        del got, again
        torch.cuda.empty_cache()

    n, k = cc.BATCH, cc.K
    if "K1" in names:
        img, q, sw = cc.k1_inputs(n, n, dev)
        _, l, d = img.shape
        c, g = sw.c1w.shape[1], sw.c2w.shape[1]
        say("K1", lambda: wqf.stage1_coattention(img, q, sw),
            lambda: wqf.stage1_coattention_reference(img, q, sw),
            cc.within(wqf.stage1_coattention(img, q, sw),
                      wqf.stage1_coattention_reference(img, q, sw), d).all(),
            (nbytes(img, q, sw.w3, sw.b3, sw.c1w, sw.c1b, sw.c2w, sw.c2b)
             + 2 * n * g * d,
             {"bf16": 2 * n * l * (d * sw.o + sw.o * c + c * g + g * d),
              "f32": 2 * n * sw.k * d * sw.o}),  # the wq build
            n=n)
        del img, q, sw

    if "K5" in names:
        img, w, b, q = cc.k5_inputs(n, 5, dev)
        _, l, d = img.shape
        f = w.shape[1]
        w_bf16, flat = w.to(torch.bfloat16), img.reshape(-1, d)
        say("K5", lambda: gf.inference_fusion_cuda(img, w, b, q, k),
            lambda: gf.grid_fuse_reference(img, w, b, q, k),
            cc.k2_within("forward", gf.inference_fusion_cuda(img, w, b, q, k),
                         gf.grid_fuse_reference(img, w, b, q, k)).all(),
            (nbytes(img, w_bf16, b, q) + 4 * n * l * (f // k),
             {"bf16": 2 * n * l * d * f}),
            library=("torch.matmul(img, bf16 W), the bare product, not K5's "
                     "function", lambda: torch.matmul(flat, w_bf16)), n=n)
        del img, w, b, q, w_bf16, flat

    n6, seed, rate = cc.TRAIN_BATCH, 7, 0.1
    if "K2" in names:
        img, w, b, q, g = cc.k2_inputs(n6, 3, dev)
        w_bf16, bf, qf = tf.operands(w, b, q)
        _, l, d = img.shape
        f = w.shape[1]
        keep = tf.keep_scale(tf.dropout_mask(seed, n6, l, f, rate, dev),
                             rate)
        out = tf.forward_cuda(img, w_bf16, bf, qf, seed, k, rate)
        args = (g, out, img, w_bf16, bf, qf, seed, k, rate)
        g_prod, parts = tf.g_prod_cuda(*args)
        ops = {"bf16": 2 * n6 * l * d * f}
        say("K2_forward",
            lambda: tf.forward_cuda(img, w_bf16, bf, qf, seed, k, rate),
            lambda: tf.forward_reference(img, w_bf16, bf, qf, k, keep),
            cc.k2_within("forward", out, tf.forward_reference(
                img, w_bf16, bf, qf, k, keep)).all(),
            (nbytes(img, w_bf16, bf, qf, out), ops), n=n6, rate=rate)
        # the backward launches on the kernel's own forward output
        say("K2_d_q", lambda: tf.d_q_cuda(*args),
            lambda: tf.d_q_reference(g, out, img, w_bf16, bf, k, keep),
            cc.k2_within("d_q", tf.d_q_cuda(*args), tf.d_q_reference(
                g, out, img, w_bf16, bf, k, keep)).all(),
            (nbytes(g, out, img, w_bf16, bf) + 4 * n6 * f, ops), n=n6,
            rate=rate)
        w_t = w_bf16.t()
        say("K2_d_img", lambda: tf.d_img_cuda(*args),
            lambda: tf.d_img_reference(g, out, w_bf16, qf, k, keep),
            cc.k2_within("d_img", tf.d_img_cuda(*args), tf.d_img_reference(
                g, out, w_bf16, qf, k, keep)).all(),
            (nbytes(g, out, w_bf16, qf, img), ops),
            library=("torch.matmul(g_prod, bf16 W^T), the bare product",
                     lambda: torch.matmul(g_prod, w_t)), n=n6, rate=rate)
        # d_W/d_b: the g_prod build and the product over it, in one call
        # and apart
        want_w, want_b = tf.d_w_reference(g, out, img, qf, k, keep)
        got_w, got_b = tf.d_w_cuda(*args)
        say("K2_d_w", lambda: tf.d_w_cuda(*args),
            lambda: tf.d_w_reference(g, out, img, qf, k, keep),
            cc.k2_within("d_w", got_w, want_w).all()
            and cc.k2_within("d_b", got_b, want_b).all(),
            (nbytes(g, out, img, qf) + 4 * (d * f + f), ops), n=n6,
            rate=rate, g_prod_ms=time_ms(lambda: tf.g_prod_cuda(*args)),
            g_prod_bound_ms=bound(nbytes(g, out, qf, g_prod, parts),
                                  {"f32": 4 * n6 * l * f})[0],
            d_w_gemm_ms=time_ms(
                lambda: tf.d_w_from_operand_cuda(img, g_prod, parts)),
            d_w_gemm_bound_ms=bound(nbytes(img, g_prod, parts)
                                    + 4 * (d * f + f), ops)[0])
        del img, w, b, q, g, w_bf16, bf, qf, keep, out, args, g_prod, parts
        del w_t, want_w, want_b, got_w, got_b

    # K3's backward launches on the kernel's own forward output at N = 64,
    # its forward at N = 64 and 256
    for n3 in (n6, n) if "K3" in names else ():
        img, w, b, q, g = cc.k2_inputs(n3, 3, dev)
        w_bf16, bf, qb = pf.operands(w, b, q)
        _, l, d = img.shape
        f = w.shape[1]
        out = pf.forward_cuda(img, w_bf16, bf, qb, k)
        prod = {"bf16": 2 * n3 * l * d * (f // k)}
        build = dict(prod, f32=2 * n3 * d * f)  # 2 N k D O = 2 N D F
        if n3 == n6:
            args = (g, out, img, w_bf16, bf, qb, k)
            got = pf.d_w_cuda(*args)
            want = pf.d_w_reference(g, out, img, w_bf16, bf, qb, k)
            say("K3_d_w", lambda: pf.d_w_cuda(*args),
                lambda: pf.d_w_reference(g, out, img, w_bf16, bf, qb, k),
                all(bool(cc.k3_within(name, a, b_).all()) for name, a, b_
                    in zip(("d_w", "d_b", "d_q"), got, want)),
                (nbytes(g, out, img, w_bf16, bf, qb)
                 + 4 * (d * f + f + n3 * f), dict(prod, f32=4 * n3 * d * f)),
                n=n3)
            gp = pf.g_pooled(g, out)[..., :f // k].to(
                torch.bfloat16).contiguous()
            wq_t = pf.contracted_weights(w_bf16, qb, k).to(
                torch.bfloat16).transpose(1, 2).contiguous()
            say("K3_d_img", lambda: pf.d_img_cuda(*args),
                lambda: pf.d_img_reference(g, out, w_bf16, qb, k),
                cc.k3_within("d_img", pf.d_img_cuda(*args), pf.d_img_reference(
                    g, out, w_bf16, qb, k)).all(),
                (nbytes(g, out, w_bf16, qb) + 4 * img.numel(), build),
                library=("torch.bmm(bf16 g_pooled, bf16 wq^T), not the "
                         "kernel's function (no wq build, bf16 out)",
                         lambda: torch.bmm(gp, wq_t)), n=n3)
            del args, got, want, gp, wq_t
        say("K3_forward", lambda: pf.forward_cuda(img, w_bf16, bf, qb, k),
            lambda: pf.forward_reference(img, w_bf16, bf, qb, k),
            cc.k3_within("forward", out, pf.forward_reference(
                img, w_bf16, bf, qb, k)).all(),
            (nbytes(img, w_bf16, bf, qb, out), build), n=n3)
        del img, w, b, q, g, w_bf16, bf, qb, out

    if "K4" in names:
        a4 = cc.k4_inputs(n, 4, dev)
        _, l, e = a4[0].shape
        t = a4[1].shape[1]
        got = co.coattention_core_cuda(*a4)
        want = co.coattention_core_reference(*a4)
        outputs = ("v", "q", "av", "aq")
        within = [cc.k4_within(name, a, b_)
                  for name, a, b_ in zip(outputs, got, want)]
        say("K4", lambda: co.coattention_core_cuda(*a4),
            lambda: co.coattention_core_reference(*a4),
            all(bool(x.all()) for x in within),
            (nbytes(*a4) + 4 * n * (2 * e + l + t),
             {"bf16": 2 * n * (3 * t * l * e + 2 * (l + t) * e)}), n=n,
            outside_tolerance=dict(zip(outputs, (int((~x).sum())
                                                 for x in within))),
            max_abs_diff=dict(zip(outputs, (float((a - b_).abs().max())
                                            for a, b_ in zip(got, want)))))
        del a4, got, want, within

    if "K6" in names:
        img, w, b, q = cc.k6_inputs(n, 6, dev)
        _, l, d = img.shape
        o = w.shape[1] // k
        say("K6", lambda: wqg.wq_grid_fuse_cuda(img, w, b, q, k),
            lambda: wqg.wq_grid_fuse_reference(img, w, b, q, k),
            cc.k6_within(wqg.wq_grid_fuse_cuda(img, w, b, q, k),
                         wqg.wq_grid_fuse_reference(img, w, b, q, k)).all(),
            (nbytes(img, *pf.operands(w, b, q)) + 2 * n * l * o,
             {"bf16": 2 * n * l * d * o, "f32": 2 * n * k * d * o}), n=n)
        del img, w, b, q

    for name, shape in cc.K7_SHAPES.items() if "K7" in names else ():
        a7 = cc.k7_inputs(shape, 7, dev)
        n7, p, c, a, d = shape
        say(f"K7_{name}",
            lambda: att.glimpse_attention_cuda(*a7, uniform_quirk=False),
            lambda: att.glimpse_attention_reference(*a7, uniform_quirk=False),
            cc.k7_within(
                att.glimpse_attention_cuda(*a7, uniform_quirk=False),
                att.glimpse_attention_reference(*a7, uniform_quirk=False)
            ).all(),
            (nbytes(a7[0], a7[1].to(torch.bfloat16), a7[2],
                    a7[3].to(torch.bfloat16), a7[4], a7[5]) + 2 * n7 * 2 * d,
             {"bf16": 2 * n7 * p * (c * a + a * 2 + 2 * d)}), n=n7,
            shape=dict(zip("npcad", shape)))
        del a7

    if "K8" in names:
        x, w_ih, w_hh, b_ih, b_hh = cc.k8_inputs(n, 9, dev)
        xp, _, bias = cc.k8_scan_inputs(x, w_ih, w_hh, b_ih, b_hh)
        w_bf16 = w_hh.to(torch.bfloat16)
        t, h = cc.K8_SHAPE["t"], cc.K8_SHAPE["h"]
        got = k8.lstm_scan_cuda(xp, w_bf16, bias)
        forced = k8.lstm_scan_reference(xp + bias, w_bf16, h_carry=got)
        free = k8.lstm_scan_reference(xp + bias, w_bf16)
        # the bound counts the recurrent products and xp, W_hh and the
        # output moved once; the T dependent steps are a latency floor it
        # does not count
        say("K8", lambda: k8.lstm_scan_cuda(xp, w_bf16, bias),
            lambda: k8.lstm_scan_reference(xp + bias, w_bf16),
            bool(cc.k8_within(got, forced).all()) and float(
                (got.float() - free.float()).abs().max()) <= cc.K8_FREE_ATOL,
            (nbytes(xp, w_bf16) + 2 * n * t * h,
             {"bf16": 2 * n * t * h * 4 * h}), n=n, **cc.K8_SHAPE)
        # the entry, beside one PyTorch call of the same function
        # (nn.LSTM: cuDNN, input projection included; at::lstm takes cuDNN
        # only for a dtype torch.cudnn_is_acceptable accepts)
        dtype = (torch.bfloat16 if torch.cudnn_is_acceptable(x)
                 else torch.float16)
        net = torch.nn.LSTM(cc.K8_SHAPE["e"], h, batch_first=True).to(
            dev, dtype)
        with torch.no_grad():
            for key, value in (("weight_ih_l0", w_ih), ("weight_hh_l0", w_hh),
                               ("bias_ih_l0", b_ih), ("bias_hh_l0", b_hh)):
                getattr(net, key).copy_(value)
        net.flatten_parameters()
        x_lib = x.to(dtype)
        with torch.inference_mode():
            xpb = k8.input_projection(x, w_ih, b_ih, b_hh)
            seq = k8.lstm_seq(x, w_ih, w_bf16, b_ih, b_hh)
            say("K8_lstm_seq",
                lambda: k8.lstm_seq(x, w_ih, w_bf16, b_ih, b_hh),
                lambda: k8.lstm_scan_reference(
                    k8.input_projection(x, w_ih, b_ih, b_hh), w_bf16),
                cc.k8_within(seq, k8.lstm_scan_reference(
                    xpb, w_bf16, h_carry=seq)).all(),
                # the scan's cost, and the input projection's product
                (nbytes(x, w_ih, w_bf16) + 2 * n * t * h,
                 {"bf16": 2 * n * t * h * 4 * h
                  + 2 * n * t * cc.K8_SHAPE["e"] * 4 * h}),
                library=(f"torch.nn.LSTM ({dtype}, cuDNN)",
                         lambda: net(x_lib)), n=n,
                library_device_ms=launch_ms(lambda: net(x_lib)))
        del x, w_ih, w_hh, b_ih, b_hh, xp, bias, w_bf16, got, forced, free
        del net, x_lib, xpb, seq

    for name, (rows, d) in cc.N1_SHAPES.items() if "N1" in names else ():
        x, r, w, b = cc.n1_inputs(rows, d, 38, dev)
        say(f"N1_{name}", lambda: mcan_norm.add_layernorm(x, r, w, b),
            lambda: mcan_norm.add_layernorm_composed(x, r, w, b),
            cc.n1_within(mcan_norm.add_layernorm(x, r, w, b),
                         mcan_norm.add_layernorm_composed(x, r, w, b)).all(),
            (nbytes(x, r, w, b) + x.numel() * x.element_size(), {}),
            shape=[rows, d])
        del x, r, w, b

    for i, (name, (heads, lq, lk)) in enumerate(
            cc.N2_SHAPES.items() if "N2" in names else ()):
        q, kk, v, mask = cc.n2_inputs(n, heads, lq, lk, 380 + i, dev)
        dm = q.shape[-1]

        def split(x):
            return x.view(n, x.shape[1], heads, -1).transpose(1, 2)

        def sdpa():
            o = F.scaled_dot_product_attention(
                split(q), split(kk), split(v),
                attn_mask=~mask[:, None, None, :])
            return o.transpose(1, 2).reshape(n, lq, dm)

        say(f"N2_{name}", lambda: mha.attention(q, kk, v, mask),
            lambda: mha.attention_composed(q, kk, v, mask, heads),
            cc.n2_within(mha.attention(q, kk, v, mask),
                         mha.attention_composed(q.float(), kk.float(),
                                                v.float(), mask, heads),
                         mha.attention_composed(q, kk, v, mask, heads)),
            (nbytes(q, kk, v, mask) + q.numel() * q.element_size(),
             {"bf16": 4.0 * n * heads * lq * lk * mha.HEAD_DIM}),
            library=("torch.nn.functional.scaled_dot_product_attention",
                     sdpa), n=n, shape=[n, heads, lq, lk])
        del q, kk, v, mask

    if "N3" in names:
        av, aq, h, hb, mask = cc.n3_inputs(n, 390, dev)
        g, (_, l, kh), t = h.shape[0], av.shape, aq.shape[1]
        h16 = h.to(torch.bfloat16)

        def einsum():
            s_ = torch.einsum("gk,bvk,bqk->bgvq", h16, av, aq)
            s_ = s_ + hb.to(s_.dtype)[None, :, None, None]
            s_ = s_.masked_fill(mask[:, None, :, None], float("-inf"))
            return torch.softmax(s_.reshape(n, g, l * t).float(), -1)

        say("N3", lambda: ban.attention_map(av, aq, h, hb, mask),
            lambda: ban.attention_map_composed(av, aq, h, hb, mask),
            cc.n3_within(ban.attention_map(av, aq, h, hb, mask),
                         cc.n3_exact(av, aq, h, hb, mask)),
            (nbytes(av, aq, h, mask) + 2 * n * g * l * t,
             {"bf16": 2.0 * n * g * t * l * kh}),
            library=("torch.einsum('gk,bvk,bqk->bgvq') + masked softmax "
                     "(ban-vqa's BCNet)", einsum),
            n=n, shape=[n, g, l, t, kh])
        del av, aq, h, hb, mask


if __name__ == "__main__":
    main()
