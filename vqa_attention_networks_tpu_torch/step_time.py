"""Time a checkout's kernels on the card.

    python3 vqa_attention_networks_tpu_torch/step_time.py [--root DIR] [--kernels [NAME ...]]

imports the port from DIR (by default the checkout that holds this file),
so that two checkouts of the port, one of them unpacked with
``git archive``, can be timed by turns on the same card: run it for each,
in the order A, B, B, A, and compare within the one machine. (A training
step is the benchmark's: ``port_bench``'s ``mhb_coatt.train_prepool``.)

- It times, with ``chip_smoke.py``'s inputs, timers and tolerances (the
  ``chip_smoke.py`` beside this package, run on DIR's port), one JSON line
  each: K1 at N = 256, by CUDA events and each of its
  launches' device time; K5 at N = 256, with ``torch.matmul`` on the bare
  product img @ bf16(W) beside it for information; K2's forward, d_q and
  d_img at N = 64, rate 0.1; K3's d_W/d_b/d_q (four launches) and d_img at
  N = 64; K3's forward at N = 64 and 256; K4 at N = 256; K6 at N = 256 (its
  forward and its scale launch apart); K7 at its two call shapes (the question
  glimpse and the co-attention), its two launches and the wrapper's cast
  apart. Each d_img line times the call that computes d_img from g and
  out (the operand's build and the product: ``d_img_cuda``, which both
  versions of the port have), with the bare product over the operand
  beside it for information: ``torch.matmul(g_prod, bf16(W)^T)`` for K2,
  ``torch.bmm`` of bf16 g_pooled [N, L, O] against a materialised bf16
  wq^T [N, O, D] for K3 (without the wq build). Names after
  ``--kernels`` (K1, K5, K2, K3, K4, K6, K7) time only those. Each line
  says whether the kernel agreed with its plain version
  on the same inputs and whether a rerun gave the same bits, and gives
  the call's time three ways: ``events_ms``, calls enqueued back to
  back; ``device_ms``, each call's events queued behind a spin on the
  card (``chip_smoke.launch_ms``); ``device_ms_by_launch``, each launch's
  device time from the profiler (``chip_smoke.device_ms_by_kernel``).

Every line carries the card's name and power limit as nvidia-smi gives
them.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

KERNEL_ITERS = 10  # timed calls of each kernel, after one warm-up
KERNELS = {"K1", "K5", "K2", "K3", "K4", "K6", "K7"}


def main() -> None:
    package = os.path.dirname(os.path.abspath(__file__))
    here = os.path.dirname(package)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=here,
                        help="the checkout whose port is timed")
    parser.add_argument("--kernels", nargs="*", default=[],
                        metavar="NAME",
                        help="time the kernels named (K1 K5 K2 K3 K4 K6 "
                             "K7); all of them without a name")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    # the port from ``root``, and none of this file's neighbours as
    # top-level modules
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") != package]
    time_kernels(os.path.join(here, "chip_smoke.py"), root,
                 set(args.kernels) or KERNELS)


def time_kernels(harness: str, root: str, names: set) -> None:
    """K1, K5, K2's forward, d_q and d_img, K3's d_W/d_b/d_q, d_img and
    forward, K4, K6 and K7 (those in ``names``), timed and checked by
    ``harness`` (a ``chip_smoke.py``) on the port that ``sys.path`` reaches
    first."""
    unknown = names - KERNELS
    if unknown:
        raise SystemExit(f"unknown kernels {sorted(unknown)}; the names "
                         f"are {sorted(KERNELS)}")
    spec = importlib.util.spec_from_file_location("chip_smoke", harness)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    from vqa_attention_networks_tpu_torch.ops import attention as att
    from vqa_attention_networks_tpu_torch.ops import coattention as co
    from vqa_attention_networks_tpu_torch.ops import grid_fusion as gf
    from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf
    from vqa_attention_networks_tpu_torch.ops import train_fusion as tf
    from vqa_attention_networks_tpu_torch.ops import wq_fusion as wqf
    from vqa_attention_networks_tpu_torch.ops import wq_grid_fusion as wqg

    _, smi = smoke.card()  # exits when no card is visible
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, dev = smoke.Config(), torch.device("cuda", 0)

    def say(kernel, fn, got, agrees, **fields):
        fn()  # warm-up
        again = fn()
        if isinstance(got, torch.Tensor):
            got, again = (got,), (again,)
        print(json.dumps(dict(
            kernel=kernel, root=root, agrees=agrees,
            rerun_bit_equal=all(torch.equal(a, b)
                                for a, b in zip(got, again)),
            events_ms=smoke.time_ms(fn, KERNEL_ITERS),
            device_ms=smoke.launch_ms(fn, KERNEL_ITERS),
            device_ms_by_launch=smoke.device_ms_by_kernel(fn, KERNEL_ITERS),
            **fields, card=smi)), flush=True)

    n, k = smoke.BATCH, cfg.mfb_factor
    if "K1" in names:
        # K1 as chip_smoke's k1_time phase draws it
        img, q, sw = smoke.k1_inputs(n, seed=n, cfg=cfg, device=dev)
        got = wqf.stage1_coattention(img, q, sw)
        want = wqf.stage1_coattention_reference(img, q, sw)
        say("K1", lambda: wqf.stage1_coattention(img, q, sw), got,
            bool(smoke.within(got, want, img.shape[2]).all()), n=n)
        del img, q, sw, got, want
        torch.cuda.empty_cache()

    if "K5" in names:
        # K5 as chip_smoke's time phase draws it
        img, w, b, q = smoke.k5_inputs(n, 5, cfg, dev)
        got = gf.inference_fusion_cuda(img, w, b, q, k)
        want = gf.grid_fuse_reference(img, w, b, q, k)
        flat, w_bf16 = img.reshape(-1, img.shape[2]), w.to(torch.bfloat16)
        torch.matmul(flat, w_bf16)  # warm-up
        say("K5", lambda: gf.inference_fusion_cuda(img, w, b, q, k), got,
            bool(smoke.k2_within("forward", got, want).all()), n=n,
            matmul_ms=smoke.time_ms(lambda: torch.matmul(flat, w_bf16),
                                    KERNEL_ITERS))
        del img, w, b, q, got, want, flat, w_bf16
        torch.cuda.empty_cache()

    n, seed, rate = smoke.TRAIN_BATCH, 7, 0.1
    if "K2" in names:
        # K2's forward as chip_smoke's k2_time phase draws it
        img, w, b, q, _ = smoke.k2_inputs(n, 3, cfg, dev)
        w_bf16, bf, qf = tf.operands(w, b, q)
        keep = tf.keep_scale(tf.dropout_mask(seed, n, img.shape[1],
                                             w.shape[1], rate, dev), rate)
        got = tf.forward_cuda(img, w_bf16, bf, qf, seed, k, rate)
        want = tf.forward_reference(img, w_bf16, bf, qf, k, keep)
        say("K2_forward",
            lambda: tf.forward_cuda(img, w_bf16, bf, qf, seed, k, rate), got,
            bool(smoke.k2_within("forward", got, want).all()), n=n,
            rate=rate)

        # K2's d_q on the kernel's own forward output, as k2_time draws it
        g = smoke.k2_inputs(n, 3, cfg, dev)[4]
        args = (g, got, img, w_bf16, bf, qf, seed, k, rate)
        d_q = tf.d_q_cuda(*args)
        want = tf.d_q_reference(g, got, img, w_bf16, bf, k, keep)
        say("K2_d_q", lambda: tf.d_q_cuda(*args), d_q,
            bool(smoke.k2_within("d_q", d_q, want).all()), n=n, rate=rate)

        # K2's d_img on the same inputs: the g_prod build and the product
        d_img = tf.d_img_cuda(*args)
        want = tf.d_img_reference(g, got, w_bf16, qf, k, keep)
        g_prod, w_t = tf.g_prod_cuda(*args)[0], w_bf16.t()
        torch.matmul(g_prod, w_t)  # warm-up
        say("K2_d_img", lambda: tf.d_img_cuda(*args), d_img,
            bool(smoke.k2_within("d_img", d_img, want).all()), n=n,
            rate=rate, matmul_ms=smoke.time_ms(
                lambda: torch.matmul(g_prod, w_t), KERNEL_ITERS))
        del img, w, b, q, g, w_bf16, bf, qf, keep, got, want, d_q, args
        del d_img, g_prod, w_t
        torch.cuda.empty_cache()

    # K3's d_W/d_b/d_q on the kernel's own forward output, as k3_time
    # draws it, and K3's forward at N = 64 (k3_time's) and 256
    for n3 in (n, smoke.BATCH) if "K3" in names else ():
        img, w, b, q, g = smoke.k2_inputs(n3, 3, cfg, dev)
        w_bf16, bf, qb = pf.operands(w, b, q)
        out = pf.forward_cuda(img, w_bf16, bf, qb, k)
        if n3 == n:
            args = (g, out, img, w_bf16, bf, qb, k)
            got = pf.d_w_cuda(*args)
            want = pf.d_w_reference(g, out, img, w_bf16, bf, qb, k)
            say("K3_d_w", lambda: pf.d_w_cuda(*args), got,
                all(bool(smoke.k3_within(name, a, b_).all()) for name, a, b_
                    in zip(("d_w", "d_b", "d_q"), got, want)), n=n3)
            # K3's d_img on the same inputs: the g_pooled build and the
            # product
            got = pf.d_img_cuda(*args)
            want = pf.d_img_reference(g, out, w_bf16, qb, k)
            o = w.shape[1] // k
            gp = pf.g_pooled(g, out)[..., :o].to(torch.bfloat16).contiguous()
            wq_t = pf.contracted_weights(w_bf16, qb, k).to(
                torch.bfloat16).transpose(1, 2).contiguous()
            torch.bmm(gp, wq_t)  # warm-up
            say("K3_d_img", lambda: pf.d_img_cuda(*args), got,
                bool(smoke.k3_within("d_img", got, want).all()), n=n3,
                bmm_ms=smoke.time_ms(lambda: torch.bmm(gp, wq_t),
                                     KERNEL_ITERS))
            del args, got, gp, wq_t
        want = pf.forward_reference(img, w_bf16, bf, qb, k)
        say("K3_forward", lambda: pf.forward_cuda(img, w_bf16, bf, qb, k),
            out, bool(smoke.k3_within("forward", out, want).all()), n=n3)
        del img, w, b, q, g, w_bf16, bf, qb, out, want
        torch.cuda.empty_cache()

    n = smoke.BATCH
    if "K4" in names:
        # K4 as chip_smoke's time phase draws it, at N = 256
        a4 = smoke.k4_inputs(n, 4, dev)
        got = co.coattention_core_cuda(*a4)
        want = co.coattention_core_reference(*a4)
        names4 = ("v", "q", "av", "aq")
        within = [smoke.k4_within(name, a, b_)
                  for name, a, b_ in zip(names4, got, want)]
        say("K4", lambda: co.coattention_core_cuda(*a4), got,
            all(bool(x.all()) for x in within), n=n,
            outside_tolerance=dict(zip(names4, (int((~x).sum())
                                                for x in within))),
            max_abs_diff=dict(zip(names4, (float((a - b_).abs().max())
                                           for a, b_ in zip(got, want)))))
        del a4, got, want
        torch.cuda.empty_cache()

    if "K6" in names:
        # K6 as chip_smoke's k6_time phase draws it, at N = 256
        img, w, b, q = smoke.k6_inputs(n, 6, cfg, dev)
        got = wqg.wq_grid_fuse_cuda(img, w, b, q, k)
        want = wqg.wq_grid_fuse_reference(img, w, b, q, k)
        say("K6", lambda: wqg.wq_grid_fuse_cuda(img, w, b, q, k), got,
            bool(smoke.k6_within(got, want).all()), n=n)
        del img, w, b, q, got, want
        torch.cuda.empty_cache()

    # K7 at both call shapes as chip_smoke's time phase draws them
    for shape_name, shape in smoke.K7_SHAPES.items() if "K7" in names \
            else ():
        a7 = smoke.k7_inputs(shape, 7, dev)
        got = att.glimpse_attention_cuda(*a7, uniform_quirk=False)
        want = att.glimpse_attention_reference(*a7, uniform_quirk=False)
        say(f"K7_{shape_name}",
            lambda: att.glimpse_attention_cuda(*a7, uniform_quirk=False),
            got, bool(smoke.k7_within(got, want).all()), n=shape[0],
            shape=dict(zip("npcad", shape)))
        del a7, got, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
