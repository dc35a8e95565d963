"""Hold K4 and its plain version against an f64 version on the card.

    python3 vqa_attention_networks_tpu_torch/k4_precision.py [--root DIR] [--seeds S ...]

imports the port from DIR (by default the checkout that holds this file),
as ``step_time.py`` does, so that two checkouts' K4 can be held against
the same reference in one call. For each seed it draws ``chip_smoke.py``'s
K4 inputs at N = 256 (``k4_inputs(256, seed)``, the checkout's own
``chip_smoke.py``) and runs DIR's kernel, the plain f32 version
(``coattention_core_reference``) and an f64 version with the same bf16
rounding points: C, Hv and Hq rounded to bf16 (through f32, as the f32
versions round) after a tanh of an f64 sum, the logits, softmaxes and
pools in f64. One JSON line a seed: for the kernel and the plain version,
per output (v, q, av, aq), the largest and the mean |error| against the
f64 version and the elements outside ``chip_smoke.py``'s K4 tolerance
(``k4_within``) against it, and the elements outside that tolerance of
the kernel against the plain version (what ``chip_smoke.py`` holds). The
card's name and power limit are on every line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

BATCH = 256
NAMES = ("v", "q", "av", "aq")
CHUNK = 64  # samples per step of the f64 version (memory)


def f64_version(img, que, cv, cq, img_w, que_w, whv, whq) -> tuple:
    """(v, q, av, aq) in f64, with K4's bf16 rounding points."""
    import torch

    f64, bf = torch.float64, torch.bfloat16

    def rnd(x):  # f64 -> f32 -> bf16 -> f64
        return x.float().to(bf).to(f64)

    wv, wq = whv.reshape(-1).to(f64), whq.reshape(-1).to(f64)
    outs = []
    for s in range(0, img.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        cv_, cq_, iw, qw = (x[sl].to(f64) for x in (cv, cq, img_w, que_w))
        c = rnd(torch.tanh(cq_ @ cv_.transpose(1, 2)))
        hv = rnd(torch.tanh(iw + c.transpose(1, 2) @ qw))
        hq = rnd(torch.tanh(qw + c @ iw))
        av = torch.softmax(hv @ wv, dim=1)
        aq = torch.softmax(hq @ wq, dim=1)
        v = torch.einsum("nl,nle->ne", av, img[sl].to(f64))
        q = torch.einsum("nt,nte->ne", aq, que[sl].to(f64))
        outs.append((v, q, av, aq))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def main() -> None:
    package = os.path.dirname(os.path.abspath(__file__))
    here = os.path.dirname(package)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=here,
                        help="the checkout whose kernel is held")
    parser.add_argument("--seeds", type=int, nargs="+",
                        default=[4, 5, 6, 7, 296])
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") != package]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    from vqa_attention_networks_tpu_torch.ops import coattention as co

    _, smi = smoke.card()  # exits when no card is visible
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        a4 = smoke.k4_inputs(BATCH, seed, dev)
        ref = f64_version(*a4)
        plain = co.coattention_core_reference(*a4)
        kernel = co.coattention_core_cuda(*a4)
        torch.cuda.synchronize()
        line = {"root": root, "seed": seed, "n": BATCH, **smoke.K4_SHAPE}
        for label, got in (("kernel", kernel), ("plain", plain)):
            line[label] = {
                name: {"max_abs_err": float((g.double() - r).abs().max()),
                       "mean_abs_err": float((g.double() - r).abs().mean()),
                       "outside_tolerance": int(
                           (~smoke.k4_within(name, g.double(), r)).sum())}
                for name, g, r in zip(NAMES, got, ref)}
        line["kernel_vs_plain_outside_tolerance"] = {
            name: int((~smoke.k4_within(name, g, p)).sum())
            for name, g, p in zip(NAMES, kernel, plain)}
        line["card"] = smi
        print(json.dumps(line), flush=True)
        del a4, ref, plain, kernel
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
