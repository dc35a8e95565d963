"""The card tools' shared definitions, on the CPU.

``ops/card_cases.py`` holds each hand-written kernel's inputs and its
tolerance against its plain version, for ``chip_smoke.py`` (the gates),
``step_time.py`` (the timer), ``k4_precision.py`` and the card tests.
Here, for each kernel (K1, K2's forward, d_img, d_W/d_b and d_q, K3, K4,
K5, K6, K7, K8, N1, N2, N3), the inputs are drawn at a small shape on the CPU
and the plain version run on them: the tolerance predicate accepts that
output against itself and rejects it with one element moved past the
tolerance. And the two tools that time or hold kernels on the card exit
non-zero where there is none, and ``step_time.KERNELS`` names every
kernel.

This file imports neither JAX nor the JAX package.
"""

import os
import subprocess
import sys

import pytest
import torch

from vqa_attention_networks_tpu_torch.ops import attention as att
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
# the small widths: grid L x D, fusion F = K * O
L, D, O, K = 6, 32, 8, 5


def _k1():
    img, q, sw = cc.k1_inputs(2, 0, CPU, l=L, d=D, f=O * K, k=K, c=16)
    want = wqf.stage1_coattention_reference(img, q, sw)
    return want, lambda got: cc.within(got, want, D)


def _k2(name):
    def case():
        img, w, b, q, g = cc.k2_inputs(2, 0, CPU, l=L, d=D, o=O, k=K,
                                       zeros=1)
        w_bf16, bf, qf = tf.operands(w, b, q)
        keep = tf.keep_scale(tf.dropout_mask(3, 2, L, O * K, 0.1, CPU), 0.1)
        out = tf.forward_reference(img, w_bf16, bf, qf, K, keep)
        d_w, d_b = tf.d_w_reference(g, out, img, qf, K, keep)
        want = {"forward": out, "d_w": d_w, "d_b": d_b,
                "d_img": tf.d_img_reference(g, out, w_bf16, qf, K, keep),
                "d_q": tf.d_q_reference(g, out, img, w_bf16, bf, K,
                                        keep)}[name]
        return want, lambda got: cc.k2_within(name, got, want)
    return case


def _k3(name):
    def case():
        img, w, b, q, g = cc.k2_inputs(2, 1, CPU, l=L, d=D, o=O, k=K)
        w_bf16, bf, qb = pf.operands(w, b, q)
        out = pf.forward_reference(img, w_bf16, bf, qb, K)
        d_w = pf.d_w_reference(g, out, img, w_bf16, bf, qb, K)[0]
        want = {"forward": out, "d_w": d_w,
                "d_img": pf.d_img_reference(g, out, w_bf16, qb, K)}[name]
        return want, lambda got: cc.k3_within(name, got, want)
    return case


def _k4(name):
    def case():
        args = cc.k4_inputs(2, 0, CPU, l=L, t=4, e=16)
        want = dict(zip(("v", "q", "av", "aq"),
                        co.coattention_core_reference(*args)))[name]
        return want, lambda got: cc.k4_within(name, got, want)
    return case


def _k5():
    img, w, b, q = cc.k5_inputs(2, 0, CPU, l=L, d=D, f=O * K)
    want = gf.grid_fuse_reference(img, w, b, q, K)
    return want, lambda got: cc.k2_within("forward", got, want)


def _k6():
    img, w, b, q = cc.k6_inputs(2, 0, CPU, l=L, d=D, o=O, k=K)
    want = wqg.wq_grid_fuse_reference(img, w, b, q, K)
    return want, lambda got: cc.k6_within(got, want)


def _k7():
    args = cc.k7_inputs((2, 5, 16, 12, 24), 0, CPU)
    want = att.glimpse_attention_reference(*args, uniform_quirk=False)
    return want, lambda got: cc.k7_within(got, want)


def _k8():
    xp, w_hh, bias = cc.k8_scan_inputs(*cc.k8_inputs(2, 0, CPU, t=3, e=8,
                                                     h=16))
    want = k8.lstm_scan_reference(xp + bias, w_hh)
    # each step against the plain steps fed the output's own carry
    return want, lambda got: cc.k8_within(got, k8.lstm_scan_reference(
        xp + bias, w_hh, h_carry=got))


def _n1():
    x, r, w, b = cc.n1_inputs(4, 16, 0, CPU)
    want = mcan_norm.add_layernorm_composed(x, r, w, b)
    return want, lambda got: cc.n1_within(got, want)


def _n2():
    q, k, v, mask = cc.n2_inputs(2, 2, 5, 7, 0, CPU)
    f32 = mha.attention_composed(q.float(), k.float(), v.float(), mask, 2)
    want = mha.attention_composed(q, k, v, mask, 2)
    return want, lambda got: cc.n2_within(got, f32, want)


def _n3():
    av, aq, h, hb, mask = cc.n3_inputs(2, 0, CPU, l=7, t=3, g=2, k=64)
    exact = cc.n3_exact(av, aq, h, hb, mask)
    return exact.to(torch.bfloat16), lambda got: cc.n3_within(got, exact)


CASES = {"K1": _k1, "K2_forward": _k2("forward"), "K2_d_img": _k2("d_img"),
         "K2_d_w": _k2("d_w"), "K2_d_b": _k2("d_b"), "K2_d_q": _k2("d_q"),
         "K3_forward": _k3("forward"), "K3_d_img": _k3("d_img"),
         "K3_d_w": _k3("d_w"), "K4_v": _k4("v"), "K4_av": _k4("av"),
         "K5": _k5, "K6": _k6, "K7": _k7, "K8": _k8, "N1": _n1, "N2": _n2,
         "N3": _n3}


def _moved(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its largest element moved by a quarter of its magnitude
    plus 0.01, past every tolerance of ``card_cases``."""
    y = x.float().clone().reshape(-1)
    i = int(y.abs().argmax())
    y[i] += 0.25 * y[i].abs() + 0.01
    return y.reshape(x.shape).to(x.dtype)


@pytest.mark.parametrize("kernel", list(CASES))
def test_a_tolerance_takes_the_plain_version_and_not_a_moved_one(kernel):
    want, within = CASES[kernel]()
    assert torch.isfinite(want.float()).all() and want.abs().max() > 0
    assert bool(torch.as_tensor(within(want)).all())
    assert not bool(torch.as_tensor(within(_moved(want))).all())


@pytest.mark.parametrize("script", ["step_time.py", "k4_precision.py"])
def test_the_card_tools_refuse_to_run_without_a_card(script):
    """Exit non-zero and print no line of results where no card is
    visible (here)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the tool would run for real")
    proc = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, "vqa_attention_networks_tpu_torch", script)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_step_time_times_every_kernel():
    """K1 to K8, N1 to N3, and K2's four launches and K8's entry apart."""
    from vqa_attention_networks_tpu_torch import step_time

    assert set(step_time.KERNELS) == {"K1", "K2", "K3", "K4", "K5", "K6",
                                      "K7", "K8", "N1", "N2", "N3"}
    assert step_time.KERNELS["K2"] == ("K2_forward", "K2_d_q", "K2_d_img",
                                       "K2_d_w")
    assert "K8_lstm_seq" in step_time.KERNELS["K8"]
    lines = [line for lines in step_time.KERNELS.values() for line in lines]
    assert len(lines) == len(set(lines)) == 22
