"""MCAN's attention kernel (``ops/mcan_attention.py`` ->
``csrc/mcan_attention.cu``) against its roofline, in %: the bound of one
forward's attention calls at the batch (``harness.bound_s`` of ``bound``:
bytes at the memory's rate, or the two products at the bf16 peak) over the
kernel's device time a forward. The forwards in the profiled stretch are
counted by the fused norm's launches (``norm_launches`` a forward), as the
other MCAN metrics count them. None where the kernel did not run (the
composed attention, or a port without the kernel)."""

from typing import Dict

from port_bench.harness import bound_s, kernel_time

KERNELS = (r"mcan_attention_kernel",)
NORM = (r"add_layernorm_kernel",)


def bound(s: Dict, n: int) -> Dict[str, float]:
    """One forward's attention calls for ``n`` questions at a
    configuration's sizes ``s``: ``att_num`` each of the words' self-
    attention (T x T), the grid's (L x L) and the grid's guided by the words
    (L x T), heads side by side in d. Bytes: q, k and v read and the output
    written once (bf16), the key mask (one byte a key); bf16 operations:
    the two products, 2 x 2 x Lq x Lk x d a question."""
    t, l = s["max_question_length"], s["img_feature_dim"]
    d, layers = s["hidden_dim"], s["att_num"]
    calls = [(t, t), (l, l), (l, t)]  # (Lq, Lk)
    moved = sum(2 * n * d * (2 * lq + 2 * lk) + n * lk for lq, lk in calls)
    ops = sum(4 * n * lq * lk * d for lq, lk in calls)
    return {"bytes": float(layers * moved), "bf16": float(layers * ops)}


def read(run):
    if run.profile is None:
        return None
    seconds, launches = kernel_time(run.profile, KERNELS)
    _, norms = kernel_time(run.profile, NORM)
    if launches[0] == 0 or norms[0] == 0 or seconds <= 0:
        return None
    s = run.cell.config["fields"]
    forwards = norms[0] / run.counts.norm_launches(s)
    return bound_s(bound(s, run.work["batch"]),
                   run.peaks) / (seconds / forwards) * 100.0
