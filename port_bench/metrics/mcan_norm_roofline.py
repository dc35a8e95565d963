"""MCAN's fused residual + LayerNorm kernel (``ops/mcan_norm.py`` ->
``csrc/mcan_layernorm.cu``) against its roofline, in %: the bound of one
forward's launches at the batch (``counts/<config>.py`` ``norm``, bytes at
the memory's rate, ``harness.bound_s``) over the kernel's device time a
forward (its time in the profiled stretch over its launches, times the
launches a forward, ``norm_launches``). None where the kernel did not run
(the composed norm, or a port without it)."""

from port_bench.harness import bound_s, kernel_time

KERNELS = (r"add_layernorm_kernel",)


def read(run):
    if run.profile is None:
        return None
    seconds, launches = kernel_time(run.profile, KERNELS)
    if launches[0] == 0 or seconds <= 0:
        return None
    s = run.cell.config["fields"]
    per_forward = seconds / launches[0] * run.counts.norm_launches(s)
    return bound_s(run.counts.norm(s, run.work["batch"]),
                   run.peaks) / per_forward * 100.0
