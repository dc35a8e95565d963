"""BAN's attention map, N3 (``ops/ban_attention.py`` ->
``csrc/ban_attention.cu``), against its roofline, in %: the bound of one
forward's call at the batch (``counts/<config>.py`` ``attention``,
``harness.bound_s``: bytes at the memory's rate, 424 MB at N = 256 for
BAN-8, or its products at the bf16 peak) over the kernel's device time a
forward. Forwards are counted by the kernel's own launches, one a forward.
None where the kernel did not run (the composed map, or a port without
the kernel)."""

from port_bench.harness import bound_s, kernel_time

KERNELS = (r"ban_attention_kernel",)


def read(run):
    if run.profile is None:
        return None
    seconds, launches = kernel_time(run.profile, KERNELS)
    if launches[0] == 0 or seconds <= 0:
        return None
    bound = bound_s(run.counts.attention(run.cell.config["fields"],
                                         run.work["batch"]), run.peaks)
    return bound / (seconds / launches[0]) * 100.0
