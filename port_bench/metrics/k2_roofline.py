"""K2 (``ops/train_fusion.py`` -> ``csrc/train_fusion.cu``) against its
roofline, in %: the sum of the bounds of its four launches a step at the
rank's rows (``counts/<config>.py`` ``k2``: forward, g_prod build, d_W's
product, d_q) over their device time a step in the profiled stretch (a
step launches each once)."""

from port_bench.harness import bound_s, kernel_time

KERNELS = (r"fwd_kernel<\d+, ?true>", r"g_prod_kernel", r"d_w_gemm_kernel",
           r"d_q_kernel")


def read(run):
    if run.profile is None:
        return None
    seconds, launches = kernel_time(run.profile, KERNELS)
    steps = launches[-1]
    if steps == 0 or seconds <= 0:
        return None
    rows = run.work["batch"] // run.cell.chips
    bound = sum(bound_s(op, run.peaks) for op in
                run.counts.k2(run.cell.config["fields"], rows).values())
    return bound / (seconds / steps) * 100.0
