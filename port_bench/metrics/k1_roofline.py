"""K1 (``ops/wq_fusion.py`` -> ``csrc/stage1_coattention.cu``) against its
roofline, in %: the bound of K1's function at the batch
(``counts/<config>.py`` ``k1``, ``harness.bound_s``) over the device time
a call of the kernels that implement it (their time in the profiled
stretch over the launches of the first)."""

from port_bench.harness import bound_s, kernel_time

KERNELS = (r"stage1_grid_kernel", r"stage1_hidden_kernel",
           r"stage1_pool_kernel")


def read(run):
    if run.profile is None:
        return None
    seconds, launches = kernel_time(run.profile, KERNELS)
    if launches[0] == 0 or seconds <= 0:
        return None
    bound = bound_s(run.counts.k1(run.cell.config["fields"],
                                  run.work["batch"]), run.peaks)
    return bound / (seconds / launches[0]) * 100.0
