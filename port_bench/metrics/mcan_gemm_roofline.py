"""MCAN's matrix products against their roofline, in %: the bf16 bound of
one forward's GEMM operations at the batch (``counts/<config>.py``
``gemm``, at the card's bf16 peak) over the device time a forward of the
GEMM kernels, cuBLAS's (``GEMMS``; attention's two products are cuBLAS
batched GEMMs too, counted in ``gemm``), less the fused attention kernels
and the port's own K1/K2 (``NOT_GEMMS``). The forwards in the profiled
stretch are counted by the fused norm's launches (``norm_launches`` a
forward). None where either is missing."""

import re

from port_bench.harness import bound_s, kernel_time

GEMMS = (r"gemm", r"nvjet", r"gemv", r"splitKreduce")
NOT_GEMMS = (r"fmha", r"flash", r"efficient", r"_gemm_kernel", r"stage1_")
NORM = (r"add_layernorm_kernel",)


def gemm_seconds(profile) -> float:
    keep = [re.compile(p) for p in GEMMS]
    drop = [re.compile(p) for p in NOT_GEMMS]
    return sum(sec for name, (sec, _) in profile["ops"].items()
               if any(k.search(name) for k in keep)
               and not any(d.search(name) for d in drop))


def read(run):
    if run.profile is None:
        return None
    _, launches = kernel_time(run.profile, NORM)
    seconds = gemm_seconds(run.profile)
    if launches[0] == 0 or seconds <= 0:
        return None
    s = run.cell.config["fields"]
    forwards = launches[0] / run.counts.norm_launches(s)
    return bound_s(run.counts.gemm(s, run.work["batch"]),
                   run.peaks) / (seconds / forwards) * 100.0
