"""BAN's matrix products against their roofline, in %: the bf16 bound of
one forward's GEMM operations at the batch (``counts/<config>.py``
``gemm``: every product but the attention map and the pools' element-wise
products, at the card's bf16 peak) over the device time a forward of the
GEMM kernels, named as ``mcan_gemm_roofline`` names them, less N3
(``ban_attention``). Forwards are counted by N3's launches, one a forward.
None where either is missing (the composed map, or a port without N3)."""

import re

from port_bench.harness import bound_s, kernel_time
from port_bench.metrics.mcan_gemm_roofline import GEMMS, NOT_GEMMS

N3 = (r"ban_attention_kernel",)


def gemm_seconds(profile) -> float:
    keep = [re.compile(p) for p in GEMMS]
    drop = [re.compile(p) for p in NOT_GEMMS + (r"ban_attention",)]
    return sum(sec for name, (sec, _) in profile["ops"].items()
               if any(k.search(name) for k in keep)
               and not any(d.search(name) for d in drop))


def read(run):
    if run.profile is None:
        return None
    _, launches = kernel_time(run.profile, N3)
    seconds = gemm_seconds(run.profile)
    if launches[0] == 0 or seconds <= 0:
        return None
    s = run.cell.config["fields"]
    return bound_s(run.counts.gemm(s, run.work["batch"]),
                   run.peaks) / (seconds / launches[0]) * 100.0
