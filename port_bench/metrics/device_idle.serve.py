"""The device's idle share: the share of the profiled stretch of the
window in which no kernel ran on rank 0's card, in %. Copies and sets
do not count as busy here (``device.busy_s`` counts them)."""


def read(run):
    p = run.profile
    if p is None or p["kernel_busy_s"] <= 0 or p["window_s"] <= 0:
        return None
    return (1.0 - p["kernel_busy_s"] / p["window_s"]) * 100.0
