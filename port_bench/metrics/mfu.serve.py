"""The serving forward's share of the card's bf16 peak, in %: the
configuration's forward operations a question (``counts/<config>.py``
``serve_flops``) times the questions answered, over the seconds and the
peak (``peaks.json``): the window before its profiled stretch, which the
profiler has not touched (``Run.unprofiled``)."""


def read(run):
    u = run.unprofiled
    if run.device.type != "cuda" or not u:
        return None
    flops = run.counts.serve_flops(run.cell.config["fields"])
    rate = u["questions"] / u["seconds"]
    return flops * rate / run.peaks["bf16_flops_per_s"] * 100.0
