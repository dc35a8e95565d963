"""The training step's share of the card's bf16 peak, in %: a row's
operations (``counts/<config>.py`` ``train_flops``: the forward and the
backward the step needs, no gradient of the features) times the rows
trained, over the seconds, the peak and the cards: the window before its
profiled stretch, which the profiler has not touched (``Run.unprofiled``)."""


def read(run):
    u = run.unprofiled
    if run.device.type != "cuda" or not u:
        return None
    flops = run.counts.train_flops(run.cell.config["fields"])
    rate = u["rows"] / u["seconds"]
    return (flops * rate / run.peaks["bf16_flops_per_s"]
            / run.cell.chips * 100.0)
