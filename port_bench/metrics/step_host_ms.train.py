"""The host's time to put a training step on the device, ms: the median over
the steps of the profiled stretch of the port's span ``train.step``
(``Solver._train_step``, whole call: the batch's copies, the forward's,
backward's and optimizer's launches, and any wait for the device inside
them; ``utils/trace.py``, which records while the profiler runs, so the
time holds the profiler's cost on each launch). None where the port
records no such span."""

import statistics


def read(run):
    try:
        from vqa_attention_networks_tpu_torch.utils.trace import spans
    except ImportError:  # a port without spans
        return None
    per = {}
    for s in spans():
        if s.name == "train.step":
            per[s.batch] = per.get(s.batch, 0) + s.end_ns - s.start_ns
    return statistics.median(per.values()) / 1e6 if per else None
