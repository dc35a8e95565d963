"""The training loop's wait for its next batch, ms: the median over the
steps of the profiled stretch of the port's span ``train.feed_wait``
(``Solver._epoch``'s wait on the prefetch stream; ``utils/trace.py``).
None where the port records no such span."""

import statistics


def read(run):
    try:
        from vqa_attention_networks_tpu_torch.utils.trace import spans
    except ImportError:  # a port without spans
        return None
    per = {}
    for s in spans():
        if s.name == "train.feed_wait":
            per[s.batch] = per.get(s.batch, 0) + s.end_ns - s.start_ns
    return statistics.median(per.values()) / 1e6 if per else None
