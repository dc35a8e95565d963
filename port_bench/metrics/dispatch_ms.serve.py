"""The engine's dispatch of a batch, ms: the median over the batches of the
profiled stretch of the port's span ``serve.dispatch``
(``InferenceEngine._dispatch`` / ``_dispatch_by_id``, whole call: the
padding, the copies to the card, the bank's slots and the forward's
launches; ``utils/trace.py``, which records while the profiler runs, so
the time holds the profiler's cost on each launch). None where the port
records no such span."""

import statistics


def read(run):
    try:
        from vqa_attention_networks_tpu_torch.utils.trace import spans
    except ImportError:  # a port without spans
        return None
    per = {}
    for s in spans():
        if s.name == "serve.dispatch":
            per[s.batch] = per.get(s.batch, 0) + s.end_ns - s.start_ns
    return statistics.median(per.values()) / 1e6 if per else None
