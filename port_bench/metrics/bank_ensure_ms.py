"""The device feature bank's slot lookup for a batch, ms: the median over
the batches of the profiled stretch of the port's span ``bank.ensure``
(``DeviceFeatureCache.ensure``: the per-id bookkeeping and any miss's
upload; ``utils/trace.py``). None where the port records no such span."""

import statistics


def read(run):
    try:
        from vqa_attention_networks_tpu_torch.utils.trace import spans
    except ImportError:  # a port without spans
        return None
    per = {}
    for s in spans():
        if s.name == "bank.ensure":
            per[s.batch] = per.get(s.batch, 0) + s.end_ns - s.start_ns
    return statistics.median(per.values()) / 1e6 if per else None
