"""The host's wait for a batch's results, ms: the median over the batches
of the profiled stretch of the port's span ``serve.result_wait`` (the
copies of the top-k to the host in ``InferenceEngine._collect``, which wait
for the device; ``utils/trace.py``). Near 0: the host sets the pace. None
where the port records no such span."""

import statistics


def read(run):
    try:
        from vqa_attention_networks_tpu_torch.utils.trace import spans
    except ImportError:  # a port without spans
        return None
    per = {}
    for s in spans():
        if s.name == "serve.result_wait":
            per[s.batch] = per.get(s.batch, 0) + s.end_ns - s.start_ns
    return statistics.median(per.values()) / 1e6 if per else None
