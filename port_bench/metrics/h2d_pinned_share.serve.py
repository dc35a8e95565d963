"""The share of the serving copies' bytes that the engine copied to the card
without a wait from page-locked memory, %: the port's counter
``serve.h2d_pinned_bytes`` (``InferenceEngine._to_device``;
``utils/trace.py``) over ``serve.h2d_bytes``, both over the profiled
stretch. None where the port keeps no such counter (a port from before
it) or copied nothing."""


def read(run):
    try:
        from vqa_attention_networks_tpu_torch.utils.trace import counters
    except ImportError:  # a port without counters
        return None
    found = counters()
    pinned = found.get("serve.h2d_pinned_bytes")
    moved = found.get("serve.h2d_bytes", 0)
    if pinned is None or not moved:
        return None
    return 100.0 * pinned / moved
