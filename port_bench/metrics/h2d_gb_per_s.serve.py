"""The serving copies' rate to the card, GB/s: the bytes the engine copied
in the profiled stretch (the port's counter ``serve.h2d_bytes``,
``InferenceEngine._to_device``: features, questions, lengths, the bank's
slot indices; ``utils/trace.py``) over the device time of the stretch's
host-to-device copies (``Memcpy HtoD`` operations). None without a device
trace (the CPU) or where the port keeps no such counter."""


def read(run):
    if run.profile is None:
        return None
    try:
        from vqa_attention_networks_tpu_torch.utils.trace import counters
    except ImportError:  # a port without counters
        return None
    moved = counters().get("serve.h2d_bytes", 0)
    seconds = sum(sec for name, (sec, _) in run.profile["ops"].items()
                  if name.startswith("Memcpy HtoD"))
    return moved / seconds / 1e9 if moved and seconds > 0 else None
