"""The share of the profiled stretch's batches that the engine replayed from
its CUDA graph, %: the port's counter ``serve.graph_replays``
(``InferenceEngine._replay_by_id``; ``utils/trace.py``) over the batches of
the stretch's ``serve.dispatch`` spans. None where the port keeps no such
counter (an eager engine, or a port without the graph)."""


def read(run):
    try:
        from vqa_attention_networks_tpu_torch.utils.trace import (
            counters,
            spans,
        )
    except ImportError:  # a port without spans
        return None
    replays = counters().get("serve.graph_replays")
    batches = {s.batch for s in spans() if s.name == "serve.dispatch"}
    if replays is None or not batches:
        return None
    return 100.0 * replays / len(batches)
