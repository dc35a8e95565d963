"""The 95th percentile of the questions' latency, in ms, as
``serve_p95_ms`` takes it (from the hand-over of a batch to the engine to
its answers), over the batches of the window before its profiled stretch
(``Run.unprofiled``): the tail beside the host feed's rate, where a rate
bought by holding more batches in flight shows."""


def read(run):
    return run.unprofiled.get("serve_p95_ms")
