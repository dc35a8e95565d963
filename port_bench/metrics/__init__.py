"""One reader a per-layer metric of ``BENCHMARK.json``
(``metrics/<metric>.py``): ``read(run)`` returns the metric from the run's
spans, counters or profiled stretch, or None where it finds nothing to
read (then the metric is left out of the line)."""
