"""The host feed's gather (``FeatureStore.gather`` of a batch's float16
grids), ms a batch: the median of the harness's span around it over the
window."""

import statistics


def read(run):
    spans = run.spans.get("gather")
    return statistics.median(spans) * 1e3 if spans else None
