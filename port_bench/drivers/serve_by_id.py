"""Serving by image id from the device feature bank.

Set-up fills an int8 ``DeviceFeatureCache`` of ``capacity`` slots with every
image once (``ensure``, in chunks of ``fill_chunk``), so the window's
questions, drawn uniformly over the images, all hit. The window drives
``InferenceEngine.predict_stream_by_id`` at the traffic's batch, one batch
in flight. Traffic parameters beyond ``traffic.py``'s: ``capacity``,
``pool`` (distinct int8 grids, each image its own scale), ``fill_chunk``,
``warm_batches``.
"""

from __future__ import annotations

from port_bench import inputs, serving
from port_bench.harness import Context, Run, Window


def run(ctx: Context) -> Run:
    tr = ctx.cell.traffic
    cfg, params, engine = serving.setup_engine(ctx, "int8")
    regions, channels = cfg.img_feature_dim, cfg.img_feature_channel
    bank = inputs.Int8Bank(tr["images"], regions, channels, tr["pool"],
                           ctx.seed, ctx.device)
    cache = engine.attach_feature_cache(tr["capacity"], bank.fetch)
    for start in range(0, tr["images"], tr["fill_chunk"]):
        cache.ensure(range(start, min(start + tr["fill_chunk"],
                                      tr["images"])), bank.fetch)
    q = serving.traffic_of(ctx, cfg)
    batch = tr["batch"]
    nb = len(q["ques_length"]) // batch

    def item(i):
        s = (i % nb) * batch
        return (q["image_ids"][s:s + batch], q["questions"][s:s + batch],
                q["ques_length"][s:s + batch])

    spans = {}
    window = Window(ctx.seconds, ctx.device, ctx.trace)
    warm = tr["warm_batches"]
    stream = engine.predict_stream_by_id
    for _ in stream(item(i) for i in range(warm)):
        pass
    cache.reset_stats()
    loop = serving.closed_loop(stream, item, window, spans, ctx.trace)
    counters = {"bank_hits": cache.hits, "bank_misses": cache.misses,
                "bank_evictions": cache.evictions}
    del engine, cache, stream
    return serving.finish(
        ctx, cfg, window, loop, q, params,
        lambda rows: bank.features(q["image_ids"][rows], ctx.device),
        spans, counters)
