"""Serving from the per-request host feed.

Each batch's float16 grids are gathered from a store on the host
(``FeatureStore.gather``, inside the window, under the span ``gather``) and
handed with the questions to ``InferenceEngine.predict_stream``, which pads
them, copies them to the card and runs the forward, one batch in flight.
The store holds ``images`` grids (``inputs.f16_store``). Traffic
parameters beyond ``traffic.py``'s: ``warm_batches``.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import inputs, serving
from port_bench.harness import Context, Run, Window, span


def run(ctx: Context) -> Run:
    from vqa_attention_networks_tpu_torch.data.feature_store import (
        FeatureStore,
    )

    tr = ctx.cell.traffic
    cfg, params, engine = serving.setup_engine(ctx, "float16")
    path = inputs.f16_store(tr["images"], cfg.img_feature_dim,
                            cfg.img_feature_channel, ctx.device)
    store = FeatureStore(str(path))
    q = serving.traffic_of(ctx, cfg)
    batch = tr["batch"]
    nb = len(q["ques_length"]) // batch
    spans = {}

    def item(i):
        s = (i % nb) * batch
        with span(spans, "gather", ctx.trace):
            feats = store.gather(q["image_ids"][s:s + batch],
                                 dtype=np.float16)
        return (feats, q["questions"][s:s + batch],
                q["ques_length"][s:s + batch])

    window = Window(ctx.seconds, ctx.device, ctx.trace)
    stream = engine.predict_stream
    for _ in stream(item(i) for i in range(tr["warm_batches"])):
        pass
    spans.clear()
    loop = serving.closed_loop(stream, item, window, spans, ctx.trace)
    del engine, stream
    rows = inputs.store_rows(path)
    return serving.finish(
        ctx, cfg, window, loop, q, params,
        lambda sel: torch.from_numpy(np.asarray(
            rows[q["image_ids"][sel]], dtype=np.float32)).to(ctx.device),
        spans, {})
