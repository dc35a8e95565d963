"""What the two serving drivers share: the engine and its weights, the closed
loop with one batch in flight, and the check of a sample of the answers.

A question's latency runs from when its batch is handed to the engine's
stream entry (the engine pulls it from the harness's iterator, which for
the host feed then gathers its features) until its ``Prediction`` comes
back; every question of a batch has its batch's latency. On a traced run
``unprofiled`` takes the rate and the tail again over the batches returned
before the profiled stretch, for the per-layer readers.
"""

from __future__ import annotations

import gc
import importlib
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from port_bench import check, faults, inputs, traffic
from port_bench.harness import (PROCESS_START, Cell, Context, Run, Window,
                                percentile, port_config, span)

TOPK = 5
SAMPLE = 2048  # questions the reference answers again after the window
SAMPLE_LONGEST = 256  # of them, questions of the longest length served
REF_BLOCK = 64


def reference_module(cell: Cell):
    return importlib.import_module(
        f"port_bench.reference.{cell.config['reference']}")


def setup_engine(ctx: Context, input_dtype: str):
    """(cfg, host weight tree, engine): weights drawn on the card from the
    seed and handed to the engine as its JAX-layout tree."""
    from vqa_attention_networks_tpu_torch.serve import InferenceEngine

    cell = ctx.cell
    cfg = port_config(cell)
    ref = reference_module(cell)
    flat = inputs.weights(ref.param_shapes(cell.config["fields"]), ctx.seed,
                          ctx.device)
    params = inputs.tree(flat)
    del flat
    reset_peak(ctx.device)
    engine = InferenceEngine(cfg, params, batch_size=cell.traffic["batch"],
                             topk=TOPK, input_dtype=input_dtype,
                             device=ctx.device)
    if ctx.fault:
        faults.plant(ctx.fault, engine=engine)
    return cfg, params, engine


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def traffic_of(ctx: Context, cfg) -> Dict[str, np.ndarray]:
    return traffic.questions(ctx.cell.traffic, cfg.q_vocab_size,
                             cfg.max_question_length, ctx.seed)


def closed_loop(stream: Callable, item: Callable[[int], tuple],
                window: Window, spans: Dict[str, List[float]],
                trace: bool) -> Dict[str, Any]:
    """Serve through ``stream`` (the engine's stream entry) batch ``item(i)``
    for i = 0, 1, ... with one batch in flight, from the window's opening
    until it is due. -> the served predictions and each batch's hand-over
    and return times."""
    hand: List[float] = []
    done: List[float] = []
    served: List[list] = []
    window.open()

    def feed():
        i = 0
        while not window.due():
            hand.append(time.perf_counter())
            yield item(i)
            i += 1

    out = stream(feed())
    while True:
        with span(spans, "engine", trace):
            preds = next(out, None)
        if preds is None:
            break
        done.append(time.perf_counter())
        served.append(preds)
    window.close()
    return {"hand": hand, "done": done, "served": served}


def serve_metrics(loop: Dict[str, Any], window: Window) -> Dict[str, float]:
    answered = sum(len(p) for p in loop["served"])
    lat = [(d - h) * 1e3 for h, d, p in zip(loop["hand"], loop["done"],
                                           loop["served"])
           for _ in range(len(p))]
    return {"serve_qa_pairs_per_s": answered / window.elapsed,
            "serve_p95_ms": percentile(lat, 95)}


def unprofiled(loop: Dict[str, Any], window: Window) -> Dict[str, float]:
    """The questions answered, and their latencies' 95th percentile, of the
    batches returned before the profiled stretch, over the window's seconds
    before it (empty on an untraced run)."""
    if window.p0 is None:
        return {}
    lat = [(d - h) * 1e3 for h, d, p in zip(loop["hand"], loop["done"],
                                           loop["served"])
           if window.before(d) for _ in range(len(p))]
    return {"seconds": window.unprofiled_s, "questions": len(lat),
            "serve_p95_ms": percentile(lat, 95)} if lat else {}


def sample(loop: Dict[str, Any], q: Dict[str, np.ndarray], batch: int,
           seed: int) -> Dict[str, np.ndarray]:
    """A sample, drawn from the seed, of the questions answered in the
    window, with some of the longest among them: their question indices
    and served top-k."""
    served = loop["served"]
    nb = len(q["ques_length"]) // batch
    rows = np.concatenate([((k % nb) * batch + np.arange(len(p)))
                           for k, p in enumerate(served)])
    top_ids = np.stack([x.top_ids for p in served for x in p])
    top_p = np.stack([x.top_probs for p in served for x in p])
    rng = np.random.default_rng([int(seed), 3])
    lengths = q["ques_length"][rows]
    longest = np.flatnonzero(lengths == lengths.max())
    pick = rng.choice(longest, min(SAMPLE_LONGEST, len(longest)),
                      replace=False)
    rest = np.setdiff1d(np.arange(len(rows)), pick)
    pick = np.concatenate([pick, rng.choice(
        rest, min(SAMPLE - len(pick), len(rest)), replace=False)])
    return {"rows": rows[pick], "top_ids": top_ids[pick],
            "top_probs": top_p[pick]}


def reference_logits(ctx: Context, params, features: Callable,
                     ques: np.ndarray, precision: str = "float32"
                     ) -> torch.Tensor:
    """The reference's logits of the sampled questions, in blocks;
    ``features(block_indices)`` gives their float32 grids."""
    from port_bench.reference import common

    common.exact_products()
    ref = reference_module(ctx.cell)
    prec = common.Precision(precision)
    dev = ctx.device
    p = {f"{layer}/{leaf}": torch.tensor(v, device=dev)
         for layer, leaves in params.items() for leaf, v in leaves.items()}
    out = []
    with torch.no_grad():
        for s in range(0, len(ques), REF_BLOCK):
            blk = np.arange(s, min(s + REF_BLOCK, len(ques)))
            out.append(ref.forward(p, features(blk), torch.from_numpy(
                ques[blk]).to(dev), ctx.cell.config["fields"], prec).cpu())
    return torch.cat(out)


def finish(ctx: Context, cfg, window: Window, loop, q, params,
           features: Callable, spans, counters) -> Run:
    """The run's record: the end-to-end values, then the sample checked
    against the reference once the program's state is freed."""
    e2e = serve_metrics(loop, window)
    quiet = unprofiled(loop, window)
    answered = sum(len(p) for p in loop["served"])
    attempted = len(loop["hand"]) * ctx.cell.traffic["batch"]
    profile = window.profile_summary() if ctx.trace else None
    peak = memory_peak(ctx.device)
    chosen = sample(loop, q, ctx.cell.traffic["batch"], ctx.seed)
    loop.clear()
    free(ctx.device)
    ques = q["questions"][chosen["rows"]]
    logits = reference_logits(
        ctx, params, lambda blk: features(chosen["rows"][blk]), ques)
    checks = check.serve_numbers(chosen["top_ids"], chosen["top_probs"],
                                 logits)
    controls = {}
    for name in ctx.controls:  # only float8 applies to serving
        ids, probs = check.top_k(reference_logits(
            ctx, params, lambda blk: features(chosen["rows"][blk]), ques,
            precision=name), TOPK)
        controls[name] = check.serve_numbers(ids, probs, logits)
    return Run(cell=ctx.cell, cfg=cfg, device=torch.device(ctx.device),
               window_s=window.elapsed, setup_s=window.t0 - PROCESS_START, e2e=e2e,
               work={"questions": answered,
                     "batch": ctx.cell.traffic["batch"]},
               attempted=attempted, failed=attempted - answered,
               checks=checks, memory_peak_bytes=peak,
               profiles=[profile] if ctx.trace else [],
               spans=spans, counters=counters, controls=controls,
               unprofiled=quiet)
