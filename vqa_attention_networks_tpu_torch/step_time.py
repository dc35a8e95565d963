"""Time the pre-pool training step of full-width bf16 mhb_coAtt on the card.

    python3 vqa_attention_networks_tpu_torch/step_time.py [--root DIR]

imports the port from DIR (by default the checkout that holds this file),
so that two checkouts of the port, one of them unpacked with
``git archive``, can be timed by turns on the same card: run it for each,
in the order A, B, B, A, and compare within the one machine. It trains
``Solver.train`` from random weights (seed 0) on synthetic data, batch 64,
and prints one JSON line: ms per step over steps 5 to the last
(synchronised at both ends), training qa-pairs/s, the per-step losses and
the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def main() -> None:
    package = os.path.dirname(os.path.abspath(__file__))
    here = os.path.dirname(package)
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=here,
                        help="the checkout whose port is timed")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch", type=int, default=64)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    # the port from ``root``, and none of this file's neighbours as
    # top-level modules
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or ".") != package]

    import numpy as np
    import torch

    from vqa_attention_networks_tpu_torch.config import Config
    from vqa_attention_networks_tpu_torch.data.feature_store import (
        make_synthetic_feature_store)
    from vqa_attention_networks_tpu_torch.data.prepare import (
        make_synthetic_qa_data)
    from vqa_attention_networks_tpu_torch.models.mhb_coatt import init_params
    from vqa_attention_networks_tpu_torch.train.solver import Solver

    if not torch.cuda.is_available():
        sys.exit("step_time.py times the card: no CUDA device")
    cfg = Config(compute_dtype="bfloat16", num_epoch=1,
                 batch_size=args.batch)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    images = 256
    qa = make_synthetic_qa_data(
        np.random.default_rng(0), n_train=args.steps * args.batch,
        n_val=args.batch, q_vocab_words=cfg.q_vocab_size - 2,
        num_answers=cfg.a_vocab_size, max_len=cfg.max_question_length,
        num_images=images)
    marks, losses = {}, []
    first, last = 5, args.steps - 1

    def on_step(step, loss):
        losses.append(float(loss))
        if step in (first, last):
            torch.cuda.synchronize()
            marks[step] = time.perf_counter()

    with tempfile.TemporaryDirectory() as tmp:
        store = make_synthetic_feature_store(tmp, list(range(images)))
        Solver(cfg, qa, store, params=params).train(on_step=on_step)
    ms = (marks[last] - marks[first]) * 1e3 / (last - first)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(json.dumps({
        "root": root, "model": cfg.model_name, "dropout_site":
        cfg.dropout_site, "batch": args.batch, "steps_timed":
        f"{first}..{last}", "ms_per_step": ms,
        "qa_pairs_per_s": args.batch * 1e3 / ms, "losses": losses,
        "card": card[0] if card else None}), flush=True)
    if not np.isfinite(losses).all():
        sys.exit("a training loss is not finite")


if __name__ == "__main__":
    main()
