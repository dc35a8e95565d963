"""MCAN-large trained through the port's ``Solver`` on one card by the
benchmark's training driver (``port_bench/drivers/train.py``), held to the
plain reference (``port_bench/reference/mcan.py``) by its training numbers
(``port_bench/check.py`` ``train_numbers``), and timed.

    python tools/mcan_train_check.py --seed 2147483647 --batch 64 \
        --seconds 20

The job is the benchmark's VQA v2 train traffic (``port_bench/traffic/
train_prepool.json``: 82,783 images in the Solver's int8 device bank, ten
annotators' soft answers a question) at ``--batch``, the model
``port_bench/configs/mcan_large.json`` at its published widths, weights
from the seed; the driver's warm-up steps, then a window of ``--seconds``.
The driver's reference steps take the soft cross-entropy of the port's
other families; MCAN trains with its own loss, so for this run they take
the reference's ``loss`` (the summed BCE over VQA scores, the Solver's
``losses.vqa_score_bce``). A stopgap until the training driver takes each
reference's loss and a cell trains MCAN (ROADMAP, Queue 6). One JSON line:
the numbers, the limits of the benchmark's training cell beside them for
scale, the rate in qa-pairs/s, the peak memory and the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402
from port_bench.drivers import train  # noqa: E402
from port_bench.reference import common  # noqa: E402
from port_bench.reference import mcan as ref  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fields", type=json.loads, default={},
                    help="JSON: configuration fields to override (a small "
                    "model for a run on the CPU)")
    ap.add_argument("--traffic", type=json.loads, default={},
                    help="JSON: traffic parameters to override")
    args = ap.parse_args(argv)

    traffic = harness.load_json(ROOT / "port_bench" / "traffic"
                                / "train_prepool.json")
    cell = harness.load_cell("mcan_large.serve_byid", overrides={
        "config": args.fields,
        "traffic": dict(traffic, batch=args.batch, **args.traffic)})
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=False, device=args.device)
    with mock.patch.object(common, "soft_cross_entropy", ref.loss):
        run = train.run_rank(ctx)
    limits = harness.load_json(ROOT / "port_bench" / "workloads"
                               / "mhb_coatt.train_prepool.json")["limits"]
    print(json.dumps({
        "seed": args.seed, "batch": args.batch, "numbers": run.checks,
        "train_prepool_limits": limits, **run.e2e, "steps": run.work["steps"],
        "setup_s": run.setup_s, "memory_peak_bytes": run.memory_peak_bytes,
        "card": harness.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
