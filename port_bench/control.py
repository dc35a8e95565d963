"""The readings a cell's correctness limits are set from (not run by the
benchmark's runs).

    python3 port_bench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--controls float8 half_batch no_exchange]

For each seed, in one process, it runs the cell as a benchmark run does
(the window at ``--seconds``) and prints one JSON line: the program's
correctness numbers (the lower readings) and, on the same inputs, each
named reference put in the program's place: ``float8``, the reference in
the precision below the configuration's bfloat16 (products of float8 e4m3
operands), and for training the faults ``half_batch`` (half of each batch
left out, the mean over the rest) and ``no_exchange`` (rank 0's rows alone,
no gradient exchange); a state left unchanged reads 1 by the measure of
``check.train_numbers`` and needs no run. The upper readings are the
least of each over the seeds. Two looks, for training, read how far
rounding alone moves a number: ``look`` (every signed square root's input
moved by bfloat16's rounding) and ``bfloat16`` (every product's operands
in the configuration's bfloat16), each the float32 reference otherwise.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402
from port_bench.harness import Context  # noqa: E402


def readings(cell: harness.Cell, seed: int, seconds: float, controls,
             device: str = "cuda") -> dict:
    driver = importlib.import_module(f"port_bench.drivers.{cell.driver}")
    run = driver.run(Context(cell=cell, seed=seed, seconds=seconds,
                             trace=False, device=device,
                             controls=tuple(controls)))
    return {"seed": seed, "program": run.checks, "controls": run.controls,
            "e2e": run.e2e, "setup_s": run.setup_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*", default=["float8"])
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, args.controls)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
