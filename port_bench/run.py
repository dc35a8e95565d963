"""Run one cell of the port's benchmark and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each correctness number beside its
limit, which also end standard error. Without a card, with fewer cards
than the cell asks for, or if JAX or the JAX package is loaded, it prints
no result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402


def measure(cell: harness.Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", fault=None) -> dict:
    """The result line of one run of ``cell`` (no look for a card: the
    tests call this on the CPU)."""
    import importlib

    from port_bench.harness import Context

    driver = importlib.import_module(f"port_bench.drivers.{cell.driver}")
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                  device=device, fault=fault)
    record = driver.run(ctx)
    return harness.result(record, trace)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # every build and kernel cache at a fixed place inside the checkout, so
    # that only a cell's first run there builds (the port's own kernels go
    # to build/kernels/, ops/_build.py)
    for key, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[key] = str(ROOT / "build" / sub)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    line = measure(cell, args.seed, args.seconds, bool(args.trace))
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"port_bench: the process holds {leaked}", file=sys.stderr)
        return 3
    for name, rec in line["checks"].items():
        print(f"{name} {rec['value']} limit {rec['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
