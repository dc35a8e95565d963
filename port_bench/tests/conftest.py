"""The harness's tests run on the CPU at small widths (the plain versions of
the kernels), from the root of the repo:

    python -m pytest port_bench/tests -q

Card-only parts are left out inside the tests (``run.measure`` takes the
device), never at import.
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small widths: every size the configurations' fields and traffic files set
SMALL_CONFIG = {"q_vocab_size": 64, "a_vocab_size": 32, "hidden_dim": 32,
                "emb_dim": 16, "mfb_out": 16, "img_feature_channel": 32,
                "embed_size": 16}
SMALL_TRAFFIC = {"images": 64, "batch": 8, "capacity": 64, "pool": 4,
                 "fill_chunk": 16, "warm_batches": 2, "warm_steps": 4}
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def small_cell(name, root=ROOT, chips=None, **config):
    """The cell at small widths; ``chips`` runs it on that many ranks (the
    training driver's data-parallel path, which no cell takes yet)."""
    import dataclasses

    from port_bench import harness

    traffic = dict(SMALL_TRAFFIC)
    entry = harness.load_json(root / "port_bench" / "workloads"
                              / f"{name}.json")
    chips = chips or entry["chips"]
    traffic["batch"] = 4 * chips if chips > 1 else 8
    cell = harness.load_cell(name, root, overrides={
        "config": dict(SMALL_CONFIG, **config), "traffic": traffic})
    return dataclasses.replace(cell, chips=chips)


@pytest.fixture
def store_cache(tmp_path, monkeypatch):
    """The stores of the runs under the test's temporary directory, and one
    thread a rank (the four-rank cell's ranks share the CPU)."""
    from port_bench import inputs

    monkeypatch.setattr(inputs, "CACHE", tmp_path / "cache")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return tmp_path / "cache"
