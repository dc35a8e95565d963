"""Every cell of BENCHMARK.json runs end to end on the CPU at small widths
and gives the contract's last line; without a card the command prints no
result and fails."""

import json
import os
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT, small_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


# every cell, and the training cell on four ranks (gloo here)
RUNS = [(c, None) for c in CELLS] + [("mhb_coatt.train_prepool", 4)]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell,chips", RUNS)
def test_cell_runs_end_to_end(cell, chips, trace, store_cache):
    from port_bench.run import measure

    c = small_cell(cell, chips=chips)
    line = measure(c, 2 ** 31 + 7, 1.5, bool(trace), device="cpu")
    json.dumps(line)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True or line["correct"] is False
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(c.limits)
    assert all(isinstance(v["value"], float) for v in line["checks"].values())
    dev = line["device"]
    assert dev["count"] == c.chips and dev["memory_peak_bytes"] >= 0
    if trace:
        assert "window_s" in dev and "busy_s" in dev
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU has no device trace: only host-side readers report
        assert set(line["metrics"]) <= {m["name"] for m in c.per_layer}
    else:
        names = {m["name"] for m in c.end_to_end}
        assert set(line["metrics"]) == names and "setup_s" in names
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_same_seed_same_inputs(store_cache):
    from port_bench import inputs, traffic

    c = small_cell("mhb_coatt.train_prepool")
    a = traffic.questions(c.traffic, 64, 22, 2 ** 31 + 3)
    b = traffic.questions(c.traffic, 64, 22, 2 ** 31 + 3)
    other = traffic.questions(c.traffic, 64, 22, 5)
    assert all((a[k] == b[k]).all() for k in a)
    assert not (a["questions"] == other["questions"]).all()
    # every seed the same work: the same lengths and images, reordered
    assert sorted(a["ques_length"]) == sorted(other["ques_length"])
    assert sorted(a["image_ids"]) == sorted(other["image_ids"])
    shapes = {"x/w": ((8, 4), "xavier"), "x/b": ((4,), "bias"),
              "y/w": ((4, 2), "normal:3.0")}
    w1 = inputs.weights(shapes, 2 ** 31 + 3, "cpu")
    w2 = inputs.weights(shapes, 2 ** 31 + 3, "cpu")
    assert all((w1[k] == w2[k]).all() for k in shapes)


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "mhb_coatt.serve_byid", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's folder
    (no program), the command fails and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "mhb_coatt.serve_byid", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
