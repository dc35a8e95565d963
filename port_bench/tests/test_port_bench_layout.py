"""The benchmark is driven by data: a new cell, traffic mix and per-layer
metric are files the harness finds by name; names and units keep to their
characters; no module imports JAX or the JAX package."""

import ast
import json
import re
import shutil

from conftest import ROOT, small_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "vqa_attention_networks_tpu"}
PORT = "vqa_attention_networks_tpu_torch"


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    metrics = b["end_to_end"] + b["per_layer"]
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in metrics]
             + [w["config"] for w in b["workloads"]]
             + [w["traffic"] for w in b["workloads"]]
             + [k for c in b["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for text in ([c["why"] for c in b["configs"]]
                 + [w["why"] for w in b["workloads"]]
                 + [m["layer"] for m in b["per_layer"]]
                 + [c["source"] for c in b["configs"]] + b["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    for name in ([f"{w['name']}.json" for w in b["workloads"]]
                 + [f"{m['name']}.py" for m in b["per_layer"]]):
        assert re.match(r"^[A-Za-z0-9_.-]+$", name)


def test_every_name_has_its_files():
    b = bench()
    pb = ROOT / "port_bench"
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists()
        assert (pb / "counts" / f"{c['name']}.py").exists()
    for w in b["workloads"]:
        spec = json.loads((pb / "workloads" / f"{w['name']}.json").read_text())
        assert {k: spec[k] for k in ("config", "traffic", "chips")} == \
            {k: w[k] for k in ("config", "traffic", "chips")}
        assert (pb / "traffic" / f"{w['traffic']}.json").exists()
    for m in b["per_layer"]:
        assert (pb / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_new_cell_and_metric_need_no_edit(tmp_path, store_cache):
    """A cell, a traffic mix and a per-layer metric added as files (and as
    entries of BENCHMARK.json) in a copy are found without an edit."""
    from port_bench import harness
    from port_bench.run import measure

    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    pb = tmp_path / "port_bench"
    traffic = json.loads((pb / "traffic" / "serve_byid.json").read_text())
    traffic.update(images=512, capacity=128)
    (pb / "traffic" / "serve_byid_evict.json").write_text(json.dumps(traffic))
    (pb / "workloads" / "mhb_coatt.serve_byid_evict.json").write_text(
        json.dumps({"config": "mhb_coatt", "traffic": "serve_byid_evict",
                    "chips": 1, "limits": {"answer_gap": 1.0,
                                           "logit_err": 1.0}}))
    (pb / "metrics" / "bank_hit_rate.py").write_text(
        "def read(run):\n"
        "    c = run.counters\n"
        "    n = c.get('bank_hits', 0) + c.get('bank_misses', 0)\n"
        "    return 100.0 * c['bank_hits'] / n if n else None\n")
    b["workloads"].append({"name": "mhb_coatt.serve_byid_evict",
                           "config": "mhb_coatt",
                           "traffic": "serve_byid_evict", "chips": 1,
                           "why": "a bank smaller than the images"})
    b["per_layer"].append({"name": "bank_hit_rate", "unit": "%",
                           "better": "higher", "source": "program_counter",
                           "layer": "device feature cache",
                           "moves": "serve_qa_pairs_per_s",
                           "workloads": ["mhb_coatt.serve_byid_evict"]})
    for m in b["end_to_end"]:
        if "workloads" in m and "serve" in m["name"]:
            m["workloads"].append("mhb_coatt.serve_byid_evict")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = small_cell("mhb_coatt.serve_byid_evict", root=tmp_path)
    cell.traffic.update(images=256, capacity=64)
    assert cell.per_layer[-1]["name"] == "bank_hit_rate"
    line = measure(cell, 3, 1.0, True, device="cpu")
    # found and read (the share itself depends on how many batches the
    # short window served: its first batches are the warm-up's, all hits)
    assert 0 <= line["metrics"]["bank_hit_rate"]["value"] <= 100
    line = measure(cell, 3, 1.0, False, device="cpu")
    assert "serve_qa_pairs_per_s" in line["metrics"]
    assert harness.load_cell("mhb_coatt.serve_byid", root=tmp_path).name


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_import():
    files = sorted((ROOT / "port_bench").rglob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    for path in sorted((ROOT / "port_bench" / "reference").rglob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] != PORT, (path, name)


def test_forbidden_modules_by_whole_name(monkeypatch):
    import sys
    import types

    from port_bench import harness

    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, f"{PORT}.fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax"]
