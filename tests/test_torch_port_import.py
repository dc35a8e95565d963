"""The port imports nothing of JAX or of the JAX package, and chip_smoke.py
refuses to run without a card or without the repository around it."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# modules each slice added, which the walk must find and import (with
# PIL absent from the card's machine, none may import it at module level)
NEEDED = [f"vqa_attention_networks_tpu_torch.{m}" for m in (
    "aot", "serve", "cli.serve", "cli.predict", "cli.extract_features",
    "models.resnet", "models.vgg", "models.extractor", "utils.checkpoint",
    "cli.train", "cli.evaluate")]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vqa_attention_networks_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
missing = sorted(set(NEEDED) - set(names))
assert not missing, missing
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib")
                or m == "vqa_attention_networks_tpu"
                or m.startswith("vqa_attention_networks_tpu."))
assert not leaked, leaked
assert "PIL" not in sys.modules, "a port module imports PIL"
print(len(names))
"""
JAX_PACKAGE = "vqa_attention_networks_tpu"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", f"NEEDED = {NEEDED!r}\n" + _IMPORT_ALL],
        cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 52  # every module


def _imports_of(path):
    """Every module name an ``import`` or ``from`` statement of the file
    names (relative imports resolve inside the port, so they are skipped)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_sources():
    root = os.path.join(ROOT, "vqa_attention_networks_tpu_torch")
    for dirpath, _, files in os.walk(root):
        yield from (os.path.join(dirpath, f) for f in files
                    if f.endswith(".py"))
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_port_source_imports_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) >= 25
    bad = [(os.path.relpath(path, ROOT), name) for path in sources
           for name in _imports_of(path)
           if name == JAX_PACKAGE or name.startswith(JAX_PACKAGE + ".")
           or name.split(".")[0] in ("jax", "jaxlib")]
    assert not bad, bad


def test_the_import_scan_sees_a_jax_package_import(tmp_path):
    # control: the scan flags both statement forms
    path = tmp_path / "probe.py"
    path.write_text("import vqa_attention_networks_tpu.config\n"
                    "from vqa_attention_networks_tpu.data import native\n")
    assert list(_imports_of(str(path))) == [
        "vqa_attention_networks_tpu.config",
        "vqa_attention_networks_tpu.data"]


def test_solver_import_leaves_jax_out():
    code = ("import sys, vqa_attention_networks_tpu_torch.train.solver\n"
            "leaked = sorted(m for m in sys.modules if m.split('.')[0]\n"
            "                in ('jax', 'jaxlib', 'vqa_attention_networks_tpu'))\n"
            "assert not leaked, leaked\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_to_run(where, tmp_path):
    """Exits non-zero and prints no ok line: with no card (here), and in a
    directory that holds chip_smoke.py and nothing else of the repo."""
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a card is visible: chip_smoke.py would run for real")
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd, env = ROOT, dict(os.environ)
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd, script = str(tmp_path), str(tmp_path / "chip_smoke.py")
        env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]
