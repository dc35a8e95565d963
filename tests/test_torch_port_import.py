"""The port imports nothing of JAX or of the JAX package, loads no file by
its path (so nothing above it, such as chip_smoke.py), and chip_smoke.py
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
    "cli.train", "cli.evaluate", "cli.export_serving", "train.feature_bank")]

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


def _package_sources():
    root = os.path.join(ROOT, "vqa_attention_networks_tpu_torch")
    for dirpath, _, files in os.walk(root):
        yield from (os.path.join(dirpath, f) for f in files
                    if f.endswith(".py"))


def _port_sources():
    yield from _package_sources()
    yield os.path.join(ROOT, "chip_smoke.py")


# what runs Python code from a file named by its path, not from a module
# named by its import path: importlib's and imp's file loaders, runpy's
# run_path, and the builtin exec
PATH_LOADERS = ("spec_from_file_location", "SourceFileLoader",
                "SourcelessFileLoader", "load_source", "run_path")


def _path_loads(path):
    """Each way the file loads code other than by importing a module of the
    port by name: a use of ``PATH_LOADERS``, a call of ``exec``, and an
    import of ``chip_smoke``, by statement or by a name in a string."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in PATH_LOADERS:
            yield node.attr
        elif isinstance(node, ast.Name) and node.id in PATH_LOADERS:
            yield node.id
        elif isinstance(node, ast.alias) and node.name in PATH_LOADERS:
            yield node.name
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "exec":
            yield "exec"
        elif isinstance(node, ast.Constant) and node.value == "chip_smoke":
            yield "chip_smoke"
    yield from (name for name in _imports_of(path)
                if name.split(".")[0] == "chip_smoke")


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


def test_no_package_module_loads_a_file_by_its_path():
    """The package depends on nothing above it: no module runs a file by
    its path or imports ``chip_smoke`` (the card tools draw their cases
    from ``ops/card_cases.py``, inside it)."""
    sources = list(_package_sources())
    assert len(sources) >= 25
    bad = [(os.path.relpath(path, ROOT), how) for path in sources
           for how in _path_loads(path)]
    assert not bad, bad


def test_the_path_load_scan_sees_each_form(tmp_path):
    # control: the scan flags every form it looks for
    path = tmp_path / "probe.py"
    path.write_text(
        "import importlib.util, runpy, chip_smoke\n"
        "from importlib.machinery import SourceFileLoader\n"
        "from chip_smoke import k4_inputs\n"
        "spec = importlib.util.spec_from_file_location('m', 'chip_smoke.py')\n"
        "runpy.run_path('chip_smoke.py')\n"
        "exec(open('chip_smoke.py').read())\n"
        "importlib.import_module('chip_smoke')\n")
    assert sorted(_path_loads(str(path))) == sorted([
        "SourceFileLoader", "spec_from_file_location", "run_path", "exec",
        "chip_smoke", "chip_smoke", "chip_smoke"])


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
