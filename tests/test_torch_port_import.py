"""The port imports without JAX, and chip_smoke.py refuses to run without a
card or without the repository around it."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vqa_attention_networks_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
assert not leaked, leaked
print(len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 16  # every module


def test_solver_import_leaves_jax_out():
    code = ("import sys, vqa_attention_networks_tpu_torch.train.solver\n"
            "leaked = sorted(m for m in sys.modules\n"
            "                if m.split('.')[0] in ('jax', 'jaxlib'))\n"
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
