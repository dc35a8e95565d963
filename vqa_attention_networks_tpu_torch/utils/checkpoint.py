"""Checkpoints in the port's own format (the counterpart of
``vqa_attention_networks_tpu/utils/checkpoint.py``, whose Orbax format is
not read here: Orbax imports jax).

Layout, under ``directory`` (the Solver passes ``<out_dir>/<model>``):

    step_<n>/state.pt    one ``torch.save`` of the Solver's state: the
                         module's ``state_dict`` (batch-norm running
                         buffers included), the optimizer's, the step, the
                         early-stop record and the best snapshot
    weights/state.pt     the weights-only export (``save_weights``)

Each is written into a temporary directory beside its target and then
renamed onto it, so a run killed while saving leaves the previous
checkpoint whole and no half-written ``step_<n>``. The functions match the
JAX module's by name and behaviour; where JAX takes a template tree to
restore into, these return the saved tree (on the CPU) for the caller to
load.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Any, List, Optional

import torch

STATE_FILE = "state.pt"
_STEP_RE = re.compile(r"^step_(\d+)$")


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def _write(path: str, state: Any) -> str:
    """``torch.save`` ``state`` to ``<path>/state.pt`` through a temporary
    directory renamed onto ``path`` (an existing ``path`` is replaced)."""
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.", dir=parent)
    try:
        torch.save(state, os.path.join(tmp, STATE_FILE))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def _read(path: str) -> Any:
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def save_checkpoint(directory: str, state: Any, step: int,
                    keep: Optional[int] = None) -> str:
    """Write one checkpoint; returns its path. ``keep`` bounds retention:
    after a successful write, the ``step_*`` directories older than the
    newest ``keep`` are deleted. ``None`` keeps all."""
    path = _write(_step_dir(directory, step), state)
    if keep is not None and keep > 0:
        for old in all_steps(directory)[:-keep]:
            shutil.rmtree(_step_dir(directory, old), ignore_errors=True)
    return path


def all_steps(directory: str) -> List[int]:
    """Ascending step numbers of every checkpoint under ``directory``."""
    try:
        entries = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(int(m.group(1)) for e in entries
                  if (m := _STEP_RE.match(e)))


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None) -> Any:
    """The state saved at ``step`` (default: the latest), its tensors on
    the CPU. FileNotFoundError when there is none."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return _read(_step_dir(directory, step))


def save_weights(directory: str, state_dict: Any) -> str:
    """Weights-only export (the analog of the reference's final ``.pth``,
    solver.py:184-190): a module ``state_dict`` at ``<directory>/weights``."""
    return _write(os.path.join(os.path.abspath(directory), "weights"),
                  state_dict)


def load_weights(directory: str) -> Any:
    """The ``state_dict`` that ``save_weights`` wrote, on the CPU."""
    return _read(os.path.join(os.path.abspath(directory), "weights"))
