"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` by hand into a shared library, loaded with ``ctypes`` (no PyTorch
headers: a file that includes them takes minutes to compile). The build
runs at first use, on the machine with the card, into ``build/kernels/`` at
the root of the checkout, keyed on a hash of the source, the shared headers
``csrc/*.cuh`` and the flags, so a changed source rebuilds and an unchanged
one loads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills in the log
)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, $PATH and the default "
        "CUDA toolkit location); the port's kernels build on a machine "
        "with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: keyed on the
    source, the shared headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()
    return BUILD_DIR / f"lib{name}_{key[:16]}.so"


def build(name: str) -> Tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns (path,
    seconds spent compiling — 0.0 when it was already built, compiler log)."""
    out = library_path(name)
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return out, 0.0, log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n{log}"
        )
    log_path.write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build loads either copy
    return out, seconds, log


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load the library of ``csrc/<name>.cu``."""
    path, _, _ = build(name)
    return ctypes.CDLL(str(path))
