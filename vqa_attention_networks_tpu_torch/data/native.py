"""ctypes bindings for the port's native data plane (``csrc/dataplane.cpp``),
the port's copy of ``vqa_attention_networks_tpu/data/native.py``.

The library is built with ``g++`` at first use into ``build/native/`` at
the root of the checkout, keyed on a hash of the source and the flags, so
the port never shares or replaces the JAX package's
``native/libvqa_dataplane.so``. On a host with no compiler every function
returns None and its caller takes its NumPy twin, which has the same
semantics: this is host-side data loading, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dataplane.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# -mavx -mf16c, not the JAX copy's -march=native: a checkout's build/ may
# travel to another x86 host, where a library tuned to this one could
# fault; every x86-64 host of the last decade has AVX and F16C (elsewhere
# the build fails and the NumPy twins run)
_FLAGS = ("-O3", "-mavx", "-mf16c", "-fPIC", "-shared", "-std=c++17",
          "-Wall", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_tried = False
# the first build/load is serialised: concurrent first callers (batch
# assembly threads) would otherwise race two compilers onto one file
_lock = threading.Lock()


def library_path() -> Path:
    key = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libvqa_dataplane_{key.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SOURCE)],
                              capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        tmp.unlink(missing_ok=True)
        return False
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)  # atomic: another process loads either copy
    return True


def _set_argtypes(lib: ctypes.CDLL) -> None:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.vqa_gather_f16_to_f32_mt.argtypes = [
        ctypes.c_void_p, i64p, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
    ]
    lib.vqa_gather_rows_u16_mt.argtypes = [
        ctypes.c_void_p, i64p, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
    ]
    lib.vqa_densify_soft_mt.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
    ]
    for fn in (lib.vqa_gather_f16_to_f32_mt, lib.vqa_gather_rows_u16_mt,
               lib.vqa_densify_soft_mt):
        fn.restype = None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        _set_argtypes(lib)
        _lib = lib
        return _lib


def num_threads() -> int:
    """Host threads for the row-parallel gathers: the core count, capped at
    16 (they are memory-bandwidth-bound; more threads add only spawn and
    join time to every batch)."""
    return max(1, min(os.cpu_count() or 1, 16))


def _check_gather_args(src: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The C gathers walk a dense row-major buffer and check no bounds: a
    strided source or an out-of-range row would read foreign memory."""
    if not src.flags["C_CONTIGUOUS"]:
        raise ValueError("native gather requires a C-contiguous source")
    rows = np.ascontiguousarray(rows, np.int64)
    if len(rows) and (rows.min() < 0 or rows.max() >= src.shape[0]):
        raise IndexError(
            f"row indices out of range [0, {src.shape[0]}) for native gather"
        )
    return rows


def _output(out: Optional[np.ndarray], shape: tuple,
            dtype) -> np.ndarray:
    """``out`` checked against the gather's result (the C gathers write
    ``prod(shape)`` elements through its pointer), or a new array."""
    if out is None:
        return np.empty(shape, dtype)
    if out.shape != shape or out.dtype != dtype:
        raise ValueError(f"out of {out.shape} {out.dtype}, the gather gives "
                         f"{shape} {np.dtype(dtype)}")
    if not out.flags["C_CONTIGUOUS"] or not out.flags["WRITEABLE"]:
        raise ValueError("out must be C-contiguous and writeable")
    return out


def gather_f16_to_f32(src: np.ndarray, rows: np.ndarray,
                      out: Optional[np.ndarray] = None,
                      ) -> Optional[np.ndarray]:
    """Fused gather + widen of f16 rows, into ``out`` where given; None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    if src.dtype != np.float16:
        raise TypeError(f"gather_f16_to_f32 takes an f16 source, got "
                        f"{src.dtype}")
    rows = _check_gather_args(src, rows)
    row_elems = int(np.prod(src.shape[1:]))
    out = _output(out, (len(rows), *src.shape[1:]), np.float32)
    lib.vqa_gather_f16_to_f32_mt(
        src.ctypes.data, rows, len(rows), row_elems,
        out.reshape(len(rows), -1), num_threads(),
    )
    return out


def _gather_u16(src: np.ndarray, rows: np.ndarray, pairs: int, dtype,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    lib = get_lib()
    rows = _check_gather_args(src, rows)
    out = _output(out, (len(rows), *src.shape[1:]), dtype)
    lib.vqa_gather_rows_u16_mt(
        src.ctypes.data, rows, len(rows), pairs,
        out.reshape(len(rows), -1).view(np.uint16), num_threads(),
    )
    return out


def gather_f16(src: np.ndarray, rows: np.ndarray,
               out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """Raw f16 row gather (the bf16 feed ships the store's dtype to the
    device unwidened), into ``out`` where given; None without the
    library."""
    if get_lib() is None:
        return None
    if src.dtype != np.float16:
        raise TypeError(f"gather_f16 takes an f16 source, got {src.dtype}")
    return _gather_u16(src, rows, int(np.prod(src.shape[1:])), np.float16,
                       out)


def gather_i8(src: np.ndarray, rows: np.ndarray) -> Optional[np.ndarray]:
    """Raw int8 row gather (the quantized feed), through the 16-bit copy
    kernel on byte pairs; None without the library or for an odd row
    size."""
    if get_lib() is None:
        return None
    if src.dtype != np.int8:
        raise TypeError(f"gather_i8 takes an int8 source, got {src.dtype}")
    row_elems = int(np.prod(src.shape[1:]))
    if row_elems % 2:
        return None
    return _gather_u16(src, rows, row_elems // 2, np.int8)


def densify_soft(idx: np.ndarray, val: np.ndarray,
                 num_answers: int) -> Optional[np.ndarray]:
    """Scatter [N, W] sparse soft answers to [N, num_answers]; None without
    the library."""
    lib = get_lib()
    if lib is None:
        return None
    idx = np.ascontiguousarray(idx, np.int32)
    val = np.ascontiguousarray(val, np.float32)
    # fail as the NumPy twin does on an index past the vocab (the C loop
    # would drop it silently)
    if idx.size and idx.max() >= num_answers:
        raise IndexError(
            f"soft-answer index {int(idx.max())} out of range for "
            f"num_answers={num_answers} — the QA artifact was prepared "
            "against a larger answer vocabulary"
        )
    n, width = idx.shape
    out = np.zeros((n, num_answers), np.float32)
    lib.vqa_densify_soft_mt(idx, val, n, width, num_answers, out,
                            num_threads())
    return out
