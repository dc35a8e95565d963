"""Frozen copies of the two functions that make the trainer's randomness, so
the reference draws the same dropout as the program from the same seeds:

- ``step_randomness``: a step's dropout-generator seed and pre-pool mask
  seed, a pure function of (base, step) (``numpy.random.SeedSequence``);
- ``prepool_mask``: the keep mask of the pre-pool fusion dropout, word 0 of
  Philox4x32-10 with key (seed, 0) at the element's counter
  ((row * L + l) * F + c), kept where the word is under (1 - rate) * 2^32.

Both are copied as the program defines them; they are the specification
the program's kernel follows, not code of the program.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_CHUNK = 1 << 24


def step_randomness(base: int, step: int) -> Tuple[int, int]:
    """(dropout generator seed, pre-pool mask seed) of training step
    ``step`` of a run whose base is ``seed + 1``."""
    w = np.random.SeedSequence([base, step]).generate_state(3, np.uint32)
    return int(w[0]) | (int(w[1]) << 32), int(w[2]) & 0x7FFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    hi = ((p_hi + (p_lo >> 16)) >> 16) & _MASK32
    return hi, lo


def philox_word0(seed: int, counter: torch.Tensor) -> torch.Tensor:
    c0 = counter & _MASK32
    c1 = counter >> 32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = int(seed) & _MASK32, 0
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def prepool_mask(seed: int, n: int, l: int, f: int, rate: float,
                 device) -> torch.Tensor:
    """The keep mask [n, l, f] of rows 0..n-1 of the global batch."""
    thr = min(int((1.0 - rate) * 4294967296.0), 4294967295)
    total = n * l * f
    out = torch.empty(total, dtype=torch.bool, device=device)
    for s in range(0, total, _CHUNK):
        idx = torch.arange(s, min(s + _CHUNK, total), dtype=torch.int64,
                           device=device)
        out[s:s + idx.numel()] = philox_word0(seed, idx) < thr
    return out.reshape(n, l, f)
