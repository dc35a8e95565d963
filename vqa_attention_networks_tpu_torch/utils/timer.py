"""Cumulative tic/toc wall-clock timer (the port's copy of
``vqa_attention_networks_tpu/utils/timer.py``, the twin of the reference's
``timer.py:3-20``); it feeds the Solver's qa-pairs/s."""

from __future__ import annotations

import time


class Timer:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._start = 0.0
        self.calls = 0
        self.total = 0.0

    def tic(self) -> None:
        self._start = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        elapsed = time.perf_counter() - self._start
        self.total += elapsed
        self.calls += 1
        return self.total / self.calls if average else elapsed

    @property
    def average(self) -> float:
        return self.total / self.calls if self.calls else 0.0

    def __enter__(self) -> "Timer":
        self.tic()
        return self

    def __exit__(self, *exc) -> None:
        self.toc()
