"""Spans and counters at the port's layer boundaries, on the profiler's clock.

The engine, the device feature bank, the host store and the Solver's step
open spans where their work happens (README, "Tracing"):

    with trace.span("serve.dispatch", batch_id):
        ...
    trace.count("serve.h2d_bytes", n)

Counters: ``serve.h2d_bytes`` (every copy to the device of the serving
engine), ``serve.h2d_pinned_bytes`` (those of its copies that
``InferenceEngine._to_device`` made to a card without a wait, from
page-locked memory), ``serve.graph_captures`` and ``serve.graph_replays``.

A span records only while a ``torch.profiler`` session records: it reads
the profiler's own enabled flag once at its entry. So spans join whatever
profile is being taken (a benchmark's traced stretch, the Solver's
``profile_steps``, an operator's own session), and with no profiler running
a span costs that flag read and an empty context: no clock read, no
allocation. Counters follow the same flag.

A recorded span holds its name, its start and end in nanoseconds on the
clock of ``time.time_ns()``, which is the profiler's (an event's absolute
time is its result's ``trace_start_ns()`` plus the event's offset), the id
of the span open around it on the same thread (its parent), its thread, and
the id of the batch or step it belongs to: the one given, else its
parent's. While it records, a span also opens a ``record_function`` range
of its name, so that a profile that records CPU activity shows it.

Spans and counters stay in memory, process-wide like the profiler's own
session, until ``reset()``: ``spans()`` and ``counters()`` read them.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, List, Optional

import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()
_ids = itertools.count()
_local = threading.local()
_lock = threading.Lock()
_spans: List["Span"] = []
_counters: Dict[str, int] = {}


class Span:
    """One span: the context ``span()`` returns while the profiler records,
    and its record once it has ended (``end_ns`` is None while it is
    open)."""

    __slots__ = ("name", "id", "parent", "thread", "batch", "start_ns",
                 "end_ns", "_range")

    def __init__(self, name: str, batch: Optional[int]):
        self.name = name
        self.batch = batch
        self.end_ns: Optional[int] = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.parent = None if parent is None else parent.id
        if self.batch is None and parent is not None:
            self.batch = parent.batch
        self.id = next(_ids)
        self.thread = threading.get_ident()
        stack.append(self)
        self.start_ns = time.time_ns()
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        self.end_ns = time.time_ns()
        _local.stack.pop()
        _spans.append(self)
        return False


def recording() -> bool:
    """Whether a ``torch.profiler`` session records now."""
    return _profiler._is_profiler_enabled


def span(name: str, batch: Optional[int] = None):
    """A context that records the span ``name`` while the profiler records,
    and does nothing else. ``batch``: the id of the batch or step, else the
    parent's."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, batch)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while the profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def spans() -> List[Span]:
    """The finished spans, in the order they started."""
    return sorted(_spans, key=lambda s: s.start_ns)


def counters() -> Dict[str, int]:
    return dict(_counters)


def reset() -> None:
    """Forget every finished span and counter."""
    with _lock:
        _spans.clear()
        _counters.clear()


def self_ns(recorded: Iterable[Span]) -> Dict[int, int]:
    """Each span's self time by id: its duration less its children's (a
    parent's children run one after another on its thread)."""
    recorded = list(recorded)
    out = {s.id: s.duration_ns for s in recorded}
    for s in recorded:
        if s.parent in out:
            out[s.parent] -= s.duration_ns
    return out
