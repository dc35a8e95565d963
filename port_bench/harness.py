"""The benchmark's machinery: cells found by name, the measured window, the
profiler's reading, the per-layer readers and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its files, each
found by name:

- ``workloads/<cell>.json``: its configuration, traffic mix and cards, the
  limits of its correctness numbers and the faults it can have;
- ``configs/<config>.json``: the model (``Config`` fields) and its source;
- ``traffic/<traffic>.json``: the driver (``drivers/<driver>.py``) and the
  parameters of the one generator (``traffic.py``) and the job;
- ``metrics/<metric>.py``: one reader a per-layer metric (``read(run)``);
- ``counts/<config>.py``: operations and bytes counted from shapes.

No module here imports JAX or the JAX package; ``forbidden_modules`` holds
the process that prints the result to that (names compared whole, by their
first dotted part: the port's name begins with the JAX package's).
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vqa_attention_networks_tpu")
SPAN_PREFIX = "bench."


def _process_start() -> float:
    """This process's start on the ``perf_counter`` clock (Linux's
    /proc; the import of this module where that is missing)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


PROCESS_START = _process_start()


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file (names with dots, as
    ``device_idle.serve``, are no import path)."""
    spec = importlib.util.spec_from_file_location(
        "port_bench._loaded." + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    config_name: str
    config: Dict[str, Any]  # configs/<config>.json
    traffic_name: str
    traffic: Dict[str, Any]  # traffic/<traffic>.json
    chips: int
    limits: Dict[str, float]
    faults: List[str]
    end_to_end: List[Dict[str, Any]]  # BENCHMARK.json entries of this cell
    per_layer: List[Dict[str, Any]]
    root: Path = ROOT

    @property
    def driver(self) -> str:
        return self.traffic["driver"]

    @property
    def bench(self) -> Path:
        return self.root / "port_bench"


@dataclass
class Context:
    """One run of a cell, as a driver gets it."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    fault: Optional[str] = None  # faults.py, planted by the tests only
    # references put in the program's place, read beside its check
    # (control.py; a benchmark run reads none)
    controls: tuple = ()


def _listed(metric: Dict[str, Any], cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load_cell(name: str, root: Path = ROOT,
              overrides: Optional[Dict[str, Dict[str, Any]]] = None) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its files read.
    ``overrides`` ({"config": {...}, "traffic": {...}}) updates the
    configuration's ``fields`` and the traffic's parameters: the tests'
    small sizes, never a benchmark run's."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = load_json(root / "port_bench" / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key}={spec[key]!r}"
                             f", BENCHMARK.json {entry[key]!r}")
    config = load_json(root / "port_bench" / "configs"
                       / f"{entry['config']}.json")
    traffic = load_json(root / "port_bench" / "traffic"
                        / f"{entry['traffic']}.json")
    overrides = overrides or {}
    config = dict(config, fields=dict(config["fields"],
                                      **overrides.get("config", {})))
    traffic = dict(traffic, **overrides.get("traffic", {}))
    e2e = [m for m in bench["end_to_end"] if _listed(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _listed(m, name, reported)]
    return Cell(name=name, config_name=entry["config"], config=config,
                traffic_name=entry["traffic"], traffic=traffic,
                chips=int(entry["chips"]), limits=spec["limits"],
                faults=list(spec.get("faults", [])), end_to_end=e2e,
                per_layer=per_layer, root=root)


def port_config(cell: Cell, **job: Any):
    """The port's ``Config`` of the cell: the configuration's fields, then
    the job's (batch size, switches of the traffic file)."""
    from vqa_attention_networks_tpu_torch.config import Config

    return Config(**dict(cell.config["fields"], **job)).validate()


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package this process holds."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def span(spans: Dict[str, List[float]], name: str, traced: bool):
    """Host time of ``name`` into ``spans``; on a traced run also a
    profiler range ``bench.<name>``, which labels the device's idle gaps."""
    import torch

    ctx = (torch.profiler.record_function(SPAN_PREFIX + name) if traced
           else contextlib.nullcontext())
    t = time.perf_counter()
    with ctx:
        yield
    spans.setdefault(name, []).append(time.perf_counter() - t)


class StopWindow(Exception):
    """Raised from a training step's callback once the window is due."""


class Window:
    """The measured window. ``open`` synchronises the device and starts the
    clock (set-up ends there); ``due`` says whether ``seconds`` have passed
    (every rank's verdict, through ``agree``, on several cards); ``close``
    synchronises and stops the clock. On a traced run ``due`` runs
    ``torch.profiler`` over a steady stretch at the window's end: from
    ``lead`` seconds in, for ``span`` seconds, ``tail`` before the close,
    between the host times ``p0`` and ``p1``. The per-layer readers that
    take a rate or a tail from the host's clock read the window before
    ``p0`` (``before``): once started, the profiler slows the process's
    launches after it stops too."""

    def __init__(self, seconds: float, device, trace: bool,
                 agree: Optional[Callable[[bool], bool]] = None):
        self.seconds = float(seconds)
        self.device = device
        self.trace = trace
        self.agree = agree
        self.tail = min(1.0, 0.1 * self.seconds)
        self.span = max(0.25, min(3.0, self.seconds - 2 * self.tail))
        self.lead = max(0.0, self.seconds - self.tail - self.span)
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.prof = None  # the profiler while it runs
        self.profiled = None  # and once it has stopped
        self.p0: Optional[float] = None
        self.p1: Optional[float] = None

    def open(self) -> None:
        synchronize(self.device)
        self.t0 = time.perf_counter()

    def due(self) -> bool:
        now = time.perf_counter() - self.t0
        if (self.trace and self.prof is None and self.profiled is None
                and now >= self.lead):
            self._start_profile()
        elif self.prof is not None and now >= self.lead + self.span:
            self._stop_profile()
        done = now >= self.seconds
        return self.agree(done) if self.agree is not None else done

    def _start_profile(self) -> None:
        """On a card, the CUDA activity alone: recording every host
        operation (the CPU activity) slows this host-bound program by
        2-3 times and would make the idle share the profiler's. The CPU's
        activity where there is no card (the tests)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        on_card = torch.device(self.device).type == "cuda"
        self.prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                        else ProfilerActivity.CPU])
        self.p0 = time.perf_counter()
        self.prof.start()

    def _stop_profile(self) -> None:
        synchronize(self.device)
        self.prof.stop()
        self.p1 = time.perf_counter()
        self.profiled, self.prof = self.prof, None

    def close(self) -> None:
        if self.prof is not None:
            self._stop_profile()
        synchronize(self.device)
        self.t1 = time.perf_counter()

    @property
    def elapsed(self) -> float:
        return self.t1 - self.t0

    def before(self, t: float) -> bool:
        """Whether the host time ``t`` comes before the profiled stretch
        (always, on an untraced run)."""
        return self.p0 is None or t < self.p0

    @property
    def unprofiled_s(self) -> float:
        """The window's seconds before the profiled stretch."""
        return (self.p0 if self.p0 is not None else self.t1) - self.t0

    def profile_summary(self) -> Optional[Dict[str, Any]]:
        return (summarize_profile(self.profiled)
                if self.profiled is not None else None)


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(x) for x in out]


def _is_device(event) -> bool:
    from torch.autograd import DeviceType

    return (event.device_type == DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False)
            and not event.name.startswith(SPAN_PREFIX))


def summarize_profile(prof) -> Dict[str, Any]:
    """What a per-layer reader needs of one profiled stretch, in seconds:
    ``window_s`` (first to last event), ``busy_s`` (any device operation:
    kernels, copies, sets), ``kernel_busy_s`` (kernels alone), ``ops``
    (device time and count by operation name) and ``idle`` (the gaps with
    no kernel running, summed by what the host was doing: the outermost
    host operation or CUDA runtime call around the gap's middle, else the
    ``bench.`` span, else the device operation the gap ends in)."""
    events = list(prof.events())
    if not events:
        return {"window_s": 0.0, "busy_s": 0.0, "kernel_busy_s": 0.0,
                "ops": {}, "idle": {}}
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    device = [e for e in events if _is_device(e)]
    kernels = [e for e in device
               if not e.name.startswith(("Memcpy", "Memset"))]
    ops: Dict[str, List[float]] = {}
    for e in device:
        rec = ops.setdefault(e.name, [0.0, 0])
        rec[0] += (e.time_range.end - e.time_range.start) / 1e6
        rec[1] += 1
    busy = _union([(e.time_range.start, e.time_range.end) for e in device])
    kbusy = _union([(e.time_range.start, e.time_range.end) for e in kernels])
    host = [e for e in events if not _is_device(e)]
    spans = [e for e in host if e.name.startswith(SPAN_PREFIX)]
    main = spans[0].thread if spans else None
    top = sorted((e.time_range.start, e.time_range.end, e.name) for e in host
                 if e.cpu_parent is None and not e.name.startswith(
                     SPAN_PREFIX) and (main is None or e.thread == main))
    marks = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in spans)
    starts = sorted((e.time_range.start, e.name) for e in device)
    idle: Dict[str, float] = {}
    edges = [lo] + [x for iv in kbusy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = _covering(top, mid) or _covering(marks, mid)
        if label is None:
            i = bisect.bisect_left(starts, (b, ""))
            label = (f"before {starts[i][1]}" if i < len(starts)
                     else "host outside any operation")
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return {"window_s": (hi - lo) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "kernel_busy_s": sum(b - a for a, b in kbusy) / 1e6,
            "ops": ops, "idle": idle}


def _covering(intervals: List[tuple], t: float) -> Optional[str]:
    """The name of the innermost interval (latest start) that covers ``t``
    among the first 64 that start before it."""
    i = bisect.bisect_right(intervals, (t, float("inf"), "")) - 1
    for j in range(i, max(i - 64, -1), -1):
        start, end, name = intervals[j]
        if start <= t <= end:
            return name
    return None


@dataclass
class Run:
    """What a driver hands back, and what every per-layer reader reads."""

    cell: Cell
    cfg: Any  # the port's Config
    device: Any
    window_s: float
    setup_s: float
    e2e: Dict[str, float]  # end-to-end values the driver measured
    work: Dict[str, float]  # questions, rows, steps, batch: counts
    attempted: int
    failed: int
    checks: Dict[str, float]  # correctness numbers, by the cell's limits
    memory_peak_bytes: int
    profiles: List[Optional[Dict[str, Any]]] = field(default_factory=list)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    controls: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # on a traced run, the host-clock values over the window before the
    # profiled stretch: "seconds", and "questions" and "serve_p95_ms", or
    # "rows"
    unprofiled: Dict[str, float] = field(default_factory=dict)

    @property
    def profile(self) -> Optional[Dict[str, Any]]:
        """Rank 0's profiled stretch (None on an untraced run)."""
        return self.profiles[0] if self.profiles else None

    @property
    def counts(self):
        return load_module(self.cell.bench / "counts"
                           / f"{self.cell.config_name}.py",
                           "counts." + self.cell.config_name)

    @property
    def peaks(self) -> Dict[str, float]:
        return load_json(BENCH / "peaks.json")


def kernel_time(profile: Dict[str, Any], patterns) -> tuple:
    """(seconds, launches by pattern) of the device operations whose names
    match one of the regular expressions ``patterns``."""
    import re

    compiled = [re.compile(p) for p in patterns]
    total, counts = 0.0, [0] * len(compiled)
    for name, (sec, n) in profile["ops"].items():
        for i, c in enumerate(compiled):
            if c.search(name):
                total += sec
                counts[i] += n
                break
    return total, counts


def bound_s(op: Dict[str, float], peaks: Dict[str, float]) -> float:
    """The least time the card could take for ``op`` ({"bf16", "f32":
    operations, "bytes": moved}): its operations, each type at its peak,
    or its bytes at the memory's rate, whichever is longer."""
    ops = (op.get("bf16", 0.0) / peaks["bf16_flops_per_s"]
           + op.get("f32", 0.0) / peaks["f32_flops_per_s"])
    return max(ops, op.get("bytes", 0.0) / peaks["hbm_bytes_per_s"])


def read_per_layer(run: Run) -> Dict[str, Dict[str, Any]]:
    """Each per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in run.cell.per_layer:
        reader = load_module(run.cell.bench / "metrics" / f"{m['name']}.py",
                             "metric." + m["name"])
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(profile: Dict[str, Any]) -> Dict[str, list]:
    top = sorted(profile["ops"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(profile["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:160], sec] for name, (sec, _) in top],
            "idle_gaps": [[name[:160], sec] for name, sec in gaps]}


def card_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def device_record(run: Run, trace: bool) -> Dict[str, Any]:
    import torch

    dev = torch.device(run.device)
    rec: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type),
        "count": run.cell.chips,
        "memory_peak_bytes": int(run.memory_peak_bytes),
    }
    if dev.type == "cuda":
        line = card_line()
        if line:
            rec["card"] = line
    if trace:
        found = [p for p in run.profiles if p is not None]
        if found:
            rec["busy_s"] = statistics.fmean(p["busy_s"] for p in found)
            rec["window_s"] = found[0]["window_s"]
    return rec


def result(run: Run, trace: bool) -> Dict[str, Any]:
    """The result line. With ``trace`` the per-layer metrics, without it the
    end-to-end ones; ``checks`` (each correctness number beside its limit)
    comes last."""
    correct = (bool(run.checks) and run.failed == 0
               and all(run.checks[k] <= v for k, v in run.cell.limits.items()
                       if k in run.checks)
               and set(run.cell.limits) <= set(run.checks))
    if trace:
        metrics = read_per_layer(run)
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in run.cell.end_to_end if m["name"] in values}
    line: Dict[str, Any] = {"correct": correct, "attempted": run.attempted,
                            "failed": run.failed, "metrics": metrics,
                            "device": device_record(run, trace)}
    if trace and run.profile is not None:
        line["breakdown"] = breakdown(run.profile)
    line["checks"] = {k: {"value": run.checks.get(k), "limit": v}
                      for k, v in run.cell.limits.items()}
    return line


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation, of all values."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
