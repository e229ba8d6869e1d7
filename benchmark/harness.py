"""The harness: finds a cell's files by name, runs its traffic driver,
reduces the trace, reads the per-layer metrics and prints the result.

Everything a cell needs is found by the names in ``BENCHMARK.json``:

- the cell ``<w>``: ``workloads/<w>.json`` (the limits of its check);
- its configuration ``<c>``: ``configs/<c>.json`` (the sizes as run);
- its traffic mix ``<t>``: ``traffic/<t>.json``, whose ``driver`` names
  the general code that runs that kind of traffic, ``drivers/<d>.py``;
- each per-layer metric ``<m>``: ``metrics/<b>.py``, where ``<b>`` is
  the name up to its first dot (``device_idle_pct.tta`` and
  ``device_idle_pct.train`` share ``device_idle_pct.py``), whose
  ``read(rec)`` returns the value or None when the run holds nothing to
  read.

A driver's ``run(run)`` builds the system under test, warms it, measures
the window inside ``run.window()``, sets its end-to-end values by base
name in ``run.values`` (``setup_s`` is set by the window), and then
checks what the window produced against the plain reference
(``run.check``).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "stil_tta_tpu")
MAX_BREAKDOWN = 10


def process_start_s() -> float:
    """The process's start on the wall clock (``/proc/self/stat``), or
    the import of this module where that cannot be read."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        btime = next(int(line.split()[1]) for line in
                     Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + int(fields[19]) / ticks
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole (``stil_tta_torch`` is not ``stil_tta_tpu``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file ``path`` under ``name`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell's spec entries and files, found by name under ``bench``."""

    def __init__(self, spec: dict, name: str, bench: Path = BENCH):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.spec, self.name, self.bench = spec, name, bench
        self.entry = cells[name]
        self.workload = load_json(bench / "workloads" / f"{name}.json")
        self.config = load_json(
            bench / "configs" / f"{self.entry['config']}.json")
        self.mix = load_json(
            bench / "traffic" / f"{self.entry['traffic']}.json")
        driver = self.mix["driver"]
        self.driver = load_module(bench / "drivers" / f"{driver}.py",
                                  f"bench_driver_{driver}")

    def end_to_end(self) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        return [m for m in self.spec["per_layer"]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        base = base_name(metric)
        return load_module(self.bench / "metrics" / f"{base}.py",
                           "bench_metric_" + base).read


def base_name(metric: str) -> str:
    """A metric's name up to its first dot: the name of its reader, and
    of the value a driver gives for it."""
    return metric.split(".", 1)[0]


class Run:
    """One run of one cell: its arguments, the clock, spans, counters,
    the trace summary and the check's readings."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", started: Optional[float] = None):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device = bool(trace), device
        self.started = process_start_s() if started is None else started
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.counts: Dict[str, float] = {}
        self.spans: Dict[str, List[float]] = {}
        self.marks: List[tuple] = []        # (name, start_ns, end_ns)
        self.checks: Dict[str, dict] = {}
        self.summary: Optional[dict] = None
        self.memory_peak = 0
        self.attempted = 0
        self.failed = 0
        self.values: Dict[str, float] = {}   # end-to-end, by base name
        self.phases: Dict[str, float] = {}
        self._phase_at = self.started

    def phase(self, name: str) -> None:
        """Close a named phase of the set-up (wall seconds since the last
        one, or since the process started)."""
        now = time.time()
        self.phases[name] = now - self._phase_at
        self._phase_at = now

    # --- the window -------------------------------------------------
    def sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def window(self):
        """The measured window: the set-up time is read at its start, the
        device drained at both ends, and with ``trace`` the profiler runs
        over it (started before the clock)."""
        self.sync()
        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] if self.device == "cpu" else \
                [ProfilerActivity.CUDA]
            prof = profile(activities=acts)
            prof.__enter__()
        t0 = time.time()
        self.setup_s = t0 - self.started
        self.values["setup_s"] = self.setup_s
        self.t0_ns = time.time_ns()
        try:
            yield self
        finally:
            self.sync()
            self.t1_ns = time.time_ns()
            self.window_s = (self.t1_ns - self.t0_ns) / 1e9
            if prof is not None:
                prof.__exit__(None, None, None)
                from tracesum import summarize
                self.summary = summarize(prof, self.t0_ns, self.t1_ns,
                                         self.marks)

    def over(self) -> bool:
        return time.time_ns() - self.t0_ns >= self.seconds * 1e9

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """A harness span: host clock, drained at both ends with
        ``sync``; kept by name (seconds) and as a mark for the trace."""
        if sync:
            self.sync()
        a = time.time_ns()
        try:
            yield
        finally:
            if sync:
                self.sync()
            b = time.time_ns()
            self.spans.setdefault(name, []).append((b - a) / 1e9)
            self.marks.append((name, a, b))

    def add(self, key: str, n: float = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    # --- the check ----------------------------------------------------
    def check(self, name: str, value: float) -> None:
        """Record a compared number; its limit is the cell's."""
        limit = self.cell.workload["limits"][name]
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] == c["value"] and c["value"] <= c["limit"]
            for c in self.checks.values())

    # --- the result ---------------------------------------------------
    def record(self) -> dict:
        """What the per-layer readers read."""
        return {"cell": self.cell.name, "config": self.cell.config,
                "mix": self.cell.mix, "counts": dict(self.counts),
                "spans": {k: list(v) for k, v in self.spans.items()},
                "window_s": self.window_s, "trace": self.summary}

    def result(self, device_info: dict) -> dict:
        metrics = {}
        if self.trace:
            rec = self.record()
            for m in self.cell.per_layer():
                value = self.cell.reader(m["name"])(rec)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
        else:
            for m in self.cell.end_to_end():
                value = self.values[base_name(m["name"])]
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device = dict(device_info, memory_peak_bytes=int(self.memory_peak))
        out = {"correct": self.correct(), "attempted": int(self.attempted),
               "failed": int(self.failed), "metrics": metrics,
               "device": device}
        if self.trace and self.summary is not None:
            device["busy_s"] = self.summary["busy_s"]
            device["window_s"] = self.window_s
            out["breakdown"] = {
                "device_ops": self.summary["device_ops"][:MAX_BREAKDOWN],
                "idle_gaps": self.summary["idle_gaps"][:MAX_BREAKDOWN]}
        out["checks"] = self.checks
        return out


def checks_text(checks: Dict[str, dict]) -> str:
    return "\n".join(f"check {k}: {v['value']!r} limit {v['limit']!r}"
                     for k, v in checks.items())
