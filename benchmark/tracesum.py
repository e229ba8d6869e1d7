"""Reduce a ``torch.profiler`` trace of the window to what the metrics
read: the device's busy time (the union of its operations' intervals:
kernels, copies, fills), each kernel's time and count by name, the
host's CUDA runtime calls by name, and the idle gaps labelled by the
harness span the host was in and whether it was calling the runtime.

The raw Kineto events are read directly (``kineto_results.events()``),
not through ``key_averages``: a window holds up to a few million events.
Their timestamps are on the wall clock, as the harness's spans are.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

NAME_CHARS = 120


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def device_events(prof) -> Tuple[List[tuple], List[tuple]]:
    """(device ops, runtime calls) as (name, start_ns, end_ns) lists. On
    a CPU-only trace (the tests) the top-level ``aten::`` ops stand in for
    the device's operations."""
    from torch.autograd import DeviceType
    ops, calls = [], []
    events = prof.profiler.kineto_results.events()
    has_cuda = any(e.device_type() == DeviceType.CUDA for e in events)
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((name, start, end))
        elif name.startswith("cuda") or name.startswith("cuLaunch"):
            calls.append((name, start, end))
        elif not has_cuda and name.startswith("aten::"):
            ops.append((name, start, end))
    return ops, calls


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def gaps(busy: Sequence[Tuple[int, int]], t0: int, t1: int
         ) -> List[Tuple[int, int]]:
    """The idle intervals of [t0, t1] between the merged busy ones."""
    out, at = [], t0
    for a, b in busy:
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
    if at < t1:
        out.append((at, t1))
    return [(a, b) for a, b in out if b > a]


def label_gaps(idle: Sequence[Tuple[int, int]], marks: Sequence[tuple],
               calls: Sequence[tuple]) -> List[list]:
    """Idle seconds by what the host was doing: the innermost harness
    span around a gap's middle, and whether the host called the CUDA
    runtime during the gap."""
    starts = sorted(c[1] for c in calls)
    marks = sorted(marks, key=lambda m: m[1])
    mark_starts = [m[1] for m in marks]
    totals: Dict[str, float] = {}
    for a, b in idle:
        mid = (a + b) // 2
        i = bisect.bisect_right(mark_starts, mid) - 1
        # the latest-starting span that still covers the middle
        span = "outside spans"
        for m in marks[max(i - 3, 0):i + 1][::-1]:
            if m[1] <= mid <= m[2]:
                span = m[0]
                break
        n = bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
        label = f"{span}; " + ("host calling the CUDA runtime" if n
                               else "no CUDA call from the host")
        totals[label] = totals.get(label, 0.0) + (b - a) / 1e9
    return sorted(([k, v] for k, v in totals.items()), key=lambda x: -x[1])


def summarize(prof, t0_ns: int, t1_ns: int, marks: Sequence[tuple]) -> dict:
    ops, calls = device_events(prof)
    busy = union([(a, b) for _, a, b in ops])
    busy_ns = sum(b - a for a, b in busy)
    kernels: Dict[str, List[float]] = {}
    for name, a, b in ops:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e9
    runtime: Dict[str, int] = {}
    for name, _, _ in calls:
        runtime[name] = runtime.get(name, 0) + 1
    first = min((a for a, _ in busy), default=t0_ns)
    last = max((b for _, b in busy), default=t1_ns)
    idle = gaps(busy, min(t0_ns, first), max(t1_ns, last))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {"busy_s": busy_ns / 1e9,
            "kernels": {k: {"count": v[0], "seconds": v[1]}
                        for k, v in kernels.items()},
            "runtime": runtime,
            "device_ops": [[_short(k), v[1]] for k, v in top[:10]],
            "idle_gaps": label_gaps(idle, marks, calls)[:10],
            "events": len(ops) + len(calls)}


def kernel_seconds(summary: dict, tag: str) -> Tuple[int, float]:
    """(count, seconds) of the kernels whose name holds ``tag``."""
    n, s = 0, 0.0
    for name, k in summary["kernels"].items():
        if tag in name:
            n += k["count"]
            s += k["seconds"]
    return n, s
