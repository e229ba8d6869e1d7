"""The host's kernel-launch and graph-launch calls to the CUDA runtime
in the traced window (the profiler's runtime events whose name holds
``Launch``), per training step of the window."""


def read(rec):
    trace, steps = rec.get("trace"), rec["counts"].get("steps")
    if not trace or not steps:
        return None
    calls = sum(n for name, n in trace["runtime"].items() if "Launch" in name)
    return calls / steps
