"""Steps of the window replayed in a CUDA graph, as a share of all its
training steps (the harness's own count of the dispatcher's route)."""


def read(rec):
    steps = rec["counts"].get("steps")
    if not steps:
        return None
    return 100.0 * rec["counts"].get("steps_graphed", 0) / steps
