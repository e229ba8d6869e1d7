"""Algorithm name -> class, the port's counterpart of
``stil_tta_tpu/algorithms/registry.py``, holding the algorithms ported so
far. Any other name raises ``NotImplementedError``."""

from __future__ import annotations

from stil_tta_torch.algorithms.stil import STiL, STiL_SAINT

ALGORITHMS = {"STiL": STiL, "STiL_SAINT": STiL_SAINT}


def get_algorithm(name: str) -> type:
    if name not in ALGORITHMS:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported to stil_tta_torch yet "
            f"(ROADMAP.md); ported: {', '.join(ALGORITHMS)}")
    return ALGORITHMS[name]
