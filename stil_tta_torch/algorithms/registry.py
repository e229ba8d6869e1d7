"""Algorithm name -> class, the port's counterpart of
``stil_tta_tpu/algorithms/registry.py``, holding the algorithms ported so
far. A name the JAX registry knows and the port does not have yet raises
``NotImplementedError``; any other name raises ``ValueError``, as the JAX
registry does."""

from __future__ import annotations

from stil_tta_torch.algorithms.comatch import CoMatch
from stil_tta_torch.algorithms.cotrain import CoTrain, CoTrainSAINT
from stil_tta_torch.algorithms.freematch import FreeMatch
from stil_tta_torch.algorithms.mmatch import MMatch
from stil_tta_torch.algorithms.simmatch import SimMatch
from stil_tta_torch.algorithms.stil import STiL, STiL_SAINT

ALGORITHMS = {"STiL": STiL, "STiL_SAINT": STiL_SAINT, "MMatch": MMatch,
              "CoTrain_Pseudo": CoTrain,
              "CoTrain_Pseudo_SAINT": CoTrainSAINT, "SimMatch": SimMatch,
              "CoMatch": CoMatch, "FreeMatch": FreeMatch}

# the JAX registry's other names (``registry.py:10-41``)
UNPORTED = ("Supervised", "TabularEval")


def get_algorithm(name: str) -> type:
    if name in ALGORITHMS:
        return ALGORITHMS[name]
    if name in UNPORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported to stil_tta_torch yet "
            f"(ROADMAP.md); ported: {', '.join(ALGORITHMS)}")
    raise ValueError(f"Algorithm name not found: {name}")
