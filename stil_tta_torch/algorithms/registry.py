"""Algorithm name -> class, the port's counterpart of
``stil_tta_tpu/algorithms/registry.py``: all ten names of the JAX
registry. Any other name raises ``ValueError``, as the JAX registry
does."""

from __future__ import annotations

from stil_tta_torch.algorithms.comatch import CoMatch
from stil_tta_torch.algorithms.cotrain import CoTrain, CoTrainSAINT
from stil_tta_torch.algorithms.freematch import FreeMatch
from stil_tta_torch.algorithms.mmatch import MMatch
from stil_tta_torch.algorithms.simmatch import SimMatch
from stil_tta_torch.algorithms.stil import STiL, STiL_SAINT
from stil_tta_torch.algorithms.supervised import Supervised
from stil_tta_torch.algorithms.tabular_eval import TabularEval

ALGORITHMS = {"STiL": STiL, "STiL_SAINT": STiL_SAINT, "MMatch": MMatch,
              "CoTrain_Pseudo": CoTrain,
              "CoTrain_Pseudo_SAINT": CoTrainSAINT, "SimMatch": SimMatch,
              "CoMatch": CoMatch, "FreeMatch": FreeMatch,
              "Supervised": Supervised, "TabularEval": TabularEval}


def get_algorithm(name: str) -> type:
    if name in ALGORITHMS:
        return ALGORITHMS[name]
    raise ValueError(f"Algorithm name not found: {name}")
