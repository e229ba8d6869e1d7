"""Save and restore a STiL train state, the port's counterpart of
``stil_tta_tpu/train/checkpoint.py``.

A checkpoint is one file, ``<directory>/<name>``, written by
``torch.save``: the state dicts of the net, the EMA backbone and the
optimizer, the prototypes and their sums, the DA ring, the train metric
states, the loss sums, the step count, and the states of the step's
generator and of the device's default generator (the one the fusion
dropout draws from), so :func:`restore_checkpoint` resumes a run exactly.
The config goes beside it as ``<name>_config.json``, as in the JAX
package. The format is the port's own: an Orbax checkpoint of the JAX
package does not load here, nor the reverse.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

import torch

from stil_tta_torch.algorithms.base import DAState
from stil_tta_torch.ops.metrics import AccuracyState, AUROCState

_BUFFERS = ("prototypes", "prototypes_sum", "prototypes_count", "log_count")
_METRICS = {"acc_train": AccuracyState, "acc_train_u": AccuracyState,
            "auc_train": AUROCState, "auc_train_u": AUROCState}


def _default_rng_state(device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        return torch.cuda.get_rng_state(device)
    return torch.get_rng_state()


def _set_default_rng_state(device: torch.device, s: torch.Tensor) -> None:
    if device.type == "cuda":
        torch.cuda.set_rng_state(s.cpu(), device)
    else:
        torch.set_rng_state(s.cpu())


def save_checkpoint(directory: os.PathLike, state, config: Optional[dict]
                    = None, name: str = "best") -> Path:
    """Write ``state`` (a :class:`~stil_tta_torch.algorithms.stil.
    STiLState`) to ``<directory>/<name>`` and ``config`` to
    ``<directory>/<name>_config.json``; returns the checkpoint's path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    device = state.prototypes.device
    payload = {
        "net": state.net.state_dict(),
        "ema": None if state.ema is None else state.ema.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
        "default_generator": _default_rng_state(device),
        "da": None if state.da is None else {"queue": state.da.queue,
                                             "ptr": state.da.ptr},
        "log_sums": state.log_sums,
        "step": state.step,
    }
    payload.update({k: getattr(state, k) for k in _BUFFERS})
    payload.update({k: None if getattr(state, k) is None
                    else dataclasses.asdict(getattr(state, k))
                    for k in _METRICS})
    path = directory / name
    tmp = path.with_name(f"{name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if config is not None:
        with open(directory / f"{name}_config.json", "w") as f:
            json.dump(config, f, indent=2, default=str)
    return path


def restore_checkpoint(directory: os.PathLike, state, name: str = "best"):
    """Load ``<directory>/<name>`` into ``state`` in place (a state built
    by ``STiL.init_state`` for the same config) and return it. Raises
    ``FileNotFoundError`` when there is no such checkpoint."""
    device = state.prototypes.device
    payload = torch.load(Path(directory) / name, map_location=device,
                         weights_only=True)
    state.net.load_state_dict(payload["net"])
    if state.ema is not None:
        state.ema.load_state_dict(payload["ema"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.generator.set_state(payload["generator"].cpu())
    _set_default_rng_state(device, payload["default_generator"])
    if payload["da"] is not None:
        state.da = DAState(payload["da"]["queue"], int(payload["da"]["ptr"]))
    state.log_sums = dict(payload["log_sums"])
    state.step = int(payload["step"])
    for k in _BUFFERS:
        setattr(state, k, payload[k])
    for k, cls in _METRICS.items():
        setattr(state, k, None if payload[k] is None else cls(**payload[k]))
    return state


def load_checkpoint_config(directory: os.PathLike,
                           name: str = "best") -> dict:
    with open(Path(directory) / f"{name}_config.json") as f:
        return json.load(f)
