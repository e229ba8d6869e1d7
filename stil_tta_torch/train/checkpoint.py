"""Save and restore a train state (STiL's ``STiLState`` or the comparison
families' ``MatchState``), the port's counterpart of
``stil_tta_tpu/train/checkpoint.py``.

A checkpoint is one file, ``<directory>/<name>``, written by
``torch.save``: the state dicts of the net, the EMA backbone (if any)
and the optimizer, the state's buffers (STiL's prototypes and their
sums; a family's ``extra``, MMatch's memory bank and its write
position), the DA ring, the train metric states, the loss sums, the step
count, and the states of the step's generator and of the device's
default generator (the one the dropout layers draw from), so
:func:`restore_checkpoint` resumes a run exactly.
The config goes beside it as ``<name>_config.json``, as in the JAX
package. Write positions and lengths (the state's 0-dim int64 tensors)
are saved as ints and restored as tensors on the state's device. The
format is the port's own: an Orbax checkpoint of the JAX
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
from stil_tta_torch.train import optim

# the buffers a state may hold; each is saved where the state has it
_BUFFERS = ("prototypes", "prototypes_sum", "prototypes_count", "log_count",
            "extra")
_METRICS = {"acc_train": AccuracyState, "acc_train_u": AccuracyState,
            "auc_train": AUROCState, "auc_train_u": AUROCState}


def _is_position(v) -> bool:
    """A write position or a length of a family's ``extra``: a 0-dim
    int64 tensor."""
    return isinstance(v, torch.Tensor) and v.dim() == 0 \
        and v.dtype == torch.long


def _default_rng_state(device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        return torch.cuda.get_rng_state(device)
    return torch.get_rng_state()


def _set_default_rng_state(device: torch.device, s: torch.Tensor) -> None:
    if device.type == "cuda":
        torch.cuda.set_rng_state(s.cpu(), device)
    else:
        torch.set_rng_state(s.cpu())


def state_tree(state) -> dict:
    """Everything a checkpoint of ``state`` (a ``STiLState`` or a
    ``MatchState``) holds, as a tree of dicts, lists, tensors and
    numbers."""
    device = state.log_count.device
    payload = {
        "net": state.net.state_dict(),
        "ema": None if state.ema is None else state.ema.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
        "default_generator": _default_rng_state(device),
        "da": None if state.da is None else {"queue": state.da.queue,
                                             "ptr": int(state.da.ptr)},
        "log_sums": state.log_sums,
        "step": state.step,
    }
    payload.update({k: getattr(state, k) for k in _BUFFERS
                    if hasattr(state, k)})
    if "extra" in payload:
        payload["extra"] = {k: int(v) if _is_position(v) else v
                            for k, v in payload["extra"].items()}
    payload.update({k: None if getattr(state, k, None) is None
                    else dataclasses.asdict(getattr(state, k))
                    for k in _METRICS})
    return payload


def save_checkpoint(directory: os.PathLike, state, config: Optional[dict]
                    = None, name: str = "best") -> Path:
    """Write ``state`` (a ``STiLState`` or a ``MatchState``) to
    ``<directory>/<name>`` and ``config`` to
    ``<directory>/<name>_config.json``; returns the checkpoint's path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    payload = state_tree(state)
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
    by the algorithm's ``init_state`` for the same config) and return it.
    Raises ``FileNotFoundError`` when there is no such checkpoint."""
    device = state.log_count.device
    payload = torch.load(Path(directory) / name, map_location=device,
                         weights_only=True)
    state.net.load_state_dict(payload["net"])
    if state.ema is not None:
        state.ema.load_state_dict(payload["ema"])
    optim.load_state(state.optimizer, payload["optimizer"])
    state.generator.set_state(payload["generator"].cpu())
    _set_default_rng_state(device, payload["default_generator"])
    if payload["da"] is not None:
        state.da = DAState(payload["da"]["queue"], torch.tensor(
            int(payload["da"]["ptr"]), dtype=torch.long, device=device))
    state.log_sums = dict(payload["log_sums"])
    state.step = int(payload["step"])
    for k in _BUFFERS:
        if hasattr(state, k):
            setattr(state, k, payload[k])
    if hasattr(state, "extra"):
        state.extra = {k: torch.tensor(v, dtype=torch.long, device=device)
                       if isinstance(v, int) else v
                       for k, v in state.extra.items()}
    for k, cls in _METRICS.items():
        if hasattr(state, k):
            setattr(state, k,
                    None if payload[k] is None else cls(**payload[k]))
    return state


def load_checkpoint_config(directory: os.PathLike,
                           name: str = "best") -> dict:
    with open(Path(directory) / f"{name}_config.json") as f:
        return json.load(f)
