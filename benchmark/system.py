"""The system under test's set-up, shared by the drivers: the port's
configuration as its loader composes it from the configuration file's
YAML, the algorithm on the device, and the benchmark's weights loaded
into it. The configuration file states every value it relies on; a
value the YAML composes otherwise is refused, so the file is the
configuration as it runs."""

from __future__ import annotations

from typing import Dict

import torch

import inputs
from reference import nets


def port_config(conf: dict, seed: int):
    """The port's ``Config`` for the configuration file ``conf``: the
    YAML and dataset group it names, with the file's assumed field
    lengths and the values of the keys it lists as ``reduced``; raises
    ``ValueError`` where the YAML disagrees with any other value the file
    states."""
    from stil_tta_torch.config.loader import load_config
    cfg = load_config(conf["source_yaml"], [f"dataset={conf['dataset']}"])
    for k in ["field_lengths", *conf["reduced"]]:
        cfg[k] = conf["cfg"][k]
    cfg.seed = int(seed)
    off = {k: (v, cfg.get(k)) for k, v in conf["cfg"].items()
           if cfg.get(k) != v}
    if off:
        raise ValueError(f"the configuration file and the port's YAML "
                         f"disagree (file, YAML): {off}")
    return cfg


def weight_layout(conf: dict):
    """(name -> shape, name -> init scale) of the net's state dict, read
    off the reference net built on the meta device."""
    with torch.device("meta"):
        net = nets.STiLNet(conf["cfg"])
    sd = net.state_dict()
    return ({k: tuple(v.shape) for k, v in sd.items()},
            {k: nets.init_scale(k, tuple(v.shape)) for k, v in sd.items()})


def make_weights(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes, scales = weight_layout(conf)
    return inputs.make_weights(shapes, scales, seed, device)


# the dtype the algorithm computes in: the configuration's bfloat16; the
# CPU tests of the check's faults take the port's float32 path
COMPUTE_DTYPE = {"dtype": torch.bfloat16}


def build_algo(cfg, conf: dict, weights: Dict[str, torch.Tensor], device,
               seed: int, train: bool):
    """The port's algorithm for ``cfg`` on ``device`` with ``weights``;
    with ``train`` also its train state (the optimizer of the route the
    config takes, the EMA backbone a copy of the loaded student's)."""
    from stil_tta_torch.algorithms.registry import get_algorithm
    algo = get_algorithm(cfg.algorithm_name)(
        cfg, conf["cfg"]["field_lengths"], dtype=COMPUTE_DTYPE["dtype"],
        device=device)
    state = None
    if train:
        state = algo.init_state(seed)
    algo.net.load_state_dict(weights, strict=True)
    if state is not None and state.ema is not None:
        state.ema.load_state_dict(backbone_part(weights), strict=True)
    return algo, state


def backbone_part(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The backbone's entries (``model.*``) of a net's state dict."""
    return {k[len("model."):]: v for k, v in sd.items()
            if k.startswith("model.")}


def split_sizes(cfg) -> tuple:
    """(labelled, unlabelled) rows of a batch, as ``evaluate`` splits it."""
    batch, ur = int(cfg.batch_size), int(cfg.unlabelled_ratio or 1)
    l_batch = max(batch // (1 + ur), 1)
    return l_batch, batch - l_batch
