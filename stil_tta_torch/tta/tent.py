"""Test-time adaptation: BN-adapt (the part of
``stil_tta_tpu/tta/tent.py`` the test-time path uses).

``bn_adapt`` re-estimates every BatchNorm's running statistics on the
(shifted) test data in one momentum sweep. The JAX package runs the
whole net with ``train=True`` and inverts flax's running-stat blend,
``(new − 0.9·old)/0.1``, to recover the batch statistics before applying
``tta_momentum``. The port takes the batch mean and unbiased variance
straight from the ``bn_stats`` sums and applies ``tta_momentum`` once:
the same value, without the tenfold amplification of the blend's
round-off.

Only the image tower holds BatchNorms, and everything after it
(tabular encoder, fusion, heads, the fusion's dropout) cannot reach
their statistics, so the stats pass runs the image tower alone.

The adapted statistics are written into the net's BN buffers in place.
``tent``, ``eata`` and ``sar`` are still to port and raise.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from stil_tta_torch.data.loader import EpochSampler
from stil_tta_torch.ops.batch_norm import BatchNorm2d, StatsFn, bn_stats

STRATEGIES = ("tent", "bn_adapt", "eata", "sar")


def knob(value, default):
    """``None -> default``; an explicit 0 is a real value."""
    return default if value is None else value


def tta_batches(cache: dict, batch_size: int, seed: int = 0
                ) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                    Optional[torch.Tensor]]]:
    """One shuffled epoch over the test cache with the pad rows REMOVED:
    the tail batch runs at its natural smaller size. Yields
    ``(images, tabular, missing-or-None)``."""
    n = int(cache["labels"].shape[0])
    sampler = EpochSampler(n, batch_size, shuffle=True, drop_last=False,
                           seed=seed)
    device = cache["labels"].device
    missing = cache.get("missing")
    for idx, w in sampler.epoch():
        j = torch.from_numpy(idx[w > 0].astype(np.int64)).to(device)
        yield (cache["images"].index_select(0, j),
               cache["tabular"].index_select(0, j),
               None if missing is None else missing.index_select(0, j))


def adapt(cfg, algo, cache: dict, stats: StatsFn = bn_stats) -> None:
    """Adapt ``algo.net`` on the (unlabelled) test cache, in place."""
    strategy = knob(cfg.tta_strategy, "tent")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown tta_strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")
    if strategy != "bn_adapt":
        raise NotImplementedError(
            f"tta_strategy {strategy!r} is not ported to stil_tta_torch "
            f"yet (ROADMAP.md); only 'bn_adapt' is")
    estimate_bn_stats(cfg, algo, cache, stats)


@torch.no_grad()
def estimate_bn_stats(cfg, algo, cache: dict,
                      stats: StatsFn = bn_stats) -> int:
    """BN-statistics re-estimation on the test cache (one momentum sweep
    of ``tta_momentum``); returns the number of batches. ``stats``
    computes the per-channel sums: the ``bn_stats`` kernel unless a
    caller passes another function to compare with."""
    momentum = float(knob(cfg.tta_momentum, 0.1))
    tower = algo.net.model.encoder_imaging
    bns = [m for m in tower.modules() if isinstance(m, BatchNorm2d)]
    saved = [(m.momentum, m.stats) for m in bns]
    for m in bns:
        m.momentum, m.stats = momentum, stats
    tower.train()
    n_batches = 0
    try:
        for images, _, _ in tta_batches(cache, int(cfg.batch_size)):
            tower(algo.aug_eval(images))
            n_batches += 1
    finally:
        tower.eval()
        for m, (mom, fn) in zip(bns, saved):
            m.momentum, m.stats = mom, fn
    return n_batches
