"""Test-time adaptation: the port of ``stil_tta_tpu/tta/tent.py``.

Every strategy starts with BN-adapt, :func:`estimate_bn_stats`: it
re-estimates every BatchNorm's running statistics on the (shifted) test
data in one momentum sweep. The JAX package runs the whole net with
``train=True`` and inverts flax's running-stat blend, ``(new −
0.9·old)/0.1``, to recover the batch statistics before applying
``tta_momentum``. The port takes the batch mean and unbiased variance
straight from the ``bn_stats`` sums and applies ``tta_momentum`` once:
the same value, without the tenfold amplification of the blend's
round-off. Only the image tower holds BatchNorms, and everything after
it (tabular encoder, fusion, heads, the fusion's dropout) cannot reach
their statistics, so the stats pass runs the image tower alone.

Then ``tent`` (:func:`_tent_phase`) minimises the mean entropy of the
multimodal head over test batches with Adam on the BatchNorm affine
parameters alone; ``eata`` and ``sar`` (``tta/methods.py``) filter and
weight the samples. Adaptation runs the net in eval mode with autograd
on: dropout is off and BatchNorm reads the re-estimated running
statistics, as the JAX package's ``train=False`` forward does.

The adapted statistics and parameters are written into the net in place.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from stil_tta_torch.algorithms.match_common import image_tower
from stil_tta_torch.data.loader import EpochSampler
from stil_tta_torch.ops.batch_norm import BatchNorm2d, StatsFn, bn_stats
from stil_tta_torch.train import optim
from stil_tta_torch.train.optim import build_optimizer

STRATEGIES = ("tent", "bn_adapt", "eata", "sar")

Tensor = torch.Tensor


def knob(value, default):
    """``None -> default``; an explicit 0 is a real value."""
    return default if value is None else value


def bn_parameters(net: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """The parameters TTA adapts, by name: the weight and bias of every
    :class:`BatchNorm2d`. The port of ``bn_param_mask``, whose name rule
    (``bn*`` and ``*_bn``) picks the same modules out of the JAX tree; the
    downsample BN, ``downsample_bn`` there, is ``downsample.1`` here."""
    return [(f"{name}.{p}", getattr(mod, p))
            for name, mod in net.named_modules()
            if isinstance(mod, BatchNorm2d) for p in ("weight", "bias")]


def entropy(probs: Tensor) -> Tensor:
    return -torch.sum(probs * torch.log(probs + 1e-12), dim=-1)


def accepts_missing_mask(net: nn.Module) -> bool:
    """Whether the network's ``forward`` takes a ``missing_mask``."""
    try:
        return "missing_mask" in inspect.signature(
            type(net).forward).parameters
    except (TypeError, ValueError):
        return False


def missing_kw(missing: Optional[Tensor], net: nn.Module = None) -> dict:
    """``missing_mask`` keyword for the forward: empty without a mask, and
    also when ``net`` is given but its ``forward`` takes none."""
    if missing is None or (net is not None
                           and not accepts_missing_mask(net)):
        return {}
    return {"missing_mask": missing}


def tta_batches(cache: dict, batch_size: int, seed: int = 0
                ) -> Iterator[Tuple[Tensor, Tensor, Optional[Tensor]]]:
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


def head_logits(algo, images: Tensor, tabular: Tensor,
                missing: Optional[Tensor]) -> Tensor:
    """The multimodal head's logits in float32, from the eval-mode
    backbone: ``out_m`` depends on the backbone alone, so the projectors
    and CLUB estimators of the full net are not run."""
    net = algo.net.model
    outs = net(algo.aug_eval(images), tabular, **missing_kw(missing, net))
    return outs["out_m"].float()


@contextlib.contextmanager
def bn_affine_only(net: nn.Module) -> Iterator[List[nn.Parameter]]:
    """Inside, gradients reach only the BatchNorm affine parameters of
    ``net`` (the list yielded), in eval mode with autograd on; the other
    parameters' ``requires_grad`` flags come back on exit. With an Adam
    over the list (``train.optim.build_optimizer``) this is the JAX
    package's ``_masked_tx``: Adam on the masked leaves, the rest held."""
    params = [p for _, p in bn_parameters(net)]
    saved = [(p, p.requires_grad) for p in net.parameters()]
    net.requires_grad_(False)
    for p in params:
        p.requires_grad_(True)
    net.eval()
    try:
        with torch.enable_grad():
            yield params
    finally:
        for p, flag in saved:
            p.requires_grad_(flag)


def adapt(cfg, algo, cache: dict, stats: StatsFn = bn_stats
          ) -> Dict[str, int]:
    """Adapt ``algo.net`` on the (unlabelled) test cache, in place.
    Returns counts of what ran: the stats batches, the adaptation steps,
    and for EATA and SAR the samples their filters selected (SAR's second
    filter) and SAR's recovery resets."""
    strategy = knob(cfg.tta_strategy, "tent")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown tta_strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")
    if strategy != "bn_adapt" and not algo.entropy_tta:
        # these nets return a tuple of heads or bare logits; the JAX
        # package's entropy phases index the output by "out_m" and fail,
        # and no head is picked here that the reference never picked
        raise ValueError(
            f"tta_strategy={strategy} needs the multimodal head of STiL's "
            f"net; {algo.name}'s net returns no head by that name and "
            f"supports tta_strategy=bn_adapt only, as the JAX package does")
    counts = {"stats_batches": estimate_bn_stats(cfg, algo, cache, stats)}
    if strategy in ("eata", "sar"):
        from stil_tta_torch.tta import methods
        counts.update((methods.eata_adapt if strategy == "eata"
                       else methods.sar_adapt)(cfg, algo, cache))
    elif strategy == "tent":
        counts.update(_tent_phase(cfg, algo, cache))
    return counts


@torch.no_grad()
def estimate_bn_stats(cfg, algo, cache: dict,
                      stats: StatsFn = bn_stats) -> int:
    """BN-statistics re-estimation on the test cache (one momentum sweep
    of ``tta_momentum``); returns the number of batches. ``stats``
    computes the per-channel sums: the ``bn_stats`` kernel unless a
    caller passes another function to compare with. A net without an
    image tower has no statistics: no batch runs."""
    momentum = float(knob(cfg.tta_momentum, 0.1))
    tower = image_tower(algo.net)
    if tower is None:
        # no BatchNorm (TabularNet): the JAX sweep runs and changes nothing
        return 0
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


def _tent_phase(cfg, algo, cache: dict) -> Dict[str, int]:
    """Tent: entropy minimisation of the multimodal head with Adam
    (``tta_lr``) on the BN affine parameters, ``tta_steps`` epochs over
    the test cache, a fresh permutation each epoch."""
    lr = float(knob(cfg.tta_lr, 1e-4))
    steps = int(knob(cfg.tta_steps, 1))
    n = 0
    with bn_affine_only(algo.net) as params:
        opt = build_optimizer(params, lr)
        for ep in range(steps):
            for images, tabular, missing in tta_batches(
                    cache, int(cfg.batch_size), seed=ep):
                logits = head_logits(algo, images, tabular, missing)
                loss = entropy(torch.softmax(logits, dim=1)).mean()
                opt.zero_grad(set_to_none=True)
                loss.backward()
                optim.step(opt)
                n += 1
    return {"steps": n}
