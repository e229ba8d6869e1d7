"""Optimizer and learning-rate schedules, the port of
``stil_tta_tpu/train/optim.py``.

The optimizer is ``torch.optim.Adam`` at ``lr_eval`` with betas (0.9,
0.999), eps 1e-8 and L2 weight decay folded into the gradient before the
moments (not AdamW): the semantics of the JAX package's optax chain
(``add_decayed_weights`` -> ``scale_by_adam`` -> learning rate) and of
the reference. The learning rate is set per epoch on the param groups
(:func:`set_learning_rate`); the schedules are host-side functions of the
epoch, copied from the JAX package.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch


def build_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                    weight_decay: float = 0.0, freeze: bool = False,
                    mu_dtype=None) -> torch.optim.Adam:
    """torch Adam with the JAX package's defaults. The encoder freeze of
    ``finetune_strategy: frozen`` and a bfloat16 first moment
    (``adam_mu_dtype``) are not ported."""
    if freeze:
        raise NotImplementedError(
            "finetune_strategy=frozen with a warm-start checkpoint is not "
            "ported to stil_tta_torch yet (ROADMAP.md)")
    if mu_dtype is not None:
        raise NotImplementedError(
            f"adam_mu_dtype={mu_dtype!r} (the fast numerics profile) is not "
            f"ported to stil_tta_torch yet (ROADMAP.md)")
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def step(opt: torch.optim.Optimizer) -> None:
    """``opt.step()`` where a parameter the loss did not reach takes a zero
    gradient, as under ``jax.grad``: Adam then still decays its moments,
    moves it by them and applies weight decay to it."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def cosine_lr(base_lr: float, epoch: int, t_max: int,
              eta_min: float = 0.0) -> float:
    """CosineAnnealingLR(T_max) (``STiLModel.py:581``)."""
    return eta_min + (base_lr - eta_min) * (
        1 + math.cos(math.pi * epoch / max(t_max, 1))) / 2


def warmup_cosine_lr(base_lr: float, epoch: int, warmup_epochs: int,
                     max_epochs: int, warmup_start_lr: float = 0.0,
                     eta_min: float = 0.0) -> float:
    """LinearWarmupCosineAnnealingLR (``STiLModel.py:583``)."""
    if warmup_epochs > 0 and epoch < warmup_epochs:
        if warmup_epochs == 1:
            return base_lr
        return warmup_start_lr + (base_lr - warmup_start_lr) * epoch / (
            warmup_epochs - 1)
    span = max(max_epochs - warmup_epochs, 1)
    t = (epoch - warmup_epochs) % (2 * span)
    return eta_min + (base_lr - eta_min) * (
        1 + math.cos(math.pi * t / span)) / 2


class PlateauScheduler:
    """ReduceLROnPlateau(patience, factor=0.1, min_lr)
    (``STiLModel.py:585``): host-side, monitors the val metric."""

    def __init__(self, base_lr: float, patience: int, min_lr: float,
                 factor: float = 0.1, mode: str = "min"):
        self.lr = base_lr
        self.patience = patience
        self.min_lr = min_lr
        self.factor = factor
        self.mode = mode
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        improved = (self.best is None
                    or (self.mode == "min" and metric < self.best)
                    or (self.mode == "max" and metric > self.best))
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


def scheduled_lr(cfg, epoch: int, val_metric: Optional[float] = None,
                 plateau: Optional[PlateauScheduler] = None) -> float:
    """Dispatch on cfg.scheduler exactly as ``STiLModel.py:579-589``."""
    base_lr = cfg.lr_eval if cfg.lr_eval is not None else cfg.lr
    sched = cfg.scheduler
    if sched == "cosine":
        t_max = int((cfg.dataset_length or 1) * (cfg.cosine_anneal_mult or 1))
        return cosine_lr(base_lr, epoch, t_max)
    if sched == "anneal":
        max_epochs = cfg.anneal_max_epochs or cfg.max_epochs
        return warmup_cosine_lr(base_lr, epoch, cfg.warmup_epochs or 0,
                                max_epochs)
    if sched == "linear":
        if plateau is None:
            raise ValueError("scheduler 'linear' needs a PlateauScheduler")
        if val_metric is None:
            return plateau.lr
        return plateau.step(val_metric)
    raise ValueError(f'Valid schedulers are "cosine", "anneal", "linear"; '
                     f"got {sched}")
