"""Optimizer and learning-rate schedules, the port of
``stil_tta_tpu/train/optim.py``.

The optimizer is ``torch.optim.Adam`` at ``lr_eval`` with betas (0.9,
0.999), eps 1e-8 and L2 weight decay folded into the gradient before the
moments (not AdamW): the semantics of the JAX package's optax chain
(``add_decayed_weights`` -> ``scale_by_adam`` -> learning rate) and of
the reference. With ``adam_mu_dtype: bfloat16`` (the fast numerics
profile) it is :class:`Adam`, which stores the first moment in bfloat16
and follows optax's ``scale_by_adam(mu_dtype=...)`` operation for
operation. The learning rate is set per epoch on the param groups
(:func:`set_learning_rate`); the schedules are host-side functions of the
epoch, copied from the JAX package.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np
import torch


class Adam(torch.optim.Optimizer):
    """Adam with L2 weight decay folded into the gradient, the first
    moment ``exp_avg`` stored in ``mu_dtype`` and the second ``exp_avg_sq``
    in the parameter's dtype: optax's ``add_decayed_weights`` ->
    ``scale_by_adam(mu_dtype=...)`` -> learning rate, in its order of
    operations. The new first moment is formed in the parameter's dtype
    (``b1 * mu`` rounded to ``mu_dtype`` first, as optax's weakly typed
    ``b1 * mu`` is), the update is taken from that value, and only then
    is the moment rounded to ``mu_dtype`` for storage. The interface is
    ``torch.optim.Adam``'s (param groups, ``lr``, ``betas``, ``eps``,
    ``weight_decay``, ``state_dict``)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    def load_state_dict(self, state_dict) -> None:
        """``torch.optim.Optimizer.load_state_dict`` casts every moment to
        its parameter's dtype; the first moment goes back to
        ``mu_dtype`` (exact: it was stored there)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter that has a gradient, each
        group's tensors together (``torch._foreach_*``)."""
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            wd, lr, eps = group["weight_decay"], group["lr"], group["eps"]
            grads = [p.grad for p in params]
            if wd:
                grads = torch._foreach_add(grads,
                                           torch._foreach_mul(params, wd))
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
            count = np.float32(states[0]["step"])
            # optax: (1 - b1) * g + b1 * mu, where b1 * mu is a mu_dtype
            # product (b1 rounded to mu_dtype); bias corrections in float32
            b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            mu = torch._foreach_add(
                torch._foreach_mul(grads, 1 - b1),
                [t.to(g.dtype) for t, g in zip(torch._foreach_mul(
                    [st["exp_avg"] for st in states], b1_mu), grads)])
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                torch._foreach_mul([st["exp_avg_sq"] for st in states], b2))
            bc1 = float(np.float32(1) - np.float32(b1) ** count)
            bc2 = float(np.float32(1) - np.float32(b2) ** count)
            denom = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            torch._foreach_add_(params, torch._foreach_mul(upd, -lr))
            for st, m, v in zip(states, mu, nu):
                st["exp_avg"] = m.to(self.mu_dtype)
                st["exp_avg_sq"] = v
        return None


def build_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                    weight_decay: float = 0.0, freeze: bool = False,
                    mu_dtype=None) -> torch.optim.Optimizer:
    """torch Adam with the JAX package's defaults, or :class:`Adam` when
    ``mu_dtype`` (``adam_mu_dtype``) names a storage dtype of the first
    moment. The encoder freeze of ``finetune_strategy: frozen`` is not
    ported."""
    if freeze:
        raise NotImplementedError(
            "finetune_strategy=frozen with a warm-start checkpoint is not "
            "ported to stil_tta_torch yet (ROADMAP.md)")
    if mu_dtype is not None:
        dtype = getattr(torch, str(mu_dtype)) if isinstance(mu_dtype, str) \
            else mu_dtype
        return Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                    weight_decay=weight_decay, mu_dtype=dtype)
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
