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

A run whose train step is captured (``train/multistep.py``) builds its
optimizer ``capturable``: the learning rate is a device tensor that
:func:`set_learning_rate` fills, the step counts live on the card
(:class:`CapturableAdam`, torch's capturable Adam with its bias
corrections computed once a step; :class:`Adam` counts on the
parameters' device) and the moments are updated in place. The same
optimizer then runs that run's eager steps too, so an eager step and a
replay do the same arithmetic. Every other optimizer (the CPU's, the
routes that are not captured, test-time adaptation) keeps a number for
its learning rate and its step counts on the host.

The encoder freeze of ``finetune_strategy: frozen`` (JAX
``optax.masked(set_to_zero, encoder_freeze_fn)`` after weight decay, Adam
and the learning rate) is a second param group, ``frozen``, at learning
rate 0 that the schedules leave alone: its parameters never move, their
gradients still pass through weight decay into the Adam moments, and the
moments, like JAX's, go into checkpoints.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional

import numpy as np
import torch

from stil_tta_torch.parallel import collectives


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
    ``weight_decay``, ``state_dict``, ``capturable``). A ``capturable``
    group takes a 0-dim tensor ``lr`` on the parameters' device and
    counts its steps there (bias corrections ``powf`` on the card);
    otherwise the count is a host tensor and the bias corrections numpy
    float32 powers. The moments are written in place either way."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype: torch.dtype = torch.bfloat16,
                 capturable: bool = False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      capturable=capturable))
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
            capturable = group["capturable"]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = torch.zeros(
                        (), dtype=torch.float32,
                        device=p.device if capturable else "cpu")
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p)
            torch._foreach_add_([st["step"] for st in states], 1.0)
            # optax: (1 - b1) * g + b1 * mu, where b1 * mu is a mu_dtype
            # product (b1 rounded to mu_dtype); bias corrections in float32
            if capturable:   # powf on the card
                count = states[0]["step"]
                bc1 = 1 - torch.pow(b1, count)
                bc2 = 1 - torch.pow(b2, count)
            else:
                count = np.float32(states[0]["step"])
                bc1 = float(np.float32(1) - np.float32(b1) ** count)
                bc2 = float(np.float32(1) - np.float32(b2) ** count)
            b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            mu = torch._foreach_add(
                torch._foreach_mul(grads, 1 - b1),
                [t.to(g.dtype) for t, g in zip(torch._foreach_mul(
                    [st["exp_avg"] for st in states], b1_mu), grads)])
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                torch._foreach_mul([st["exp_avg_sq"] for st in states], b2))
            denom = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            torch._foreach_add_(params, torch._foreach_mul(upd, -lr))
            torch._foreach_copy_([st["exp_avg"] for st in states], mu)
            torch._foreach_copy_([st["exp_avg_sq"] for st in states], nu)
        return None


class CapturableAdam(torch.optim.Adam):
    """``torch.optim.Adam(capturable=True)`` (L2 weight decay, no
    amsgrad, no maximize), its multi-tensor update operation for
    operation (``torch.optim.adam._multi_tensor_adam``), with the bias
    corrections computed once a param group and step where torch
    computes them once a parameter: every parameter of a group has taken
    the same steps, so torch's per-parameter corrections are one value,
    and a step launches two ``pow`` kernels where torch's launch two a
    parameter. The update is bit for bit torch's on the same inputs; the
    state (``step`` on the parameters' device, ``exp_avg``,
    ``exp_avg_sq``) and ``state_dict`` are torch's."""

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("CapturableAdam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            if not group["capturable"] or group["amsgrad"] \
                    or group["maximize"] or group["decoupled_weight_decay"]:
                raise ValueError("CapturableAdam: a capturable group with L2 "
                                 "weight decay only")
            b1, b2 = group["betas"]
            wd, lr, eps = group["weight_decay"], group["lr"], group["eps"]
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = torch.zeros((), dtype=_scalar_dtype(),
                                             device=p.device)
                    st["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            steps = [st["step"] for st in states]
            exp_avgs = [st["exp_avg"] for st in states]
            exp_avg_sqs = [st["exp_avg_sq"] for st in states]
            grads = [p.grad for p in params]
            torch._foreach_add_(steps, 1)
            if wd != 0:
                grads = torch._foreach_add(grads, params, alpha=wd)
            torch._foreach_lerp_(exp_avgs, grads, 1 - b1)
            torch._foreach_mul_(exp_avg_sqs, b2)
            torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - b2)
            # step_size = lr / (b1^t - 1), bc2_sqrt = sqrt(1 - b2^t): torch's
            # sequence, on one count
            step_size = torch.pow(b1, steps[0]).sub_(1).div_(lr).reciprocal_()
            bc2_sqrt = torch.pow(b2, steps[0]).sub_(1).neg_().sqrt_()
            denom = torch._foreach_sqrt(exp_avg_sqs)
            torch._foreach_div_(denom, bc2_sqrt)
            torch._foreach_add_(denom, eps)
            torch._foreach_div_(denom, step_size)
            torch._foreach_addcdiv_(params, exp_avgs, denom)
        return None


def _scalar_dtype() -> torch.dtype:
    """The dtype of torch's Adam step counts."""
    return torch.float64 if torch.get_default_dtype() == torch.float64 \
        else torch.float32


ENCODERS = ("encoder_imaging", "encoder_tabular")


def frozen_parameters(cfg, net: torch.nn.Module
                      ) -> List[torch.nn.Parameter]:
    """With ``finetune_strategy: frozen`` and a ``checkpoint``
    (``algorithms/stil.py:218-220``, ``match_common.py:129-131``), the
    parameters under a module named ``encoder_imaging`` or
    ``encoder_tabular`` anywhere in ``net`` (JAX ``encoder_freeze_fn``);
    else none."""
    if cfg.finetune_strategy != "frozen" or not cfg.checkpoint:
        return []
    return [p for name, p in net.named_parameters()
            if any(part in ENCODERS for part in name.split("."))]


def build_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                    weight_decay: float = 0.0,
                    frozen: Iterable[torch.nn.Parameter] = (),
                    mu_dtype=None, capturable: bool = False
                    ) -> torch.optim.Optimizer:
    """torch Adam with the JAX package's defaults, or :class:`Adam` when
    ``mu_dtype`` (``adam_mu_dtype``) names a storage dtype of the first
    moment. The parameters of ``params`` that are in ``frozen`` go into a
    second group at learning rate 0 marked ``frozen``. ``capturable``
    (for a step that is captured: the module docstring) makes the
    learning rate a float32 tensor on the parameters' device and keeps
    the step counts there."""
    params = list(params)
    if capturable:
        lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
    skip = {id(p) for p in frozen}
    if skip:
        params = [{"params": [p for p in params if id(p) not in skip]},
                  {"params": [p for p in params if id(p) in skip],
                   "lr": 0.0, "frozen": True}]
    if mu_dtype is not None:
        dtype = getattr(torch, str(mu_dtype)) if isinstance(mu_dtype, str) \
            else mu_dtype
        return Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                    weight_decay=weight_decay, mu_dtype=dtype,
                    capturable=capturable)
    cls = CapturableAdam if capturable else torch.optim.Adam
    opt = cls(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
              weight_decay=weight_decay, capturable=capturable)
    # the same instance runs eagerly and captured: torch's one-time
    # warning for a capturable optimizer stepped outside a capture does
    # not apply
    opt._warned_capturable_if_run_uncaptured = True
    return opt


def load_state(opt: torch.optim.Optimizer, state_dict: dict) -> None:
    """``opt.load_state_dict(state_dict)`` that keeps ``opt``'s mode.
    ``load_state_dict`` takes every group's settings from the saved
    groups, ``capturable`` and ``lr`` among them: a checkpoint of a run
    that was not capturable (the CPU's, a route that is not captured)
    would leave a capturable optimizer with a number for its learning
    rate, which a capture bakes in for good, and one of a capturable run
    would give the others a tensor that torch's eager Adam refuses. So
    each group keeps its ``capturable`` flag and the kind of its learning
    rate (a capturable group its very tensor, filled with the saved
    value), and the step counts go where that mode keeps them."""
    kept = [(group.get("capturable", False), group["lr"])
            for group in opt.param_groups]
    opt.load_state_dict(state_dict)
    for group, (capturable, lr) in zip(opt.param_groups, kept):
        value = float(group["lr"])
        group["capturable"] = capturable
        group["lr"] = lr.fill_(value) if isinstance(lr, torch.Tensor) \
            else value
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].to(
                    device=p.device if capturable else "cpu")


def step(opt: torch.optim.Optimizer) -> None:
    """``opt.step()`` where a parameter the loss did not reach takes a zero
    gradient, as under ``jax.grad``: Adam then still decays its moments,
    moves it by them and applies weight decay to it. Under a data-parallel
    mesh every gradient (the frozen group's too, whose moments advance) is
    first summed over the ranks, once: each rank's gradient is its rows'
    share of the global batch's loss."""
    params = [p for group in opt.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    mesh = collectives.active_mesh()
    if mesh is not None:
        collectives.all_reduce_grads(mesh, params)
    opt.step()


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """``lr`` on every param group but the ``frozen`` one: written into a
    group's device tensor where it holds one (a capturable optimizer's),
    in place, so that a captured step reads it."""
    for group in opt.param_groups:
        if group.get("frozen"):
            continue
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
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
