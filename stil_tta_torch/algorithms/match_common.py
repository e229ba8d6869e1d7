"""The shared machinery of the comparison families ported so far (MMatch
and Co-Training), the port of the part of
``stil_tta_tpu/algorithms/match_common.py`` they use: the train state
(:class:`MatchState`), construction, the seeded init, the epoch end and
the train-metric update (:class:`MatchBase`), and CoMatch's circular
enqueue (:func:`enqueue`, ``comatch.py:59-77``), which MMatch's memory
bank uses.

The optimizer is a float32 Adam at ``lr_eval`` with ``weight_decay_eval``
whatever ``adam_mu_dtype`` says: the JAX ``MatchBase`` builds its
optimizer without the first-moment dtype (``match_common.py:132-134``),
so the fast profile's bfloat16 moment does not reach these families.
The encoder freeze of ``finetune_strategy: frozen`` is refused, as it is
for STiL. ``ImagingNet``, ``MatchMultimodalNet`` and the weak, strong and
hard-eval views belong to the FixMatch families and are not ported.

The train state is mutable: a step updates it in place and returns it.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from stil_tta_torch.algorithms.base import DAState, init_weights
from stil_tta_torch.data.augment import default_pipeline
from stil_tta_torch.models.layers import acc_dtype
from stil_tta_torch.ops.metrics import (AccuracyState, accuracy_compute,
                                        accuracy_init, accuracy_update)
from stil_tta_torch.train.optim import build_optimizer

Tensor = torch.Tensor


@dataclasses.dataclass
class MatchState:
    """What a run of a comparison family carries from step to step (the
    JAX package's ``MatchState``): the student net, the EMA copy of its
    backbone (None where the family keeps no teacher), the optimizer, the
    generator of the step's random views, the DA ring (None without
    ``DA``), the family's buffers (``extra``: MMatch's memory bank), the
    streaming train accuracies, this epoch's loss sums and the step
    count."""

    net: nn.Module
    ema: Optional[nn.Module]
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    da: Optional[DAState]
    extra: Dict[str, object]
    acc_train: AccuracyState
    acc_train_u: AccuracyState
    log_sums: Dict[str, Tensor]
    log_count: Tensor
    step: int = 0


def enqueue(queue: Tensor, probs: Tensor, ptr: int, z: Tensor,
            t: Tensor) -> int:
    """CoMatch's circular enqueue (``comatch.py:59-77``), in place: the
    rows of ``z`` (B, D) and ``t`` (B, C) go into the columns ``ptr,
    ptr+1, ...`` of ``queue`` (D, K) and ``probs`` (C, K); rows past
    column K - 1 are dropped, not wrapped. Returns the new write position
    ``(ptr + min(B, K - ptr)) % K``."""
    k = queue.shape[1]
    n = min(z.shape[0], k - ptr)
    queue[:, ptr:ptr + n] = z[:n].T.to(queue.dtype)
    probs[:, ptr:ptr + n] = t[:n].T.to(probs.dtype)
    return (ptr + n) % k


class MatchBase:
    """Construction, init, epoch end and metric update shared by the
    comparison families; a subclass provides ``LOG_KEYS``, ``build_net``,
    ``extra_state``, ``make_train_step`` and ``make_eval_step``, and
    ``uses_ema`` when it keeps an EMA teacher. The net's parameters are
    float32 (float64 when ``dtype`` is float64, for parity tests) and it
    computes in ``dtype``.

    ``entropy_tta`` is False: TTA by entropy (Tent, EATA, SAR) reads the
    multimodal head by name, which these nets' tuple outputs do not
    have, and the JAX package fails there (``tta/tent.py:191``), so the
    port refuses it (BN-adapt works)."""

    LOG_KEYS: Tuple[str, ...] = ("loss",)
    name = "MatchBase"
    entropy_tta = False

    def __init__(self, cfg, field_lengths: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.num_classes = int(cfg.num_classes)
        self.net = self.build_net(cfg, tuple(int(x) for x in field_lengths),
                                  dtype)
        self.net.to(device=self.device, dtype=acc_dtype(dtype)).eval()
        self.aug_eval = default_pipeline(int(cfg.img_size), cfg.target)

    # -- subclass hooks -------------------------------------------------
    def build_net(self, cfg, field_lengths, dtype) -> nn.Module:
        raise NotImplementedError

    def uses_ema(self) -> bool:
        return False

    def extra_state(self) -> Dict[str, object]:
        return {}

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> MatchState:
        """Seeded random weights (:func:`init_weights`), the EMA backbone
        as a copy of the student's where the family keeps one, a fresh
        float32 Adam, the family's buffers and zeroed sums. The generator
        that drew the weights goes on to draw the steps' views."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        init_weights(self.net, gen)
        ema = None
        if self.uses_ema():
            ema = copy.deepcopy(self.net.model).eval().requires_grad_(False)
        freeze = cfg.finetune_strategy == "frozen" and bool(cfg.checkpoint)
        # no mu_dtype: the JAX MatchBase passes none (match_common.py:132)
        optimizer = build_optimizer(
            self.net.parameters(), float(cfg.lr_eval),
            float(cfg.weight_decay_eval or 0.0), freeze=freeze)
        adt = acc_dtype(self.dtype)
        state = MatchState(
            net=self.net, ema=ema, optimizer=optimizer, generator=gen,
            da=(DAState.create(self.num_classes, dtype=adt,
                               device=self.device) if bool(cfg.DA)
                else None),
            extra=self.extra_state(), acc_train=None, acc_train_u=None,
            log_sums=None, log_count=None)
        self._reset_epoch(state)
        return state

    def _reset_epoch(self, state: MatchState) -> None:
        adt, dev = acc_dtype(self.dtype), self.device
        state.acc_train = accuracy_init(dev)
        state.acc_train_u = accuracy_init(dev)
        state.log_sums = {k: torch.zeros((), dtype=adt, device=dev)
                          for k in self.LOG_KEYS}
        state.log_count = torch.zeros((), dtype=adt, device=dev)

    def epoch_end(self, state: MatchState) -> Tuple[MatchState, Dict]:
        """The epoch's train logs (``match_common.py:223-237``); resets
        the sums."""
        n = max(float(state.log_count), 1.0)
        logs = {k: float(v) / n for k, v in state.log_sums.items()}
        logs["eval.train.acc"] = accuracy_compute(state.acc_train)
        logs["eval.train_unlabelled.acc"] = accuracy_compute(
            state.acc_train_u)
        self._reset_epoch(state)
        return state, logs

    @torch.no_grad()
    def update_accuracy(self, state: MatchState, out_m: Tensor, y_l: Tensor,
                        y_u: Tensor) -> None:
        """The streaming train accuracies of the multimodal head on the
        labelled rows (first) and the unlabelled rows, in place
        (``match_common.py:257-264``; binary tasks score the class-1
        probability)."""
        prob = torch.softmax(out_m.detach(), dim=1)
        b_l = y_l.shape[0]
        prob_l, prob_u = prob[:b_l], prob[b_l:]
        if self.num_classes == 2:
            prob_l, prob_u = prob_l[:, 1], prob_u[:, 1]
        state.acc_train = accuracy_update(state.acc_train, prob_l, y_l)
        state.acc_train_u = accuracy_update(state.acc_train_u, prob_u, y_u)

    @torch.no_grad()
    def add_logs(self, state: MatchState, logs: Dict[str, Tensor]) -> None:
        """One step's logs into the epoch's sums, in place."""
        state.log_sums = {k: state.log_sums[k] + logs[k].detach()
                          for k in self.LOG_KEYS}
        state.log_count = state.log_count + 1.0
