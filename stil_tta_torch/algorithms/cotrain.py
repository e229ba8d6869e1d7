"""Co-Training with cross-modal pseudo labels, the port of
``stil_tta_tpu/algorithms/cotrain.py``: :class:`CoTrain`
(``CoTrain_Pseudo``) and :class:`CoTrainSAINT` (``CoTrain_Pseudo_SAINT``,
the same with the SAINT tabular encoder).

The three-head concat backbone of :class:`~stil_tta_torch.algorithms.
mmatch.MMatch` with an optional EMAN teacher (``use_ema``): the imaging
head learns from the tabular teacher's soft labels and the tabular head
from the imaging teacher's, each masked where the teacher's top
probability reaches ``co_threshold``; the loss ``alpha * CE_l +
rate_uce * (L_i + L_t)`` past ``start_epoch``. Without the teacher the
student's own detached heads give the soft labels.
"""

from __future__ import annotations

from typing import Dict

import torch

from stil_tta_torch.algorithms.base import accumulate_chunks, ema_update
from stil_tta_torch.algorithms.match_common import MatchBase, MatchState
from stil_tta_torch.algorithms.mmatch import MMatch
from stil_tta_torch.losses.common import cross_entropy, soft_cross_entropy
from stil_tta_torch.parallel import sharded
from stil_tta_torch.train import optim
from stil_tta_torch.utils import trace

Tensor = torch.Tensor


class CoTrain(MMatch):
    """cfg keys consumed besides MMatch's construction keys (names of
    ``config_dvm_CoTrain.yaml``): alpha, rate_uce, co_threshold,
    start_epoch, use_ema, eman, ema_momentum, augmentation_rate,
    corruption_rate, crop_scale_lower, lr_eval, weight_decay_eval,
    finetune_strategy and micro_batches. ``teacher_int8`` and
    ``adam_mu_dtype`` are accepted and have no effect, as in the JAX
    package."""

    name = "CoTrain_Pseudo"
    LOG_KEYS = ("loss", "CEloss", "CEloss_unlabelled_i",
                "CEloss_unlabelled_t", "threshold_i_ratio",
                "threshold_t_ratio")

    def uses_ema(self) -> bool:
        return bool(self.cfg.use_ema)

    def extra_state(self) -> Dict[str, object]:
        return {}

    def epoch_values(self, epoch: int) -> Dict[str, float]:
        """MatchBase's ``gate`` alone: no bank smooths the soft labels."""
        return MatchBase.epoch_values(self, epoch)

    def make_train_step(self):
        """The train step: ``step(state, cache_l, cache_u, idx_l, idx_u,
        epoch)`` updates ``state`` in place and returns it.

        With ``micro_batches: 1``, the single-batch step
        (``cotrain.py:47-131``), in the reference's order: the student's
        train-mode forward (BatchNorm running statistics update in place);
        the EMAN lerp of the EMA backbone towards the student's pre-update
        parameters and post-forward statistics; the eval-mode teacher on
        the same views, without gradient; the cross-modal losses,
        backward and Adam step; the metrics.

        With ``micro_batches: m > 1``, the JAX package's ``step_micro``
        (``cotrain.py:134-257``): the EMAN lerp runs once, before the
        first chunk, from the pre-step parameters and running statistics;
        then m chunks of B/m rows in order, each with its own views,
        student and teacher forwards, and one Adam step on the mean of the
        chunk gradients. Its documented divergences: BatchNorm statistics
        per chunk, the pre-forward lerp, and with SAINT (CoTrainSAINT) the
        intersample attention over the chunk's rows instead of the
        batch's. The soft labels and masks are per sample."""
        cfg = self.cfg
        self._prepare_training()
        alpha, rate_uce = float(cfg.alpha), float(cfg.rate_uce)
        threshold = float(cfg.co_threshold)
        use_ema, eman = bool(cfg.use_ema), bool(cfg.eman)
        momentum = float(cfg.ema_momentum)
        m_micro = int(cfg.micro_batches or 1)

        def forward_losses(state: MatchState, images, tabs, y_l,
                           gate: Tensor, lerp_ema: bool):
            """Student forward, teacher forward (after the EMAN lerp when
            ``lerp_ema``) and the losses."""
            b_l = y_l.shape[0]
            rows = (b_l, images.shape[0] - b_l)
            om, oi, ot, _ = sharded(state.net, rows, images, tabs)
            if use_ema:
                if lerp_ema:
                    ema_update(state.ema, state.net.model, momentum, eman)
                with torch.no_grad():
                    _, t_i, t_t, _ = sharded(state.ema, rows, images, tabs)
            else:
                t_i, t_t = oi.detach(), ot.detach()
            pseudo_i = torch.softmax(t_i[b_l:], dim=1)
            pseudo_t = torch.softmax(t_t[b_l:], dim=1)
            mask_i = (pseudo_i.amax(1) >= threshold).float()
            mask_t = (pseudo_t.amax(1) >= threshold).float()
            loss_ce = (cross_entropy(om[:b_l], y_l)
                       + cross_entropy(oi[:b_l], y_l)
                       + cross_entropy(ot[:b_l], y_l))
            # cross-modal: imaging student <- tabular teacher, and the
            # reverse (``CoTraining.py:147-149``)
            loss_i_u = (soft_cross_entropy(oi[b_l:], pseudo_t, "none")
                        * mask_t).mean()
            loss_t_u = (soft_cross_entropy(ot[b_l:], pseudo_i, "none")
                        * mask_i).mean()
            total = alpha * loss_ce + gate * rate_uce * (loss_i_u + loss_t_u)
            logs = {"loss": total, "CEloss": loss_ce,
                    "CEloss_unlabelled_i": loss_i_u,
                    "CEloss_unlabelled_t": loss_t_u,
                    "threshold_i_ratio": mask_i.mean(),
                    "threshold_t_ratio": mask_t.mean()}
            return om, total, logs

        def step(state: MatchState, cache_l: dict, cache_u: dict,
                 idx_l: Tensor, idx_u: Tensor, epoch: int) -> MatchState:
            gate = self.set_epoch(epoch)["gate"]
            y_l, y_u, images, tabs = self.chunk_views(state, cache_l,
                                                      cache_u, idx_l, idx_u)
            state.net.train()
            om, total, logs = forward_losses(state, images, tabs, y_l,
                                             gate, lerp_ema=True)
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            optim.step(state.optimizer)
            self.update_accuracy(state, om, y_l, y_u)
            self.add_logs(state, logs)
            state.step += 1
            return state

        def step_micro(state: MatchState, cache_l: dict, cache_u: dict,
                       idx_l: Tensor, idx_u: Tensor,
                       epoch: int) -> MatchState:
            gate = self.set_epoch(epoch)["gate"]
            state.net.train()
            if use_ema:
                # once, on the pre-step parameters and running statistics
                ema_update(state.ema, state.net.model, momentum, eman)
            lacc = {k: 0.0 for k in self.LOG_KEYS}

            def chunk(il: Tensor, iu: Tensor) -> Tensor:
                y_l, y_u, images, tabs = self.chunk_views(
                    state, cache_l, cache_u, il, iu)
                om, total, logs = forward_losses(state, images, tabs, y_l,
                                                 gate, lerp_ema=False)
                self.update_accuracy(state, om, y_l, y_u)
                for k in self.LOG_KEYS:
                    lacc[k] = lacc[k] + logs[k].detach()
                return total

            accumulate_chunks(state.optimizer, m_micro, chunk, idx_l, idx_u)
            optim.step(state.optimizer)
            self.add_logs(state, {k: v / m_micro for k, v in lacc.items()})
            state.step += 1
            return state

        return trace.traced("train.step",
                            step if m_micro == 1 else step_micro)


class CoTrainSAINT(CoTrain):
    """``CoTraining_SAINT.py``: Co-Training with the SAINT tabular
    encoder; only the backbone's encoder is swapped."""

    name = "CoTrain_Pseudo_SAINT"
    tabular_encoder = "saint"
