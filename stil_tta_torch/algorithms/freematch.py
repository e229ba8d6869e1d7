"""FreeMatch (self-adaptive thresholds and a fairness loss), the port of
``stil_tta_tpu/algorithms/freematch.py``.

A student and its EMAN teacher over :class:`ImagingNet` or, with a
multimodal ``eval_datatype``, :class:`MatchMultimodalNet`. The teacher's
weak-view probabilities move three EMA buffers at m = 0.999 (``extra``:
``time_p``, the mean top probability; ``p_model``, the mean
distribution; ``label_hist``, the histogram of its top classes;
``freematch_model.py:127-143``); the mask is ``max_prob >= time_p *
p_model[y_hat] / max(p_model)``; the one-hot pseudo labels train the
strong view by an unmasked cross entropy, and the mask feeds the
fairness loss (``losses/common.py:entropy_loss``). The loss is ``loss_x +
lambda_u * loss_u + lambda_e * loss_e`` past ``start_epoch``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from stil_tta_torch.algorithms.base import accumulate_chunks, ema_update
from stil_tta_torch.algorithms.match_common import (MatchBase, MatchState,
                                                    ema_source)
from stil_tta_torch.losses.common import (cross_entropy, entropy_loss,
                                          soft_cross_entropy)
from stil_tta_torch.models.layers import acc_dtype
from stil_tta_torch.parallel import sharded
from stil_tta_torch.train import optim

Tensor = torch.Tensor

SELF_ADAPT_M = 0.999  # freematch_model.py:48 (``self.m``)


class FreeMatch(MatchBase):
    """cfg keys consumed (names of ``config_dvm_FreeMatch.yaml``): model,
    num_classes, target, eval_datatype, projection_dim, the tabular and
    fusion widths, img_size; for training also lambda_u, lambda_e,
    start_epoch, ema_momentum, eval_train_augment_rate,
    augmentation_rate, corruption_rate, lr_eval, weight_decay_eval,
    finetune_strategy and micro_batches."""

    name = "FreeMatch"
    LOG_KEYS = ("loss", "loss_x", "loss_u", "loss_e", "threshold1_ratio")

    def uses_ema(self) -> bool:
        return True

    def extra_state(self) -> Dict[str, object]:
        c, adt, dev = self.num_classes, acc_dtype(self.dtype), self.device
        return {"p_model": torch.full((c,), 1.0 / c, dtype=adt, device=dev),
                "label_hist": torch.full((c,), 1.0 / c, dtype=adt,
                                         device=dev),
                "time_p": torch.tensor(1.0 / c, dtype=adt, device=dev)}

    def make_train_step(self):
        """The train step: ``step(state, cache_l, cache_u, idx_l, idx_u,
        epoch)`` updates ``state`` in place and returns it.

        With ``micro_batches: 1``, the single-batch step
        (``freematch.py:51-144``), in the reference's order: the
        student's train-mode forward on (labelled, strong) (BatchNorm
        running statistics update in place); the EMAN lerp of the teacher
        towards the student's pre-update parameters and post-forward
        statistics; the eval-mode teacher on the weak view; the buffers,
        the mask and the losses; backward and Adam.

        With ``micro_batches: m > 1``, ``step_micro``
        (``freematch.py:146-282``): the EMAN lerp once, before the first
        chunk, from the pre-step parameters and statistics; m chunks of
        B/m rows in order, each with its own views and a mask from the
        pre-step buffers lerped with the chunk's own means; one Adam step
        on the mean of the chunk gradients. The committed buffers use the
        whole batch's means (the mean of the chunk means, and the summed
        histogram normalised once), so they equal the single-batch
        step's given the same teacher outputs."""
        cfg = self.cfg
        self._prepare_views()
        c = self.num_classes
        lambda_u = float(cfg.lambda_u)
        lambda_e = float(cfg.lambda_e or 0.01)
        momentum = float(cfg.ema_momentum)
        m = SELF_ADAPT_M
        m_micro = int(cfg.micro_batches or 1)

        def teacher_stats(state: MatchState, img_w, tab_w):
            """The eval-mode teacher's weak-view probabilities: (top
            probabilities, top classes, mean distribution, histogram of
            the top classes as raw counts)."""
            with torch.no_grad():
                logits_uw, _ = sharded(state.ema, (img_w.shape[0],), img_w,
                                       tab_w)
                probs = torch.softmax(logits_uw, dim=1)
            max_probs, max_idx = probs.max(1)
            hist = torch.zeros(c, dtype=probs.dtype,
                               device=probs.device).index_add_(
                0, max_idx, torch.ones_like(max_probs))
            return max_probs, max_idx, probs.mean(0), hist

        def lerped(state: MatchState, mean_maxp, mean_probs, hist):
            ex = state.extra
            return (ex["time_p"] * m + (1 - m) * mean_maxp,
                    ex["p_model"] * m + (1 - m) * mean_probs,
                    ex["label_hist"] * m + (1 - m) * hist / hist.sum())

        def losses(logits, b_l, y_l, max_probs, max_idx, time_p, p_model,
                   label_hist, gate: Tensor):
            mod = p_model / p_model.max()
            mask = (max_probs >= time_p * mod[max_idx]).float()
            pseudo = F.one_hot(max_idx, c).to(logits.dtype)
            logits_x, logits_us = logits[:b_l], logits[b_l:]
            loss_x = cross_entropy(logits_x, y_l)
            # no confidence mask on the consistency loss: the reference's
            # plain CrossEntropyLoss (``FreeMatch.py:35, 93``)
            loss_u = soft_cross_entropy(logits_us, pseudo)
            loss_e = entropy_loss(mask, logits_us, p_model, label_hist)
            total = loss_x + gate * (lambda_u * loss_u + lambda_e * loss_e)
            return total, {"loss": total, "loss_x": loss_x,
                           "loss_u": loss_u, "loss_e": loss_e,
                           "threshold1_ratio": mask.mean()}

        @torch.no_grad()
        def commit(state: MatchState, time_p, p_model, label_hist) -> None:
            """The lerped buffers into the state's, in place."""
            ex = state.extra
            for k, v in (("time_p", time_p), ("p_model", p_model),
                         ("label_hist", label_hist)):
                ex[k].copy_(v)

        def step(state: MatchState, cache_l: dict, cache_u: dict,
                 idx_l: Tensor, idx_u: Tensor, epoch: int) -> MatchState:
            gate = self.set_epoch(epoch)["gate"]
            y_l, y_u, (img_x, tab_x), (img_w, tab_w), (img_s, tab_s), _ = \
                self.batch_views(state, cache_l, cache_u, idx_l, idx_u)
            state.net.train()
            logits, _ = sharded(state.net, (y_l.shape[0], y_u.shape[0]),
                                torch.cat([img_x, img_s]),
                                torch.cat([tab_x, tab_s]))
            ema_update(state.ema, ema_source(state.net), momentum, True)
            max_probs, max_idx, mean_probs, hist = teacher_stats(
                state, img_w, tab_w)
            time_p, p_model, label_hist = lerped(
                state, max_probs.mean(), mean_probs, hist)
            total, logs = losses(logits, y_l.shape[0], y_l, max_probs,
                                 max_idx, time_p, p_model, label_hist, gate)
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            optim.step(state.optimizer)
            commit(state, time_p, p_model, label_hist)
            self.update_accuracy(state, logits, y_l, y_u)
            self.add_logs(state, logs)
            state.step += 1
            return state

        def step_micro(state: MatchState, cache_l: dict, cache_u: dict,
                       idx_l: Tensor, idx_u: Tensor,
                       epoch: int) -> MatchState:
            gate = self.set_epoch(epoch)["gate"]
            state.net.train()
            # once, on the pre-step parameters and running statistics
            ema_update(state.ema, ema_source(state.net), momentum, True)
            lacc = {k: 0.0 for k in self.LOG_KEYS}
            sums = [0.0, 0.0, 0.0]   # top probability, distribution, hist

            def chunk(il: Tensor, iu: Tensor) -> Tensor:
                y_l, y_u, (img_x, tab_x), (img_w, tab_w), (img_s, tab_s), \
                    _ = self.batch_views(state, cache_l, cache_u, il, iu)
                logits, _ = sharded(state.net, (y_l.shape[0], y_u.shape[0]),
                                    torch.cat([img_x, img_s]),
                                    torch.cat([tab_x, tab_s]))
                max_probs, max_idx, mean_probs, hist = teacher_stats(
                    state, img_w, tab_w)
                mean_maxp = max_probs.mean()
                total, logs = losses(logits, y_l.shape[0], y_l, max_probs,
                                     max_idx, *lerped(state, mean_maxp,
                                                      mean_probs, hist),
                                     gate)
                for i, v in enumerate((mean_maxp, mean_probs, hist)):
                    sums[i] = sums[i] + v
                self.update_accuracy(state, logits, y_l, y_u)
                for k in self.LOG_KEYS:
                    lacc[k] = lacc[k] + logs[k].detach()
                return total

            accumulate_chunks(state.optimizer, m_micro, chunk, idx_l, idx_u)
            optim.step(state.optimizer)
            with torch.no_grad():
                time_p, p_model, label_hist = lerped(
                    state, sums[0] / m_micro, sums[1] / m_micro, sums[2])
                commit(state, time_p, p_model, label_hist)
                self.add_logs(state, {k: v / m_micro
                                      for k, v in lacc.items()})
            state.step += 1
            return state

        return step if m_micro == 1 else step_micro
