"""SimMatch (semantic and instance pseudo labels), the port of
``stil_tta_tpu/algorithms/simmatch.py``.

A student and its EMAN teacher over :class:`ImagingNet` or, with a
multimodal ``eval_datatype``, :class:`MatchMultimodalNet`, and an
instance bank holding one teacher embedding per labelled sample
(``extra``: ``bank`` (projection_dim, K) and ``bank_labels`` (K,), K =
the labelled set's size; ``simmatch_model.py:68-70``). The teacher's
weak-view probabilities, aligned by the DA ring, are smoothed by the
bank: the weak embeddings' softmax over the bank at ``tt`` gives the
instance distribution, scaled by each bank entry's class probability
(the teacher distribution of the instance loss) and summed per class
(``c_smooth`` of the smoothed pseudo labels; ``:268-282``). The student
learns the masked soft pseudo labels on the strong view (mask
``max >= sim_threshold``) and the teacher distribution through its own
bank softmax at ``st``. The loss is ``loss_x + lambda_u * loss_u +
lambda_in * loss_in`` past ``start_epoch``; after the step the labelled
rows' teacher embeddings and labels go into the bank at their dataset
indices (``data/loader.py:dataset_indices``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from stil_tta_torch.algorithms.base import (DAState, accumulate_chunks,
                                            distribution_alignment,
                                            ema_update)
from stil_tta_torch.algorithms.match_common import (MatchBase, MatchState,
                                                    ema_source)
from stil_tta_torch.data.loader import dataset_indices, gather_batch
from stil_tta_torch.losses.common import cross_entropy, soft_cross_entropy
from stil_tta_torch.models.layers import acc_dtype
from stil_tta_torch.parallel import sharded
from stil_tta_torch.train import optim
from stil_tta_torch.utils import trace

Tensor = torch.Tensor


class SimMatch(MatchBase):
    """cfg keys consumed (names of ``config_dvm_SimMatch.yaml``): model,
    num_classes, target, eval_datatype, projection_dim, the tabular and
    fusion widths, img_size, K (the labelled set's size;
    ``train.evaluate`` sets it when the config leaves it unset); for
    training also tt, st, c_smooth, sim_threshold, lambda_u, lambda_in,
    start_epoch, ema_momentum, DA, eval_train_augment_rate,
    augmentation_rate, corruption_rate, lr_eval, weight_decay_eval,
    finetune_strategy and micro_batches."""

    name = "SimMatch"
    LOG_KEYS = ("loss", "loss_x", "loss_u", "loss_in", "threshold1_ratio")

    def uses_ema(self) -> bool:
        return True

    def extra_state(self) -> Dict[str, object]:
        """Unit-column normal embeddings and zero labels. The JAX package
        draws the embeddings from ``jax.random.key(7)``; here a generator
        seeded 7 on the run's device draws them."""
        if not self.cfg.K:
            raise ValueError("SimMatch needs K, the labelled set's size "
                             "(train.evaluate sets it)")
        k, dim = int(self.cfg.K), int(self.cfg.projection_dim)
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(7)
        bank = torch.randn((dim, k), generator=gen, device=dev).to(
            acc_dtype(self.dtype))
        return {"bank": bank / bank.norm(dim=0, keepdim=True),
                "bank_labels": torch.zeros(k, dtype=torch.long, device=dev)}

    def make_train_step(self):
        """The train step: ``step(state, cache_l, cache_u, idx_l, idx_u,
        epoch)`` updates ``state`` in place and returns it.

        With ``micro_batches: 1``, the single-batch step
        (``simmatch.py:49-156``), in the reference's order
        (``simmatch_model.py:240-264``): the student's train-mode forward
        on (labelled, strong) (BatchNorm running statistics update in
        place); the EMAN lerp of the teacher towards the student's
        pre-update parameters and post-forward statistics; the eval-mode
        teacher on (labelled, weak); DA, the bank's smoothing, the mask
        and the losses; backward and Adam; then the bank scatter of the
        labelled rows' teacher embeddings and labels.

        With ``micro_batches: m > 1``, ``step_micro``
        (``simmatch.py:160-337``): the EMAN lerp once, before the first
        chunk, from the pre-step parameters and statistics; m chunks of
        B/m rows in order, each with its own views, aligning against the
        pre-step DA ring with its own mean in slot ``ptr`` (the committed
        slot is the mean of the chunk means, ``ptr`` advances once), all
        against the pre-step bank; one Adam step on the mean of the chunk
        gradients; one scatter of the whole batch's rows."""
        cfg = self.cfg
        self._prepare_views()
        c = self.num_classes
        threshold = float(cfg.sim_threshold)
        lambda_u, lambda_in = float(cfg.lambda_u), float(cfg.lambda_in)
        tt, st = float(cfg.tt), float(cfg.st)
        c_smooth = float(cfg.c_smooth)
        momentum = float(cfg.ema_momentum)
        use_da = bool(cfg.DA)
        m_micro = int(cfg.micro_batches or 1)

        def targets_losses(state: MatchState, da: DAState, logits, feat,
                           x, w, y_l, gate: Tensor):
            """From the student's outputs on (labelled, strong): the
            teacher on (labelled, weak) as it stands, the targets
            (aligned against ``da``) and the losses; returns (the
            labelled rows' teacher embeddings, the new DA state, the
            loss, the logs)."""
            b_l = y_l.shape[0]
            bank = state.extra["bank"]
            onehot_bank = F.one_hot(state.extra["bank_labels"], c).to(
                bank.dtype)                                       # (K, C)
            with torch.no_grad():
                logits_k, feat_k = sharded(
                    state.ema, (b_l, w[0].shape[0]), torch.cat([x[0], w[0]]),
                    torch.cat([x[1], w[1]]))
                prob_ku_orig = torch.softmax(logits_k[b_l:], dim=1)
                if use_da:
                    da, prob_ku_orig = distribution_alignment(
                        da, prob_ku_orig)
                feat_ku = feat_k[b_l:]
                teacher_prob_orig = torch.softmax(feat_ku @ bank / tt, dim=1)
                factor = prob_ku_orig @ onehot_bank.T   # prob[b, lbl[k]]
                teacher_prob = teacher_prob_orig * factor
                teacher_prob = teacher_prob / teacher_prob.sum(
                    1, keepdim=True).clamp_min(1e-12)
                prob_ku = (c_smooth * prob_ku_orig + (1 - c_smooth)
                           * (teacher_prob_orig @ onehot_bank))
                mask = (prob_ku.amax(1) >= threshold).float()
            loss_x = cross_entropy(logits[:b_l], y_l)
            loss_u = (soft_cross_entropy(logits[b_l:], prob_ku, "none")
                      * mask).mean()
            student_prob = torch.softmax(feat[b_l:] @ bank / st, dim=1)
            loss_in = (-teacher_prob * torch.log(student_prob + 1e-12)).sum(
                1).mean()
            total = loss_x + gate * (lambda_u * loss_u + lambda_in * loss_in)
            logs = {"loss": total, "loss_x": loss_x, "loss_u": loss_u,
                    "loss_in": loss_in, "threshold1_ratio": mask.mean()}
            return feat_k[:b_l], da, total, logs

        @torch.no_grad()
        def scatter_bank(state: MatchState, cache_l: dict, idx_l: Tensor,
                         feat_kx: Tensor, y_l: Tensor) -> None:
            ds_l = dataset_indices(cache_l, idx_l)
            ex = state.extra
            ex["bank"][:, ds_l] = feat_kx.T.to(ex["bank"].dtype)
            ex["bank_labels"][ds_l] = y_l.to(ex["bank_labels"].dtype)

        def step(state: MatchState, cache_l: dict, cache_u: dict,
                 idx_l: Tensor, idx_u: Tensor, epoch: int) -> MatchState:
            gate = self.set_epoch(epoch)["gate"]
            y_l, y_u, x, w, s, _ = self.batch_views(state, cache_l, cache_u,
                                                    idx_l, idx_u)
            state.net.train()
            logits, feat = sharded(state.net, (y_l.shape[0], y_u.shape[0]),
                                   torch.cat([x[0], s[0]]),
                                   torch.cat([x[1], s[1]]))
            ema_update(state.ema, ema_source(state.net), momentum, True)
            feat_kx, da, total, logs = targets_losses(
                state, state.da, logits, feat, x, w, y_l, gate)
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            optim.step(state.optimizer)
            scatter_bank(state, cache_l, idx_l, feat_kx, y_l)
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
            da0 = state.da
            lacc = {k: 0.0 for k in self.LOG_KEYS}
            means, feats = [], []

            def chunk(il: Tensor, iu: Tensor) -> Tensor:
                y_l, y_u, x, w, s, _ = self.batch_views(
                    state, cache_l, cache_u, il, iu)
                logits, feat = sharded(
                    state.net, (y_l.shape[0], y_u.shape[0]),
                    torch.cat([x[0], s[0]]), torch.cat([x[1], s[1]]))
                feat_kx, da_c, total, logs = targets_losses(
                    state, da0.clone(), logits, feat, x, w, y_l, gate)
                if use_da:
                    # the chunk's mean sits in the slot its alignment wrote
                    means.append(da_c.row(da0.ptr))
                feats.append(feat_kx)
                self.update_accuracy(state, logits, y_l, y_u)
                for k in self.LOG_KEYS:
                    lacc[k] = lacc[k] + logs[k].detach()
                return total

            accumulate_chunks(state.optimizer, m_micro, chunk, idx_l, idx_u)
            optim.step(state.optimizer)
            with torch.no_grad():
                if use_da:
                    da0.write(sum(means[1:], means[0]) / m_micro)
                y_l = gather_batch(cache_l, idx_l)["labels"]
                scatter_bank(state, cache_l, idx_l, torch.cat(feats), y_l)
                self.add_logs(state, {k: v / m_micro
                                      for k, v in lacc.items()})
            state.step += 1
            return state

        return trace.traced("train.step",
                            step if m_micro == 1 else step_micro)
