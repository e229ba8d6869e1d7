"""CoMatch (graph-contrastive co-training of class probabilities and
embeddings), the port of ``stil_tta_tpu/algorithms/comatch.py``.

A student and a momentum encoder over :class:`ImagingNet` or, with a
multimodal ``eval_datatype``, :class:`MatchMultimodalNet`; two strong
views. ``extra`` holds two circular queues of K columns: the strong
view's embeddings with their pseudo labels (``queue_s``, ``probs_u``,
``ptr_s``) and the weak and labelled embeddings with their targets
(``queue_w``, ``probs_xu``, ``ptr_w``; ``comatch_model.py:80-90``), and
the DA history (``hist_prob``, a 128-deep ring with its length and write
position; the mean over the ring's filled slots divides the
probabilities, ``:270-284``). Positions and the ring's length are 0-dim
int64 tensors on the device. Past ``start_epoch`` the pseudo labels are
smoothed through the weak queue (``:287-293``). The pseudo-label graph
(the batch's pairwise products, diagonal 1, and the products with
``probs_u``) is cut at ``contrast_th`` and normalised; it weighs the
embedding graph of the first strong view against the second and
``queue_s`` (``:295-312``). The loss is ``loss_x + lam_u * masked soft CE
+ min(epoch + 1, lam_c) * loss_contrast`` past ``start_epoch``; after
the step both queues take the batch's rows (``match_common.enqueue``).

Two reference quirks are kept, as the JAX package keeps them: the
momentum update is of the parameters alone, before the student's
forward; and the momentum encoder is never put in eval mode, so its
BatchNorms normalise by the batch (the ``bn_stats`` kernel, without
gradient) and its running statistics do not move
(``ops.batch_norm.running_stats_frozen``; ``comatch.py:106-124``).
``queue_w`` starts as normal draws that are not normalised
(``comatch.py:47``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
import torch.nn.functional as F
from torch import nn

from stil_tta_torch.algorithms.base import accumulate_chunks, ema_update
from stil_tta_torch.algorithms.match_common import (MatchBase, MatchState,
                                                    ema_source, enqueue,
                                                    position)
from stil_tta_torch.data.loader import gather_batch
from stil_tta_torch.losses.common import cross_entropy, soft_cross_entropy
from stil_tta_torch.models.layers import acc_dtype
from stil_tta_torch.ops.batch_norm import running_stats_frozen
from stil_tta_torch.parallel import sharded
from stil_tta_torch.train import optim
from stil_tta_torch.utils import trace

Tensor = torch.Tensor

DA_WINDOW = 128  # comatch_model.py:281 (``len(self.hist_prob) > 128``)


@contextlib.contextmanager
def train_mode_teacher(ema: nn.Module) -> Iterator[None]:
    """The momentum encoder in train mode, without gradient, its running
    statistics left as they are; back in eval mode on exit."""
    with torch.no_grad(), running_stats_frozen(ema):
        ema.train()
        try:
            yield
        finally:
            ema.eval()


class CoMatch(MatchBase):
    """cfg keys consumed (names of ``config_dvm_CoMatch.yaml``): model,
    num_classes, target, eval_datatype, projection_dim, the tabular and
    fusion widths, img_size, K; for training also co_threshold,
    contrast_th, alpha, lam_u, lam_c, co_temperature (else temperature),
    start_epoch, ema_momentum, eval_train_augment_rate,
    augmentation_rate, corruption_rate, lr_eval, weight_decay_eval,
    finetune_strategy and micro_batches."""

    name = "CoMatch"
    LOG_KEYS = ("loss", "loss_x", "loss_u", "loss_contrast",
                "threshold1_ratio")

    def uses_ema(self) -> bool:
        return True

    def epoch_values(self, epoch: int) -> Dict[str, float]:
        """MatchBase's ``gate`` (past ``start_epoch`` it also smooths the
        pseudo labels through the weak queue) and ``lam_c``, ``min(epoch
        + 1, lam_c)``."""
        return {**super().epoch_values(epoch),
                "lam_c": min(float(epoch) + 1.0, float(self.cfg.lam_c))}

    def extra_state(self) -> Dict[str, object]:
        """The queues (``comatch.py:38-57``). The JAX package draws
        ``queue_s`` from ``jax.random.key(11)`` and ``queue_w`` from
        ``jax.random.key(13)``; here generators seeded 11 and 13 on the
        run's device draw them."""
        k = int(self.cfg.K or 2560)
        dim, c = int(self.cfg.projection_dim), self.num_classes
        adt, dev = acc_dtype(self.dtype), self.device

        def normal(seed: int) -> Tensor:
            gen = torch.Generator(device=dev).manual_seed(seed)
            return torch.randn((dim, k), generator=gen, device=dev).to(adt)

        queue_s = normal(11)
        zeros = lambda *s: torch.zeros(s, dtype=adt, device=dev)  # noqa
        return {"queue_s": queue_s / queue_s.norm(dim=0, keepdim=True),
                "probs_u": zeros(c, k), "queue_w": normal(13),
                "probs_xu": zeros(c, k), "ptr_s": position(0, dev),
                "ptr_w": position(0, dev), "hist_prob": zeros(DA_WINDOW, c),
                "hist_len": position(0, dev), "hist_ptr": position(0, dev)}

    def make_train_step(self):
        """The train step: ``step(state, cache_l, cache_u, idx_l, idx_u,
        epoch)`` updates ``state`` in place and returns it.

        With ``micro_batches: 1``, the single-batch step
        (``comatch.py:92-225``): the parameters-only momentum lerp; the
        train-mode momentum encoder on (labelled, weak, second strong);
        DA over the history ring, the smoothing, the pseudo-label graph
        and the mask; the student's train-mode forward on (labelled,
        first strong), the losses, backward and Adam; the two enqueues
        (the second strong view's embeddings with the pseudo labels; the
        labelled and weak embeddings with the labelled one-hots and the
        aligned, unsmoothed pseudo labels).

        With ``micro_batches: m > 1``, ``step_micro``
        (``comatch.py:229-425``): the momentum lerp once; m chunks of B/m
        rows in order, each with its own views, momentum-encoder
        statistics, DA slot (the pre-step ring with the chunk's mean at
        ``hist_ptr``) and graphs over its own rows against the pre-step
        queues; one Adam step on the mean of the chunk gradients; the DA
        slot committed as the mean of the chunk means; both enqueues with
        the whole batch's rows, labelled rows first."""
        cfg = self.cfg
        self._prepare_views()
        c = self.num_classes
        thr = float(cfg.co_threshold)
        contrast_th = float(cfg.contrast_th)
        lam_u = float(cfg.lam_u)
        alpha = float(cfg.alpha)
        temp = float(cfg.co_temperature or cfg.temperature)
        momentum = float(cfg.ema_momentum)
        m_micro = int(cfg.micro_batches or 1)

        def teacher_targets(state: MatchState, x, w, s1, smooth: Tensor):
            """The momentum encoder's outputs and the targets drawn from
            them against the pre-step buffers, the pseudo labels smoothed
            where ``smooth`` is 1: (f_us1, f_xuw, probs, probs_orig, q,
            mask, chunk mean)."""
            ex = state.extra
            b_l, b_u = x[0].shape[0], w[0].shape[0]
            with train_mode_teacher(state.ema):
                logits_m, feats_m = sharded(
                    state.ema, (b_l, b_u, b_u),
                    torch.cat([x[0], w[0], s1[0]]),
                    torch.cat([x[1], w[1], s1[1]]))
                probs = torch.softmax(logits_m[b_l:b_l + b_u], dim=1)
                mean_p = probs.mean(0)
                hist = ex["hist_prob"].clone()
                hist.index_copy_(0, ex["hist_ptr"].view(1),
                                 mean_p.view(1, -1).to(hist.dtype))
                hist_len = (ex["hist_len"] + 1).clamp_(max=DA_WINDOW)
                probs = probs / (hist.sum(0) / hist_len).clamp_min(1e-12)
                probs = probs / probs.sum(1, keepdim=True)
                probs_orig = probs
                a = torch.exp(feats_m[b_l:b_l + b_u] @ ex["queue_w"] / temp)
                a = a / a.sum(1, keepdim=True).clamp_min(1e-12)
                probs = torch.where(smooth.bool(), alpha * probs + (
                    1 - alpha) * (a @ ex["probs_xu"].T), probs)
                eye = torch.eye(b_u, dtype=probs.dtype, device=probs.device)
                q_self = (probs @ probs.T) * (1 - eye) + eye
                q = torch.cat([q_self, probs @ ex["probs_u"]], dim=1)
                mask = (probs.amax(1) >= thr).float()
            return (feats_m[b_l + b_u:], feats_m[:b_l + b_u], probs,
                    probs_orig, q, mask, mean_p)

        def losses(state: MatchState, logits, feats, y_l, f_us1, probs, q,
                   mask, gates: Dict[str, Tensor]):
            b_l = y_l.shape[0]
            f_us0 = feats[b_l:]
            loss_x = cross_entropy(logits[:b_l], y_l)
            loss_u = (soft_cross_entropy(logits[b_l:], probs, "none")
                      * mask).mean()
            sim = torch.cat([torch.exp(f_us0 @ f_us1.T / temp),
                             torch.exp(f_us0 @ state.extra["queue_s"]
                                       / temp)], dim=1)
            pos_mask = (q >= contrast_th).to(q.dtype)
            q_mask = q * pos_mask
            q_mask = q_mask / q_mask.sum(1, keepdim=True).clamp_min(1e-12)
            pos_probs = (sim * pos_mask) / sim.sum(
                1, keepdim=True).clamp_min(1e-12)
            log_probs = torch.log(pos_probs + 1e-7) * pos_mask
            loss_contrast = (-(log_probs * q_mask).sum(1)).mean()
            total = loss_x + gates["gate"] * (
                lam_u * loss_u + gates["lam_c"] * loss_contrast)
            return total, {"loss": total, "loss_x": loss_x,
                           "loss_u": loss_u, "loss_contrast": loss_contrast,
                           "threshold1_ratio": mask.mean()}

        @torch.no_grad()
        def commit(state: MatchState, mean_p: Tensor, f_us1: Tensor,
                   probs: Tensor, f_xuw: Tensor, y_l: Tensor,
                   probs_orig: Tensor) -> None:
            """The DA slot, then the two enqueues (``comatch.py:208-218``),
            in place."""
            ex = state.extra
            ex["hist_prob"].index_copy_(0, ex["hist_ptr"].view(1),
                                        mean_p.view(1, -1).to(
                                            ex["hist_prob"].dtype))
            ex["hist_len"].add_(1).clamp_(max=DA_WINDOW)
            ex["hist_ptr"].add_(1).remainder_(DA_WINDOW)
            enqueue(ex["queue_s"], ex["probs_u"], ex["ptr_s"], f_us1, probs)
            onehot = F.one_hot(y_l.long(), c).to(probs_orig.dtype)
            enqueue(ex["queue_w"], ex["probs_xu"], ex["ptr_w"], f_xuw,
                    torch.cat([onehot, probs_orig]))

        def step(state: MatchState, cache_l: dict, cache_u: dict,
                 idx_l: Tensor, idx_u: Tensor, epoch: int) -> MatchState:
            gates = self.set_epoch(epoch)
            y_l, y_u, x, w, s0, s1 = self.batch_views(
                state, cache_l, cache_u, idx_l, idx_u, two_strong=True)
            ema_update(state.ema, ema_source(state.net), momentum, False)
            f_us1, f_xuw, probs, probs_orig, q, mask, mean_p = \
                teacher_targets(state, x, w, s1, gates["gate"])
            state.net.train()
            logits, feats = sharded(state.net, (y_l.shape[0], y_u.shape[0]),
                                    torch.cat([x[0], s0[0]]),
                                    torch.cat([x[1], s0[1]]))
            total, logs = losses(state, logits, feats, y_l, f_us1, probs, q,
                                 mask, gates)
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            optim.step(state.optimizer)
            commit(state, mean_p, f_us1, probs, f_xuw, y_l, probs_orig)
            self.update_accuracy(state, logits, y_l, y_u)
            self.add_logs(state, logs)
            state.step += 1
            return state

        def step_micro(state: MatchState, cache_l: dict, cache_u: dict,
                       idx_l: Tensor, idx_u: Tensor,
                       epoch: int) -> MatchState:
            gates = self.set_epoch(epoch)
            ema_update(state.ema, ema_source(state.net), momentum, False)
            state.net.train()
            lacc = {k: 0.0 for k in self.LOG_KEYS}
            rows = {k: [] for k in ("mean", "us1", "x", "u", "probs",
                                    "orig")}

            def chunk(il: Tensor, iu: Tensor) -> Tensor:
                y_l, y_u, x, w, s0, s1 = self.batch_views(
                    state, cache_l, cache_u, il, iu, two_strong=True)
                f_us1, f_xuw, probs, probs_orig, q, mask, mean_p = \
                    teacher_targets(state, x, w, s1, gates["gate"])
                logits, feats = sharded(
                    state.net, (y_l.shape[0], y_u.shape[0]),
                    torch.cat([x[0], s0[0]]), torch.cat([x[1], s0[1]]))
                total, logs = losses(state, logits, feats, y_l, f_us1,
                                     probs, q, mask, gates)
                b_l = y_l.shape[0]
                for k, v in (("mean", mean_p), ("us1", f_us1),
                             ("x", f_xuw[:b_l]), ("u", f_xuw[b_l:]),
                             ("probs", probs), ("orig", probs_orig)):
                    rows[k].append(v)
                self.update_accuracy(state, logits, y_l, y_u)
                for k in self.LOG_KEYS:
                    lacc[k] = lacc[k] + logs[k].detach()
                return total

            accumulate_chunks(state.optimizer, m_micro, chunk, idx_l, idx_u)
            optim.step(state.optimizer)
            with torch.no_grad():
                cat = lambda k: torch.cat(rows[k])  # noqa: E731
                commit(state, sum(rows["mean"][1:], rows["mean"][0])
                       / m_micro, cat("us1"), cat("probs"),
                       torch.cat([cat("x"), cat("u")]),
                       gather_batch(cache_l, idx_l)["labels"], cat("orig"))
                self.add_logs(state, {k: v / m_micro
                                      for k, v in lacc.items()})
            state.step += 1
            return state

        return trace.traced("train.step",
                            step if m_micro == 1 else step_micro)
