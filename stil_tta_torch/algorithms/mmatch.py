"""MMatch (multimodal pseudo-labelling with a memory bank, no EMA), the
port of ``stil_tta_tpu/algorithms/mmatch.py``: :class:`SemiMultimodalNet`
and :class:`MMatch` with its single-batch step and the micro-batched step
of ``micro_batches > 1``.

The three-head concat backbone; DA-aligned pseudo labels from the
student's own multimodal head; after epoch 0 they are smoothed through
the memory bank, ``0.9 * DA + 0.1 * A @ probs_bank`` with ``A`` the
softmax over the bank of the batch's embedding similarities at
``temperature``; hard-label cross entropy masked at ``th1`` on the
imaging and tabular heads; the loss ``alpha * CE_l + mmatch_lambda *
(L_i + L_t)`` past ``start_epoch``. The bank (``embed_queue`` (P, 640),
``probs_queue`` (C, 640), ``ptr``) takes the batch's normalised
embeddings and its targets (the labelled one-hots, then the pseudo
labels) after the update, truncating at its end; its position is a
0-dim int64 tensor on the device.

Co-Training (``algorithms/cotrain.py``) subclasses :class:`MMatch` for
its net, views, eval step and plumbing, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from stil_tta_torch.algorithms.base import (DAState, accumulate_chunks,
                                            distribution_alignment,
                                            draw_views)
from stil_tta_torch.algorithms.match_common import (MatchBase, MatchState,
                                                    enqueue, position)
from stil_tta_torch.data.augment import contrastive_pipeline
from stil_tta_torch.data.loader import gather_batch, marginal_table
from stil_tta_torch.losses.clip_loss import l2norm
from stil_tta_torch.losses.common import cross_entropy, soft_cross_entropy
from stil_tta_torch.models.backbones import SemiMultimodalBackbone
from stil_tta_torch.models.layers import acc_dtype
from stil_tta_torch.parallel import sharded
from stil_tta_torch.train import optim
from stil_tta_torch.utils import trace

Tensor = torch.Tensor

MMATCH_K = 640  # MMatch.py:52 (``self.K = 640``)


class SemiMultimodalNet(nn.Module):
    """:class:`SemiMultimodalBackbone` under ``model``, the reference's
    torch key layout; returns ``(out_m, out_i, out_t, x_m)``."""

    def __init__(self, encoder: str, field_lengths: Sequence[int],
                 num_classes: int, projection_dim: int = 128,
                 tabular_embedding_dim: int = 512,
                 multimodal_embedding_dim: int = 512,
                 tabular_num_layers: int = 4,
                 tabular_encoder: str = "transformer",
                 saint_ff_dropout: float = 0.8,
                 dtype: torch.dtype = torch.bfloat16, img_size: int = 128):
        super().__init__()
        self.model = SemiMultimodalBackbone(
            encoder, field_lengths, num_classes,
            projection_dim=projection_dim,
            tabular_embedding_dim=tabular_embedding_dim,
            multimodal_embedding_dim=multimodal_embedding_dim,
            tabular_num_layers=tabular_num_layers,
            tabular_encoder=tabular_encoder,
            saint_ff_dropout=saint_ff_dropout, dtype=dtype,
            img_size=img_size)

    def forward(self, image: Tensor, tabular: Tensor):
        return self.model(image, tabular)


class MMatch(MatchBase):
    """cfg keys consumed (names of ``config_dvm_MMatch.yaml``): model,
    num_classes, target, projection_dim, tabular_embedding_dim,
    multimodal_embedding_dim, tabular_transformer_num_layers, img_size,
    saint_ff_dropout; for training also alpha, mmatch_lambda, th1,
    temperature, start_epoch, DA (must be on), augmentation_rate,
    corruption_rate, crop_scale_lower, lr_eval, weight_decay_eval,
    finetune_strategy and micro_batches. ``teacher_int8`` and
    ``adam_mu_dtype`` are accepted and have no effect, as in the JAX
    package."""

    name = "MMatch"
    LOG_KEYS = ("loss", "CEloss", "CEloss_unlabelled_i",
                "CEloss_unlabelled_t", "threshold1_ratio")
    tabular_encoder = "transformer"

    def build_net(self, cfg, field_lengths, dtype) -> nn.Module:
        return SemiMultimodalNet(
            cfg.model, field_lengths, self.num_classes,
            projection_dim=int(cfg.projection_dim),
            tabular_embedding_dim=int(cfg.tabular_embedding_dim),
            multimodal_embedding_dim=int(cfg.multimodal_embedding_dim),
            tabular_num_layers=int(cfg.tabular_transformer_num_layers),
            tabular_encoder=self.tabular_encoder,
            saint_ff_dropout=(0.8 if cfg.saint_ff_dropout is None
                              else float(cfg.saint_ff_dropout)),
            dtype=dtype, img_size=int(cfg.img_size))

    def epoch_values(self, epoch: int) -> Dict[str, float]:
        """MatchBase's ``gate`` and ``smooth``, 1.0 past epoch 0 (the
        pseudo labels are smoothed through the bank)."""
        return {**super().epoch_values(epoch),
                "smooth": float(int(epoch) > 0)}

    def extra_state(self) -> Dict[str, object]:
        """The memory bank (``mmatch.py:87-95``): unit-column normal
        embeddings, zero targets, write position 0. The JAX package draws
        the embeddings from ``jax.random.key(17)``; here a generator
        seeded 17 on the run's device draws them."""
        dim, c = int(self.cfg.projection_dim), self.num_classes
        adt, dev = acc_dtype(self.dtype), self.device
        gen = torch.Generator(device=dev).manual_seed(17)
        q = torch.randn((dim, MMATCH_K), generator=gen, device=dev).to(adt)
        return {"embed_queue": q / q.norm(dim=0, keepdim=True),
                "probs_queue": torch.zeros((c, MMATCH_K), dtype=adt,
                                           device=dev),
                "ptr": position(0, dev)}

    # ------------------------------------------------------------------
    def _prepare_training(self) -> None:
        cfg = self.cfg
        self.aug_train = contrastive_pipeline(
            int(cfg.img_size), cfg.target,
            float(cfg.crop_scale_lower or 0.08))

    def chunk_views(self, state: MatchState, cache_l: dict, cache_u: dict,
                    idx_l: Tensor, idx_u: Tensor):
        """The labels of ``idx_l`` and ``idx_u`` and their contrastive
        views (``mmatch.py:97-103``), labelled rows first:
        ``(y_l, y_u, images, tabular)``."""
        bl, bu = gather_batch(cache_l, idx_l), gather_batch(cache_u, idx_u)
        img_l, tab_l, img_u, tab_u = draw_views(
            self.cfg, self.aug_train, state.generator, bl, bu,
            marginal_table(cache_l), marginal_table(cache_u))
        return (bl["labels"], bu["labels"], torch.cat([img_l, img_u], 0),
                torch.cat([tab_l, tab_u], 0))

    def make_train_step(self):
        """The train step: ``step(state, cache_l, cache_u, idx_l, idx_u,
        epoch)`` updates ``state`` in place and returns it.

        With ``micro_batches: 1``, the single-batch step
        (``mmatch.py:141-219``): one train-mode student forward (BatchNorm
        running statistics update in place); the pseudo labels from its
        detached multimodal head, aligned (DA) and, after epoch 0,
        smoothed through the bank; the losses, backward and Adam step;
        then the enqueue of the batch's embeddings and targets, labelled
        one-hots first, and the metrics.

        With ``micro_batches: m > 1``, the JAX package's ``step_micro``
        (``mmatch.py:221-356``): m chunks of B/m rows in order, each with
        its own views, one Adam step on the mean of the chunk gradients.
        Its documented divergences: BatchNorm statistics per chunk (the
        running statistics are lerped m times a step); each chunk aligns
        against the pre-step DA ring with its own mean in slot ``ptr``,
        the committed slot is the mean of the chunk means and ``ptr``
        advances once; the bank is the pre-step bank in every chunk; the
        end-of-step enqueue writes the whole batch's rows in the order
        ``[labelled..., unlabelled...]``. Accuracies add per chunk, the
        loss sums the mean of the chunks' logs."""
        cfg = self.cfg
        if not bool(cfg.DA):
            raise ValueError("MMatch aligns its pseudo labels with the DA "
                             "ring (DA: true), as the JAX step does")
        self._prepare_training()
        c = self.num_classes
        alpha = float(cfg.alpha)
        lam = float(cfg.mmatch_lambda or 1.0)
        th1, temp = float(cfg.th1), float(cfg.temperature)
        m_micro = int(cfg.micro_batches or 1)

        def forward_losses(state: MatchState, da: DAState, images, tabs,
                           y_l, gates: Dict[str, Tensor]):
            """Student forward, targets (aligned against ``da``, smoothed
            through the state's bank after epoch 0) and losses."""
            b_l = y_l.shape[0]
            om, oi, ot, xm = sharded(state.net,
                                     (b_l, images.shape[0] - b_l), images,
                                     tabs)
            feat_m = l2norm(xm.detach())
            da, pseudo = distribution_alignment(
                da, torch.softmax(om[b_l:].detach(), dim=1))
            ex = state.extra
            a = torch.exp((feat_m[b_l:] @ ex["embed_queue"]) / temp)
            a = a / a.sum(1, keepdim=True).clamp_min(1e-12)
            pseudo = torch.where(gates["smooth"].bool(), 0.9 * pseudo
                                 + 0.1 * (a @ ex["probs_queue"].T), pseudo)
            mask1 = (pseudo.amax(1) >= th1).float()
            hard = F.one_hot(pseudo.argmax(1), c).float()
            loss_ce = (cross_entropy(om[:b_l], y_l)
                       + cross_entropy(oi[:b_l], y_l)
                       + cross_entropy(ot[:b_l], y_l))
            loss_i_u = (soft_cross_entropy(oi[b_l:], hard, "none")
                        * mask1).mean()
            loss_t_u = (soft_cross_entropy(ot[b_l:], hard, "none")
                        * mask1).mean()
            total = alpha * loss_ce + gates["gate"] * lam * (loss_i_u
                                                             + loss_t_u)
            logs = {"loss": total, "CEloss": loss_ce,
                    "CEloss_unlabelled_i": loss_i_u,
                    "CEloss_unlabelled_t": loss_t_u,
                    "threshold1_ratio": mask1.mean()}
            return om, feat_m, pseudo, da, total, logs

        @torch.no_grad()
        def commit_bank(state: MatchState, feat_m: Tensor, y_l: Tensor,
                        pseudo_u: Tensor) -> None:
            ex = state.extra
            targets = torch.cat([F.one_hot(y_l.long(), c).to(pseudo_u.dtype),
                                 pseudo_u], 0)
            enqueue(ex["embed_queue"], ex["probs_queue"], ex["ptr"], feat_m,
                    targets)

        def step(state: MatchState, cache_l: dict, cache_u: dict,
                 idx_l: Tensor, idx_u: Tensor, epoch: int) -> MatchState:
            gates = self.set_epoch(epoch)
            y_l, y_u, images, tabs = self.chunk_views(state, cache_l,
                                                      cache_u, idx_l, idx_u)
            state.net.train()
            om, feat_m, pseudo, da, total, logs = forward_losses(
                state, state.da, images, tabs, y_l, gates)
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            optim.step(state.optimizer)
            commit_bank(state, feat_m, y_l, pseudo)
            self.update_accuracy(state, om, y_l, y_u)
            self.add_logs(state, logs)
            state.step += 1
            return state

        def step_micro(state: MatchState, cache_l: dict, cache_u: dict,
                       idx_l: Tensor, idx_u: Tensor,
                       epoch: int) -> MatchState:
            gates = self.set_epoch(epoch)
            state.net.train()
            da0 = state.da
            lacc = {k: 0.0 for k in self.LOG_KEYS}
            means, feats_l, feats_u, pseudos = [], [], [], []

            def chunk(il: Tensor, iu: Tensor) -> Tensor:
                y_l, y_u, images, tabs = self.chunk_views(
                    state, cache_l, cache_u, il, iu)
                om, feat_m, pseudo, da_c, total, logs = forward_losses(
                    state, da0.clone(), images, tabs, y_l, gates)
                # the chunk's mean sits in the slot its alignment wrote
                means.append(da_c.row(da0.ptr))
                b_l = y_l.shape[0]
                feats_l.append(feat_m[:b_l])
                feats_u.append(feat_m[b_l:])
                pseudos.append(pseudo)
                self.update_accuracy(state, om, y_l, y_u)
                for k in self.LOG_KEYS:
                    lacc[k] = lacc[k] + logs[k].detach()
                return total

            accumulate_chunks(state.optimizer, m_micro, chunk, idx_l, idx_u)
            optim.step(state.optimizer)
            with torch.no_grad():
                da0.write(sum(means[1:], means[0]) / m_micro)
                y_l = gather_batch(cache_l, idx_l)["labels"]
                commit_bank(state, torch.cat(feats_l + feats_u, 0), y_l,
                            torch.cat(pseudos, 0))
                self.add_logs(state, {k: v / m_micro
                                      for k, v in lacc.items()})
            state.step += 1
            return state

        return trace.traced("train.step",
                            step if m_micro == 1 else step_micro)

    def make_eval_step(self):
        """The three-head eval step (``mmatch.py:112-127``): resize-only
        images, clean tabular, the three heads' probabilities.
        ``step(cache, idx, pad_w=None)``; pad rows are dropped by the
        caller, so ``pad_w`` is not read."""
        net, aug = self.net, self.aug_eval

        @torch.no_grad()
        def step(cache, idx: Tensor, pad_w=None):
            net.eval()
            batch = gather_batch(cache, idx)
            om, oi, ot, _ = net(aug(batch["images"]), batch["tabular"])
            return {"prob_m": torch.softmax(om, dim=1),
                    "prob_i": torch.softmax(oi, dim=1),
                    "prob_t": torch.softmax(ot, dim=1),
                    "labels": batch["labels"]}

        return step
