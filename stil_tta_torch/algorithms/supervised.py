"""The supervised multimodal baseline, the port of
``stil_tta_tpu/algorithms/supervised.py``: STiL's net trained on the
labelled batch alone with the cross-entropy of its three heads.

:class:`Supervised` is :class:`STiL` with another train step. The step
ignores the unlabelled stream, leaves the EMA teacher and the prototypes
as they are, and adds 1.0 to every class's prototype count (the JAX
step's ``prototypes_count + 1.0``), so STiL's epoch end finds every class
with mass and sets the prototypes to the zero sums over those counts, as
the JAX package's does. It replaces STiL's whole step dispatch:
``micro_batches`` is accepted and ignored, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from stil_tta_torch.algorithms.stil import STiL, STiLState
from stil_tta_torch.data.augment import contrastive_pipeline
from stil_tta_torch.data.corrupt import corrupt_tabular
from stil_tta_torch.data.loader import gather_batch, marginal_table
from stil_tta_torch.losses.common import cross_entropy
from stil_tta_torch.ops.metrics import accuracy_update
from stil_tta_torch.parallel import sharded
from stil_tta_torch.train import optim

Tensor = torch.Tensor


class Supervised(STiL):
    name = "Supervised"

    @classmethod
    def graph_unsafe(cls, cfg) -> Optional[str]:
        """Always capturable: the step ignores ``micro_batches`` and
        ``teacher_int8``."""
        return None

    def make_train_step(self):
        """``step(state, cache_l, cache_u, idx_l, idx_u, epoch,
        mask_rand=None)`` (``supervised.py:31-78``): the labelled rows'
        contrastive view at ``augmentation_rate`` and their corruption at
        ``corruption_rate``, drawn from ``state.generator``; the
        backbone's train-mode forward without the missing-column masks
        (the JAX step passes none); the sum of the three heads'
        cross-entropies; one Adam step; the train accuracy of the
        multimodal head (the class-1 probability on binary tasks); the
        loss into ``CEloss`` and ``loss``. The unlabelled stream, the
        epoch and ``mask_rand`` are not read."""
        cfg = self.cfg
        self.aug_train = contrastive_pipeline(
            int(cfg.img_size), cfg.target, float(cfg.crop_scale_lower or 0.08))
        rate = float(cfg.augmentation_rate)
        crate = float(cfg.corruption_rate)
        binary = self.num_classes == 2

        def step(state: STiLState, cache_l: dict, cache_u: dict,
                 idx_l: Tensor, idx_u: Tensor, epoch: int,
                 mask_rand: Optional[Tensor] = None) -> STiLState:
            del cache_u, idx_u, epoch, mask_rand
            bl = gather_batch(cache_l, idx_l)
            y_l = bl["labels"]
            gen = state.generator
            imgs = self.aug_train(gen, bl["images"], rate)
            tabs = corrupt_tabular(gen, bl["tabular"], marginal_table(cache_l),
                                   crate)
            net = state.net
            net.train()
            # the projectors and CLUB estimators hold no BatchNorm and no
            # dropout, and no loss reads them: the backbone alone
            outs = sharded(net.model, (y_l.shape[0],), imgs, tabs)
            loss = (cross_entropy(outs["out_m"], y_l)
                    + cross_entropy(outs["out_i"], y_l)
                    + cross_entropy(outs["out_t"], y_l))
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optim.step(state.optimizer)
            with torch.no_grad():   # in place, as STiL's step
                prob = torch.softmax(outs["out_m"].detach(), dim=1)
                accuracy_update(state.acc_train,
                                prob[:, 1] if binary else prob, y_l)
                loss = loss.detach()
                state.log_sums["CEloss"].add_(loss)
                state.log_sums["loss"].add_(loss)
                state.log_count.add_(1.0)
                state.prototypes_count.add_(1.0)
            state.step += 1
            return state

        return step
