"""Tabular-only supervised evaluation, the port of
``stil_tta_tpu/algorithms/tabular_eval.py``.

:class:`TabularNet` is the tabular transformer with a float32 linear
head on the CLS token; it has no image tower and no BatchNorm.
:class:`TabularEval` trains it on the labelled batch with the
cross-entropy loss, each row's marginal corruption gated by a draw below
``eval_train_augment_rate``. It is a :class:`MatchBase` whose net is a
:class:`TabularNet` from the start: the JAX ``MatchBase`` builds a Match
net first and replaces it, which costs nothing in flax, and would
allocate a ResNet here.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from stil_tta_torch.algorithms.match_common import MatchBase, MatchState
from stil_tta_torch.data.corrupt import apply_corruption, sample_corruption
from stil_tta_torch.data.loader import gather_batch, marginal_table
from stil_tta_torch.losses.common import cross_entropy
from stil_tta_torch.models.layers import Linear
from stil_tta_torch.models.tabular_transformer import (
    TabularTransformerEncoder, split_field_lengths)
from stil_tta_torch.ops.metrics import accuracy_update
from stil_tta_torch.parallel import sharded
from stil_tta_torch.train import optim

Tensor = torch.Tensor


class TabularNet(nn.Module):
    """``tabular_eval.py:27-46``: the encoder (torch keys
    ``encoder_tabular.*``) and ``classifier`` on the CLS token cast to
    float32, computing in the promoted dtype of token and weight. The
    image argument is not read; the forward returns the logits."""

    def __init__(self, field_lengths: Sequence[int], num_classes: int,
                 tabular_embedding_dim: int = 512, num_layers: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cat, con = split_field_lengths(field_lengths)
        self.encoder_tabular = TabularTransformerEncoder(
            cat, con, embedding_dim=tabular_embedding_dim,
            num_layers=num_layers, dtype=dtype)
        self.classifier = Linear(tabular_embedding_dim, num_classes)

    def forward(self, image: Optional[Tensor], tabular: Tensor) -> Tensor:
        del image
        tokens = self.encoder_tabular(tabular)
        return self.classifier(tokens[:, 0].to(torch.float32))


class TabularEval(MatchBase):
    """cfg keys consumed: num_classes, tabular_embedding_dim,
    tabular_transformer_num_layers, img_size and target (the eval
    transform, which the net does not read), lr_eval, weight_decay_eval,
    eval_train_augment_rate, corruption_rate."""

    name = "TabularEval"
    LOG_KEYS = ("loss",)

    def epoch_values(self, epoch: int) -> Dict[str, float]:
        """None: the step does not read the epoch."""
        return {}

    def build_net(self, cfg, field_lengths, dtype) -> nn.Module:
        return TabularNet(
            field_lengths, self.num_classes,
            tabular_embedding_dim=int(cfg.tabular_embedding_dim),
            num_layers=int(cfg.tabular_transformer_num_layers), dtype=dtype)

    def sample_views(self, gen: torch.Generator, b: int, f: int,
                     n: int) -> Dict[str, object]:
        """The step's draws for ``b`` rows of ``f`` fields out of a table
        of ``n`` rows: the corruption's (``data/corrupt.py``) and the (B,
        1) gate, True where a row is corrupted."""
        rate = float(self.cfg.eval_train_augment_rate)
        return {"corruption": sample_corruption(
                    gen, b, f, n, float(self.cfg.corruption_rate)),
                "gate": torch.rand(b, 1, generator=gen,
                                   device=gen.device) < rate}

    def make_train_step(self):
        """``step(state, cache_l, cache_u, idx_l, idx_u, epoch,
        draws=None)`` (``tabular_eval.py:59-101``): the labelled rows,
        corrupted at ``corruption_rate`` where the gate holds; the
        train-mode forward; the cross-entropy; one Adam step; the
        labelled train accuracy (the class-1 probability on binary
        tasks); the loss into ``loss``. ``draws`` are
        :meth:`sample_views`'s; None draws them from
        ``state.generator``."""
        crate = float(self.cfg.corruption_rate)
        binary = self.num_classes == 2

        def step(state: MatchState, cache_l: dict, cache_u: dict,
                 idx_l: Tensor, idx_u: Tensor, epoch: int,
                 draws: Optional[Dict[str, object]] = None) -> MatchState:
            del cache_u, idx_u, epoch
            bl = gather_batch(cache_l, idx_l)
            y, rows = bl["labels"], bl["tabular"]
            marginal = marginal_table(cache_l)
            if draws is None:
                draws = self.sample_views(state.generator, *rows.shape,
                                          marginal.shape[0])
            corrupted = apply_corruption(rows, marginal, crate,
                                         draws["corruption"])
            tabs = torch.where(draws["gate"], corrupted, rows)
            net = state.net
            net.train()
            logits = sharded(net, (y.shape[0],), None, tabs)
            loss = cross_entropy(logits, y)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optim.step(state.optimizer)
            with torch.no_grad():
                prob = torch.softmax(logits.detach(), dim=1)
                accuracy_update(state.acc_train,
                                prob[:, 1] if binary else prob, y)
            self.add_logs(state, {"loss": loss})
            state.step += 1
            return state

        return step

    def make_eval_step(self):
        """``tabular_eval.py:103-119``: the clean rows' probabilities and
        labels; ``step(cache, idx, pad_w=None)``, ``pad_w`` not read."""
        net = self.net

        @torch.no_grad()
        def step(cache, idx: Tensor, pad_w=None):
            net.eval()
            batch = gather_batch(cache, idx)
            logits = net(None, batch["tabular"])
            return {"prob_m": torch.softmax(logits, dim=1),
                    "labels": batch["labels"]}

        return step
