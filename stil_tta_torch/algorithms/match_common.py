"""The shared machinery of the comparison families, the port of
``stil_tta_tpu/algorithms/match_common.py``: the train state
(:class:`MatchState`), construction with the ``multimodal`` switch on
``eval_datatype``, the seeded init, the FixMatch families' views
(:meth:`MatchBase.labeled_views`, :meth:`MatchBase.weak_strong_views`),
their ``(logits, emb)`` eval step, the epoch end and the train-metric
update (:class:`MatchBase`); the FixMatch families' nets
(:class:`ImagingNet`, :class:`MatchMultimodalNet`); and CoMatch's circular
enqueue (:func:`enqueue`, ``comatch.py:59-77``), which MMatch's memory
bank uses too.

The optimizer is a float32 Adam at ``lr_eval`` with ``weight_decay_eval``
whatever ``adam_mu_dtype`` says: the JAX ``MatchBase`` builds its
optimizer without the first-moment dtype (``match_common.py:132-134``),
so the fast profile's bfloat16 moment does not reach these families.
With ``finetune_strategy: frozen`` and a ``checkpoint`` the encoders'
updates are zero (``train/optim.py:frozen_parameters``), as for STiL.

The train state is mutable: a step updates it in place and returns it.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from stil_tta_torch.algorithms.base import DAState, init_weights
from stil_tta_torch.data.augment import (default_pipeline,
                                         hard_eval_pipeline,
                                         strong_pipeline, weak_pipeline)
from stil_tta_torch.data.corrupt import corrupt_tabular
from stil_tta_torch.data.loader import gather_batch, marginal_table
from stil_tta_torch.models.backbones import MatchBackbone
from stil_tta_torch.models.layers import Linear, acc_dtype
from stil_tta_torch.models.resnet import EMBEDDING_DIM, image_encoder
from stil_tta_torch.ops.metrics import (AccuracyState, accuracy_compute,
                                        accuracy_init, accuracy_update)
from stil_tta_torch.train import optim

Tensor = torch.Tensor

WEAK_TAB_CORRUPTION = 0.1   # StrongWeakImagingAndTabularDataset.py:79


class ImagingNet(nn.Module):
    """The imaging net of SimMatch, CoMatch and FreeMatch
    (``simmatch_model.py:20-37``; the JAX package's ``ImagingNet``): a
    ResNet (``backbone``), a linear ``classifier`` on the pooled features
    in at least float32, and a ``head`` (Linear, ReLU, Linear at the
    pooled width; torch keys ``head.0`` / ``head.2``) to
    ``projection_dim`` whose output is L2-normalised with the norm
    clipped at 1e-12. ``forward(image, tabular=None)`` returns
    ``(logits, embedding)``; the tabular rows are not read."""

    def __init__(self, encoder: str, num_classes: int,
                 projection_dim: int = 128,
                 dtype: torch.dtype = torch.bfloat16, img_size: int = 128):
        super().__init__()
        width = EMBEDDING_DIM[encoder]
        self.backbone = image_encoder(encoder, dtype=dtype,
                                      img_size=img_size)
        self.head_dtype = acc_dtype(dtype)
        self.classifier = Linear(width, num_classes, dtype=self.head_dtype)
        self.head = nn.Sequential(Linear(width, width, dtype=dtype),
                                  nn.ReLU(),
                                  Linear(width, projection_dim, dtype=dtype))

    def forward(self, image: Tensor, tabular: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
        pooled = self.backbone(image)[0]
        logits = self.classifier(pooled.to(self.head_dtype))
        emb = self.head(pooled).to(self.head_dtype)
        return logits, emb / emb.norm(dim=1, keepdim=True).clamp_min(1e-12)


class MatchMultimodalNet(nn.Module):
    """:class:`MatchBackbone` under ``model`` (the reference's torch key
    layout); returns its ``(logits, embedding)``."""

    def __init__(self, encoder: str, field_lengths: Sequence[int],
                 num_classes: int, projection_dim: int = 128,
                 tabular_embedding_dim: int = 512,
                 multimodal_embedding_dim: int = 512,
                 tabular_num_layers: int = 4,
                 dtype: torch.dtype = torch.bfloat16, img_size: int = 128):
        super().__init__()
        self.model = MatchBackbone(
            encoder, field_lengths, num_classes,
            projection_dim=projection_dim,
            tabular_embedding_dim=tabular_embedding_dim,
            multimodal_embedding_dim=multimodal_embedding_dim,
            tabular_num_layers=tabular_num_layers, dtype=dtype,
            img_size=img_size)

    def forward(self, image: Tensor, tabular: Tensor
                ) -> Tuple[Tensor, Tensor]:
        return self.model(image, tabular)


def ema_source(net: nn.Module) -> nn.Module:
    """The part of a net its EMA teacher mirrors: the backbone under
    ``model`` (the JAX EMA tree ``{"backbone": ...}``), or the whole net
    where the JAX parameters sit at the top level (:class:`ImagingNet`)."""
    return net.model if hasattr(net, "model") else net


def image_tower(net: nn.Module) -> Optional[nn.Module]:
    """The ResNet of any of the port's nets, which holds every
    BatchNorm; None for ``TabularNet``, which has neither."""
    if hasattr(net, "model"):
        return net.model.encoder_imaging
    return getattr(net, "backbone", None)


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
    """Construction, init, views, eval step, epoch end and metric update
    shared by the comparison families; a subclass provides ``LOG_KEYS``,
    ``extra_state`` and ``make_train_step``, and ``uses_ema`` when it
    keeps an EMA teacher. ``build_net`` and ``make_eval_step`` default to
    the FixMatch families' (the JAX ``MatchBase``'s): :class:`ImagingNet`,
    or :class:`MatchMultimodalNet` when ``eval_datatype`` is
    ``imaging_and_tabular`` or ``multimodal``, scored on its logits. The
    net's parameters are float32 (float64 when ``dtype`` is float64, for
    parity tests) and it computes in ``dtype``.

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
        self.multimodal = cfg.eval_datatype in ("imaging_and_tabular",
                                                "multimodal")
        self.net = self.build_net(cfg, tuple(int(x) for x in field_lengths),
                                  dtype)
        self.net.to(device=self.device, dtype=acc_dtype(dtype)).eval()
        self.aug_eval = default_pipeline(int(cfg.img_size), cfg.target)

    # -- subclass hooks -------------------------------------------------
    def build_net(self, cfg, field_lengths, dtype) -> nn.Module:
        if self.multimodal:
            return MatchMultimodalNet(
                cfg.model, field_lengths, self.num_classes,
                projection_dim=int(cfg.projection_dim),
                tabular_embedding_dim=int(cfg.tabular_embedding_dim),
                multimodal_embedding_dim=int(cfg.multimodal_embedding_dim),
                tabular_num_layers=int(cfg.tabular_transformer_num_layers),
                dtype=dtype, img_size=int(cfg.img_size))
        return ImagingNet(cfg.model, self.num_classes,
                          projection_dim=int(cfg.projection_dim),
                          dtype=dtype, img_size=int(cfg.img_size))

    def uses_ema(self) -> bool:
        return False

    def extra_state(self) -> Dict[str, object]:
        return {}

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> MatchState:
        """Seeded random weights (:func:`init_weights`), the EMA teacher
        as a copy of the student's (:func:`ema_source`) where the family
        keeps one, a fresh float32 Adam, the family's buffers and zeroed
        sums. The generator that drew the weights goes on to draw the
        steps' views."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        init_weights(self.net, gen)
        ema = None
        if self.uses_ema():
            ema = copy.deepcopy(ema_source(self.net)).eval().requires_grad_(
                False)
        # no mu_dtype: the JAX MatchBase passes none (match_common.py:132)
        optimizer = optim.build_optimizer(
            self.net.parameters(), float(cfg.lr_eval),
            float(cfg.weight_decay_eval or 0.0),
            frozen=optim.frozen_parameters(cfg, self.net))
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

    # -- the FixMatch families' views -----------------------------------
    def _prepare_views(self) -> None:
        """The train recipes, built when a train step is made (test and
        serving need none of them)."""
        img_size, target = int(self.cfg.img_size), self.cfg.target
        self.aug_labeled = hard_eval_pipeline(img_size, target)
        self.aug_weak = weak_pipeline(img_size, target)
        self.aug_strong = strong_pipeline(img_size, target)

    def labeled_views(self, gen: torch.Generator, images: Tensor,
                      tabular: Tensor, marginal: Tensor):
        """The labelled rows' view (``match_common.py:161-175``): the
        hard-eval recipe at ``eval_train_augment_rate`` (imaging) or
        ``augmentation_rate`` (multimodal), the rows corrupted at
        ``corruption_rate`` when multimodal; ``(images, tabular)``."""
        cfg = self.cfg
        rate = float(cfg.augmentation_rate if self.multimodal
                     else cfg.eval_train_augment_rate)
        imgs = self.aug_labeled(gen, images, rate)
        if self.multimodal:
            tabular = corrupt_tabular(gen, tabular, marginal,
                                      float(cfg.corruption_rate))
        return imgs, tabular

    def weak_strong_views(self, gen: torch.Generator, images: Tensor,
                          tabular: Tensor, marginal: Tensor,
                          two_strong: bool = False):
        """The unlabelled rows' views (``match_common.py:177-194``): the
        weak recipe with the rows corrupted at ``WEAK_TAB_CORRUPTION``,
        the strong recipe with the rows corrupted at ``corruption_rate``
        (tabular corruption only when multimodal), and with
        ``two_strong`` a second strong view (else ``(None, None)``)."""
        crate = float(self.cfg.corruption_rate)
        img_w = self.aug_weak(gen, images)
        img_s = self.aug_strong(gen, images)
        img_s2 = self.aug_strong(gen, images) if two_strong else None
        if self.multimodal:
            tab_w = corrupt_tabular(gen, tabular, marginal,
                                    WEAK_TAB_CORRUPTION)
            tab_s = corrupt_tabular(gen, tabular, marginal, crate)
            tab_s2 = (corrupt_tabular(gen, tabular, marginal, crate)
                      if two_strong else None)
        else:
            tab_w = tab_s = tabular
            tab_s2 = tabular if two_strong else None
        return (img_w, tab_w), (img_s, tab_s), (img_s2, tab_s2)

    def batch_views(self, state: MatchState, cache_l: dict, cache_u: dict,
                    idx_l: Tensor, idx_u: Tensor, two_strong: bool = False):
        """The labels of ``idx_l`` and ``idx_u`` and their views, drawn
        from the state's generator: ``(y_l, y_u, (img_x, tab_x), (img_w,
        tab_w), (img_s, tab_s), (img_s2, tab_s2))``."""
        bl, bu = gather_batch(cache_l, idx_l), gather_batch(cache_u, idx_u)
        gen = state.generator
        x = self.labeled_views(gen, bl["images"], bl["tabular"],
                               marginal_table(cache_l))
        w, s, s2 = self.weak_strong_views(gen, bu["images"], bu["tabular"],
                                          marginal_table(cache_u),
                                          two_strong)
        return bl["labels"], bu["labels"], x, w, s, s2

    def make_eval_step(self):
        """The ``(logits, emb)`` nets' eval step
        (``match_common.py:239-255``): resize-only images, clean tabular,
        the logits' probabilities. ``step(cache, idx, pad_w=None)``; pad
        rows are dropped by the caller, so ``pad_w`` is not read."""
        net, aug = self.net, self.aug_eval

        @torch.no_grad()
        def step(cache, idx: Tensor, pad_w=None):
            net.eval()
            batch = gather_batch(cache, idx)
            logits, _ = net(aug(batch["images"]), batch["tabular"])
            return {"prob_m": torch.softmax(logits, dim=1),
                    "labels": batch["labels"]}

        return step

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
