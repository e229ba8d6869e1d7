"""STiL: the network, its train step and its eval step, the port of
``stil_tta_tpu/algorithms/stil.py`` (single-batch step; the micro-batched
step of ``micro_batches > 1`` is not ported).

:class:`STiLNet` is the backbone plus the ITC projectors and the CLUB
estimators in one module, with the reference's torch key layout
(``model.*``, ``projector_*``, ``CLUB_*``), so one ``state_dict`` serves
JAX exports and reference checkpoints alike. :class:`STiL` builds the
net on a device, the transforms, seeded random weights, the train state
(:class:`STiLState`), the train step, the epoch end and the eval step.

The train state is mutable: the step updates the net, the EMA teacher,
the optimizer and the buffers in place and returns the same object, where
the JAX package returns a new pytree.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stil_tta_torch.algorithms.base import (DAState, distribution_alignment,
                                            ema_update, sharpen)
from stil_tta_torch.data.augment import contrastive_pipeline, default_pipeline
from stil_tta_torch.data.corrupt import corrupt_tabular
from stil_tta_torch.data.loader import gather_batch, marginal_table
from stil_tta_torch.losses.clip_loss import clip_loss, l2norm
from stil_tta_torch.losses.club import CLUBMean, club_losses
from stil_tta_torch.losses.common import (at_least_f32, cross_entropy,
                                          soft_cross_entropy)
from stil_tta_torch.losses.prototype_loss import prototype_loss
from stil_tta_torch.models.backbones import DisCoBackbone
from stil_tta_torch.models.layers import (Linear, SimCLRProjectionHead,
                                          acc_dtype)
from stil_tta_torch.models.resnet import Conv2d
from stil_tta_torch.ops.metrics import (AccuracyState, AUROCState,
                                        accuracy_compute, accuracy_init,
                                        accuracy_update, auroc_compute,
                                        auroc_init, auroc_update)
from stil_tta_torch.train import optim
from stil_tta_torch.train.optim import build_optimizer

Tensor = torch.Tensor

LOG_KEYS = (
    "CEloss", "CEloss_unlabelled_m", "CEloss_unlabelled_i",
    "CEloss_unlabelled_t", "threshold1_ratio", "case1_ratio",
    "case2_i_ratio", "case2_t_ratio", "case3_ratio", "ITCloss",
    "CLUBloss_imaging", "CLUBloss_imaging_est", "CLUBloss_tabular",
    "CLUBloss_tabular_est", "PTloss", "loss",
)


def _l2norm(x: Tensor) -> Tensor:
    return l2norm(at_least_f32(x))


class STiLNet(nn.Module):
    """Backbone + ITC projectors + CLUB estimators
    (``STiLModel.py:34, 56-68``)."""

    def __init__(self, encoder: str, field_lengths: Sequence[int],
                 num_classes: int, target: str = "dvm",
                 projection_dim: int = 128, tabular_embedding_dim: int = 512,
                 multimodal_embedding_dim: int = 512,
                 tabular_num_layers: int = 4, multimodal_num_layers: int = 1,
                 embedding_dropout: float = 0.0, drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hid = multimodal_embedding_dim
        self.model = DisCoBackbone(
            encoder, field_lengths, num_classes,
            tabular_embedding_dim=tabular_embedding_dim,
            multimodal_embedding_dim=hid,
            tabular_num_layers=tabular_num_layers,
            multimodal_num_layers=multimodal_num_layers,
            embedding_dropout=embedding_dropout, drop_rate=drop_rate,
            dtype=dtype)
        self.projector_multimodal = SimCLRProjectionHead(
            hid * 3, hid * 3, projection_dim, dtype)
        if target == "dvm":
            # DVM uses linear ITC heads (``STiLModel.py:57-60``)
            self.projector_imaging = Linear(hid, projection_dim)
            self.projector_tabular = Linear(hid, projection_dim)
        else:
            self.projector_imaging = SimCLRProjectionHead(
                hid, hid, projection_dim, dtype)
            self.projector_tabular = SimCLRProjectionHead(
                hid, hid, projection_dim, dtype)
        self.CLUB_imaging = CLUBMean(hid, hid)
        self.CLUB_tabular = CLUBMean(hid, hid)

    def forward(self, image: Tensor, tabular: Tensor,
                missing_mask: Optional[Tensor] = None) -> Dict[str, Tensor]:
        out = self.model(image, tabular, missing_mask)
        feat_m_raw = torch.cat(
            [out["x_si_enhance"], out["x_c"], out["x_st_enhance"]], dim=1)
        out["feat_m"] = _l2norm(self.projector_multimodal(feat_m_raw))
        out["feat_i"] = _l2norm(self.projector_imaging(out["x_ai"]))
        out["feat_t"] = _l2norm(self.projector_tabular(out["x_at"]))
        out["mu_i"] = self.CLUB_imaging(out["x_si"])
        out["mu_t"] = self.CLUB_tabular(out["x_st"])
        return out

    def teacher(self, ema: DisCoBackbone, image: Tensor, tabular: Tensor,
                missing_mask: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """EMA forward: the EMA backbone ``ema`` (in eval mode) and this
        net's multimodal projector: the reference's EMA copies only the
        backbone (``STiLModel.py:88, 252-254``)."""
        out = ema(image, tabular, missing_mask)
        feat_m_raw = torch.cat(
            [out["x_si_enhance"], out["x_c"], out["x_st_enhance"]], dim=1)
        return {"out_m": out["out_m"], "out_i": out["out_i"],
                "out_t": out["out_t"],
                "feat_m": _l2norm(self.projector_multimodal(feat_m_raw))}


@torch.no_grad()
def init_weights(net: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights in the JAX package's init families: convs
    kaiming-normal (fan_out, ReLU), dense layers truncated-normal with
    std sqrt(1/fan_in), embeddings and tokens truncated-normal std 0.02,
    biases zero, BatchNorm scale 1 / shift 0. ``generator`` lives on the
    weights' device."""
    def normal_(t: Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator,
                            device=t.device).clamp_(-2.0, 2.0) * std)

    for mod in net.modules():
        if isinstance(mod, Conv2d):
            cout, _, kh, kw = mod.weight.shape
            mod.weight.copy_(torch.randn(
                mod.weight.shape, generator=generator,
                device=mod.weight.device) * math.sqrt(2.0 / (cout * kh * kw)))
        elif isinstance(mod, nn.Linear):
            normal_(mod.weight, math.sqrt(1.0 / mod.in_features))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 0.02)
    for name, p in net.named_parameters():
        if name.endswith(("cls_token", "mask_special_token")):
            normal_(p, 0.02)


@dataclasses.dataclass
class STiLState:
    """What a STiL run carries from step to step (the JAX package's
    ``STiLState``): the student net, the EMA backbone (None without
    ``use_ema``), the optimizer, the generator of the step's random draws
    (augmentation, corruption, case-3 routing), the prototypes and this
    epoch's sums for them, the DA ring, the streaming train metrics, this
    epoch's loss sums and the step count. The fusion layer's dropout draws
    from the device's default generator instead."""

    net: STiLNet
    ema: Optional[DisCoBackbone]
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    prototypes: Tensor            # (C, P)
    prototypes_sum: Tensor
    prototypes_count: Tensor      # (C, 1)
    da: Optional[DAState]
    acc_train: AccuracyState
    acc_train_u: AccuracyState
    auc_train: Optional[AUROCState]   # binary tasks only
    auc_train_u: Optional[AUROCState]
    log_sums: Dict[str, Tensor]
    log_count: Tensor
    step: int = 0


class STiL:
    """Builds STiL's net on ``device``, its train state, train step,
    epoch end and eval step. The net's parameters are float32 (float64
    when ``dtype`` is float64, for parity tests) and it computes in
    ``dtype``.

    cfg keys consumed (names of ``config_dvm_STiL.yaml``): model,
    num_classes, target, projection_dim, tabular_embedding_dim,
    multimodal_embedding_dim, tabular_transformer_num_layers,
    multimodal_transformer_num_layers, embedding_dropout, drop_rate,
    img_size, temperature, lambda_0; for training also alpha, beta, gamma,
    rate_pt, rate_uce, th1, rate_pseudo, start_epoch, repeat_ratio,
    use_ema, eman, ema_momentum, DA, augmentation_rate, corruption_rate,
    crop_scale_lower, lr_eval, weight_decay_eval, finetune_strategy,
    adam_mu_dtype, micro_batches and strict_prototypes."""

    name = "STiL"

    def __init__(self, cfg, field_lengths: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.num_classes = int(cfg.num_classes)
        self.net = STiLNet(
            encoder=cfg.model,
            field_lengths=tuple(int(x) for x in field_lengths),
            num_classes=self.num_classes, target=cfg.target,
            projection_dim=int(cfg.projection_dim),
            tabular_embedding_dim=int(cfg.tabular_embedding_dim),
            multimodal_embedding_dim=int(cfg.multimodal_embedding_dim),
            tabular_num_layers=int(cfg.tabular_transformer_num_layers),
            multimodal_num_layers=int(cfg.multimodal_transformer_num_layers),
            embedding_dropout=float(cfg.embedding_dropout or 0.0),
            drop_rate=float(cfg.drop_rate or 0.0),
            dtype=dtype)
        self.net.to(device=self.device, dtype=acc_dtype(dtype)).eval()
        self.aug_eval = default_pipeline(int(cfg.img_size), cfg.target)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> STiLState:
        """Seeded random weights (:func:`init_weights`), the EMA backbone
        as a copy of the student's, a fresh optimizer and zeroed buffers.
        The generator that drew the weights goes on to draw the steps'
        random views and routing."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        init_weights(self.net, gen)
        ema = None
        if bool(cfg.use_ema):
            ema = copy.deepcopy(self.net.model).eval().requires_grad_(False)
        freeze = cfg.finetune_strategy == "frozen" and bool(cfg.checkpoint)
        optimizer = build_optimizer(
            self.net.parameters(), float(cfg.lr_eval),
            float(cfg.weight_decay_eval or 0.0), freeze=freeze,
            mu_dtype=cfg.adam_mu_dtype)
        c, pdim = self.num_classes, int(cfg.projection_dim)
        adt, dev = acc_dtype(self.dtype), self.device
        state = STiLState(
            net=self.net, ema=ema, optimizer=optimizer, generator=gen,
            prototypes=torch.zeros((c, pdim), dtype=adt, device=dev),
            prototypes_sum=None, prototypes_count=None,
            da=(DAState.create(c, dtype=adt, device=dev) if bool(cfg.DA)
                else None),
            acc_train=None, acc_train_u=None, auc_train=None,
            auc_train_u=None, log_sums=None, log_count=None)
        self._reset_epoch(state)
        return state

    def _reset_epoch(self, state: STiLState) -> None:
        """Zero the per-epoch sums, metric states and loss sums."""
        c, pdim = state.prototypes.shape
        adt, dev = state.prototypes.dtype, self.device
        state.prototypes_sum = torch.zeros((c, pdim), dtype=adt, device=dev)
        state.prototypes_count = torch.zeros((c, 1), dtype=adt, device=dev)
        state.acc_train = accuracy_init(dev)
        state.acc_train_u = accuracy_init(dev)
        binary = self.num_classes == 2
        state.auc_train = auroc_init(device=dev) if binary else None
        state.auc_train_u = auroc_init(device=dev) if binary else None
        state.log_sums = {k: torch.zeros((), dtype=adt, device=dev)
                          for k in LOG_KEYS}
        state.log_count = torch.zeros((), dtype=adt, device=dev)

    def _views(self, gen: torch.Generator, bl: dict, bu: dict,
               marg_l: Tensor, marg_u: Tensor):
        """Augmented image view and corrupted tabular view of each stream
        (``ContrastiveImagingAndTabularDataset.__getitem__``: the image
        is augmented with probability augmentation_rate, the row
        corrupted at corruption_rate)."""
        rate = float(self.cfg.augmentation_rate)
        crate = float(self.cfg.corruption_rate)
        img_l = self.aug_train(gen, bl["images"], rate)
        img_u = self.aug_train(gen, bu["images"], rate)
        tab_l = corrupt_tabular(gen, bl["tabular"], marg_l, crate)
        tab_u = corrupt_tabular(gen, bu["tabular"], marg_u, crate)
        return img_l, tab_l, img_u, tab_u

    # ------------------------------------------------------------------
    def make_train_step(self):
        """The single-batch train step (``STiLModel.py:228-386``):
        ``step(state, cache_l, cache_u, idx_l, idx_u, epoch,
        mask_rand=None)`` updates ``state`` in place and returns it.
        ``mask_rand`` (B_U,) bool is the case-3 routing draw; None draws
        it from ``state.generator``.

        Order, as the reference fixes it: the student's train-mode
        forward (BatchNorm running statistics update in place); the EMAN
        lerp of the EMA backbone towards the student's pre-update
        parameters and post-forward statistics; the teacher forward
        without gradient; the CGPL/PGLS targets (all detached); the
        losses, backward and Adam step; then the prototype sums (from
        the teacher's features), metrics and loss sums."""
        cfg = self.cfg
        if int(cfg.micro_batches or 1) > 1:
            raise NotImplementedError(
                "micro_batches > 1 (the micro-batched step of the fast "
                "numerics profile) is not ported to stil_tta_torch yet "
                "(ROADMAP.md)")
        self.aug_train = contrastive_pipeline(
            int(cfg.img_size), cfg.target, float(cfg.crop_scale_lower or 0.08))
        c = self.num_classes
        alpha, beta = float(cfg.alpha), float(cfg.beta)
        gamma = float(cfg.gamma)
        rate_pt, rate_uce = float(cfg.rate_pt), float(cfg.rate_uce)
        th1, temp = float(cfg.th1), float(cfg.temperature)
        lam0 = float(cfg.lambda_0)
        rate_pseudo = float(cfg.rate_pseudo)
        start_epoch = int(cfg.start_epoch)
        repeat_ratio = float(cfg.repeat_ratio or 1.0)
        momentum = float(cfg.ema_momentum)
        use_ema, eman, use_da = bool(cfg.use_ema), bool(cfg.eman), bool(cfg.DA)
        binary = c == 2

        def cal_prototypes(label: Tensor, feat: Tensor):
            """``STiLModel.py:199-226``: confident rows' hard labels."""
            conf = (label.amax(1) >= th1).to(feat.dtype)[:, None]
            hard = F.one_hot(label.argmax(1), c).to(feat.dtype) * conf
            return hard.T @ feat, hard.sum(0)[:, None]

        def derive_targets(tout, da, prototypes, mask_rand, b_l, y_l,
                           use_pseudo):
            """CGPL cases and PGLS blending from the detached teacher
            outputs (``STiLModel.py:262-321``)."""
            feat_m_le, feat_m_ue = tout["feat_m"][:b_l], tout["feat_m"][b_l:]
            yh_m, yh_i, yh_t = (tout[k][b_l:]
                                for k in ("out_m", "out_i", "out_t"))
            top_m, top_i, top_t = (t.argmax(1) for t in (yh_m, yh_i, yh_t))
            case1 = (top_m == top_i) & (top_m == top_t)
            case2_i = (top_m == top_i) & (top_m != top_t)
            case2_t = (top_m == top_t) & (top_m != top_i)
            case3 = ~(case1 | case2_i | case2_t)
            pl1 = sharpen((yh_m + yh_i + yh_t) / 3.0, 1.0)
            adt = pl1.dtype
            f = lambda m: m.to(adt)[:, None]  # noqa: E731
            pseudo_orig = (f(case1) * pl1
                           + f(case2_i) * sharpen((yh_m + yh_i) / 2.0, 1.0)
                           + f(case2_t) * sharpen((yh_m + yh_t) / 2.0, 1.0)
                           + f(case3) * sharpen(yh_m, 1.0))
            if use_da:
                da, prediction = distribution_alignment(
                    da, torch.softmax(yh_m, dim=1))
            else:
                prediction = sharpen(yh_m, 1.0)
            teacher_probs = torch.softmax((feat_m_ue @ prototypes.T) / temp,
                                          dim=1)
            pseudo_label = (rate_pseudo * pseudo_orig
                            + (1 - rate_pseudo) * teacher_probs)
            prediction = (rate_pseudo * prediction
                          + (1 - rate_pseudo) * teacher_probs)
            return {
                "feat_m_le": feat_m_le, "feat_m_ue": feat_m_ue,
                "case1": case1, "case2_i": case2_i, "case2_t": case2_t,
                "case3": case3, "pseudo_label": pseudo_label,
                # masks and ratios in float32, as in the reference
                "mask1": (prediction.amax(1) >= th1).float(),
                "mask_rand": mask_rand.float(),
                # prediction joins the prototype/PT targets only after
                # start_epoch (:317-321)
                "pseudo_label_all": torch.cat(
                    [F.one_hot(y_l.long(), c).float(),
                     prediction * use_pseudo], dim=0),
                "da": da,
            }

        def assemble_losses(outs, tg, y_l, b_l, prototypes, use_pseudo):
            """The loss graph (``STiLModel.py:284-345``)."""
            adt = tg["mask1"].dtype
            f = lambda m: m.to(adt)  # noqa: E731
            case1, case2_i = f(tg["case1"]), f(tg["case2_i"])
            case2_t, case3 = f(tg["case2_t"]), f(tg["case3"])
            mask1, mask_rand = tg["mask1"], tg["mask_rand"]
            yh_m, yh_i, yh_t = outs["out_m"], outs["out_i"], outs["out_t"]

            def sce(logits):
                return soft_cross_entropy(logits[b_l:], tg["pseudo_label"],
                                          "none") * mask1

            loss_ce = (cross_entropy(yh_m[:b_l], y_l)
                       + cross_entropy(yh_i[:b_l], y_l)
                       + cross_entropy(yh_t[:b_l], y_l))
            loss_m_u = (sce(yh_m) * case1).mean()
            loss_i_u = (sce(yh_i) * (case1 + case2_t
                                     + case3 * mask_rand)).mean()
            loss_t_u = (sce(yh_t) * (case1 + case2_i
                                     + case3 * (1 - mask_rand))).mean()
            loss_itc, _, _ = clip_loss(outs["feat_i"], outs["feat_t"], temp,
                                       lam0)
            club_i, club_i_est = club_losses(outs["mu_i"], outs["x_ai"])
            club_t, club_t_est = club_losses(outs["mu_t"], outs["x_at"])
            loss_pt = prototype_loss(tg["pseudo_label_all"], prototypes,
                                     outs["feat_m"], temp, th1)
            base = (alpha * loss_ce + beta * loss_itc
                    + gamma * (club_i + club_i_est + club_t + club_t_est))
            extra = (rate_pt * loss_pt
                     + rate_uce * (loss_m_u + loss_i_u + loss_t_u))
            total = base + use_pseudo * extra
            logs = {
                "CEloss": loss_ce, "CEloss_unlabelled_m": loss_m_u,
                "CEloss_unlabelled_i": loss_i_u,
                "CEloss_unlabelled_t": loss_t_u,
                "threshold1_ratio": mask1.mean(),
                "case1_ratio": case1.mean(), "case2_i_ratio": case2_i.mean(),
                "case2_t_ratio": case2_t.mean(), "case3_ratio": case3.mean(),
                "ITCloss": loss_itc, "CLUBloss_imaging": club_i,
                "CLUBloss_imaging_est": club_i_est,
                "CLUBloss_tabular": club_t,
                "CLUBloss_tabular_est": club_t_est,
                "PTloss": loss_pt, "loss": total,
            }
            return total, logs

        def step(state: STiLState, cache_l: dict, cache_u: dict,
                 idx_l: Tensor, idx_u: Tensor, epoch: int,
                 mask_rand: Optional[Tensor] = None) -> STiLState:
            net, gen = state.net, state.generator
            bl, bu = gather_batch(cache_l, idx_l), gather_batch(cache_u, idx_u)
            y_l, y_u = bl["labels"], bu["labels"]
            b_l, b_u = y_l.shape[0], y_u.shape[0]
            img_l, tab_l, img_u, tab_u = self._views(
                gen, bl, bu, marginal_table(cache_l), marginal_table(cache_u))
            images = torch.cat([img_l, img_u], dim=0)
            tabs = torch.cat([tab_l, tab_u], dim=0)
            missing = None
            if "missing" in bl and "missing" in bu:
                missing = torch.cat([bl["missing"], bu["missing"]], dim=0)
            if mask_rand is None:
                mask_rand = torch.rand(b_u, generator=gen,
                                       device=gen.device) >= 0.5
            use_pseudo = float(int(epoch) > start_epoch)

            net.train()
            outs = net(images, tabs, missing)
            if use_ema:
                ema_update(state.ema, net.model, momentum, eman)
                with torch.no_grad():
                    tout = net.teacher(state.ema, images, tabs, missing)
            else:
                # no EMA: the student's own outputs are the teacher's
                # (``STiLModel.py:256-257``)
                tout = {k: outs[k].detach()
                        for k in ("out_m", "out_i", "out_t", "feat_m")}
            tg = derive_targets(tout, state.da, state.prototypes,
                                mask_rand, b_l, y_l, use_pseudo)
            total, logs = assemble_losses(outs, tg, y_l, b_l,
                                          state.prototypes, use_pseudo)
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            optim.step(state.optimizer)

            with torch.no_grad():
                # prototype sums from the teacher's features, labelled
                # terms scaled 1/repeat_ratio (:374-381)
                pla = tg["pseudo_label_all"]
                sum_l, cnt_l = cal_prototypes(pla[:b_l], tg["feat_m_le"])
                sum_u, cnt_u = cal_prototypes(pla[b_l:], tg["feat_m_ue"])
                state.prototypes_sum = (state.prototypes_sum
                                        + sum_l / repeat_ratio + sum_u)
                state.prototypes_count = (state.prototypes_count
                                          + cnt_l / repeat_ratio + cnt_u)
                prob_m = torch.softmax(outs["out_m"].detach(), dim=1)
                pm_l, pm_u = prob_m[:b_l], prob_m[b_l:]
                if binary:
                    pm_l, pm_u = pm_l[:, 1], pm_u[:, 1]
                    state.auc_train = auroc_update(state.auc_train, pm_l, y_l)
                    state.auc_train_u = auroc_update(state.auc_train_u, pm_u,
                                                     y_u)
                state.acc_train = accuracy_update(state.acc_train, pm_l, y_l)
                state.acc_train_u = accuracy_update(state.acc_train_u, pm_u,
                                                    y_u)
                state.log_sums = {k: state.log_sums[k] + logs[k].detach()
                                  for k in LOG_KEYS}
                state.log_count = state.log_count + 1.0
            state.da = tg["da"]
            state.step += 1
            return state

        return step

    def epoch_end(self, state: STiLState) -> Tuple[STiLState, Dict]:
        """Prototype normalisation (``STiLModel.py:408-415``) and the
        epoch's train logs; resets the per-epoch sums. The reference
        asserts that every class received confident mass this epoch;
        ``strict_prototypes: false`` keeps the previous prototype of an
        empty class instead."""
        count = state.prototypes_count
        strict = self.cfg.strict_prototypes
        if strict is None or strict:
            empty = torch.nonzero(count[:, 0] < 1)[:, 0].tolist()
            if empty:
                raise AssertionError(
                    f"classes with no prototype mass this epoch: {empty}")
            protos = state.prototypes_sum / count
        else:
            protos = torch.where(count >= 1, state.prototypes_sum
                                 / count.clamp_min(1.0), state.prototypes)
        n = max(float(state.log_count), 1.0)
        logs = {k: float(v) / n for k, v in state.log_sums.items()}
        logs["eval.train.acc"] = accuracy_compute(state.acc_train)
        logs["eval.train_unlabelled.acc"] = accuracy_compute(
            state.acc_train_u)
        if state.auc_train is not None:
            logs["eval.train.auc"] = auroc_compute(state.auc_train)
            logs["eval.train_unlabelled.auc"] = auroc_compute(
                state.auc_train_u)
        state.prototypes = protos
        self._reset_epoch(state)
        return state, logs

    def make_eval_step(self):
        """Validation forward (``STiLModel.py:424-474``): resize-only
        images, clean tabular, the three heads, and the val losses.
        ``step(cache, idx, pad_w=None)``; rows with ``pad_w == 0`` are
        padding and drop out of every reduction."""
        net, aug = self.net, self.aug_eval
        temp = float(self.cfg.temperature)
        lam0 = float(self.cfg.lambda_0)

        @torch.no_grad()
        def step(cache, idx: Tensor, pad_w: Optional[Tensor] = None):
            net.eval()
            batch = gather_batch(cache, idx)
            outs = net(aug(batch["images"]), batch["tabular"],
                       batch.get("missing"))
            w = (torch.ones(idx.shape[0], device=idx.device)
                 if pad_w is None else pad_w.float())
            denom = w.sum().clamp_min(1.0)
            loss_itc, itc_logits, itc_labels = clip_loss(
                outs["feat_i"], outs["feat_t"], temp, lam0, row_weights=w)
            ranks = torch.argsort(-itc_logits, dim=1, stable=True)
            top1 = ((ranks[:, 0] == itc_labels).float() * w).sum() / denom
            top5 = ((ranks[:, :5] == itc_labels[:, None]).any(1).float()
                    * w).sum() / denom
            loss_ce = (cross_entropy(outs["out_m"], batch["labels"], "none")
                       * w).sum() / denom
            club_i, club_i_est = club_losses(outs["mu_i"], outs["x_ai"], w)
            club_t, club_t_est = club_losses(outs["mu_t"], outs["x_at"], w)
            return {
                "prob_m": torch.softmax(outs["out_m"], dim=1),
                "prob_i": torch.softmax(outs["out_i"], dim=1),
                "prob_t": torch.softmax(outs["out_t"], dim=1),
                "labels": batch["labels"],
                "losses": {"ITCloss": loss_itc, "CEloss": loss_ce,
                           "CLUBloss_imaging": club_i,
                           "CLUBloss_imaging_est": club_i_est,
                           "CLUBloss_tabular": club_t,
                           "CLUBloss_tabular_est": club_t_est,
                           "top1": top1, "top5": top5},
            }

        return step
