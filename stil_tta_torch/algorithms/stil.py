"""STiL's network and eval step (the part of
``stil_tta_tpu/algorithms/stil.py`` the test-time path uses).

:class:`STiLNet` is the backbone plus the ITC projectors and the CLUB
estimators in one module, with the reference's torch key layout
(``model.*``, ``projector_*``, ``CLUB_*``), so one ``state_dict`` serves
JAX exports and reference checkpoints alike. :class:`STiL` builds the
net on a device, the resize-only eval transform, seeded random weights,
and the eval step. The train step is still to port (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from stil_tta_torch.data.augment import default_pipeline
from stil_tta_torch.data.loader import gather_batch
from stil_tta_torch.losses.clip_loss import clip_loss, l2norm
from stil_tta_torch.losses.club import CLUBMean, club_losses
from stil_tta_torch.losses.common import at_least_f32, cross_entropy
from stil_tta_torch.models.backbones import DisCoBackbone
from stil_tta_torch.models.layers import (Linear, SimCLRProjectionHead,
                                          acc_dtype)
from stil_tta_torch.models.resnet import Conv2d

Tensor = torch.Tensor


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


class STiL:
    """Builds STiL's net on ``device`` and its eval step. The net's
    parameters are float32 (float64 when ``dtype`` is float64, for
    parity tests) and it computes in ``dtype``.

    cfg keys consumed (names of ``config_dvm_STiL.yaml``): model,
    num_classes, target, projection_dim, tabular_embedding_dim,
    multimodal_embedding_dim, tabular_transformer_num_layers,
    multimodal_transformer_num_layers, embedding_dropout, drop_rate,
    img_size, temperature, lambda_0."""

    name = "STiL"

    def __init__(self, cfg, field_lengths: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
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
