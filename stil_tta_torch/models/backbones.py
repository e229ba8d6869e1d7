"""The fusion backbones of the port (the part of
``stil_tta_tpu/models/backbones.py`` ported so far): STiL's
disentangled contrastive backbone, the three-head concat backbone of
MMatch and Co-Training (:class:`SemiMultimodalBackbone`) and the
FixMatch families' concat backbone with a projection head
(:class:`MatchBackbone`, at the end).

:class:`DisCoBackbone` (``STiLModel_backbone.py:35-165``): image tokens
from the ResNet stage-4 map, tabular tokens (the tabular transformer, or
SAINT with ``tabular_encoder="saint"``), the si/ai/st/at disentangle
projections, shared-feature reduction, MITransformer fusion, and three
classifiers (multimodal / imaging / tabular) computing in at least
float32. Images are NHWC; tabular rows are (B, ncat+ncon) float with the
categorical columns first.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from stil_tta_torch.models.disentangle import MITransformerLayer
from stil_tta_torch.models.layers import Linear, MLPHead, acc_dtype
from stil_tta_torch.models.resnet import EMBEDDING_DIM, image_encoder
from stil_tta_torch.models.saint import SAINTEncoder
from stil_tta_torch.models.tabular_transformer import (
    TabularTransformerEncoder, split_field_lengths)

Tensor = torch.Tensor

OUTPUT_KEYS = ("out_m", "out_i", "out_t", "x_si_enhance", "x_si", "x_ai",
               "x_st_enhance", "x_st", "x_at", "x_c")


class DisCoBackbone(nn.Module):
    """STiL disentangled-attention backbone. Torch keys follow the
    reference (``encoder_imaging``, ``encoder_tabular``,
    ``projection_{si,ai,st,at}``, ``reduce``, ``transformer.{i}``,
    ``classifier_{multimodal,imaging,tabular}``). The SAINT variant
    (``STiLModel_SAINT_backbone.py:108-142``) hard-codes SAINT's
    hyperparameters (depth 1, 4 heads, colrow, token dim 32, feed-forward
    dropout ``saint_ff_dropout``) and lifts its 32-wide tokens to the
    fusion width in ``projection_st`` / ``projection_at``."""

    def __init__(self, model: str, field_lengths: Sequence[int],
                 num_classes: int, tabular_embedding_dim: int = 512,
                 multimodal_embedding_dim: int = 512,
                 tabular_num_layers: int = 4, multimodal_num_layers: int = 1,
                 embedding_dropout: float = 0.0, drop_rate: float = 0.0,
                 tabular_encoder: str = "transformer",
                 saint_ff_dropout: float = 0.8,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cat_lengths, con_lengths = split_field_lengths(field_lengths)
        self.encoder_imaging = image_encoder(
            model, return_all_feature_maps=True, dtype=dtype)
        self.saint = tabular_encoder == "saint"
        if self.saint:
            self.encoder_tabular = SAINTEncoder(
                cat_lengths, len(con_lengths), token_dim=32, depth=1,
                heads=4, ff_dropout=saint_ff_dropout, dtype=dtype)
            tab_dim = 32
        elif tabular_encoder == "transformer":
            self.encoder_tabular = TabularTransformerEncoder(
                cat_lengths, con_lengths,
                embedding_dim=tabular_embedding_dim,
                num_layers=tabular_num_layers,
                embedding_dropout=embedding_dropout, drop_rate=drop_rate,
                dtype=dtype)
            tab_dim = tabular_embedding_dim
        else:
            raise ValueError(f"unknown tabular_encoder {tabular_encoder!r}")
        hid = multimodal_embedding_dim
        img_dim = EMBEDDING_DIM[model]
        self.projection_si = MLPHead(img_dim, hid, hid, dtype)
        self.projection_ai = MLPHead(img_dim, hid, hid, dtype)
        self.projection_st = MLPHead(tab_dim, hid, hid, dtype)
        self.projection_at = MLPHead(tab_dim, hid, hid, dtype)
        self.reduce = Linear(2 * hid, hid, dtype=dtype)
        self.transformer = nn.ModuleList(
            MITransformerLayer(hid, num_heads=4, mlp_ratio=1.0,
                               qkv_bias=True, attn_drop=0.1, proj_drop=0.1,
                               drop_path=0.1, dtype=dtype)
            for _ in range(multimodal_num_layers))
        head_t = acc_dtype(dtype)
        self.classifier_multimodal = Linear(3 * hid, num_classes,
                                            dtype=head_t)
        self.classifier_imaging = Linear(2 * hid, num_classes, dtype=head_t)
        self.classifier_tabular = Linear(2 * hid, num_classes, dtype=head_t)
        self.head_dtype = head_t

    def encode(self, image: Tensor, tabular: Tensor,
               missing_mask: Optional[Tensor] = None,
               int8_image: bool = False):
        """Disentangled features (``STiLModel_backbone.py:118-132``).
        ``int8_image``: the image tower's int8 eval forward; the tabular
        encoder, projections and fusion stay exact."""
        x_i = self.encoder_imaging(image, int8=int8_image)[-1]  # NHWC view
        b, h, w, c = x_i.shape
        x_i = x_i.reshape(b, h * w, c)          # h-major tokens, as JAX
        # SAINT takes no missing-column mask
        x_t = (self.encoder_tabular(tabular) if self.saint
               else self.encoder_tabular(tabular, missing_mask))
        return (self.projection_si(x_i), self.projection_ai(x_i.mean(1)),
                self.projection_st(x_t[:, 1:]), self.projection_at(x_t[:, 0]))

    def fuse(self, x_si, x_ai, x_st, x_at):
        """``STiLModel_backbone.py:135-147``."""
        x_c = self.reduce(torch.cat([x_ai, x_at], dim=1))[:, None]
        for block in self.transformer:
            x_si, x_st, x_c = block(x_si, x_st, x_c)
        return x_si.mean(1), x_st.mean(1), x_c.mean(1)

    def forward(self, image: Tensor, tabular: Tensor,
                missing_mask: Optional[Tensor] = None,
                int8_image: bool = False) -> Dict[str, Tensor]:
        """The reference's ``forward_all`` outputs
        (``STiLModel_backbone.py:150-156``) as a dict, ``OUTPUT_KEYS``."""
        x_si, x_ai, x_st, x_at = self.encode(image, tabular, missing_mask,
                                             int8_image)
        x_si_pool, x_st_pool = x_si.mean(1), x_st.mean(1)
        x_si_enh, x_st_enh, x_c = self.fuse(x_si, x_ai, x_st, x_at)
        f = lambda t: t.to(self.head_dtype)  # noqa: E731
        return {
            "out_m": self.classifier_multimodal(
                f(torch.cat([x_si_enh, x_c, x_st_enh], dim=1))),
            "out_i": self.classifier_imaging(
                f(torch.cat([x_si_enh, x_ai], dim=1))),
            "out_t": self.classifier_tabular(
                f(torch.cat([x_st_enh, x_at], dim=1))),
            "x_si_enhance": f(x_si_enh), "x_si": f(x_si_pool),
            "x_ai": f(x_ai), "x_st_enhance": f(x_st_enh),
            "x_st": f(x_st_pool), "x_at": f(x_at), "x_c": f(x_c),
        }


class SemiMultimodalBackbone(nn.Module):
    """Concat fusion with three classifiers, the backbone of MMatch and
    Co-Training (``Multimodal_model.py:36-122``; the JAX package's
    ``SemiMultimodalBackbone``): the pooled image features, the tabular
    CLS token (the tabular transformer's, or SAINT's 32-wide one with
    ``tabular_encoder="saint"``), ``image_proj`` and, when the tabular
    width differs from the fusion width, ``tabular_proj``; their concat
    through ``multimodal_proj`` to ``projection_dim``; one linear head on
    it, one on the image features, one on the CLS token. The projections
    compute in ``dtype``, the heads in at least float32."""

    def __init__(self, model: str, field_lengths: Sequence[int],
                 num_classes: int, projection_dim: int = 128,
                 tabular_embedding_dim: int = 512,
                 multimodal_embedding_dim: int = 512,
                 tabular_num_layers: int = 4, embedding_dropout: float = 0.0,
                 drop_rate: float = 0.0, tabular_encoder: str = "transformer",
                 saint_ff_dropout: float = 0.8,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cat_lengths, con_lengths = split_field_lengths(field_lengths)
        self.encoder_imaging = image_encoder(model, dtype=dtype)
        if tabular_encoder == "saint":
            self.encoder_tabular = SAINTEncoder(
                cat_lengths, len(con_lengths), token_dim=32, depth=1,
                heads=4, ff_dropout=saint_ff_dropout, dtype=dtype)
            tab_dim = 32
        elif tabular_encoder == "transformer":
            self.encoder_tabular = TabularTransformerEncoder(
                cat_lengths, con_lengths,
                embedding_dim=tabular_embedding_dim,
                num_layers=tabular_num_layers,
                embedding_dropout=embedding_dropout, drop_rate=drop_rate,
                dtype=dtype)
            tab_dim = tabular_embedding_dim
        else:
            raise ValueError(f"unknown tabular_encoder {tabular_encoder!r}")
        hid = multimodal_embedding_dim
        img_dim = EMBEDDING_DIM[model]
        self.image_proj = Linear(img_dim, hid, dtype=dtype)
        # the JAX module compares the configured tabular width, not the
        # encoder's: SAINT's 32-wide CLS token goes in unprojected at the
        # default widths
        self.tabular_proj = (Linear(tab_dim, hid, dtype=dtype)
                             if tabular_embedding_dim != hid else None)
        proj_t = hid if self.tabular_proj is not None else tab_dim
        self.multimodal_proj = Linear(hid + proj_t, projection_dim,
                                      dtype=dtype)
        head_t = acc_dtype(dtype)
        self.classifier_multimodal = Linear(projection_dim, num_classes,
                                            dtype=head_t)
        self.classifier_imaging = Linear(img_dim, num_classes, dtype=head_t)
        self.classifier_tabular = Linear(tab_dim, num_classes, dtype=head_t)
        self.head_dtype = head_t

    def forward(self, image: Tensor, tabular: Tensor
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """``(out_m, out_i, out_t, x_m)``, all in at least float32."""
        x_i = self.encoder_imaging(image)[0]
        t_cls = self.encoder_tabular(tabular)[:, 0]
        proj_t = (self.tabular_proj(t_cls) if self.tabular_proj is not None
                  else t_cls)
        x_m = self.multimodal_proj(torch.cat(
            [self.image_proj(x_i), proj_t.to(x_i.dtype)], dim=1))
        f = lambda t: t.to(self.head_dtype)  # noqa: E731
        return (self.classifier_multimodal(f(x_m)),
                self.classifier_imaging(f(x_i)),
                self.classifier_tabular(f(t_cls)), f(x_m))


class MatchBackbone(nn.Module):
    """Concat fusion with a projection head and one classifier, the
    multimodal net of SimMatch, CoMatch and FreeMatch
    (``multimodal_backbone.py:37-124``; the JAX package's
    ``MatchBackbone``): the pooled image features through ``image_proj``
    and the tabular transformer's CLS token (through ``tabular_proj`` when
    its width differs from the fusion width), concatenated into ``x_m``;
    ``head`` (Linear, ReLU, Linear; torch keys ``head.0`` / ``head.2``)
    to ``projection_dim``; ``classifier_multimodal`` over ``x_m``. The
    projections compute in ``dtype``, the classifier and the embedding's
    L2 normalisation (``/ (norm + 1e-12)``, not clipped) in at least
    float32."""

    def __init__(self, model: str, field_lengths: Sequence[int],
                 num_classes: int, projection_dim: int = 128,
                 tabular_embedding_dim: int = 512,
                 multimodal_embedding_dim: int = 512,
                 tabular_num_layers: int = 4, embedding_dropout: float = 0.0,
                 drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cat_lengths, con_lengths = split_field_lengths(field_lengths)
        self.encoder_imaging = image_encoder(model, dtype=dtype)
        self.encoder_tabular = TabularTransformerEncoder(
            cat_lengths, con_lengths, embedding_dim=tabular_embedding_dim,
            num_layers=tabular_num_layers,
            embedding_dropout=embedding_dropout, drop_rate=drop_rate,
            dtype=dtype)
        hid = multimodal_embedding_dim
        self.image_proj = Linear(EMBEDDING_DIM[model], hid, dtype=dtype)
        self.tabular_proj = (Linear(tabular_embedding_dim, hid, dtype=dtype)
                             if tabular_embedding_dim != hid else None)
        width = 2 * hid
        self.head = nn.Sequential(Linear(width, hid, dtype=dtype), nn.ReLU(),
                                  Linear(hid, projection_dim, dtype=dtype))
        self.head_dtype = acc_dtype(dtype)
        self.classifier_multimodal = Linear(width, num_classes,
                                            dtype=self.head_dtype)
        self.dtype = dtype

    def forward(self, image: Tensor, tabular: Tensor
                ) -> Tuple[Tensor, Tensor]:
        """``(logits, embedding)``, both in at least float32."""
        x_i = self.encoder_imaging(image)[0]
        t_cls = self.encoder_tabular(tabular)[:, 0]
        if self.tabular_proj is not None:
            t_cls = self.tabular_proj(t_cls)
        x_m = torch.cat([self.image_proj(x_i), t_cls.to(self.dtype)], dim=1)
        emb = self.head(x_m).to(self.head_dtype)
        logits = self.classifier_multimodal(x_m.to(self.head_dtype))
        return logits, emb / (emb.norm(dim=1, keepdim=True) + 1e-12)
