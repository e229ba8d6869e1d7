"""BERT-style tabular transformer encoder and TIP's two other modules,
the port of ``stil_tta_tpu/models/tabular_transformer.py``.

:class:`TabularTransformerEncoder`: per-categorical-value embedding with
cumulative offsets, a Linear(1, d) embedding per continuous value, CLS
token, learned column embedding, N pre-norm self-attention blocks, and
additive -1e9 masking of missing columns (``Transformer.py:186-278``);
``return_attn`` also returns each block's attention map and
``attn_probes`` adds a probe to each (``utils/profiling.py``). Rows are
(B, ncat+ncon) float with the categorical columns first.
:class:`MultimodalTransformerEncoder` (tabular tokens cross-attending
over image features) and :class:`TabularPredictor` (the masked
reconstruction head) are TIP's; no algorithm uses them, and they load
TIP checkpoints.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from stil_tta_torch.models.layers import Block, LayerNorm, Linear, dropout

Tensor = torch.Tensor


def split_field_lengths(field_lengths: Sequence[int]
                        ) -> Tuple[List[int], List[int]]:
    """Split field lengths into (cat, con) lists; 1 => continuous
    (``STiLModel_backbone.py:96-105``)."""
    cat = [int(x) for x in field_lengths if int(x) > 1]
    con = [1 for x in field_lengths if int(x) == 1]
    return cat, con


def build_attention_mask(missing: Tensor) -> Tensor:
    """(B, N) bool, True where a column is missing -> (B, 1, N+1, N+1)
    additive float32 mask of {0, -1e9}: every token is masked from
    attending to missing tokens, except a missing token to itself; CLS is
    never masked (``Transformer.py:264-274``)."""
    b, n = missing.shape
    cls = torch.zeros((b, 1), dtype=torch.bool, device=missing.device)
    m = torch.cat([cls, missing.bool()], dim=1)[:, None, :].expand(
        b, n + 1, n + 1)
    eye = torch.eye(n + 1, dtype=torch.bool, device=missing.device)
    return (m & ~eye)[:, None].to(torch.float32) * -1e9


class TabularTransformerEncoder(nn.Module):
    def __init__(self, cat_lengths: Sequence[int], con_lengths: Sequence[int],
                 embedding_dim: int = 512, num_layers: int = 4,
                 embedding_dropout: float = 0.0, drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_cat = len(cat_lengths)
        self.num_con = len(con_lengths)
        self.dtype = dtype
        self.embedding_dropout = embedding_dropout
        lengths = torch.tensor([int(x) for x in cat_lengths],
                               dtype=torch.long)
        self.register_buffer("cat_lengths", lengths, persistent=False)
        self.register_buffer(
            "cat_offsets", torch.cumsum(lengths, 0) - lengths,
            persistent=False)
        d = embedding_dim
        self.cat_embedding = nn.Embedding(int(lengths.sum()), d)
        self.con_proj = Linear(1, d, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.mask_special_token = nn.Parameter(torch.zeros(1, 1, d))
        self.column_embedding = nn.Embedding(self.num_cat + self.num_con + 1,
                                             d)
        self.norm = LayerNorm(d, dtype)
        self.transformer_blocks = nn.ModuleList(
            Block(d, num_heads=8, mlp_ratio=4.0, qkv_bias=False,
                  drop=drop_rate, dtype=dtype) for _ in range(num_layers))

    def embed(self, x: Tensor) -> Tensor:
        """``Transformer.py:240-259``: (B, F) rows -> (B, F+1, d) tokens."""
        parts = []
        if self.num_cat:
            # clamp each column to [0, cardinality-1], as the JAX gather
            cat = torch.minimum(x[:, :self.num_cat].long().clamp_min(0),
                                self.cat_lengths - 1)
            parts.append(self.cat_embedding(cat + self.cat_offsets)
                         .to(self.dtype))
        if self.num_con:
            parts.append(self.con_proj(
                x[:, self.num_cat:].to(self.dtype)[..., None]))
        tokens = torch.cat(parts, dim=1)
        cls = self.cls_token.to(self.dtype).expand(x.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self.column_embedding.weight.to(self.dtype)[None]
        tokens = self.norm(tokens)
        return dropout(tokens, self.embedding_dropout, self.training)

    def forward(self, x: Tensor, missing_mask: Optional[Tensor] = None,
                return_attn: bool = False,
                attn_probes: Optional[Sequence[Tensor]] = None):
        """Tokens (B, F+1, d); with ``return_attn`` also the list of each
        block's (B, 8, F+1, F+1) attention map."""
        tokens = self.embed(x)
        mask = (None if missing_mask is None
                else build_attention_mask(missing_mask))
        maps = []
        for i, block in enumerate(self.transformer_blocks):
            tokens = block(tokens, mask, return_attn=return_attn,
                           attn_probe=(None if attn_probes is None
                                       else attn_probes[i]))
            if return_attn:
                tokens, attn = tokens
                maps.append(attn)
        return (tokens, maps) if return_attn else tokens


class MultimodalTransformerEncoder(nn.Module):
    """TIP's cross-attention multimodal encoder (``Transformer.py:281-327``):
    image features ((B, N, C), or a (B, H, W, C) map taken as H·W tokens)
    through ``image_proj`` and ``image_norm``; the tabular tokens through
    ``tabular_proj`` when their width differs; ``num_layers``
    cross-attention blocks; ``norm``."""

    def __init__(self, embedding_dim: int = 2048,
                 multimodal_embedding_dim: int = 512,
                 tabular_embedding_dim: int = 512, num_layers: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        d = multimodal_embedding_dim
        self.image_proj = Linear(embedding_dim, d, dtype=dtype)
        self.image_norm = LayerNorm(d, dtype)
        self.tabular_proj = (Linear(tabular_embedding_dim, d, dtype=dtype)
                             if tabular_embedding_dim != d else None)
        self.transformer_blocks = nn.ModuleList(
            Block(d, num_heads=8, dtype=dtype, is_cross_attention=True)
            for _ in range(num_layers))
        self.norm = LayerNorm(d, dtype)

    def forward(self, x: Tensor, image_features: Tensor) -> Tensor:
        if image_features.dim() == 4:
            b, h, w, c = image_features.shape
            image_features = image_features.reshape(b, h * w, c)
        img = self.image_norm(self.image_proj(image_features))
        if self.tabular_proj is not None:
            x = self.tabular_proj(x)
        for block in self.transformer_blocks:
            x = block(x, encoder_hidden_states=img)
        return self.norm(x)


class TabularPredictor(nn.Module):
    """TIP's masked tabular reconstruction head (``Transformer.py:331-364``):
    over the tokens after CLS, a classifier over every categorical value
    on the categorical tokens and a regressor on the continuous ones,
    both in float32 (as in JAX). Returns ``(cat_out, con_out)``."""

    def __init__(self, cat_lengths: Sequence[int],
                 con_lengths: Sequence[int], embedding_dim: int = 512):
        super().__init__()
        self.num_cat = len(cat_lengths)
        self.cat_classifier = Linear(embedding_dim,
                                     int(sum(int(n) for n in cat_lengths)),
                                     dtype=torch.float32)
        self.con_regressor = Linear(embedding_dim, 1, dtype=torch.float32)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        x = x[:, 1:]
        return (self.cat_classifier(x[:, :self.num_cat]),
                self.con_regressor(x[:, self.num_cat:]))
