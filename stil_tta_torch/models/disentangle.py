"""Disentangled (modality-shared vs modality-specific) fusion attention,
the port of ``stil_tta_tpu/models/disentangle.py``.

One shared qkv projection for the three streams; the image and tabular
streams self-attend, the shared stream attends over
``cat(k_global, k_img, k_tab)`` (``disentangle_transformer.py:65-81``);
one shared MLP and shared norms serve all three streams (``:151-164``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stil_tta_torch.models.layers import (LayerNorm, Linear, Mlp, drop_path,
                                          merge_heads, scaled_attention,
                                          split_heads)

Tensor = torch.Tensor


class MIAttention(nn.Module):
    """``disentangle_transformer.py:29-94``."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop

    def forward(self, x_img: Tensor, x_tab: Tensor, x_glob: Tensor
                ) -> Tuple[Tensor, Tensor, Tensor]:
        (q_i, k_i, v_i), (q_t, k_t, v_t), (q_g, k_g, v_g) = (
            [split_heads(t, self.num_heads) for t in self.qkv(x).chunk(3, -1)]
            for x in (x_img, x_tab, x_glob))
        att = lambda q, k, v: scaled_attention(  # noqa: E731
            q, k, v, self.scale, None, self.attn_drop, self.training)
        outs = (att(q_i, k_i, v_i), att(q_t, k_t, v_t),
                att(q_g, torch.cat([k_g, k_i, k_t], dim=2),
                    torch.cat([v_g, v_i, v_t], dim=2)))
        return tuple(F.dropout(self.proj(merge_heads(o)), self.proj_drop,
                               self.training) for o in outs)


class MITransformerLayer(nn.Module):
    """``disentangle_transformer.py:125-169``: shared norms and MLP across
    the three streams, residuals with per-sample DropPath. As the
    reference does, the shared MLP's dropout rate is ``drop_path``."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 1.0,
                 qkv_bias: bool = False, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, hidden, out_features=hidden, drop=drop_path,
                       dtype=dtype)
        self.attn = MIAttention(dim, num_heads, qkv_bias, attn_drop,
                                proj_drop, dtype)
        self.drop_path = drop_path

    def forward(self, x_img: Tensor, x_tab: Tensor, x_glob: Tensor
                ) -> Tuple[Tensor, Tensor, Tensor]:
        dp = lambda t: drop_path(t, self.drop_path,  # noqa: E731
                                 self.training)
        attn = self.attn(self.norm1(x_img), self.norm1(x_tab),
                         self.norm1(x_glob))
        xs = [x + dp(a) for x, a in zip((x_img, x_tab, x_glob), attn)]
        return tuple(x + dp(self.mlp(self.norm2(x))) for x in xs)
