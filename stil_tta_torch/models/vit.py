"""Vision Transformer image encoder, the port of
``stil_tta_tpu/models/vit.py``: a pre-norm ViT on the tabular encoder's
transformer blocks.

A ``patch_embed`` conv with bias cuts the image into p x p patches (p =
16), a ``cls_token`` goes in front, ``pos_embed`` is added, then
``depth`` blocks with ``qkv_bias`` and a final ``norm``. The output
follows the encoder zoo's contract: with ``return_all_feature_maps`` a
one-element list holding the patch tokens as a (B, H/p, W/p, C) grid
(the DisCo backbone's stage-4-tokens path), otherwise the [CLS]
embedding. ``pos_embed`` has one row a patch of an ``img_size`` image
plus one, as the JAX module sizes it at init. Inputs are NHWC float.
The tower has no BatchNorm, so no BN kernel runs in it.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from stil_tta_torch.models.layers import Block, LayerNorm

Tensor = torch.Tensor


class ViT(nn.Module):
    """Torch keys ``patch_embed``, ``cls_token``, ``pos_embed``,
    ``transformer_blocks.{i}`` (JAX ``block_i``) and ``norm``."""

    def __init__(self, patch_size: int = 16, embedding_dim: int = 384,
                 depth: int = 12, num_heads: int = 6, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, return_all_feature_maps: bool = False,
                 img_size: int = 128, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        d = embedding_dim
        self.patch_size = patch_size
        self.return_all_feature_maps = return_all_feature_maps
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, d, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, (img_size // patch_size) ** 2 + 1, d))
        self.transformer_blocks = nn.ModuleList(
            Block(d, num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=True,
                  drop=drop_rate, dtype=dtype) for _ in range(depth))
        self.norm = LayerNorm(d, dtype)

    def forward(self, x: Tensor, int8: bool = False) -> List[Tensor]:
        """``int8`` is taken and ignored: the int8 convolutions are the
        ResNets' (the JAX backbone drops the flag for a ViT)."""
        b, h, w, _ = x.shape
        p, dt = self.patch_size, self.dtype
        gh, gw = h // p, w // p
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.conv2d(x, self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=p)
        tokens = x.flatten(2).transpose(1, 2)             # (B, gh·gw, C)
        cls = self.cls_token.to(dt).expand(b, -1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(dt)
        for block in self.transformer_blocks:
            tokens = block(tokens)
        tokens = self.norm(tokens)
        if self.return_all_feature_maps:
            return [tokens[:, 1:].reshape(b, gh, gw, -1)]
        return [tokens[:, 0]]


def vit_small(**kw) -> ViT:
    return ViT(embedding_dim=384, depth=12, num_heads=6, **kw)


def vit_base(**kw) -> ViT:
    return ViT(embedding_dim=768, depth=12, num_heads=12, **kw)
