"""Shared transformer building blocks (the port of
``stil_tta_tpu/models/layers.py``).

Parameters are float32 and keep the reference torch key names. Each layer
computes in its ``dtype`` (bfloat16 on the card) the way the JAX module
with ``dtype=bf16, param_dtype=f32`` does: inputs and weights cast to
``dtype``, attention scores and softmax in at least float32, LayerNorm
statistics in at least float32.

Every dropout mask and stochastic-depth draw comes from
:func:`stil_tta_torch.parallel.collectives.uniform_rows`: under a
data-parallel mesh a rank's mask is its rows of the single process's
mask.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from stil_tta_torch.parallel.collectives import uniform_rows

Tensor = torch.Tensor


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least float32: bfloat16 -> float32, float64 stays float64."""
    return torch.promote_types(dtype, torch.float32)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype``; with ``dtype=None`` in the
    promoted dtype of input and weight (flax ``Dense(dtype=None)``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """eps 1e-5; statistics and affine in at least float32, output in
    ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(dim, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        acc = acc_dtype(self.compute_dtype)
        y = F.layer_norm(x.to(acc), self.normalized_shape,
                         self.weight.to(acc), self.bias.to(acc), self.eps)
        return y.to(self.compute_dtype)


def drop_path(x: Tensor, rate: float, training: bool) -> Tensor:
    """Per-sample stochastic depth
    (``disentangle_transformer.py:108-123``)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.floor(keep + uniform_rows(shape, 0, x.device))
    return (x / keep) * mask.to(x.dtype)


def dropout(x: Tensor, rate: float, training: bool,
            row_dim: int = 0) -> Tensor:
    """Elementwise dropout: each element kept with probability 1 - rate
    and scaled by 1 / (1 - rate); ``row_dim`` is the axis of the batch's
    rows."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = uniform_rows(x.shape, row_dim, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class Dropout(nn.Module):
    """:func:`dropout` as a module (no parameters, like ``nn.Dropout``)."""

    def __init__(self, rate: float, row_dim: int = 0):
        super().__init__()
        self.rate, self.row_dim = rate, row_dim

    def forward(self, x: Tensor) -> Tensor:
        return dropout(x, self.rate, self.training, self.row_dim)


def split_heads(x: Tensor, num_heads: int) -> Tensor:
    """(B, N, C) -> (B, H, N, C/H)."""
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x: Tensor) -> Tensor:
    """(B, H, N, D) -> (B, N, H·D)."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def scaled_attention(q: Tensor, k: Tensor, v: Tensor, scale: float,
                     mask: Optional[Tensor] = None,
                     dropout_rate: float = 0.0,
                     training: bool = False, return_attn: bool = False,
                     attn_probe: Optional[Tensor] = None):
    """Softmax attention with an additive mask (``Transformer.py:72-85``):
    scores and softmax in at least float32, the weighted sum in ``v``'s
    dtype with a float32 accumulator. ``return_attn`` also returns the
    post-softmax map (before dropout). ``attn_probe``, a tensor of the
    map's shape, is added to the map after the softmax (no dropout
    then), so the gradient with respect to a zero probe is the gradient
    with respect to the map."""
    acc = acc_dtype(v.dtype)
    attn = (q.to(acc) @ k.to(acc).transpose(-1, -2)) * scale
    if mask is not None:
        attn = attn + mask
    attn = torch.softmax(attn, dim=-1)
    if attn_probe is None:
        weights = dropout(attn, dropout_rate, training)
    else:
        attn = weights = attn + attn_probe
    out = weights.to(v.dtype) @ v
    return (out, attn) if return_attn else out


class Mlp(nn.Module):
    """fc -> GELU -> drop -> fc -> drop (``Transformer.py:17-33``)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, drop: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features, dtype=dtype)
        self.fc2 = Linear(hidden_features, out_features or in_features,
                          dtype=dtype)
        self.drop = drop

    def forward(self, x: Tensor) -> Tensor:
        x = dropout(F.gelu(self.fc1(x)), self.drop, self.training)
        return dropout(self.fc2(x), self.drop, self.training)


class Attention(nn.Module):
    """Self-attention (``Transformer.py:36-92``). ``return_attn`` and
    ``attn_probe`` are :func:`scaled_attention`'s; the probe stands for
    the reference's ``save_attn_gradients`` hook
    (``Transformer.py:51-55``)."""

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

    def forward(self, x: Tensor, mask: Optional[Tensor] = None,
                return_attn: bool = False,
                attn_probe: Optional[Tensor] = None):
        q, k, v = (split_heads(t, self.num_heads)
                   for t in self.qkv(x).chunk(3, dim=-1))
        out, attn = scaled_attention(q, k, v, self.scale, mask,
                                     self.attn_drop, self.training, True,
                                     attn_probe)
        out = dropout(self.proj(merge_heads(out)), self.proj_drop,
                      self.training)
        return (out, attn) if return_attn else out


class CrossAttention(nn.Module):
    """Queries attend over encoder states (``Transformer.py:95-142``):
    ``kv_proj`` (bias as ``qkv_bias``) on the states, ``q_proj`` and
    ``proj`` with bias, both at the states' width ``k_dim``."""

    def __init__(self, q_dim: int, k_dim: int, num_heads: int = 8,
                 qkv_bias: bool = False, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (k_dim // num_heads) ** -0.5
        self.kv_proj = Linear(k_dim, k_dim * 2, bias=qkv_bias, dtype=dtype)
        self.q_proj = Linear(q_dim, k_dim, dtype=dtype)
        self.proj = Linear(k_dim, k_dim, dtype=dtype)
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop

    def forward(self, q_in: Tensor, k_in: Tensor,
                return_attn: bool = False):
        k, v = (split_heads(t, self.num_heads)
                for t in self.kv_proj(k_in).chunk(2, dim=-1))
        q = split_heads(self.q_proj(q_in), self.num_heads)
        out, attn = scaled_attention(q, k, v, self.scale, None,
                                     self.attn_drop, self.training, True)
        out = dropout(self.proj(merge_heads(out)), self.proj_drop,
                      self.training)
        return (out, attn) if return_attn else out


class Block(nn.Module):
    """Pre-norm transformer block (``Transformer.py:145-183``); with
    ``is_cross_attention`` a ``cross_norm`` and a :class:`CrossAttention`
    over ``encoder_hidden_states`` sit between the self-attention and
    the MLP. ``return_attn`` and ``attn_probe`` are the self-attention's
    (:class:`Attention`)."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 is_cross_attention: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop,
                              dtype)
        if is_cross_attention:
            self.cross_norm = LayerNorm(dim, dtype)
            self.cross_attn = CrossAttention(dim, dim, num_heads, qkv_bias,
                                             attn_drop, drop, dtype)
        self.is_cross_attention = is_cross_attention
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop, dtype=dtype)
        self.drop_path = drop_path

    def forward(self, x: Tensor, mask: Optional[Tensor] = None,
                encoder_hidden_states: Optional[Tensor] = None,
                return_attn: bool = False,
                attn_probe: Optional[Tensor] = None):
        out = self.attn(self.norm1(x), mask, return_attn, attn_probe)
        if return_attn:
            out, attn = out
        x = x + drop_path(out, self.drop_path, self.training)
        if self.is_cross_attention:
            if encoder_hidden_states is None:
                raise ValueError("a cross-attention Block needs "
                                 "encoder_hidden_states")
            x = x + drop_path(self.cross_attn(self.cross_norm(x),
                                              encoder_hidden_states),
                              self.drop_path, self.training)
        x = x + drop_path(self.mlp(self.norm2(x)), self.drop_path,
                          self.training)
        return (x, attn) if return_attn else x


class MLPHead(nn.Module):
    """Linear -> ReLU -> Linear (``STiLModel_backbone.py:19-32``); torch
    keys ``model.0`` / ``model.2``."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.model = nn.Sequential(Linear(in_dim, hidden_dim, dtype=dtype),
                                   nn.ReLU(),
                                   Linear(hidden_dim, out_dim, dtype=dtype))

    def forward(self, x: Tensor) -> Tensor:
        return self.model(x)


class SimCLRProjectionHead(nn.Module):
    """Linear -> ReLU -> Linear, as lightly's head at
    ``STiLModel.py:56-64``; torch keys ``layers.0`` / ``layers.2``."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.layers = nn.Sequential(Linear(in_dim, hidden_dim, dtype=dtype),
                                    nn.ReLU(),
                                    Linear(hidden_dim, out_dim, dtype=dtype))

    def forward(self, x: Tensor) -> Tensor:
        return self.layers(x)
