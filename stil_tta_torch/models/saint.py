"""SAINT tabular encoder, the port of ``stil_tta_tpu/models/saint.py``.

The encoder the STiL-SAINT backbone drives: a CLS column (category id 0)
before the categorical columns, categorical embeddings with the offsets
``cumsum([0, 1] + cats)[:-1]``, one [1 -> 100 -> dim] MLP per continuous
column (vectorised: ``con_mlp_w1/b1/w2/b2`` stack the columns' weights),
positional encodings on the CLS and categorical tokens only, then per
layer column attention and intersample (row) attention, where the batch
is the sequence: ``(1, B, n * dim)``. A prediction therefore depends on
its batch mates. Under a data-parallel mesh the intersample attention
stays global, as under the JAX package's GSPMD: each rank's rows attend
over the keys and values of every rank's rows, and the feed-forward
dropout masks are the single process's
(:mod:`stil_tta_torch.parallel.collectives`).

Quirks of the reference kept as the JAX module keeps them: each sublayer
is ``fn(norm(x)) + norm(x)`` (the residual carries the normed input);
attention has no dropout (the reference defines it and never applies
it), its logits are accumulated in at least float32, scaled after the
product, and cast to ``v``'s dtype before the second product; only the
feed-forward dropout acts. Categorical indices are clamped to each
column's cardinality. SAINT takes no missing-column mask.

``state_dict`` keys follow the somepago/saint layout of the reference's
checkpoints (``embeds``, ``pos_encodings``, ``simple_MLP.{i}.layers.{0,
2}``, ``transformer.layers.{d}.{0..3}.{norm, fn.fn.*}``); the vectorised
MLP stacks are split into the per-column keys on save and stacked back on
load.
"""

from __future__ import annotations

import re
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from stil_tta_torch.models.layers import (Dropout, LayerNorm, Linear,
                                          merge_heads, scaled_attention,
                                          split_heads)
from stil_tta_torch.parallel.collectives import active_shard, gather_rows

Tensor = torch.Tensor

# the per-column MLP's keys in the reference layout, and the stacked
# parameter each belongs to with the transform between them
_CON_MLP = (("con_mlp_w1", "layers.0.weight", True),
            ("con_mlp_b1", "layers.0.bias", False),
            ("con_mlp_w2", "layers.2.weight", True),
            ("con_mlp_b2", "layers.2.bias", False))


class SaintAttention(nn.Module):
    """``model_util.py:60-87``: qkv without bias, out with bias.
    ``intersample``: the input is ``(1, B, n * dim)``, the batch's rows
    the sequence."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dtype: torch.dtype = torch.bfloat16,
                 intersample: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.scale = heads, dim_head ** -0.5
        self.intersample = intersample
        self.to_qkv = Linear(dim, inner * 3, bias=False, dtype=dtype)
        self.to_out = Linear(inner, dim, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        q, k, v = (split_heads(t, self.heads)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        shard = active_shard()
        if self.intersample and shard is not None:
            # the keys and values of every rank's rows (axis 2 of (1, H,
            # B, D)); each rank's rows take every rank's queries' gradients
            k, v = gather_rows(torch.cat([k, v], dim=-1), shard, dim=2,
                               summed=True).chunk(2, dim=-1)
        return self.to_out(merge_heads(scaled_attention(q, k, v,
                                                        self.scale)))


class GEGLU(nn.Module):
    def forward(self, x: Tensor) -> Tensor:
        a, gates = x.chunk(2, dim=-1)
        return a * F.gelu(gates)


class GEGLUFeedForward(nn.Module):
    """``model_util.py:43-57``: Linear -> GEGLU -> Dropout -> Linear,
    torch keys ``net.0`` / ``net.3``; ``row_dim`` is the axis of the
    batch's rows."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, row_dim: int = 0):
        super().__init__()
        self.net = nn.Sequential(Linear(dim, dim * mult * 2, dtype=dtype),
                                 GEGLU(), Dropout(dropout, row_dim),
                                 Linear(dim * mult, dim, dtype=dtype))

    def forward(self, x: Tensor) -> Tensor:
        return self.net(x)


class _Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn


class PreNormResidual(nn.Module):
    """The reference's ``PreNorm(dim, Residual(fn))``: ``fn(norm(x)) +
    norm(x)``."""

    def __init__(self, dim: int, fn: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(dim, dtype)
        self.fn = _Residual(fn)

    def forward(self, x: Tensor) -> Tensor:
        h = self.norm(x)
        return self.fn.fn(h) + h


def _split_con_mlp(module, state_dict, prefix, local_metadata) -> None:
    """state_dict hook: the stacked MLP parameters -> per-column keys."""
    for stacked, leaf, transpose in _CON_MLP:
        v = state_dict.pop(prefix + stacked)
        for i in range(v.shape[0]):
            state_dict[f"{prefix}simple_MLP.{i}.{leaf}"] = (
                v[i].T if transpose else v[i])


def _stack_con_mlp(state_dict, prefix, local_metadata, strict, missing_keys,
                   unexpected_keys, error_msgs) -> None:
    """load pre-hook: per-column keys -> the stacked MLP parameters."""
    pat = re.compile(re.escape(prefix) + r"simple_MLP\.(\d+)\.")
    cols = {int(m.group(1)) for k in state_dict for m in [pat.match(k)] if m}
    if not cols:
        return
    for stacked, leaf, transpose in _CON_MLP:
        keys = [f"{prefix}simple_MLP.{i}.{leaf}" for i in range(max(cols) + 1)]
        if all(k in state_dict for k in keys):
            vals = [state_dict.pop(k) for k in keys]
            state_dict[prefix + stacked] = torch.stack(
                [v.T if transpose else v for v in vals])


class SAINTEncoder(nn.Module):
    """(B, ncat + ncon) rows -> (B, 1 + ncat + ncon, token_dim) tokens,
    CLS first. Parameters float32; computes in ``dtype``."""

    def __init__(self, cat_lengths: Sequence[int], num_continuous: int,
                 token_dim: int = 32, depth: int = 1, heads: int = 4,
                 dim_head: int = 16, ff_dropout: float = 0.8,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cats = [int(c) for c in cat_lengths]
        ncat, ncon, dim = len(cats), int(num_continuous), token_dim
        self.ncat, self.ncon, self.dim = ncat, ncon, dim
        self.dtype = dtype
        self.register_buffer("offsets", torch.tensor(
            [0, 1] + cats).cumsum(0)[:-1], persistent=False)
        self.register_buffer("cat_max", torch.tensor(cats) - 1,
                             persistent=False)
        self.embeds = nn.Embedding(sum(cats) + 1, dim)
        self.pos_encodings = nn.Embedding(ncat + ncon, dim)
        self.con_mlp_w1 = nn.Parameter(torch.zeros(ncon, 1, 100))
        self.con_mlp_b1 = nn.Parameter(torch.zeros(ncon, 100))
        self.con_mlp_w2 = nn.Parameter(torch.zeros(ncon, 100, dim))
        self.con_mlp_b2 = nn.Parameter(torch.zeros(ncon, dim))
        n = 1 + ncat + ncon
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(nn.ModuleList([
            PreNormResidual(dim, SaintAttention(dim, heads, dim_head, dtype),
                            dtype),
            PreNormResidual(dim, GEGLUFeedForward(dim, 4, ff_dropout, dtype),
                            dtype),
            PreNormResidual(n * dim, SaintAttention(
                n * dim, heads, 64, dtype, intersample=True), dtype),
            PreNormResidual(n * dim, GEGLUFeedForward(
                n * dim, 4, ff_dropout, dtype, row_dim=1), dtype),
        ]) for _ in range(depth))
        self._register_state_dict_hook(_split_con_mlp)
        self._register_load_state_dict_pre_hook(_stack_con_mlp)

    def forward(self, x: Tensor) -> Tensor:
        ncat, dt = self.ncat, self.dtype
        b = x.shape[0]
        cat = torch.minimum(x[:, :ncat].to(torch.int64).clamp_min(0),
                            self.cat_max)
        cls = torch.zeros((b, 1), dtype=torch.int64, device=x.device)
        x_categ = torch.cat([cls, cat], dim=1) + self.offsets
        x_categ_enc = self.embeds(x_categ).to(dt)
        con = x[:, ncat:].to(dt)[..., None]                 # (B, ncon, 1)
        h = F.relu(torch.einsum("bci,cih->bch", con, self.con_mlp_w1.to(dt))
                   + self.con_mlp_b1.to(dt))
        x_cont_enc = (torch.einsum("bch,cho->bco", h, self.con_mlp_w2.to(dt))
                      + self.con_mlp_b2.to(dt))
        x_categ_enc = x_categ_enc + self.pos_encodings.weight[:ncat + 1].to(
            dt)[None]
        tokens = torch.cat([x_categ_enc, x_cont_enc], dim=1)
        n = tokens.shape[1]
        for attn_col, ff_col, attn_row, ff_row in self.transformer.layers:
            tokens = ff_col(attn_col(tokens))
            flat = ff_row(attn_row(tokens.reshape(1, b, n * self.dim)))
            tokens = flat.reshape(b, n, self.dim)
        return tokens
