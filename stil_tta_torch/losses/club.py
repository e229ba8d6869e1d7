"""CLUB mutual-information upper bound (variance-1 "CLUBMean"), the port
of ``stil_tta_tpu/losses/club.py`` (``club.py:88-130``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from stil_tta_torch.losses.common import at_least_f32
from stil_tta_torch.models.layers import Linear

Tensor = torch.Tensor


class CLUBMean(nn.Module):
    """Mean head Linear(x_dim, hidden) -> ReLU -> Linear(hidden, y_dim),
    in at least float32; torch keys ``p_mu.0`` / ``p_mu.2``."""

    def __init__(self, x_dim: int, y_dim: int, hidden_size: int = 512):
        super().__init__()
        self.p_mu = nn.Sequential(Linear(x_dim, hidden_size), nn.ReLU(),
                                  Linear(hidden_size, y_dim))

    def forward(self, x_samples: Tensor) -> Tensor:
        return self.p_mu(at_least_f32(x_samples))


def club_losses(mu: Tensor, y_samples: Tensor,
                weights: Optional[Tensor] = None):
    """Given mu = CLUBMean(x), returns (mi_upper_bound, learning_loss);
    ``weights`` (0/1 per row) excludes padded rows from every reduction,
    the negative-pair means included."""
    mu, y = at_least_f32(mu), at_least_f32(y_samples)
    positive = -((mu - y) ** 2).sum(-1) / 2.0
    if weights is None:
        y_sq_mean = (y ** 2).sum(-1).mean()
        y_mean = y.mean(0)
        wmean = torch.mean
    else:
        w = weights.to(mu.dtype)
        denom = w.sum().clamp_min(1.0)
        y_sq_mean = ((y ** 2).sum(-1) * w).sum() / denom
        y_mean = (y * w[:, None]).sum(0) / denom
        wmean = lambda v: (v * w).sum() / denom  # noqa: E731
    negative = -(y_sq_mean - 2.0 * (mu @ y_mean) + (mu ** 2).sum(-1)) / 2.0
    return wmean(positive - negative), wmean(((mu - y) ** 2).sum(1))
