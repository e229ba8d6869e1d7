"""Symmetric InfoNCE (CLIP) loss, the port of
``stil_tta_tpu/losses/clip_loss.py`` (``utils/clip_loss.py:6-40``)."""

from __future__ import annotations

from typing import Optional

import torch

from stil_tta_torch.losses.common import at_least_f32, cross_entropy

Tensor = torch.Tensor


def l2norm(x: Tensor) -> Tensor:
    """Rows scaled to unit L2 norm (norms clipped at 1e-12)."""
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


def clip_loss(out0: Tensor, out1: Tensor, temperature: float,
              lambda_0: float = 0.5, row_weights: Optional[Tensor] = None):
    """Returns (loss, logits, labels). ``row_weights`` (0/1 per row)
    excludes padded rows from the similarity matrix (as -1e9 rows and
    columns) and from the reduction."""
    out0, out1 = l2norm(at_least_f32(out0)), l2norm(at_least_f32(out1))
    logits = (out0 @ out1.T) / temperature
    labels = torch.arange(out0.shape[0], device=out0.device)
    if row_weights is None:
        loss = (lambda_0 * cross_entropy(logits, labels)
                + (1.0 - lambda_0) * cross_entropy(logits.T, labels))
        return loss, logits, labels
    w = row_weights.to(logits.dtype)
    col_mask = torch.where(w > 0, 0.0, -1e9).to(logits.dtype)
    logits = logits + col_mask[None, :] + col_mask[:, None]
    denom = w.sum().clamp_min(1.0)
    nll0 = cross_entropy(logits, labels, "none")
    nll1 = cross_entropy(logits.T, labels, "none")
    loss = (lambda_0 * (nll0 * w).sum()
            + (1.0 - lambda_0) * (nll1 * w).sum()) / denom
    return loss, logits, labels
