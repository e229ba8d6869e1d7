"""Shared loss primitives, the port of the part of
``stil_tta_tpu/losses/common.py`` the eval step uses."""

from __future__ import annotations

import torch

from stil_tta_torch.models.layers import acc_dtype

Tensor = torch.Tensor


def at_least_f32(x: Tensor) -> Tensor:
    """bfloat16 -> float32; float64 stays float64."""
    return x.to(acc_dtype(x.dtype))


def cross_entropy(logits: Tensor, labels: Tensor,
                  reduction: str = "mean") -> Tensor:
    """``torch.nn.CrossEntropyLoss`` semantics in at least float32."""
    logp = torch.log_softmax(at_least_f32(logits), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll
