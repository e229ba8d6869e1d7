"""Shared loss primitives, the port of ``stil_tta_tpu/losses/common.py``:
``cross_entropy``, the soft-target ``soft_cross_entropy`` of the
pseudo-label losses and FreeMatch's fairness loss ``entropy_loss``."""

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
    return _reduce(nll, reduction)


def soft_cross_entropy(logits: Tensor, target_probs: Tensor,
                       reduction: str = "mean") -> Tensor:
    """Cross entropy against soft targets (rows of probabilities), in at
    least float32."""
    logp = torch.log_softmax(at_least_f32(logits), dim=-1)
    nll = -(at_least_f32(target_probs) * logp).sum(-1)
    return _reduce(nll, reduction)


def _reduce(nll: Tensor, reduction: str) -> Tensor:
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def entropy_loss(mask: Tensor, logits_s: Tensor, prob_model: Tensor,
                 label_hist: Tensor) -> Tensor:
    """FreeMatch's self-adaptive fairness loss
    (``freematch_utils.py:17-45``; ``losses/common.py:49-73``): the
    histogram and mean of the strong view's predictions over the rows of
    ``mask`` (their count clipped at 1), each divided by its EMA
    counterpart (``prob_model``, ``label_hist``; an empty bin gives 0),
    renormalised, and ``sum(mod_prob * log(mod_mean_prob + 1e-12))``; 0
    when the mask is empty. ``mask`` (B,) is a float32 0/1 vector."""
    prob_s = torch.softmax(at_least_f32(logits_s), dim=-1)
    mask = mask.to(prob_s.dtype)
    denom = mask.sum()
    safe = denom.clamp_min(1.0)
    hist_s = torch.zeros(logits_s.shape[-1], dtype=prob_s.dtype,
                         device=prob_s.device).index_add_(
        0, prob_s.argmax(-1), mask) / safe
    prob_s_mean = (prob_s * mask[:, None]).sum(0) / safe

    def inv0(v: Tensor) -> Tensor:
        return torch.where(v > 0, 1.0 / v.clamp_min(1e-12),
                           torch.zeros_like(v))

    mod_prob = prob_model * inv0(label_hist)
    mod_prob = mod_prob / mod_prob.sum()
    mod_mean_prob = prob_s_mean * inv0(hist_s)
    mod_mean_prob = mod_mean_prob / mod_mean_prob.sum().clamp_min(1e-12)
    loss = (mod_prob * torch.log(mod_mean_prob + 1e-12)).sum()
    return torch.where(denom > 0, loss, torch.zeros_like(loss))
