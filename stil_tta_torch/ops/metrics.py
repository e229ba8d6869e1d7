"""Streaming train metrics, the port of the part of
``stil_tta_tpu/ops/metrics.py`` the STiL train step uses: exact accuracy
counters, and the bucketised AUROC of binary tasks (class-1 scores in
8192 histogram buckets, ties counted one half).

Each state is a small dataclass of tensors on the run's device; an
update adds to its tensors in place (a captured train step holds their
addresses), returns the same state and needs no host sync."""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

DEFAULT_BUCKETS = 8192


@dataclasses.dataclass
class AccuracyState:
    correct: Tensor  # float32 scalar
    total: Tensor


def accuracy_init(device="cpu") -> AccuracyState:
    z = lambda: torch.zeros((), dtype=torch.float32, device=device)  # noqa
    return AccuracyState(z(), z())


def accuracy_update(state: AccuracyState, preds: Tensor,
                    labels: Tensor) -> AccuracyState:
    """preds: (B, C) probabilities or logits, or (B,) class-1 probability
    (binary, thresholded at 0.5)."""
    if preds.dim() == 2:
        pred_cls = preds.argmax(-1)
    else:
        pred_cls = (preds >= 0.5).long()
    hit = (pred_cls == labels.long()).float()
    state.correct.add_(hit.sum())
    state.total.add_(float(hit.numel()))
    return state


def accuracy_compute(state: AccuracyState) -> float:
    return float(state.correct / state.total.clamp_min(1.0))


@dataclasses.dataclass
class AUROCState:
    pos: Tensor  # (K,) histogram of class-1 scores of positive rows
    neg: Tensor


def auroc_init(num_buckets: int = DEFAULT_BUCKETS,
               device="cpu") -> AUROCState:
    z = lambda: torch.zeros(num_buckets, dtype=torch.float32,  # noqa
                            device=device)
    return AUROCState(z(), z())


def auroc_update(state: AUROCState, preds: Tensor,
                 labels: Tensor) -> AUROCState:
    """Binary: preds (B,) class-1 probability (or (B, 2) probabilities)."""
    if preds.dim() == 2:
        preds = preds[:, 1]
    k = state.pos.shape[0]
    idx = torch.floor(preds.float().clamp(0.0, 1.0) * (k - 1) + 0.5).long()
    # 0/1 counts: the float sums are exact whatever the order
    state.pos.index_add_(0, idx, (labels == 1).float())
    state.neg.index_add_(0, idx, (labels == 0).float())
    return state


def auroc_compute(state: AUROCState) -> float:
    """Rank statistic over the bucket counts; 0 when a class is absent."""
    pos, neg = state.pos.double(), state.neg.double()
    p_total, n_total = pos.sum(), neg.sum()
    if p_total == 0 or n_total == 0:
        return 0.0
    neg_below = torch.cumsum(neg, 0) - neg
    return float((pos * (neg_below + 0.5 * neg)).sum() / (p_total * n_total))
