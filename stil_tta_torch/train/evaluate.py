"""Validation / test scoring (the part of
``stil_tta_tpu/train/evaluate.py`` the test-time path uses).

AUROC is computed here with numpy and ``scipy.stats.rankdata`` (the card
machine has no scikit-learn), keeping ``sklearn.metrics.roc_auc_score``'s
semantics: binary AUROC is the Mann-Whitney statistic with ties counted
one half, nan when ``y_true`` holds one class; macro one-vs-rest AUROC
averages the per-class binary AUROCs (nan when a class is absent) and
raises ``ValueError`` where sklearn does. The training loop
(``evaluate=True``) is still to port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from scipy.stats import rankdata

from stil_tta_torch.data.loader import EpochSampler


def binary_auroc(y_true: np.ndarray, score: np.ndarray) -> float:
    """``roc_auc_score(y_true, score)`` for 0/1 labels."""
    y = np.asarray(y_true).astype(bool)
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = rankdata(np.asarray(score, np.float64))
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def ovr_macro_auroc(y_true: np.ndarray, probs: np.ndarray,
                    num_classes: int) -> float:
    """``roc_auc_score(y_true, probs, multi_class='ovr', average='macro',
    labels=range(num_classes))``."""
    probs = np.asarray(probs)
    y = np.asarray(y_true)
    if probs.ndim != 2 or probs.shape[1] != num_classes:
        raise ValueError("Number of given labels, {}, not equal to the "
                         "number of columns in 'y_score', {}".format(
                             num_classes, probs.shape[-1]))
    if not np.allclose(1, probs.sum(axis=1)):
        raise ValueError("Target scores need to be probabilities for "
                         "multiclass roc_auc, i.e. they should sum up to "
                         "1.0 over classes")
    if np.setdiff1d(y, np.arange(num_classes)).size:
        raise ValueError("'y_true' contains labels not in parameter "
                         "'labels'")
    return float(np.mean([binary_auroc(y == k, probs[:, k])
                          for k in range(num_classes)]))


def compute_eval_metrics(probs: np.ndarray, labels: np.ndarray,
                         num_classes: int, prefix: str) -> Dict[str, float]:
    """acc + auc; binary tasks are scored on the class-1 probability
    (``STiLModel.py:461-464``)."""
    out = {}
    if num_classes == 2:
        p1 = probs[:, 1]
        out[f"{prefix}.acc"] = float(((p1 >= 0.5).astype(int) == labels)
                                     .mean())
        out[f"{prefix}.auc"] = binary_auroc(labels, p1)
    else:
        out[f"{prefix}.acc"] = float((probs.argmax(1) == labels).mean())
        try:
            auc = ovr_macro_auroc(labels, probs, num_classes)
            # macro OVR is nan when some classes are absent in the data
            out[f"{prefix}.auc"] = 0.0 if np.isnan(auc) else auc
        except ValueError:
            out[f"{prefix}.auc"] = 0.0
    return out


def apply_batch_limit(n_batches: int, limit) -> int:
    """PyTorch-Lightning ``limit_{train,val,test}_batches`` semantics:
    float in (0, 1] = fraction of the epoch, int = absolute batch cap,
    None/1.0 = everything."""
    if limit is None:
        return n_batches
    lim = float(limit)
    if lim < 0:
        raise ValueError(f"limit_*_batches must be >= 0, got {limit!r}")
    if lim == 0:
        return 0
    if lim <= 1.0 and not (isinstance(limit, int) and limit == 1):
        return max(int(n_batches * lim), 1)
    return min(n_batches, int(lim))


def run_validation(eval_step, cache: dict, batch_size: int,
                   num_classes: int, prefix: str = "eval.val",
                   limit_batches=None) -> Dict[str, float]:
    """Score ``cache`` in order, batch by batch (the tail batch padded to
    ``batch_size`` with weight-0 rows), and reduce the metrics."""
    n = int(cache["labels"].shape[0])
    device = cache["labels"].device
    sampler = EpochSampler(n, batch_size, shuffle=False, drop_last=False)
    max_b = apply_batch_limit(sampler.steps_per_epoch(), limit_batches)
    if max_b == 0:
        return {}
    outs = []
    for bi, (idx, w) in enumerate(sampler.epoch()):
        if bi >= max_b:
            break
        outs.append((eval_step(cache, torch.from_numpy(idx).to(device),
                               torch.from_numpy(w).to(device)), w))
    probs = {"m": [], "i": [], "t": []}
    ys = []
    loss_sums: Dict[str, float] = {}
    loss_counts: Dict[str, int] = {}
    for out, w in outs:
        keep = w > 0
        for k in probs:
            probs[k].append(out[f"prob_{k}"].float().cpu().numpy()[keep])
        ys.append(out["labels"].cpu().numpy()[keep])
        for k, v in out["losses"].items():
            # retrieval accuracy is skipped for non-full batches, as the
            # reference does (``STiLModel.py:437``)
            if k in ("top1", "top5") and not keep.all():
                continue
            loss_sums[k] = loss_sums.get(k, 0.0) + float(v)
            loss_counts[k] = loss_counts.get(k, 0) + 1
    y = np.concatenate(ys)
    metrics = compute_eval_metrics(np.concatenate(probs["m"]), y,
                                   num_classes, prefix)
    for k, stream in (("i", "imaging"), ("t", "tabular")):
        sub = compute_eval_metrics(np.concatenate(probs[k]), y, num_classes,
                                   prefix)
        metrics[f"{prefix}.acc_{stream}"] = sub[f"{prefix}.acc"]
        metrics[f"{prefix}.auc_{stream}"] = sub[f"{prefix}.auc"]
    if prefix == "eval.val":  # the reference logs val losses only
        for k, v in loss_sums.items():
            metrics[f"multimodal.val.{k}"] = v / max(loss_counts[k], 1)
    return metrics
