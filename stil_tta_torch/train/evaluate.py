"""Training loop ("evaluate" in the reference's vocabulary) and
validation / test scoring, the port of ``stil_tta_tpu/train/evaluate.py``.

:func:`evaluate` trains STiL on the labelled and unlabelled splits, held
on the device (:class:`DeviceCache`): the unlabelled stream defines the
epoch (dropped last), the labelled stream cycles; both samplers are
seeded per epoch, so a resumed run replays the uninterrupted one. Each
epoch validates, keeps the best checkpoint and stops early as the
reference does; with ``test_and_eval`` the best checkpoint is then
scored on the test split. Not ported (each raises
``NotImplementedError``): ``host_stream``, ``weighted_sampler``, a
``.ckpt``/``.pth`` warm start, ``checkpoint_SAINT``, ``micro_batches >
1`` and the optimizer options of ``stil_tta_torch.train.optim``.

AUROC is computed here with numpy and ``scipy.stats.rankdata`` (the card
machine has no scikit-learn), keeping ``sklearn.metrics.roc_auc_score``'s
semantics: binary AUROC is the Mann-Whitney statistic with ties counted
one half, nan when ``y_true`` holds one class; macro one-vs-rest AUROC
averages the per-class binary AUROCs (nan when a class is absent) and
raises ``ValueError`` where sklearn does.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from scipy.stats import rankdata

from stil_tta_torch.data.loader import (CyclingSampler, DeviceCache,
                                        EpochSampler)


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


def _refuse_unported(cfg) -> None:
    """Raise for the training options the port does not have yet."""
    if cfg.algorithm_name != "STiL":
        raise NotImplementedError(
            f"algorithm {cfg.algorithm_name!r} is not ported to "
            f"stil_tta_torch yet (ROADMAP.md); only STiL is")
    unported = {
        "host_stream": bool(cfg.host_stream),
        "weighted_sampler": bool(cfg.weighted_sampler and cfg.weights),
        "a .ckpt/.pth warm start": (
            not cfg.resume_training
            and str(cfg.checkpoint or "").endswith((".ckpt", ".pth"))),
        "checkpoint_SAINT": bool(cfg.checkpoint_SAINT),
        "micro_batches > 1": int(cfg.micro_batches or 1) > 1,
    }
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(
                f"{what} is not ported to stil_tta_torch yet (ROADMAP.md)")
    if float(cfg.val_check_interval or 1.0) < 1.0:
        raise ValueError(
            "val_check_interval < 1.0 (fractional mid-epoch validation) "
            "is not supported; validation runs per epoch "
            "(check_val_every_n_epoch)")


def evaluate(cfg, logdir: Optional[Path] = None,
             device="cuda") -> Dict[str, float]:
    """Train STiL (``trainers/evaluate.py:93-219``); returns
    ``{"best_val": ...}`` and, with ``test_and_eval``, the test metrics.
    ``resume_training`` with ``checkpoint=<dir>/checkpoint_last`` resumes
    from a checkpoint written by ``checkpoint_every_n_epochs``."""
    from stil_tta_torch.algorithms.stil import STiL
    from stil_tta_torch.data.datasets import (apply_sweep_truncation,
                                              attach_missing_masks,
                                              load_sources)
    from stil_tta_torch.train import optim
    from stil_tta_torch.train.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    from stil_tta_torch.utils.logging import MetricLogger

    _refuse_unported(cfg)
    logdir = Path(logdir or cfg.logdir or "runs/eval")
    logger = MetricLogger(logdir, echo=bool(cfg.enable_progress_bar))
    sources = attach_missing_masks(
        apply_sweep_truncation(load_sources(cfg), cfg), cfg)
    src_l, src_u = sources["train_labelled"], sources["train_unlabelled"]
    num_classes = int(cfg.num_classes or src_l.num_classes)
    cfg.num_classes = num_classes

    # batch split and repeat_ratio (``trainers/evaluate.py:83-88``)
    batch_size = int(cfg.batch_size)
    ur = int(cfg.unlabelled_ratio or 1)
    l_batch = max(batch_size // (1 + ur), 1)
    u_batch = batch_size - l_batch
    cfg.repeat_ratio = max(len(src_u) // (ur * max(len(src_l), 1)) - 1, 1)

    algo = STiL(cfg, src_l.field_lengths, device=device)
    cache_l = DeviceCache(src_l, device=algo.device).as_dict()
    cache_u = DeviceCache(src_u, device=algo.device).as_dict()
    cache_val = DeviceCache(sources["val"], device=algo.device).as_dict()
    seed0 = int(cfg.seed or 0)
    torch.manual_seed(seed0)    # the fusion dropout's generator
    state = algo.init_state(seed0)
    if cfg.resume_training and cfg.checkpoint:
        ckpt = Path(cfg.checkpoint)
        restore_checkpoint(ckpt.parent, state, name=ckpt.name)
        print(f"Resumed training state from {ckpt} at step {state.step}")
    # The JAX package may scan steps_per_dispatch steps in one dispatch
    # (``train/multistep.py``); that is the very same step, so here the
    # steps run one by one.
    train_step = algo.make_train_step()
    eval_step = algo.make_eval_step()

    def make_samplers(epoch_idx: int):
        """Samplers seeded by (run seed, epoch): the data order is a
        function of the epoch alone, so a resumed run replays the
        uninterrupted one."""
        u = EpochSampler(len(src_u), u_batch, shuffle=True, drop_last=True,
                         seed=seed0 + 100003 * epoch_idx)
        lab = CyclingSampler(len(src_l), l_batch,
                             seed=seed0 + 100003 * epoch_idx + 1)
        return lab, u

    eval_metric = cfg.eval_metric or ("acc" if cfg.target == "dvm"
                                      else "auc")
    monitor = f"eval.val.{eval_metric}"
    best = -np.inf
    es_best = -np.inf   # early stopping keeps its own best, with min_delta
    patience = int(40 if cfg.sweep else 100)
    bad_epochs = 0
    plateau = optim.PlateauScheduler(
        float(cfg.lr_eval),
        patience=int(10 / (cfg.check_val_every_n_epoch or 1)),
        min_lr=float(cfg.lr) * 1e-4, mode="max") \
        if cfg.scheduler == "linear" else None

    max_epochs = int(cfg.max_epochs)
    steps_per_epoch = apply_batch_limit(
        make_samplers(0)[1].steps_per_epoch(), cfg.limit_train_batches)
    cfg.dataset_length = steps_per_epoch
    val_metric_value = None
    for epoch in range(state.step // max(steps_per_epoch, 1), max_epochs):
        lr = optim.scheduled_lr(cfg, epoch, val_metric_value, plateau)
        optim.set_learning_rate(state.optimizer, lr)
        t0 = time.time()
        l_sampler, u_sampler = make_samplers(epoch)
        pairs = [(l_sampler.next()[0], idx_u)
                 for idx_u, _ in u_sampler.epoch()][:steps_per_epoch]
        for idx_l, idx_u in pairs:
            train_step(state, cache_l, cache_u,
                       torch.from_numpy(idx_l).to(algo.device),
                       torch.from_numpy(idx_u).to(algo.device), epoch)
        state, train_logs = algo.epoch_end(state)
        dt = time.time() - t0
        train_logs["lr"] = lr
        train_logs["samples_per_sec"] = (steps_per_epoch * batch_size
                                         / max(dt, 1e-9))
        logger.log(train_logs, step=epoch, prefix="multimodal.train.")

        if epoch % int(cfg.check_val_every_n_epoch or 1) == 0:
            val_metrics = run_validation(
                eval_step, cache_val, batch_size, num_classes,
                limit_batches=cfg.limit_val_batches)
            logger.log(val_metrics, step=epoch)
            val_metric_value = val_metrics.get(monitor)
            if val_metric_value is not None and val_metric_value > best:
                best = val_metric_value
                if cfg.save_checkpoints is None or cfg.save_checkpoints:
                    save_checkpoint(logdir, state, cfg.to_dict(),
                                    name=f"checkpoint_best_{eval_metric}")
            # the 1e-4 min_delta is early stopping's only (reference
            # EarlyStopping(min_delta=1e-4); ModelCheckpoint has none)
            if val_metric_value is not None and \
                    val_metric_value > es_best + 1e-4:
                es_best = val_metric_value
                bad_epochs = 0
            elif val_metrics:
                bad_epochs += 1
                if bad_epochs >= patience:
                    print(f"Early stopping at epoch {epoch}")
                    break
        if cfg.checkpoint_every_n_epochs and \
                (epoch + 1) % int(cfg.checkpoint_every_n_epochs) == 0:
            save_checkpoint(logdir, state, cfg.to_dict(),
                            name="checkpoint_last")

    logger.log({f"best.val.{eval_metric}": best}, step=max_epochs)
    logger.dump_csv("eval_results.csv")
    results = {"best_val": best}
    if cfg.test_and_eval:
        try:
            restore_checkpoint(logdir, state,
                               name=f"checkpoint_best_{eval_metric}")
        except FileNotFoundError:
            pass
        cache_test = DeviceCache(sources["test"], device=algo.device).as_dict()
        test_metrics = run_validation(
            eval_step, cache_test, batch_size, num_classes, prefix="test",
            limit_batches=cfg.limit_test_batches)
        logger.log(test_metrics, step=max_epochs)
        logger.dump_csv("test_results.csv", test_metrics)
        results.update(test_metrics)
    return results
