"""Test entry point with test-time adaptation (the port of
``stil_tta_tpu/train/test.py``).

Builds the test split, the net of ``algorithm_name`` on the card (seeded
random weights, or a reference-layout ``.ckpt``), adapts it with
``tta: true`` (BN-adapt; Tent, EATA or SAR for STiL's nets), scores the
three heads and writes ``metrics.jsonl`` and ``test_results.csv`` under
the run's log directory.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from stil_tta_torch.algorithms.base import init_weights
from stil_tta_torch.algorithms.registry import get_algorithm
from stil_tta_torch.data.datasets import (apply_sweep_truncation,
                                          attach_missing_masks, load_sources)
from stil_tta_torch.data.loader import DeviceCache
from stil_tta_torch.data.source import ArraySource
from stil_tta_torch.train.convert import (load_torch_state_dict,
                                          saint_inert_key)
from stil_tta_torch.train.evaluate import run_validation
from stil_tta_torch.utils.logging import MetricLogger

# Lightning-level entries of a reference checkpoint that are not weights
# of the scoring net (tools/export_torch_checkpoint.py): the EMA teacher
# (STiL, Co-Training; ``model.ema.`` for the FixMatch families), STiL's
# prototypes, the DA ring, MMatch's memory bank (``embed_queue``,
# ``embed_queue_ptr``, ``probs_queue``), SimMatch's instance bank and its
# labels, CoMatch's queues and their positions
_NOT_NET = ("ema.", "prototypes", "DA_", "embed_queue", "probs_queue",
            "model.ema.", "model.DA_", "model.bank", "model.labels",
            "model.queue_s", "model.queue_ptr_s", "model.probs_u",
            "model.queue_w", "model.queue_ptr_w", "model.probs_xu")
# the FixMatch families wrap the student as ``model.main``
# (``simmatch_model.py:51-57``): ``model.main.<key>`` is the imaging net's
# ``<key>`` and the multimodal net's ``model.<key>``
_MAIN = "model.main."


def load_test_split(cfg) -> ArraySource:
    sources = attach_missing_masks(
        apply_sweep_truncation(load_sources(cfg), cfg), cfg)
    src = sources["test"]
    cfg.num_classes = int(cfg.num_classes or src.num_classes)
    return src


def load_checkpoint(net: torch.nn.Module, path) -> None:
    """Load a reference-layout torch checkpoint (a ``.ckpt`` written by
    ``tools/export_torch_checkpoint.py``, or a bare ``state_dict``) into
    ``net`` with ``strict=True``, leaving out what is not the scoring
    net's (``_NOT_NET``) and the SAINT entries its forward never reads;
    the FixMatch families' student comes from under ``_MAIN``."""
    sd = load_torch_state_dict(path)
    keys = set(net.state_dict())

    def key(k: str) -> str:
        if not k.startswith(_MAIN):
            return k
        k = k[len(_MAIN):]
        return k if k in keys else "model." + k

    sd = {key(k): v for k, v in sd.items()}
    net.load_state_dict({k: v for k, v in sd.items()
                         if not k.startswith(_NOT_NET)
                         and (k in keys or not saint_inert_key(k))},
                        strict=True)


def build_algo(cfg, field_lengths: Sequence[int], device="cuda",
               dtype: torch.dtype = torch.bfloat16):
    """The algorithm of ``algorithm_name`` (any of the registry's) on
    ``device`` with the ``checkpoint`` weights, or seeded random weights
    (``seed``) when there is none."""
    algo = get_algorithm(cfg.algorithm_name)(cfg, field_lengths,
                                             dtype=dtype, device=device)
    if cfg.checkpoint:
        load_checkpoint(algo.net, cfg.checkpoint)
    else:
        gen = torch.Generator(device=algo.device)
        gen.manual_seed(int(cfg.seed or 0))
        init_weights(algo.net, gen)
    return algo


def test(cfg, logdir: Optional[Path] = None, device="cuda",
         dtype: torch.dtype = torch.bfloat16) -> Dict[str, float]:
    logdir = Path(logdir or cfg.logdir or "runs/test")
    logger = MetricLogger(logdir, echo=bool(cfg.enable_progress_bar))
    src = load_test_split(cfg)
    algo = build_algo(cfg, src.field_lengths, device, dtype)
    cache = DeviceCache(src, device=algo.device).as_dict()
    if cfg.tta:
        from stil_tta_torch.tta import adapt
        adapt(cfg, algo, cache)
    metrics = run_validation(algo.make_eval_step(), cache,
                             int(cfg.batch_size), int(cfg.num_classes),
                             prefix="test",
                             limit_batches=cfg.limit_test_batches)
    logger.log(metrics, step=0)
    logger.dump_csv("test_results.csv", metrics)
    return metrics
