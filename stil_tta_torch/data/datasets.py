"""Dataset assembly from config, the port of
``stil_tta_tpu/data/datasets.py``.

Two modes: native artifact directories (``{data_base}/{split}`` or
explicit ``data_{split}`` keys), or ``synthetic: true`` with sizes from
the ``synthetic_*`` keys.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict

import numpy as np

from stil_tta_torch.data.source import ArraySource, synthetic_source

SPLITS = ("train_labelled", "train_unlabelled", "val", "test")


def load_sources(cfg) -> Dict[str, ArraySource]:
    if cfg.synthetic:
        n_l = int(cfg.synthetic_labelled or 64)
        n_u = int(cfg.synthetic_unlabelled or 448)
        n_v = int(cfg.synthetic_val or 128)
        n_t = int(cfg.synthetic_test or 128)
        nc = int(cfg.num_classes or 8)
        size = int(cfg.synthetic_image_size or cfg.img_size or 64)
        fl = cfg.field_lengths
        target = cfg.target or "dvm"
        mk = lambda n, frac, seed: synthetic_source(
            n, num_classes=nc, field_lengths=fl, image_size=size,
            labelled_frac=frac, target=target, seed=seed)
        return {"train_labelled": mk(n_l, 1.0, 0),
                "train_unlabelled": mk(n_u, 0.0, 1),
                "val": mk(n_v, 1.0, 2), "test": mk(n_t, 1.0, 3)}

    base = Path(cfg.data_base or ".")
    if cfg.get("fraction_dir"):
        base = base / str(cfg.fraction_dir)
    out = {}
    for split in SPLITS:
        path = cfg.get(f"data_{split}") or (base / split)
        out[split] = ArraySource.load(path)
    return out


def attach_missing_masks(sources: Dict[str, ArraySource],
                         cfg) -> Dict[str, ArraySource]:
    """Set ``source.missing`` for the ``missing_tabular`` mode
    (``datasets.py:55-98``). Per split, in order: a mask the source
    already carries; ``missing_mask.npy`` in the split's directory; for
    ``missing_strategy`` ``feature``, ``MI`` or ``LI`` the same columns in
    every split (seed 0); else (``random``) an i.i.d. mask at seed ``1000
    + i`` for the i-th split. Without ``missing_tabular`` the sources
    pass through."""
    if not cfg.missing_tabular:
        return sources
    from stil_tta_torch.dataprep.missing_mask import (feature_missing_mask,
                                                      random_missing_mask)

    rate = float(cfg.missing_rate or 0.0)
    strategy = str(cfg.missing_strategy or "random")
    base = Path(cfg.data_base or ".")
    out = {}
    for i, (split, src) in enumerate(sources.items()):
        if src.missing is not None:
            out[split] = src
            continue
        key = cfg.get(f"data_{split}")
        mask_file = (Path(key) if key else base / split) / "missing_mask.npy"
        if mask_file.exists():
            mask = np.load(mask_file)
        elif strategy in ("feature", "MI", "LI"):
            mask = feature_missing_mask(len(src), src.tabular.shape[1],
                                        rate, seed=0)
        else:
            mask = random_missing_mask(len(src), src.tabular.shape[1],
                                       rate, seed=1000 + i)
        out[split] = dataclasses.replace(src, missing=mask.astype(bool))
    return out


def apply_sweep_truncation(sources: Dict[str, ArraySource],
                           cfg) -> Dict[str, ArraySource]:
    """``sweep``/``unit_test`` truncation to <= 5000 samples, and
    ``delete_segmentation`` (zero the first image channel)."""
    if cfg.sweep or cfg.unit_test:
        sources = {k: v.truncate(5000) for k, v in sources.items()}
    if cfg.delete_segmentation:
        out = {}
        for k, v in sources.items():
            imgs = np.array(v.images)
            imgs[..., 0] = 0
            out[k] = dataclasses.replace(v, images=imgs)
        sources = out
    return sources
