"""Dataset assembly from config (the part of
``stil_tta_tpu/data/datasets.py`` the test-time path uses).

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
    """Only ``missing_tabular: false`` is ported: the sources pass
    through. The masked-tabular evaluation mode (mask files or
    generated masks) is still to port (ROADMAP.md)."""
    if cfg.missing_tabular:
        raise NotImplementedError(
            "missing_tabular is not ported to stil_tta_torch yet "
            "(see ROADMAP.md)")
    return sources


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
