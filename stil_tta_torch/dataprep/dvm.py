"""DVM car dataset construction, the port's copy of
``stil_tta_tpu/dataprep/dvm.py``.

From the raw DVM download (image folders and the ad table CSV) it builds
the artifact set the port trains on: label-encoded car-model labels (286
classes), a tabular table with the categorical columns first and then
z-scored continuous columns (optionally jittered), per-split
:class:`ArraySource` directories and uint8 image arrays. PIL and pandas
are imported inside the functions that read raw files.

    python -m stil_tta_torch.dataprep.dvm --table ads.csv \
        --image-root images --cat-cols Color Bodytype Gearbox Fuel_type \
        --con-cols Price Runned_Miles --out data/dvm
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from stil_tta_torch.data.source import ArraySource


def label_encode(values: Sequence) -> tuple[np.ndarray, Dict]:
    uniq = sorted(set(values))
    mapping = {v: i for i, v in enumerate(uniq)}
    return np.asarray([mapping[v] for v in values], np.int64), mapping


def build_tabular(df, cat_cols: List[str], con_cols: List[str],
                  jitter_frac: float = 0.0, seed: int = 0):
    """Categorical-first table (the 'reordered' layout): label-encoded
    categoricals, z-scored continuous columns, optional relative jitter
    of physical attributes (the reference's 'physical_jittered_50'
    variant adds up to ±jitter_frac noise)."""
    rng = np.random.RandomState(seed)
    field_lengths = []
    cols = []
    for c in cat_cols:
        enc, mapping = label_encode(list(df[c]))
        field_lengths.append(len(mapping))
        cols.append(enc.astype(np.float32))
    for c in con_cols:
        v = np.asarray(df[c], np.float32)
        if jitter_frac > 0:
            v = v * (1 + rng.uniform(-jitter_frac, jitter_frac, len(v)))
        std = v.std() or 1.0
        cols.append((v - v.mean()) / std)
        field_lengths.append(1)
    return np.stack(cols, axis=1), field_lengths


def load_images(paths: Sequence[str], size: int) -> np.ndarray:
    from PIL import Image
    out = np.zeros((len(paths), size, size, 3), np.uint8)
    for i, p in enumerate(paths):
        if str(p).endswith(".npy"):
            arr = np.load(p, allow_pickle=True).astype(np.uint8)
            img = Image.fromarray(arr)
        else:
            img = Image.open(p).convert("RGB")
        out[i] = np.asarray(img.resize((size, size), Image.BILINEAR))
    return out


def build_semi_splits(source: ArraySource, label_fraction: float,
                      val_frac: float = 0.1, test_frac: float = 0.1,
                      seed: int = 0) -> Dict[str, ArraySource]:
    """train/val/test split and the labelled/unlabelled partition of
    train (the SemiPseudo_{0.01,0.1} artifact pairs)."""
    n = len(source)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_test = int(n * test_frac)
    n_val = int(n * val_frac)
    test_idx = perm[:n_test]
    val_idx = perm[n_test:n_test + n_val]
    train_idx = perm[n_test + n_val:]
    n_lab = max(int(round(len(train_idx) * label_fraction)), 1)

    def subset(idx, labelled):
        idx = np.sort(idx)
        return ArraySource(
            images=np.asarray(source.images[idx]),
            tabular=source.tabular[idx], labels=source.labels[idx],
            labelled=np.full(len(idx), labelled, bool),
            field_lengths=source.field_lengths,
            num_classes=source.num_classes, target=source.target)

    return {
        "train_labelled": subset(train_idx[:n_lab], True),
        "train_unlabelled": subset(train_idx[n_lab:], False),
        "val": subset(val_idx, True),
        "test": subset(test_idx, True),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--table", required=True, help="DVM ad table CSV")
    ap.add_argument("--image-root", required=True)
    ap.add_argument("--image-col", default="Image_path")
    ap.add_argument("--label-col", default="Genmodel_ID")
    ap.add_argument("--cat-cols", nargs="+", required=True)
    ap.add_argument("--con-cols", nargs="+", required=True)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--jitter", type=float, default=0.0)
    ap.add_argument("--label-fraction", type=float, default=0.01)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import pandas as pd
    df = pd.read_csv(args.table)
    labels, mapping = label_encode(list(df[args.label_col]))
    tab, field_lengths = build_tabular(df, args.cat_cols, args.con_cols,
                                       args.jitter)
    paths = [str(Path(args.image_root) / p) for p in df[args.image_col]]
    images = load_images(paths, args.size)
    source = ArraySource(images=images, tabular=tab, labels=labels,
                         labelled=np.ones(len(labels), bool),
                         field_lengths=field_lengths,
                         num_classes=len(mapping), target="dvm")
    splits = build_semi_splits(source, args.label_fraction)
    out = Path(args.out)
    for name, src in splits.items():
        src.save(out / name)
    with open(out / "label_mapping.json", "w") as f:
        json.dump({str(k): v for k, v in mapping.items()}, f, indent=2)
    print({k: len(v) for k, v in splits.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
