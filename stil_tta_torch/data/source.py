"""Dataset artifact sources (numpy only).

The port's own copy of ``stil_tta_tpu/data/source.py``: one directory per
split holding

- ``spec.json``   — field_lengths, num_classes, target, shapes
- ``images.npy``  — (N, H, W, 3) uint8 (dvm) or float (cardiac), memmapped
- ``tabular.npy`` — (N, F) float32, categorical columns first
- ``labels.npy``  — (N,) int64
- ``labelled.npy``— (N,) bool

and the class-conditional synthetic source, which gives the same arrays
for a seed as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ArraySource:
    """An in-memory (or memmapped) dataset split."""

    images: np.ndarray          # (N, H, W, 3)
    tabular: np.ndarray         # (N, F) float32
    labels: np.ndarray          # (N,) int64
    labelled: np.ndarray        # (N,) bool
    field_lengths: List[int]
    num_classes: int
    target: str = "dvm"
    # optional missing-feature mask (N, F) bool
    missing: Optional[np.ndarray] = None

    def __post_init__(self):
        n = len(self.tabular)
        if not (len(self.images) == n == len(self.labels)
                == len(self.labelled)):
            raise ValueError(
                f"length mismatch {len(self.images)} {n} {len(self.labels)} "
                f"{len(self.labelled)}")

    def __len__(self) -> int:
        return len(self.tabular)

    @property
    def num_cat(self) -> int:
        return sum(1 for x in self.field_lengths if int(x) > 1)

    @property
    def num_con(self) -> int:
        return sum(1 for x in self.field_lengths if int(x) == 1)

    def truncate(self, max_n: int) -> "ArraySource":
        """``sweep`` truncation to <= ``max_n`` samples."""
        n = min(max_n, len(self))
        return dataclasses.replace(
            self, images=self.images[:n], tabular=self.tabular[:n],
            labels=self.labels[:n], labelled=self.labelled[:n])

    def save(self, directory: os.PathLike) -> None:
        """Write the split as an artifact directory that :meth:`load`
        reads (images memmapped)."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / "images.npy", np.asarray(self.images))
        np.save(d / "tabular.npy", np.asarray(self.tabular, np.float32))
        np.save(d / "labels.npy", np.asarray(self.labels, np.int64))
        np.save(d / "labelled.npy", np.asarray(self.labelled, bool))
        if self.missing is not None:
            np.save(d / "missing.npy", np.asarray(self.missing, bool))
        with open(d / "spec.json", "w") as f:
            json.dump({
                "field_lengths": [int(x) for x in self.field_lengths],
                "num_classes": int(self.num_classes),
                "target": self.target,
                "image_shape": list(self.images.shape[1:]),
                "image_dtype": str(np.asarray(self.images).dtype),
            }, f, indent=2)

    @classmethod
    def load(cls, directory: os.PathLike, mmap: bool = True) -> "ArraySource":
        d = Path(directory)
        with open(d / "spec.json") as f:
            spec = json.load(f)
        mmap_mode = "r" if mmap else None
        missing_path = d / "missing.npy"
        return cls(
            images=np.load(d / "images.npy", mmap_mode=mmap_mode),
            tabular=np.load(d / "tabular.npy"),
            labels=np.load(d / "labels.npy"),
            labelled=np.load(d / "labelled.npy"),
            field_lengths=list(spec["field_lengths"]),
            num_classes=int(spec["num_classes"]),
            target=spec.get("target", "dvm"),
            missing=np.load(missing_path) if missing_path.exists()
            else None,
        )


def synthetic_source(n: int, num_classes: int = 8,
                     field_lengths: Optional[Sequence[int]] = None,
                     image_size: int = 64, labelled_frac: float = 1.0,
                     target: str = "dvm", seed: int = 0) -> ArraySource:
    """Class-conditional synthetic data: images carry a class-colored
    square, tabular rows carry class-shifted continuous features, so a
    model can actually fit it."""
    rng = np.random.RandomState(seed)
    if field_lengths is None:
        field_lengths = [5, 4, 2, 1] + [1] * 12  # dvm-like: 4 cat, 13 con
    fl = [int(x) for x in field_lengths]
    cat_lengths = [x for x in fl if x > 1]
    ncon = sum(1 for x in fl if x == 1)

    labels = rng.randint(0, num_classes, n).astype(np.int64)
    imgs = rng.randint(0, 256, (n, image_size, image_size, 3),
                       dtype=np.uint8)
    # paint a class-dependent square
    s = image_size // 4
    for c in range(num_classes):
        mask = labels == c
        color = np.array([(37 * c + 50) % 256, (91 * c + 120) % 256,
                          (53 * c + 200) % 256], np.uint8)
        y = (c * 7) % (image_size - s)
        imgs[mask, y:y + s, y:y + s] = color

    cat = np.stack([rng.randint(0, c, n) for c in cat_lengths], axis=1) \
        if cat_lengths else np.zeros((n, 0), np.int64)
    con = rng.randn(n, ncon).astype(np.float32)
    con[:, : min(4, ncon)] += labels[:, None] * 0.5
    tab = np.concatenate([cat.astype(np.float32), con], axis=1)
    labelled = np.zeros(n, bool)
    labelled[: int(round(n * labelled_frac))] = True
    return ArraySource(images=imgs, tabular=tab, labels=labels,
                       labelled=labelled, field_lengths=fl,
                       num_classes=num_classes, target=target)
