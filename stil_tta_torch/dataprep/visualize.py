"""Dataset visualisation, the port's copy of
``stil_tta_tpu/dataprep/visualize.py``.

The reference's ``data/visualize_dataset.ipynb`` in script form: sample
grids of images and t-SNE projections of tabular features or embeddings
coloured by label, written as PNGs. scikit-learn (t-SNE) and PIL are
imported inside the functions that use them.

    python -m stil_tta_torch.dataprep.visualize --source data/dvm/test \
        --out runs/visualize
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def image_grid(images: np.ndarray, rows: int = 4, cols: int = 8):
    n, h, w, c = images.shape
    rows = min(rows, (n + cols - 1) // cols)
    grid = np.zeros((rows * h, cols * w, c), images.dtype)
    for i in range(min(n, rows * cols)):
        r, cc = divmod(i, cols)
        grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = images[i]
    return grid


def tsne_embedding(features: np.ndarray, perplexity: float = 30.0,
                   seed: int = 0) -> np.ndarray:
    from sklearn.manifold import TSNE
    return TSNE(n_components=2, perplexity=min(perplexity,
                                               max(len(features) // 4, 2)),
                random_state=seed, init="pca").fit_transform(features)


def save_png(path, array: np.ndarray) -> None:
    from PIL import Image
    arr = array
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)


def scatter_png(path, xy: np.ndarray, labels: np.ndarray,
                size: int = 800) -> None:
    """Dependency-light scatter plot rendered straight into a bitmap."""
    img = np.full((size, size, 3), 255, np.uint8)
    mins, maxs = xy.min(0), xy.max(0)
    span = np.maximum(maxs - mins, 1e-6)
    pts = ((xy - mins) / span * (size - 9) + 4).astype(int)
    rng = np.random.RandomState(0)
    palette = rng.randint(30, 225, (int(labels.max()) + 1, 3))
    for (x, y), lab in zip(pts, labels):
        img[size - 1 - y - 2:size - 1 - y + 3, x - 2:x + 3] = palette[lab]
    save_png(path, img)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--source", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=512)
    args = ap.parse_args(argv)
    from stil_tta_torch.data.source import ArraySource
    src = ArraySource.load(args.source)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    n = min(args.n, len(src))
    save_png(out / "image_grid.png",
             image_grid(np.asarray(src.images[:32]).astype(np.uint8)))
    xy = tsne_embedding(src.tabular[:n])
    scatter_png(out / "tabular_tsne.png", xy, src.labels[:n])
    print(f"wrote visualisations -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
