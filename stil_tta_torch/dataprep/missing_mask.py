"""Missing-feature masks, the port's copy of
``stil_tta_tpu/dataprep/missing_mask.py``: boolean (N, F) masks marking
tabular columns as missing, either uniformly at random (``random``) or by
dropping whole columns (``feature``), which the tabular transformer's
attention masking consumes (``build_attention_mask``). Both draw from
``np.random.RandomState(seed)``, so they equal the JAX package's masks bit
for bit.

    python -m stil_tta_torch.dataprep.missing_mask --n 1000 \
        --num-features 17 --rate 0.3 --strategy random \
        --out data/test/missing_mask.npy
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def random_missing_mask(n: int, num_features: int, rate: float,
                        seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.rand(n, num_features) < rate


def feature_missing_mask(n: int, num_features: int, rate: float,
                         seed: int = 0,
                         importance: np.ndarray | None = None) -> np.ndarray:
    """Drop ``round(num_features * rate)`` whole columns, drawn at random
    or, with ``importance`` given, the most important first."""
    rng = np.random.RandomState(seed)
    k = int(round(num_features * rate))
    if importance is None:
        cols = rng.choice(num_features, size=k, replace=False)
    else:
        cols = np.argsort(-np.asarray(importance))[:k]
    mask = np.zeros((n, num_features), bool)
    mask[:, cols] = True
    return mask


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--num-features", type=int, required=True)
    ap.add_argument("--rate", type=float, required=True)
    ap.add_argument("--strategy", choices=["random", "feature"],
                    default="random")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    fn = random_missing_mask if args.strategy == "random" \
        else feature_missing_mask
    mask = fn(args.n, args.num_features, args.rate, args.seed)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.save(args.out, mask)
    print(f"wrote {mask.shape} mask ({mask.mean():.3f} missing) -> "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
