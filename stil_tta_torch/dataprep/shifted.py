"""Distribution-shifted split construction, the port's copy of
``stil_tta_tpu/dataprep/shifted.py`` (the "-TTA" fork's data
contribution).

Hold-out splits of the DVM table along a shift dimension (body colour,
registration year, mileage, the label distribution, and a ``normal``
i.i.d. control) as :class:`ArraySource` directories, with a
Jensen-Shannon-divergence report of the induced shift. numpy only; every
draw comes from ``np.random.RandomState(seed)``, so the split ids equal
the JAX package's.

    python -m stil_tta_torch.dataprep.shifted --source data/dvm/all \
        --shift column --name black --column 0 --values 3 \
        --label-fraction 0.1 --out data/shifts/black
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from stil_tta_torch.data.source import ArraySource


def js_divergence(p: np.ndarray, q: np.ndarray, bins: int = 30) -> float:
    """JS divergence between two empirical 1-D distributions."""
    lo = min(p.min(), q.min())
    hi = max(p.max(), q.max())
    if hi <= lo:
        return 0.0
    hp, _ = np.histogram(p, bins=bins, range=(lo, hi), density=False)
    hq, _ = np.histogram(q, bins=bins, range=(lo, hi), density=False)
    hp = hp / max(hp.sum(), 1)
    hq = hq / max(hq.sum(), 1)
    m = (hp + hq) / 2

    def kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log(
            a[mask] / np.clip(b[mask], 1e-12, None))))

    return 0.5 * kl(hp, m) + 0.5 * kl(hq, m)


def shift_report(train: ArraySource, test: ArraySource) -> Dict[str, float]:
    """Per-feature JS divergence between the splits' marginals, and the
    labels'."""
    report = {}
    for f in range(train.tabular.shape[1]):
        report[f"feature_{f}"] = js_divergence(train.tabular[:, f],
                                               test.tabular[:, f])
    report["labels"] = js_divergence(train.labels.astype(float),
                                     test.labels.astype(float))
    return report


@dataclasses.dataclass
class ShiftSpec:
    """Hold out rows where ``predicate(tabular, labels)`` is True as the
    shifted test pool; the remainder forms the train pool.

    With ``common_label_space`` every split is restricted to the
    intersection of the splits' class sets and relabelled contiguously
    (the reference notebook's ``ensure_same_class_num`` and
    ``categorize``), which is why the shifted YAMLs carry fewer than 286
    classes."""

    name: str
    predicate: Callable[[np.ndarray, np.ndarray], np.ndarray]
    description: str = ""
    common_label_space: bool = True


def ensure_common_label_space(splits: Dict[str, ArraySource]):
    """Restrict all splits to the intersection of their class sets and
    relabel contiguously (sorted by original class id).

    Returns ``(new_splits, num_classes, mapping)`` where ``mapping`` is
    ``{original_label: new_label}``.
    """
    class_sets = [set(np.unique(s.labels).tolist()) for s in splits.values()]
    common = sorted(set.intersection(*class_sets))
    if not common:
        raise ValueError("no common classes across splits — shift predicate "
                         "leaves disjoint label sets")
    mapping = {int(c): i for i, c in enumerate(common)}
    lut = np.full(int(max(common)) + 1, -1, np.int64)
    for c, i in mapping.items():
        lut[c] = i

    def relabel(src: ArraySource) -> ArraySource:
        keep = np.isin(src.labels, common)
        return ArraySource(
            images=np.asarray(src.images[keep]),
            tabular=src.tabular[keep],
            labels=lut[src.labels[keep].astype(np.int64)],
            labelled=src.labelled[keep],
            field_lengths=src.field_lengths,
            num_classes=len(common), target=src.target)

    return ({k: relabel(v) for k, v in splits.items()}, len(common), mapping)


def make_column_value_shift(name: str, column: int, values,
                            description: str = "") -> ShiftSpec:
    vals = np.asarray(values, np.float32)
    return ShiftSpec(
        name=name,
        predicate=lambda tab, y: np.isin(tab[:, column], vals),
        description=description or f"column {column} in {list(values)}")


def make_quantile_shift(name: str, column: int, q: float,
                        upper: bool = True) -> ShiftSpec:
    def pred(tab, y):
        thr = np.quantile(tab[:, column], q)
        return tab[:, column] >= thr if upper else tab[:, column] <= thr

    return ShiftSpec(name=name, predicate=pred,
                     description=f"column {column} {'>=' if upper else '<='}"
                                 f" quantile {q}")


def make_label_subset_shift(name: str, labels) -> ShiftSpec:
    """Unseen-class holdout (classes in ``labels`` become the test pool).
    Not the reference's ``labels`` shift, which is
    :func:`build_label_dist_shifted_splits`; the train and test class
    sets are disjoint by construction, so the common label space is
    off."""
    ls = np.asarray(labels)
    return ShiftSpec(name=name,
                     predicate=lambda tab, y: np.isin(y, ls),
                     description=f"labels in subset ({len(ls)})",
                     common_label_space=False)


def make_normal_shift(name: str = "normal", frac: float = 0.2,
                      seed: int = 0) -> ShiftSpec:
    def pred(tab, y):
        rng = np.random.RandomState(seed)
        return rng.rand(len(y)) < frac

    return ShiftSpec(name=name, predicate=pred,
                     description="i.i.d. control split")


def build_shifted_splits(source: ArraySource, spec: ShiftSpec,
                         label_fraction: float = 0.01,
                         seed: int = 0,
                         out_dir: Optional[Path] = None) -> Dict:
    """Produce {train_labelled, train_unlabelled, test} under the shift,
    with ``label_fraction`` of the train pool labelled (the reference's
    SemiPseudo_{0.01,0.1} splits)."""
    held_out = spec.predicate(source.tabular, source.labels)
    train_idx = np.where(~held_out)[0]
    test_idx = np.where(held_out)[0]
    rng = np.random.RandomState(seed)
    perm = rng.permutation(train_idx)
    n_lab = max(int(round(len(perm) * label_fraction)), 1)
    lab_idx, unlab_idx = perm[:n_lab], perm[n_lab:]

    def subset(idx, labelled):
        idx = np.sort(idx)
        return ArraySource(
            images=np.asarray(source.images[idx]),
            tabular=source.tabular[idx],
            labels=source.labels[idx],
            labelled=np.full(len(idx), labelled, bool),
            field_lengths=source.field_lengths,
            num_classes=source.num_classes, target=source.target)

    splits = {"train_labelled": subset(lab_idx, True),
              "train_unlabelled": subset(unlab_idx, False),
              "test": subset(test_idx, True)}
    label_mapping = None
    if spec.common_label_space:
        splits, _, label_mapping = ensure_common_label_space(splits)
    return _finish_splits(splits, spec.name, spec.description,
                          label_fraction, label_mapping, out_dir)


def _finish_splits(splits, name, description, label_fraction,
                   label_mapping, out_dir):
    report = shift_report(splits["train_labelled"], splits["test"])
    if out_dir is not None:
        out_dir = Path(out_dir)
        for split_name, src in splits.items():
            src.save(out_dir / split_name)
        meta = {"shift": name,
                "description": description,
                "label_fraction": label_fraction,
                "num_classes": int(next(iter(splits.values())).num_classes),
                "sizes": {k: len(v) for k, v in splits.items()},
                "js_divergence": report}
        if label_mapping is not None:
            meta["label_mapping"] = {str(k): v
                                     for k, v in label_mapping.items()}
        with open(out_dir / "shift_report.json", "w") as f:
            json.dump(meta, f, indent=2)
    return {"splits": splits, "report": report,
            "num_classes": int(next(iter(splits.values())).num_classes),
            "label_mapping": label_mapping}


def build_label_dist_shifted_splits(source: ArraySource, column: int,
                                    labeled_values, unlabeled_values,
                                    label_fraction: float = 0.1,
                                    test_frac: float = 0.15,
                                    seed: int = 0,
                                    out_dir: Optional[Path] = None) -> Dict:
    """The reference's ``labels`` / ``labels_black`` shift: a label
    distribution (class prior) shift induced by partitioning a
    categorical column.

    The labelled train pool is drawn only from ``labeled_values`` of the
    column (the reference uses Color == Black), the unlabelled train pool
    only from ``unlabeled_values`` (Grey/White), and the test split from
    held-out rows of both groups. A ``test_black`` split restricted to
    ``labeled_values`` is the ``labels_black`` YAML's test set. All
    splits then pass :func:`ensure_common_label_space`.
    """
    col = source.tabular[:, column]
    in_lab = np.isin(col, np.asarray(labeled_values, col.dtype))
    in_unlab = np.isin(col, np.asarray(unlabeled_values, col.dtype))
    rng = np.random.RandomState(seed)

    def take(mask):
        idx = np.where(mask)[0]
        return idx[rng.permutation(len(idx))]

    lab_pool = take(in_lab)
    unlab_pool = take(in_unlab & ~in_lab)
    # test rows held out of both pools, disjoint from train
    n_test_lab = max(int(round(len(lab_pool) * test_frac)), 1)
    n_test_unlab = max(int(round(len(unlab_pool) * test_frac)), 1)
    test_idx = np.concatenate([lab_pool[:n_test_lab],
                               unlab_pool[:n_test_unlab]])
    test_lab_idx = lab_pool[:n_test_lab]
    lab_rest = lab_pool[n_test_lab:]
    unlab_rest = unlab_pool[n_test_unlab:]
    # label_fraction is of the whole train size (the reference's 2900 of
    # 29000 at 0.1, 290 at 0.01)
    n_train_total = len(lab_rest) + len(unlab_rest)
    n_lab = min(max(int(round(n_train_total * label_fraction)), 1),
                len(lab_rest))

    def subset(idx, labelled):
        idx = np.sort(idx)
        return ArraySource(
            images=np.asarray(source.images[idx]),
            tabular=source.tabular[idx],
            labels=source.labels[idx],
            labelled=np.full(len(idx), labelled, bool),
            field_lengths=source.field_lengths,
            num_classes=source.num_classes, target=source.target)

    splits = {"train_labelled": subset(lab_rest[:n_lab], True),
              "train_unlabelled": subset(unlab_rest, False),
              "test": subset(test_idx, True),
              "test_black": subset(test_lab_idx, True)}
    splits, _, mapping = ensure_common_label_space(splits)
    desc = (f"label-distribution shift: labeled train from column {column} "
            f"in {list(labeled_values)}, unlabeled from "
            f"{list(unlabeled_values)}")
    return _finish_splits(splits, "labels", desc, label_fraction,
                          mapping, out_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--source", required=True,
                    help="native-format split dir of the full dataset")
    ap.add_argument("--shift", required=True,
                    choices=["column", "quantile", "labels", "label-subset",
                             "normal"])
    ap.add_argument("--name", required=True)
    ap.add_argument("--column", type=int)
    ap.add_argument("--values", type=float, nargs="*")
    ap.add_argument("--labeled-values", type=float, nargs="*",
                    help="labels shift: column values of the labeled pool "
                         "(reference: Color==Black)")
    ap.add_argument("--unlabeled-values", type=float, nargs="*",
                    help="labels shift: column values of the unlabeled pool "
                         "(reference: Grey/White)")
    ap.add_argument("--quantile", type=float, default=0.8)
    ap.add_argument("--label-subset", type=int, nargs="*")
    ap.add_argument("--label-fraction", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    source = ArraySource.load(args.source, mmap=True)
    if args.shift == "labels":
        res = build_label_dist_shifted_splits(
            source, args.column, args.labeled_values, args.unlabeled_values,
            args.label_fraction, seed=args.seed, out_dir=Path(args.out))
        print(json.dumps(res["report"], indent=2))
        return 0
    if args.shift == "column":
        spec = make_column_value_shift(args.name, args.column, args.values)
    elif args.shift == "quantile":
        spec = make_quantile_shift(args.name, args.column, args.quantile)
    elif args.shift == "label-subset":
        spec = make_label_subset_shift(args.name, args.label_subset)
    else:
        spec = make_normal_shift(args.name, seed=args.seed)
    res = build_shifted_splits(source, spec, args.label_fraction,
                               args.seed, Path(args.out))
    print(json.dumps(res["report"], indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
