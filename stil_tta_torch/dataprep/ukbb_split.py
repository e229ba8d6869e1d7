"""UKBB cardiac labelled table -> per-split artifact assembly, the port's
copy of ``stil_tta_tpu/dataprep/ukbb_split.py``.

The programmatic cells of the reference's
``data/preprocess_ukbb/create_image_tabular_split.ipynb`` and the
label-derivation cells (222-223, 231) of
``preprocess_ukbb/preprocess_cardiac_table.ipynb``: the steps that
rebuild the reference's cardiac artifact set from the cleaned feature
table:

- CAD / Infarction / CAD_broad labels from the 223 ``Diagnoses -
  ICD10-0.{i}`` columns, Infarction OR'd with 'Heart attack diagnosed
  by doctor', and the Hypertension rule (table notebook cells 222-231);
- invalid-id / problem-id removal (split notebook cells 3-9);
- 0.1-test / 0.2-val subject splits at ``random_state=2022`` (cell 9);
- global z-score of the 49 continuous features, then simple
  (0-fill / column mode) or iterative (``IterativeImputer`` with
  ``sample_posterior`` on continuous + ``KNNImputer(9)`` rounded on
  categorical) imputation (cells 11-13);
- field lengths (1 per continuous, per-categorical ``max+1``),
  categorical-first reorder, and the ``noExt`` variant dropping the
  last 10 (imaging-derived) features (cells 15-16);
- per-split reordered headerless feature CSVs + image-path lists +
  per-target label arrays (cell 18);
- class-balanced train/val subsets (positives + ``random.sample``'d
  negatives at seed 2022, cell 19) and the chained 0.1 -> 0.01
  stratified low-data subsets at ``random_state=2022`` (cell 20).

REFERENCE QUIRK, kept under ``faithful=True`` (default): the notebook's
``CAD_codes`` literal is missing a comma between ``'I249'`` and
``'I250'``, so Python string-concatenates them into the single token
``'I249I250'`` — neither I24.9 nor I25.0 ever matches an ICD column.
``faithful=False`` restores the two codes. Published reference
checkpoints were trained on the faithful labels.

Artifacts are written with the reference's own names/formats
(``torch.save`` .pt lists + headerless .csv), so
``tools/convert_torch_artifacts.py`` ingests them unchanged. pandas and
scikit-learn (``train_test_split``, whose draws give the split ids, and
the imputers) are imported inside the functions that use them.

    python -m stil_tta_torch.dataprep.ukbb_split \
        --labeled-csv cardiac_feature_18545_vector_labeled_noOH.csv \
        --image-paths paths.pt --store data/cardiac
"""

from __future__ import annotations

import random as _random
from pathlib import Path
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

ICD_FIELD = "Diagnoses - ICD10"
N_ICD_COLUMNS = 223  # the notebook scans f'{ICD_FIELD}-0.{0..222}'

INFARCTION_CODES = ("I210", "I211", "I212", "I213", "I214", "I219",
                    "I252")
# cell 222/231 literal, including the missing-comma token (see module
# docstring); the fixed set replaces it with the two intended codes
_CAD_COMMON = ("I200", "I201", "I208", "I209",
               "I210", "I211", "I212", "I213", "I214", "I219",
               "I220", "I221", "I228", "I229",
               "I240", "I248",
               "I251", "I252", "I253", "I254", "I255", "I256",
               "I258", "I259")
CAD_CODES_FAITHFUL = _CAD_COMMON + ("I249I250",)
CAD_CODES_FIXED = _CAD_COMMON + ("I249", "I250")

DILATED_CARDIOMYOPATHY = ("I420",)
HEART_FAILURE = ("I500", "I501", "I509")
ATHEROSCLEROSIS = ("I700", "I7000", "I7001", "I701", "I7010", "I7011",
                   "I702", "I7020", "I7021", "I708", "I7080", "I7081",
                   "I709", "I7090", "I7091")
ARTERIAL_EMBOLISM_THROMBOSIS = ("I740", "I741", "I742", "I743", "I744",
                                "I745", "I748", "I749")

# cell 11: the 49 continuous features, in emission order — the last 10
# are the imaging-derived ventricular measures the noExt variant drops
CONTINUOUS_COLUMNS = [
    "Pulse wave Arterial Stiffness index-2.0",
    "Systolic blood pressure-2.mean",
    "Diastolic blood pressure-2.mean",
    "Pulse rate-2.mean",
    "Body fat percentage-2.0",
    "Whole body fat mass-2.0",
    "Body mass index (BMI)-2.0",
    "Basal metabolic rate-2.0",
    "Waist circumference-2.0",
    "Hip circumference-2.0",
    "Weight-2.0",
    "Ventricular rate-2.0",
    "P duration-2.0",
    "QRS duration-2.0",
    "Cardiac output-2.0",
    "Cardiac index-2.0",
    "Average heart rate-2.0",
    "Body surface area-2.0",
    "Duration of walks-2.0",
    "Duration of moderate activity-2.0",
    "Duration of vigorous activity-2.0",
    "Heart rate during PWA-2.0",
    "Systolic brachial blood pressure during PWA-2.0",
    "Diastolic brachial blood pressure during PWA-2.0",
    "Peripheral pulse pressure during PWA-2.0",
    "Central systolic blood pressure during PWA-2.0",
    "Central pulse pressure during PWA-2.0",
    "Number of beats in waveform average for PWA-2.0",
    "Central augmentation pressure during PWA-2.0",
    "Augmentation index for PWA-2.0",
    "Cardiac output during PWA-2.0",
    "End systolic pressure during PWA-2.0",
    "End systolic pressure index during PWA-2.0",
    "Total peripheral resistance during PWA-2.0",
    "Stroke volume during PWA-2.0",
    "Cardiac index during PWA-2.0",
    "Sleep duration-2.0",
    "Exposure to tobacco smoke at home-2.0",
    "Exposure to tobacco smoke outside home-2.0",
    "LVESV (mL)",
    "LVEDV (mL)",
    "LVSV (mL)",
    "LVEF (%)",
    "LVCO (L/min)",
    "LVM (g)",
    "RVEDV (mL)",
    "RVESV (mL)",
    "RVSV (mL)",
    "RVEF (%)",
]
N_EXTRACTED = 10  # noExt drops this many trailing features post-reorder

# cell 11 else-branch: the 26 label-encoded (noOH) categoricals
CATEGORICAL_COLUMNS = [
    "Shortness of breath walking on level ground-2.0",
    "Sex-0.0",
    "Diabetes diagnosis",
    "Angina diagnosed by doctor",
    "Stroke diagnosed by doctor",
    "High blood pressure diagnosed by doctor",
    "Cholesterol lowering medication regularly taken",
    "Blood pressure medication regularly taken",
    "Insulin medication regularly taken",
    "Hormone replacement therapy medication regularly taken",
    "Oral contraceptive pill or minipill medication regularly taken",
    "Long-standing illness, disability or infirmity-2.0",
    "Ever smoked-2.0",
    "Sleeplessness / insomnia-2.0",
    "Alcohol intake frequency.-2.0",
    "Overall health rating-2.0",
    "Alcohol drinker status-2.0",
    "Falls in the last year-2.0",
    "Number of days/week walked 10+ minutes-2.0",
    "Number of days/week of moderate physical activity 10+ minutes-2.0",
    "Number of days/week of vigorous physical activity 10+ minutes-2.0",
    "Usual walking pace-2.0",
    "Duration of strenuous sports-2.0",
    "Current tobacco smoking-2.0",
    "Past tobacco smoking-2.0",
    "Smoking status-2.0",
]

SPLIT_SEED = 2022
TEST_FRACTION = 0.1
VAL_FRACTION = 0.2
LOW_DATA_FRACTIONS = (0.1, 0.01)


def broad_cad_codes(faithful: bool = True) -> Tuple[str, ...]:
    base = CAD_CODES_FAITHFUL if faithful else CAD_CODES_FIXED
    return (base + DILATED_CARDIOMYOPATHY + HEART_FAILURE
            + ATHEROSCLEROSIS + ARTERIAL_EMBOLISM_THROMBOSIS)


def _icd_superset(icd_df, codes: Sequence[str],
                  n_cols: int = N_ICD_COLUMNS) -> np.ndarray:
    """Row mask: any of the first ``n_cols`` ICD10 diagnosis columns is
    in ``codes`` (cell 222's column-by-column ``isin`` OR chain)."""
    codes = set(codes)
    mask = np.zeros(len(icd_df), bool)
    for i in range(n_cols):
        col = f"{ICD_FIELD}-0.{i}"
        if col in icd_df.columns:
            mask |= icd_df[col].isin(codes).to_numpy()
    return mask


def derive_labels(icd_df, feature_df, faithful: bool = True,
                  n_icd_cols: int = N_ICD_COLUMNS):
    """Add Infarction / CAD / CAD_broad / Hypertension columns to a COPY
    of ``feature_df`` (cells 222-223 + 231). ``icd_df`` holds the raw
    ``Diagnoses - ICD10-0.{i}`` columns, row-aligned with
    ``feature_df``."""
    assert len(icd_df) == len(feature_df)
    out = feature_df.reset_index(drop=True).copy()
    icd_df = icd_df.reset_index(drop=True)
    cad = CAD_CODES_FAITHFUL if faithful else CAD_CODES_FIXED
    for codes, name in ((INFARCTION_CODES, "Infarction"),
                        (cad, "CAD"),
                        (broad_cad_codes(faithful), "CAD_broad")):
        out[name] = _icd_superset(icd_df, codes, n_icd_cols).astype(int)
    # cell 223: doctor-diagnosed heart attacks count as Infarction even
    # without an ICD code (the != comparison only ever flips 0 -> 1
    # because 'Heart attack diagnosed by doctor' is binary)
    doctor = out["Heart attack diagnosed by doctor"].to_numpy()
    out.loc[doctor != out["Infarction"].to_numpy(), "Infarction"] = 1
    # cell 231: hypertension from BP means / diagnosis / medication
    htn = (((out["Systolic blood pressure-2.mean"] > 140)
            & (out["Diastolic blood pressure-2.mean"] > 90))
           | (out["High blood pressure diagnosed by doctor"] == 1)
           | (out["Blood pressure medication regularly taken"] == 1))
    out["Hypertension"] = htn.astype(int)
    return out


def drop_subjects(df, bad_ids: Sequence[int]):
    """Remove invalid / image-problem subjects (cells 4-5, 9)."""
    bad = set(int(x) for x in bad_ids)
    out = df[~df["eid"].astype(int).isin(bad)]
    return out.reset_index(drop=True)


def split_subject_ids(ids: Sequence[int], seed: int = SPLIT_SEED,
                      test_fraction: float = TEST_FRACTION,
                      val_fraction: float = VAL_FRACTION):
    """(train, val, test) eid lists — cell 9's nested
    ``train_test_split`` calls at ``random_state=2022``."""
    from sklearn.model_selection import train_test_split
    train_set, test = train_test_split(list(ids),
                                       test_size=test_fraction,
                                       random_state=seed)
    train, val = train_test_split(train_set, test_size=val_fraction,
                                  random_state=seed)
    return train, val, test


def normalise_continuous(cont_df):
    """Global (all-subject) z-score — cell 12 normalises BEFORE the
    split, exactly as the reference does."""
    return (cont_df - cont_df.mean()) / cont_df.std()


def impute_simple(cont_df, cat_df):
    """Cell 13 'simple': continuous NaN -> 0 (post z-score), categorical
    NaN -> column mode."""
    cont = cont_df.fillna(0)
    cat = cat_df.copy()
    for c in cat.columns[cat.isnull().any(axis=0)]:
        cat[c] = cat[c].fillna(cat[c].mode()[0])
    return cont, cat


def impute_iterative(cont_df, cat_df, max_iter: int = 10,
                     n_neighbors: int = 9, seed: int = 0):
    """Cell 13 'iterative': ``IterativeImputer`` (sample_posterior,
    skip_complete, min/max clamped to observed bounds) on continuous;
    ``KNNImputer`` over [continuous | categorical] with the categorical
    outputs rounded to integers."""
    import pandas as pd
    from sklearn.experimental import enable_iterative_imputer  # noqa: F401
    from sklearn.impute import IterativeImputer, KNNImputer

    imp = IterativeImputer(max_iter=max_iter, random_state=seed,
                           sample_posterior=True, skip_complete=True,
                           min_value=cont_df.min(),
                           max_value=cont_df.max())
    cont_values = imp.fit_transform(cont_df)

    joint = pd.concat([cont_df, cat_df], axis=1)
    knn = KNNImputer(n_neighbors=n_neighbors)
    joint_values = knn.fit_transform(joint)
    cat_values = np.round(joint_values[:, cont_df.shape[1]:], 0)

    cont = pd.DataFrame(cont_values, columns=cont_df.columns,
                        index=cont_df.index)
    cat = pd.DataFrame(cat_values, columns=cat_df.columns,
                       index=cat_df.index)
    return cont, cat


def assemble_feature_table(labeled_df, impute_strategy: str = "simple",
                           continuous_columns: Sequence[str] = None,
                           categorical_columns: Sequence[str] = None):
    """eid + z-scored/imputed continuous + categorical frame in the
    notebook's column order (cells 11-13)."""
    import pandas as pd
    cont_cols = list(continuous_columns or CONTINUOUS_COLUMNS)
    cat_cols = list(categorical_columns or CATEGORICAL_COLUMNS)
    eid = labeled_df.loc[:, "eid"].astype("int")
    cont = normalise_continuous(labeled_df.loc[:, cont_cols])
    cat = labeled_df.loc[:, cat_cols]
    if impute_strategy == "simple":
        cont, cat = impute_simple(cont, cat)
    elif impute_strategy == "iterative":
        cont, cat = impute_iterative(cont, cat)
    else:
        raise ValueError(f"unknown impute strategy {impute_strategy!r}")
    return pd.concat([eid, cont, cat], axis=1)


def compute_field_lengths(imputed_df, n_continuous: int = None
                          ) -> List[int]:
    """1 per continuous + ``max+1`` per categorical (cell 15; the max
    is taken over the imputed table, so imputation can extend a
    category range — reference semantics)."""
    n_cont = (len(CONTINUOUS_COLUMNS) if n_continuous is None
              else n_continuous)
    lengths = [1] * n_cont
    cat_max = list(imputed_df.max(axis=0))[n_cont + 1:]  # skip eid
    return lengths + [int(m) + 1 for m in cat_max]


def reorder_indices(field_lengths: Sequence[int]
                    ) -> Tuple[List[int], List[int], List[int]]:
    """(reorder_ids, reordered_lengths, noExt_lengths) — categorical
    first (cell 16)."""
    cat_ids = [i for i, l in enumerate(field_lengths) if l != 1]
    cont_ids = [i for i, l in enumerate(field_lengths) if l == 1]
    reorder = cat_ids + cont_ids
    reordered = [field_lengths[i] for i in reorder]
    return reorder, reordered, reordered[:-N_EXTRACTED]


def _save_pt(obj, path: Path):
    import torch
    torch.save(obj, str(path))


def emit_split_artifacts(imputed_df, labeled_df, split_ids: Dict[str, list],
                         image_paths: Mapping[int, str], target: str,
                         store: Path, reorder: Sequence[int],
                         suffix: str = "", target_tag: str = None,
                         balanced: bool = False) -> None:
    """Cell 18/19/20: per-split reordered headerless CSV (+ noExt),
    image-path list, and label array, under the reference's artifact
    names. ``suffix`` lands between ``imaging`` and ``_reordered`` on
    features/paths (e.g. ``_CAD_0.1_balanced``); labels follow the
    reference's distinct ``cardiac_labels_{target_tag}_{split}[_balanced]``
    pattern (``target_tag`` e.g. ``CAD`` or ``CAD_0.1``)."""
    store = Path(store)
    store.mkdir(parents=True, exist_ok=True)
    tag = target_tag or target
    for split, ids in split_ids.items():
        split_df = imputed_df.set_index("eid").loc[ids]
        split_df = split_df.iloc[:, list(reorder)]
        stem = (f"cardiac_features_{split}_imputed_noOH_tabular_imaging"
                f"{suffix}_reordered")
        split_df.to_csv(store / f"{stem}.csv", index=False, header=False)
        split_df.iloc[:, :-N_EXTRACTED].to_csv(
            store / f"{stem}_noExt.csv", index=False, header=False)
        _save_pt([image_paths[k] for k in ids],
                 store / f"cardiac_{split}_paths_imaging{suffix}.pt")
        labels = labeled_df.set_index("eid").loc[ids, target].values
        lname = (f"cardiac_labels_{tag}_{split}"
                 + ("_balanced" if balanced else "") + ".pt")
        _save_pt(labels, store / lname)


def balance_split(labeled_df, ids: Sequence[int], target: str,
                  seed: int = SPLIT_SEED) -> List[int]:
    """Cell 19: all positives + an equal-size ``random.sample`` of
    negatives, positives first."""
    split_df = labeled_df.set_index("eid").loc[ids].assign(
        eid=lambda d: d.index)
    pos = list(split_df.loc[split_df[target] == 1]["eid"])
    neg_pool = list(split_df.loc[split_df[target] == 0]["eid"])
    if len(pos) > len(neg_pool):
        raise ValueError(
            f"cannot balance {target}: {len(pos)} positives but only "
            f"{len(neg_pool)} negatives in the split (the reference's "
            f"random.sample would fail identically)")
    rng = _random.Random(seed)
    neg = rng.sample(neg_pool, len(pos))
    return [int(x) for x in pos] + [int(x) for x in neg]


def low_data_indices(labels: Sequence[int], fraction: float = 0.1,
                     seed: int = SPLIT_SEED) -> List[int]:
    """Cell 20: the stratified ``test_size=fraction`` slice of a
    balanced split's row indices (chained 0.1 -> 0.01 by running this
    on the previous subset's labels)."""
    from sklearn.model_selection import train_test_split
    indices = list(range(len(labels)))
    _, low = train_test_split(indices, test_size=fraction,
                              random_state=seed, stratify=list(labels))
    return low


def assemble_cardiac_splits(labeled_df, image_paths: Mapping[int, str],
                            store: Path, targets=("CAD", "Infarction"),
                            invalid_ids: Sequence[int] = (),
                            problem_ids: Sequence[int] = (),
                            impute_strategy: str = "simple",
                            seed: int = SPLIT_SEED) -> Dict:
    """Full pipeline: drop bad subjects, split, impute, emit unbalanced
    + balanced + low-data artifacts for every target. Returns the
    reorder bookkeeping and id lists for tests."""
    store = Path(store)
    store.mkdir(parents=True, exist_ok=True)
    labeled_df = drop_subjects(labeled_df, list(invalid_ids))
    kept = drop_subjects(labeled_df, list(problem_ids))
    train, val, test = split_subject_ids(
        kept["eid"].astype(int).tolist(), seed=seed)
    imputed = assemble_feature_table(kept, impute_strategy)
    lengths = compute_field_lengths(imputed)
    reorder, reordered, noext = reorder_indices(lengths)
    _save_pt(lengths, store / "tabular_lengths.pt")
    _save_pt(reordered, store / "tabular_lengths_reordered.pt")
    _save_pt(noext, store / "tabular_lengths_reordered_noExt.pt")

    splits = {"train": train, "val": val, "test": test}
    for target in targets:
        emit_split_artifacts(imputed, kept, splits, image_paths, target,
                             store, reorder)
        balanced = {s: balance_split(kept, splits[s], target, seed)
                    for s in ("train", "val")}
        emit_split_artifacts(imputed, kept, balanced, image_paths,
                             target, store, reorder,
                             suffix=f"_{target}_balanced",
                             balanced=True)
        for s, ids in balanced.items():
            _save_pt(ids, store / f"ids_{s}_tabular_imaging_{target}"
                                  f"_balanced.pt")
        # chained low-data subsets of the balanced TRAIN set
        ids = balanced["train"]
        labels = kept.set_index("eid").loc[ids, target].tolist()
        for fraction in LOW_DATA_FRACTIONS:
            low = low_data_indices(labels, 0.1, seed)
            ids = [ids[i] for i in low]
            labels = [labels[i] for i in low]
            emit_split_artifacts(
                imputed, kept, {"train": ids}, image_paths, target,
                store, reorder,
                suffix=f"_{target}_{fraction}_balanced",
                target_tag=f"{target}_{fraction}", balanced=True)
            _save_pt(ids, store / f"ids_train_tabular_imaging_{target}"
                                  f"_{fraction}_balanced.pt")
    return {"splits": splits, "field_lengths": lengths,
            "reorder": reorder, "reordered_lengths": reordered,
            "noext_lengths": noext, "imputed": imputed}


def main(argv=None) -> int:  # pragma: no cover - needs the UKBB table
    import argparse

    import pandas as pd

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--labeled-csv", required=True,
                    help="cardiac_feature_*_vector_labeled_noOH.csv")
    ap.add_argument("--image-paths", required=True,
                    help=".pt mapping/list of per-eid image paths")
    ap.add_argument("--store", required=True)
    ap.add_argument("--invalid-ids", default=None)
    ap.add_argument("--problem-ids", default=None)
    ap.add_argument("--impute", default="simple",
                    choices=("simple", "iterative"))
    ap.add_argument("--targets", nargs="+",
                    default=("CAD", "Infarction"))
    args = ap.parse_args(argv)

    import torch
    labeled = pd.read_csv(args.labeled_csv)
    paths = torch.load(args.image_paths)
    if isinstance(paths, (list, tuple)):
        paths = dict(zip(labeled["eid"].astype(int), paths))
    load_ids = (lambda p: [] if p is None else torch.load(p))
    assemble_cardiac_splits(
        labeled, paths, Path(args.store), tuple(args.targets),
        load_ids(args.invalid_ids), load_ids(args.problem_ids),
        args.impute)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
