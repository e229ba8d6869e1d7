"""Raw DVM-CAR release -> reference artifact assembly, the port's copy of
``stil_tta_tpu/dataprep/dvm_raw.py``.

The programmatic cells of the reference's ``create_dvm_dataset.ipynb``:
the steps that rebuild the reference's artifact set from the raw DVM-CAR
download (https://deepvisualmarketing.github.io):

- table loading and the release's stray-whitespace column fixes (cell 4),
- ``Adv_ID`` parsing from ``Image_ID`` and the optional front-view /
  quality filter and per-ad dedup (cell 5),
- feature/image join on ``Adv_ID`` with a uniqueness check (cell 7),
- ``Engin_size`` 'xxL' -> float extraction (cell 8),
- categorical/continuous split, z-scoring, label-encoding (cell 10),
- minimum-population class filter (>=100 ads) and contiguous label remap
  (cells 12-14),
- physical-attribute table: fill missing Wheelbase/Length/Width/Height
  from other ads of the same model, the two manual fixes the notebook
  records, and the +-50 mm anti-leak jitter (cells 32-35),
- merge physical attrs (z-scored PER SPLIT in cell 35's
  create_feature_files), drop non-features, categorical-first
  reorder, ``Adv_year`` removal (cells 35-36, 40-42),
- stratified 50/20/... train/val/test splits at seed 2022 and the
  low-data (label-fraction) splits that keep >=1 ad per class at seed
  2023 (cells 21, 24-25).

pandas and scikit-learn (``train_test_split``, whose draws give the
split ids) are imported inside the functions that use them; the image
packing and on-disk layout reuse :mod:`stil_tta_torch.dataprep.dvm`
(``load_images``) and :class:`ArraySource`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CONTINUOUS_COLS = ["Adv_year", "Adv_month", "Reg_year", "Runned_Miles",
                   "Price", "Seat_num", "Door_num", "Entry_price",
                   "Engine_size"]
CATEGORICAL_COLS = ["Color", "Bodytype", "Gearbox", "Fuel_type"]
PHYSICAL_COLS = ["Wheelbase", "Height", "Width", "Length"]
# final feature layout (cells 36+42; the '..._reordered.csv' the
# shipped configs consume — 4 categoricals first, then 13 continuous,
# ``dvm_all_server_reordered_SemiPseudo_0.01.yaml:20-35``). The 'rmAY'
# variant (cells 40-42) additionally drops Adv_year.
FINAL_COLS = (CATEGORICAL_COLS + ["Wheelbase", "Height", "Width",
                                  "Length", "Adv_year", "Adv_month",
                                  "Reg_year", "Runned_Miles", "Price",
                                  "Seat_num", "Door_num", "Entry_price",
                                  "Engine_size"])
MIN_POPULATION = 100       # cell 12
SPLIT_SEED = 2022          # cell 21
LOW_DATA_SEED = 2023       # cell 24
JITTER_MM = 50             # cell 34

# the two wheelbase corrections the notebook hard-codes (cell 32)
MANUAL_PHYSICAL_FIXES = {("69_36", "Wheelbase"): 2612.0,   # Peugeot RCZ
                         ("29_20", "Wheelbase"): 2788.0}   # Grand C-Max


def _strip_columns(df):
    """The DVM-CAR CSVs ship columns like ``' Genmodel_ID'`` /
    ``'Genmodel_ID '`` — cell 4 renames them one by one; stripping is
    the general form."""
    return df.rename(columns={c: c.strip() for c in df.columns})


def parse_adv_id(image_ids: Sequence[str]) -> List[str]:
    """``Adv_ID`` = first two ``$$``-separated fields of ``Image_ID``
    (cell 5)."""
    out = []
    for x in image_ids:
        parts = str(x).split("$$")
        out.append(f"{parts[0]}$${parts[1]}")
    return out


def prepare_image_table(image_df, front_view_only: bool = False):
    """cell 5: Adv_ID column, optional quality/front-view filter,
    per-ad dedup (first image of each ad)."""
    image_df = _strip_columns(image_df).copy()
    image_df["Adv_ID"] = parse_adv_id(image_df["Image_ID"])
    if front_view_only:
        image_df = image_df[(image_df["Quality_check"] == "P")
                            & (image_df["Predicted_viewpoint"] == 0)]
    return image_df.drop_duplicates(subset=["Adv_ID"])


def extract_engine_size(series) -> np.ndarray:
    """``'2.0L' -> 2.0`` (cell 8)."""
    return np.asarray([float(str(x)[:-1]) for x in series], np.float64)


def join_ad_and_images(ad_df, image_df, front_view_only: bool = False):
    """cells 4-8: ad table x image table on Adv_ID, NaN drop,
    engine-size extraction. Returns the joined dataframe with
    ``Image_name`` / ``Predicted_viewpoint`` attached."""
    import pandas as pd

    ad_df = _strip_columns(ad_df).copy()
    if "Adv_ID" not in ad_df.columns:
        raise ValueError("ad table must carry Adv_ID")
    img = prepare_image_table(image_df, front_view_only)
    cols = ["Adv_ID", "Image_name"]
    if "Predicted_viewpoint" in img.columns:
        cols.append("Predicted_viewpoint")
    df = ad_df.merge(img[cols], on="Adv_ID")
    if not df["Adv_ID"].is_unique:
        raise ValueError("Adv_ID not unique after image join (cell 7 "
                         "asserts uniqueness)")
    df = df.dropna()
    if "Engin_size" in df.columns:
        df = df.assign(Engine_size=extract_engine_size(df["Engin_size"]))
        df = df.drop(columns=["Engin_size"])
    df["Runned_Miles"] = pd.to_numeric(df["Runned_Miles"],
                                       errors="coerce")
    df["Price"] = pd.to_numeric(df["Price"], errors="coerce")
    return df.dropna()


def filter_populated_classes(df, min_population: int = MIN_POPULATION
                             ) -> Tuple["object", Dict]:
    """cells 12-14: keep models with >= min_population ads, remap
    Genmodel_ID to contiguous codes (first-appearance order, matching
    the notebook's ``unique()`` walk)."""
    counts = df["Genmodel_ID"].value_counts()
    populated = set(counts[counts >= min_population].index)
    out = df[df["Genmodel_ID"].isin(populated)].copy()
    mapping = {}
    for v in out["Genmodel_ID"].unique():
        mapping[v] = len(mapping)
    out["Genmodel_ID"] = out["Genmodel_ID"].map(mapping)
    return out, mapping


def fill_physical_attributes(physical_df):
    """cell 32: manual fixes + fill missing/zero physical attributes
    from any other ad of the same model."""
    df = _strip_columns(physical_df).copy()
    for (model, attr), value in MANUAL_PHYSICAL_FIXES.items():
        if (df["Genmodel_ID"] == model).any():
            df.loc[df["Genmodel_ID"] == model, attr] = value
    for attr in ["Wheelbase", "Length", "Width", "Height"]:
        if attr not in df.columns:
            continue
        by_model = (df[df[attr].notna() & (df[attr] > 0)]
                    .drop_duplicates("Genmodel_ID")
                    .set_index("Genmodel_ID")[attr])
        bad = df[attr].isna() | (df[attr] <= 0)
        df.loc[bad, attr] = df.loc[bad, "Genmodel_ID"].map(by_model)
    return df


def jitter_physical(df, jitter: int = JITTER_MM, seed: int = 2022):
    """cell 34: +-jitter mm uniform-integer noise on the physical
    dimensions so they aren't class labels in disguise (the notebook
    uses python ``random.randint`` at seed 2022; we use a numpy
    generator — the *distribution* is what matters, SURVEY.md §7)."""
    rng = np.random.RandomState(seed)
    df = df.copy()
    for attr in PHYSICAL_COLS:
        df[attr] = df[attr] + rng.randint(-jitter, jitter + 1, len(df))
    return df


def reference_splits(df, seed: int = SPLIT_SEED,
                     test_size: float = 0.5, val_size: float = 0.2):
    """cell 21 (all-views branch): stratified train/test split then
    train/val split, both at seed 2022.

    Faithful quirk: the notebook's second split passes
    ``stratify=filtered_data_df[isin(train_set_ids)]['Genmodel_ID']``
    — labels in ORIGINAL dataframe order against ``train_set_ids`` in
    sklearn's shuffled order, so element i of the id list is stratified
    by the class of a *different* ad and the train/val split is only
    approximately stratified. Reproducing the reference's exact split
    ids requires keeping that misalignment (``sub`` below is in df
    order on purpose); do NOT "fix" it to ``by_id.loc[train_set]``."""
    from sklearn.model_selection import train_test_split

    ids = list(df["Adv_ID"])
    strat = df["Genmodel_ID"]
    train_set, test = train_test_split(ids, test_size=test_size,
                                       random_state=seed, stratify=strat)
    sub = df[df["Adv_ID"].isin(train_set)]
    train, val = train_test_split(
        train_set, test_size=val_size, random_state=seed,
        stratify=sub["Genmodel_ID"])
    by_id = df.set_index("Adv_ID")
    return (by_id.loc[train].reset_index(),
            by_id.loc[val].reset_index(),
            by_id.loc[test].reset_index())


def low_data_split(df, nclasses: int, fraction: float,
                   seed: int = LOW_DATA_SEED) -> np.ndarray:
    """cell 24: the labeled subset at ``fraction`` — one guaranteed ad
    per class (``groupby.head(1)``), remainder stratified at seed
    2023. Returns the selected Adv_IDs."""
    from sklearn.model_selection import train_test_split

    critical = df.groupby("Genmodel_ID", as_index=False).head(1)["Adv_ID"]
    other = np.asarray(
        df.loc[~df["Adv_ID"].isin(critical)]["Adv_ID"], object)
    to_fill = int(len(df) * fraction) - len(critical)
    if to_fill > 0:
        strat = None
        if to_fill >= nclasses:
            strat = df.set_index("Adv_ID").loc[other]["Genmodel_ID"]
        _, extra = train_test_split(other, test_size=to_fill,
                                    random_state=seed, stratify=strat)
    else:
        extra = []
    return np.concatenate([np.asarray(critical), np.asarray(extra)])


def build_feature_frame(df, physical_df, drop_adv_year: bool = False):
    """cells 35-36 (+40-42 when ``drop_adv_year``, the 'rmAY'
    variant): merge physical attrs, z-score the 9 continuous columns
    globally (cell 10), reorder categorical-first. The 4 PHYSICAL_COLS
    stay RAW here — cell 35's create_feature_files normalises them per
    split, which :func:`assemble_raw_dvm` applies after
    :func:`reference_splits`. Returns (feature dataframe in FINAL_COLS
    order with label-encoded categoricals, field_lengths, category
    mappings, merged rows)."""
    merged = df.merge(physical_df[["Adv_ID"] + PHYSICAL_COLS],
                      on="Adv_ID")
    for attr in PHYSICAL_COLS:
        if merged[attr].isna().any() or (merged[attr] == 0).any():
            raise ValueError(f"{attr} still has missing/zero values "
                             "after fill (cell 35 asserts)")
    out = {}
    field_lengths = []
    mappings = {}
    for c in CATEGORICAL_COLS:
        cat = merged[c].astype("category")
        mappings[c] = dict(enumerate(cat.cat.categories))
        out[c] = cat.cat.codes.astype(np.float32)
        field_lengths.append(len(cat.cat.categories))
    for c in FINAL_COLS[len(CATEGORICAL_COLS):]:
        v = np.asarray(merged[c], np.float64)
        if c in PHYSICAL_COLS:
            # cell 35 (create_feature_files) normalises the 4 physical
            # columns PER SPLIT — keep them raw here; assemble_raw_dvm
            # z-scores each split's slice after reference_splits()
            out[c] = v.astype(np.float32)
        else:
            # the 9 continuous columns are z-scored globally (cell 10,
            # before the cell-21 split)
            std = v.std(ddof=1) or 1.0
            out[c] = ((v - v.mean()) / std).astype(np.float32)
        field_lengths.append(1)
    import pandas as pd
    cols = [c for c in FINAL_COLS
            if not (drop_adv_year and c == "Adv_year")]
    if drop_adv_year:
        field_lengths = [fl for c, fl in zip(FINAL_COLS, field_lengths)
                         if c != "Adv_year"]
    feats = pd.DataFrame(out)[cols]
    feats.index = merged.index
    return feats, field_lengths, mappings, merged


def assemble_raw_dvm(ad_df, image_df, physical_df,
                     label_fractions: Sequence[float] = (0.01, 0.1),
                     front_view_only: bool = False,
                     min_population: int = MIN_POPULATION,
                     jitter_seed: int = 2022):
    """Full notebook pipeline on in-memory tables. Returns a dict:

    - ``splits``: {'train'|'val'|'test': (features_df, labels, ids,
      image_names)} with features in the reference's reordered/rmAY
      layout,
    - ``labelled_ids``: {fraction: set of labeled train Adv_IDs},
    - ``field_lengths``, ``label_mapping``, ``category_mappings``.
    """
    df = join_ad_and_images(ad_df, image_df, front_view_only)
    df, label_mapping = filter_populated_classes(df, min_population)
    if not len(df):
        raise ValueError(
            f"no class reaches min_population={min_population}")
    nclasses = len(label_mapping)
    physical = jitter_physical(fill_physical_attributes(physical_df),
                               seed=jitter_seed)

    # Encode ONCE on the full table, then split. Cell 10 computes
    # cat.codes / continuous z-scores on the complete frame before the
    # cell-21 split, so categorical codes and the 9 continuous columns'
    # normalisation statistics are shared by train/val/test. The 4
    # physical columns are the exception: cell 35's create_feature_files
    # normalises them PER SPLIT (each split file carries its own
    # mean/std) — build_feature_frame leaves them raw and they are
    # z-scored per split below.
    feats_all, field_lengths, cat_mappings, merged_all = \
        build_feature_frame(df, physical)
    # the physical merge is an inner join: any ad missing from (or
    # duplicated in) the physical table would silently change the id
    # list fed to train_test_split vs the notebook's (which splits the
    # pre-merge frame) — refuse instead
    if len(merged_all) != len(df):
        raise ValueError(
            f"physical-attribute merge changed the row count "
            f"({len(df)} -> {len(merged_all)}): the physical table must "
            f"cover every ad exactly once (cell 35)")
    if not merged_all["Adv_ID"].is_unique:
        raise ValueError("Adv_ID not unique after physical merge")
    merged_all = merged_all.reset_index(drop=True)
    feats_all.index = merged_all.index

    import pandas as pd
    row_of = pd.Series(np.arange(len(merged_all)),
                       index=merged_all["Adv_ID"])
    train_df, val_df, test_df = reference_splits(merged_all)
    splits = {}
    for name, part in (("train", train_df), ("val", val_df),
                       ("test", test_df)):
        rows = row_of.loc[list(part["Adv_ID"])].to_numpy()
        feats = feats_all.iloc[rows].reset_index(drop=True).copy()
        # cell 35: per-split z-score of the physical columns
        for c in PHYSICAL_COLS:
            v = np.asarray(feats[c], np.float64)
            std = v.std(ddof=1) or 1.0
            feats[c] = ((v - v.mean()) / std).astype(np.float32)
        splits[name] = (feats,
                        np.asarray(merged_all["Genmodel_ID"]
                                   .iloc[rows], np.int64),
                        list(merged_all["Adv_ID"].iloc[rows]),
                        list(merged_all["Image_name"].iloc[rows]))

    labelled_ids = {}
    feats, labels, ids, _ = splits["train"]
    train_key = pd.DataFrame({"Adv_ID": ids, "Genmodel_ID": labels})
    for frac in label_fractions:
        labelled_ids[frac] = set(
            low_data_split(train_key, nclasses, frac))

    return {"splits": splits, "labelled_ids": labelled_ids,
            "field_lengths": field_lengths,
            "label_mapping": label_mapping,
            "category_mappings": cat_mappings,
            "num_classes": nclasses}


def splits_to_sources(assembled, image_root, size: int = 128,
                      label_fraction: float = 0.01):
    """Materialise :func:`assemble_raw_dvm` output as the native
    ``ArraySource`` split dict (images loaded + resized via
    :func:`stil_tta_torch.dataprep.dvm.load_images`; DVM image paths are
    ``root/a/b/c/d/name`` from the ``$$``-separated name — cell 22)."""
    from pathlib import Path

    from stil_tta_torch.data.source import ArraySource
    from stil_tta_torch.dataprep.dvm import load_images

    def img_path(name):
        parts = str(name).split("$$")
        return str(Path(image_root).joinpath(*parts[:4], name)) \
            if len(parts) >= 5 else str(Path(image_root) / str(name))

    fl = assembled["field_lengths"]
    nclasses = assembled["num_classes"]
    lab_ids = assembled["labelled_ids"][label_fraction]
    out = {}
    for name, (feats, labels, ids, image_names) in \
            assembled["splits"].items():
        images = load_images([img_path(n) for n in image_names], size)
        labelled = np.asarray([i in lab_ids for i in ids]) \
            if name == "train" else np.ones(len(ids), bool)
        src = ArraySource(images=images,
                          tabular=np.asarray(feats, np.float32),
                          labels=labels, labelled=labelled,
                          field_lengths=fl, num_classes=nclasses,
                          target="dvm")
        if name == "train":
            keep_l = np.where(labelled)[0]
            keep_u = np.where(~labelled)[0]
            take = lambda idx, lab: ArraySource(
                images=images[idx], tabular=src.tabular[idx],
                labels=labels[idx],
                labelled=np.full(len(idx), lab, bool),
                field_lengths=fl, num_classes=nclasses, target="dvm")
            out["train_labelled"] = take(keep_l, True)
            out["train_unlabelled"] = take(keep_u, False)
        else:
            out[name] = src
    return out
