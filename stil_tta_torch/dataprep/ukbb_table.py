"""UKBB cardiac raw feature table -> cleaned and vectorised feature CSVs,
the port's copy of ``stil_tta_tpu/dataprep/ukbb_table.py``.

The programmatic cells of the reference's
``data/preprocess_ukbb/preprocess_cardiac_table.ipynb`` (233 code cells;
the plot-only EDA cells are left out) and vectorised equivalents of its
``preprocess_ukbb/tabular_utils.py``. With
:mod:`stil_tta_torch.dataprep.ukbb` (field filtering, image packing) and
:mod:`stil_tta_torch.dataprep.ukbb_split` (labels, splits, imputation,
artifact emission) this is the whole raw-UKBB -> artifact pipeline.
pandas is imported inside the functions, so the module imports without
it.

Input: the renamed cardiac feature table (``cardiac_features_18545.csv``
joined to names via the data dictionary, ``rename_to_field_names``).
Outputs: the notebook's four vector CSVs under the reference names
(``python -m stil_tta_torch.dataprep.ukbb_table features.csv out_dir``)

- ``cardiac_feature_18545_vector.csv``          (one-hot, cell 329)
- ``cardiac_feature_18545_vector_labeled.csv``  (+ICD labels, cell 337)
- ``cardiac_feature_18545_vector_noOH.csv``     (ordinal, cell 343)
- ``cardiac_feature_18545_vector_labeled_noOH.csv`` (cell 345)

REFERENCE QUIRKS kept faithfully (each unit-tested):

- cell 101 passes ``update_through_age(df, field_id, 'Diabetes
  diagnosis')`` with the *age field* in the ``diag_id`` slot: the call
  overwrites the ``Age diabetes diagnosed-{i}.0`` columns with True and
  leaves ``Diabetes diagnosis`` untouched (the "or age for diagnosis"
  print is wishful). We reproduce the swapped call.
- cell 145 "clears" female-specific medications for men using column
  names *without* the word "medication" — names that do not exist, so
  pandas silently creates two all-NA columns and the real medication
  columns keep their male values. Reproduced.
- cell 284 cleans only array items ``-2.0..-2.3`` of 'Types of physical
  activity in last 4 weeks' but ``check_answer_single_visit`` scans
  ``option_array_size=5`` items; item ``-2.4`` is compared raw.
- cell 292 runs ``remove_outliers`` *before* ``to_numeric`` on
  'Diastolic brachial blood pressure-2.0' (works because the dtype map
  already typed it Continuous).
- the ``CAD_codes`` missing comma (cells 334/345) lives in
  :mod:`ukbb_split` and is shared from there.

All loops over subjects are vectorised (pandas column ops); the
reference's per-row ``.apply`` one-hot encodes ~40k rows in minutes,
ours in milliseconds.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# --------------------------------------------------------------------
# tabular_utils.py equivalents (vectorised)
# --------------------------------------------------------------------


def get_all_features_same_id(df: pd.DataFrame, feature_id: int):
    """All entries of a multi-array field ID per subject
    (``tabular_utils.py:9-23``). Returns (eids, list-of-lists)."""
    cols = df.filter(regex=f"{feature_id}-*|eid")
    eids = cols["eid"]
    values = cols.drop(columns=["eid"]).values
    out = [[x for x in row if str(x) != "nan"] for row in values]
    return eids, out


def check_coverage(df: pd.DataFrame, field_ids: Sequence[str]):
    """Row mask where every field is non-NA (``tabular_utils.py:25-36``,
    sans printing)."""
    return df[field_ids].notna().all(axis="columns")


def grab_sorted_values(df: pd.DataFrame, field_id: str,
                       descending: bool = True) -> List:
    """Sorted non-NA values (``tabular_utils.py:62-68``)."""
    values = list(df.loc[~df[field_id].isna(), field_id])
    values.sort(reverse=descending)
    return values


def remove_outliers(df: pd.DataFrame, field_id: str, limit: float,
                    greater: bool = True) -> None:
    """Set values beyond ``limit`` to NA (``tabular_utils.py:71-80``)."""
    import pandas as pd
    if greater:
        df.loc[df[field_id] > limit, field_id] = pd.NA
    else:
        df.loc[df[field_id] < limit, field_id] = pd.NA


def calc_and_save_mean(df: pd.DataFrame, field_id: str) -> None:
    """Mean over the ``-i.0, -i.1, ...`` array columns into
    ``-i.mean`` (``tabular_utils.py:80-93``). ``field_id`` must point at
    array item 0."""
    ids = []
    cols = df.columns
    while field_id in cols:
        ids.append(field_id)
        stem, idx = field_id.rsplit(".", 1)
        field_id = f"{stem}.{int(idx) + 1}"
    stem = ids[-1].rsplit(".", 1)[0]
    df[f"{stem}.mean"] = df[ids].mean(axis=1)


def get_name(field_id: str, datadict_df: pd.DataFrame) -> str:
    """Integer field id -> Field name (``tabular_utils.py:54-59``)."""
    base = int(field_id.split("-")[0])
    return datadict_df.loc[datadict_df["FieldID"] == base, "Field"].iloc[0]


def rename_to_field_names(df: pd.DataFrame,
                          datadict_df: pd.DataFrame) -> None:
    """Rename integer-id columns to ``{Field name}-{instance.array}``
    (``tabular_utils.py:94-105``); in-place like the reference. The
    caller must first disambiguate FieldID 23104 to 'Body mass index
    (BMI) Impedance' (notebook cell 7)."""
    mapping = {}
    for c in df.columns:
        if c.startswith("eid") or c.startswith("age"):
            continue
        mapping[c] = f"{get_name(c, datadict_df)}-{c.split('-')[1]}"
    df.rename(columns=mapping, inplace=True)


def update_through_age(df: pd.DataFrame, diag_id: str,
                       age_id: str) -> None:
    """OR a diagnosis flag with "gave an age/date for it"
    (``tabular_utils.py:106-113``; whole-column assignment + bool
    coercion because pandas 2.x refuses the bool/float mixing that the
    reference's pandas 1.x performed silently — only relevant for the
    cell-101 swapped call, whose output column is never consumed)."""
    right = df[diag_id]
    if right.dtype != bool:
        right = right.fillna(0).astype(bool)
    df[diag_id] = df[age_id].notna() | right


def check_answer(df: pd.DataFrame, answer: int, field_name: str,
                 instance_array_size: int, option_array_size: int,
                 agnostic_field: Optional[str] = None) -> pd.Series:
    """True where any ``{field}-{i}.{j}`` equals ``answer``
    (``tabular_utils.py:115-127``)."""
    import pandas as pd
    superset = pd.Series(False, index=df.index)
    for i in range(instance_array_size):
        for j in range(option_array_size):
            superset = superset | (df[f"{field_name}-{i}.{j}"] == answer)
    if agnostic_field:
        superset = superset | df[agnostic_field]
    return superset


def check_answer_single_visit(df: pd.DataFrame, answer: int, visit: int,
                              field_name: str, option_array_size: int,
                              agnostic_field: Optional[str] = None
                              ) -> pd.Series:
    """Single-instance variant (``tabular_utils.py:129-140``)."""
    import pandas as pd
    superset = pd.Series(False, index=df.index)
    for j in range(option_array_size):
        superset = superset | (df[f"{field_name}-{visit}.{j}"] == answer)
    if agnostic_field:
        superset = superset | df[agnostic_field]
    return superset


def operations_performed(df: pd.DataFrame, field_name: str,
                         operation_codes: Sequence) -> pd.Series:
    """Count occurrences of operation codes over the fixed 3x32 array
    (``tabular_utils.py:142-151``)."""
    import pandas as pd
    counts = pd.Series(0, index=df.index)
    for i in range(3):
        for j in range(32):
            counts = counts + df[f"{field_name}-{i}.{j}"].isin(
                operation_codes)
    return counts


def one_hot_encode_column(col: pd.Series, num_classes: int,
                          one_based: bool = False) -> np.ndarray:
    """Vectorised ``tabular_utils.one_hot_encode`` over a column:
    (n, num_classes) float array, NaN rows -> all-NaN rows
    (``tabular_utils.py:156-169``)."""
    import pandas as pd
    vals = pd.to_numeric(col, errors="coerce").to_numpy(dtype=float)
    out = np.full((len(vals), num_classes), np.nan)
    mask = ~np.isnan(vals)
    idx = vals[mask].astype(int) - (1 if one_based else 0)
    eye = np.eye(num_classes)
    out[mask] = eye[idx]
    return out


def clean_categorical_column(col: pd.Series) -> pd.Series:
    """NaN-preserving int cast (``tabular_utils.py:171-178``); uses
    pandas Int64 so ints stay ints next to NA."""
    import pandas as pd
    return pd.to_numeric(col, errors="coerce").astype("Int64")


def expand_list(df: pd.DataFrame, label_id: str) -> pd.DataFrame:
    """Expand a list-valued column into ``{label_id}-{i}`` scalar
    columns (``tabular_utils.py:180-189``)."""
    import pandas as pd
    num_classes = len(df[label_id].iloc[0])
    cols = [f"{label_id}-{i}" for i in range(num_classes)]
    out = pd.concat(
        [df, pd.DataFrame(df[label_id].tolist(), columns=cols,
                          index=df.index)], axis=1)
    return out.drop(label_id, axis=1)


# --------------------------------------------------------------------
# The cleaning chain (notebook cells 23..318, mutations only, in order)
# --------------------------------------------------------------------

PWA_FIELDS = (
    "Heart rate during PWA",
    "Systolic brachial blood pressure during PWA",
    "Diastolic brachial blood pressure during PWA",
    "Peripheral pulse pressure during PWA",
    "Central systolic blood pressure during PWA",
    "Central pulse pressure during PWA",
    "Number of beats in waveform average for PWA",
    "Central augmentation pressure during PWA",
    "Augmentation index for PWA",
    "Cardiac output during PWA",
    "End systolic pressure during PWA",
    "End systolic pressure index during PWA",
    "Total peripheral resistance during PWA",
    "Stroke volume during PWA",
    "Cardiac index during PWA",
)

MED_FIELD_M = ("Medication for cholesterol, blood pressure, diabetes,"
               " or take exogenous hormones")
MED_FIELD_F = "Medication for cholesterol, blood pressure or diabetes"
VASC_FIELD = "Vascular/heart problems diagnosed by doctor"
ACTIVITY_FIELD = "Types of physical activity in last 4 weeks"


def _num(df, fid):
    import pandas as pd
    df[fid] = pd.to_numeric(df[fid], errors="coerce")


def _na(df, fid, *codes):
    import pandas as pd
    for c in codes:
        df.loc[df[fid] == c, fid] = pd.NA


def _set(df, fid, code, value):
    df.loc[df[fid] == code, fid] = value


def _fill_na(df, fid, value):
    df.loc[df[fid].isna(), fid] = value


def clean_cardiac_table(df: pd.DataFrame) -> None:
    """Apply the notebook's full field-cleaning + derivation chain
    in-place (cells 23-316, state-mutating statements only, original
    order). ``df`` is the renamed feature table."""
    import pandas as pd
    # cells 23-25: alcohol intake frequency
    _num(df, "Alcohol intake frequency.-2.0")
    _na(df, "Alcohol intake frequency.-2.0", -3)
    # cell 30: arterial stiffness outlier
    remove_outliers(df, "Pulse wave Arterial Stiffness index-2.0", 50)
    # cell 33
    _num(df, "Sex-0.0")
    # cells 41-56: blood pressure / pulse means
    _num(df, "Systolic blood pressure, automated reading-2.0")
    calc_and_save_mean(df, "Systolic blood pressure, automated reading-2.0")
    _num(df, "Systolic blood pressure, automated reading-0.0")
    calc_and_save_mean(df, "Systolic blood pressure, automated reading-0.0")
    _num(df, "Diastolic blood pressure, automated reading-2.0")
    calc_and_save_mean(df, "Diastolic blood pressure, automated reading-2.0")
    _num(df, "Pulse rate, automated reading-2.0")
    calc_and_save_mean(df, "Pulse rate, automated reading-2.0")
    # cells 54-56: sysBP outlier then mean recomputed from clipped data
    remove_outliers(df, "Systolic blood pressure, automated reading-2.0",
                    500)
    calc_and_save_mean(df, "Systolic blood pressure, automated reading-2.0")
    # cells 64-68: adopt the automated means under the plain names
    df["Systolic blood pressure-2.mean"] = (
        df["Systolic blood pressure, automated reading-2.mean"])
    df["Diastolic blood pressure-2.mean"] = (
        df["Diastolic blood pressure, automated reading-2.mean"])
    df["Pulse rate-2.mean"] = df["Pulse rate, automated reading-2.mean"]
    # cells 70-98
    _num(df, "Body fat percentage-2.0")
    _num(df, "Whole body fat mass-2.0")
    _num(df, "Body mass index (BMI)-2.0")
    _num(df, "Ethnic background-0.0")
    _num(df, "Overall health rating-2.0")
    _na(df, "Overall health rating-2.0", -1, -3)
    # cells 100-101: diabetes (incl. the swapped update_through_age)
    df["Diabetes diagnosis"] = check_answer(
        df, 1, "Diabetes diagnosed by doctor", 4, 1)
    for i in range(4):
        # reference quirk: arguments swapped -> mutates the age field
        update_through_age(df, f"Age diabetes diagnosed-{i}.0",
                           "Diabetes diagnosis")
    # cell 106: vascular/heart problems
    for i in range(3):
        for j in range(4):
            fid = f"{VASC_FIELD}-{i}.{j}"
            _num(df, fid)
            _na(df, fid, -3)
            _set(df, fid, -7, 0)
    df["Heart attack diagnosed by doctor"] = check_answer(
        df, 1, VASC_FIELD, 3, 4)
    df["Angina diagnosed by doctor"] = check_answer(df, 2, VASC_FIELD, 3, 4)
    df["Stroke diagnosed by doctor"] = check_answer(df, 3, VASC_FIELD, 3, 4)
    df["High blood pressure diagnosed by doctor"] = check_answer(
        df, 4, VASC_FIELD, 3, 4)
    # cell 112: ages for heart attack (only 0..2 cleaned here)
    for i in range(3):
        fid = f"Age heart attack diagnosed-{i}.0"
        _num(df, fid)
        _na(df, fid, -1)
    # cells 114-116: MI dates fold into the heart-attack flag
    for date_field in ("Date of myocardial infarction-0.0",
                       "Date of STEMI-0.0", "Date of NSTEMI-0.0"):
        df[date_field] = pd.to_datetime(df[date_field], errors="coerce")
        update_through_age(df, "Heart attack diagnosed by doctor",
                           date_field)
    # cell 122: ages 0..3 fold in (item 3 never to_numeric'd: faithful)
    for i in range(4):
        update_through_age(df, "Heart attack diagnosed by doctor",
                           f"Age heart attack diagnosed-{i}.0")
    # cells 124-127: high blood pressure ages
    for i in range(4):
        _num(df, f"Age high blood pressure diagnosed-{i}.0")
    for i in range(4):
        update_through_age(df, "High blood pressure diagnosed by doctor",
                           f"Age high blood pressure diagnosed-{i}.0")
    # cells 135-138: stroke ages
    for i in range(4):
        _num(df, f"Age stroke diagnosed-{i}.0")
    for i in range(4):
        update_through_age(df, "Stroke diagnosed by doctor",
                           f"Age stroke diagnosed-{i}.0")
    # cell 141: medication field (male questionnaire, 4x4)
    for i in range(4):
        for j in range(4):
            fid = f"{MED_FIELD_M}-{i}.{j}"
            _num(df, fid)
            _na(df, fid, -1, -3)
            _set(df, fid, -7, 0)
    med_names = ("Cholesterol lowering medication regularly taken",
                 "Blood pressure medication regularly taken",
                 "Insulin medication regularly taken",
                 "Hormone replacement therapy medication regularly taken",
                 "Oral contraceptive pill or minipill medication"
                 " regularly taken")
    for answer, name in enumerate(med_names, start=1):
        df[name] = check_answer(df, answer, MED_FIELD_M, 4, 4)
    # cell 142: per-visit variants
    for answer, name in enumerate(med_names, start=1):
        for visit in (0, 2):
            df[f"{name}-{visit}.0"] = check_answer_single_visit(
                df, answer, visit, MED_FIELD_M, 4)
    # cell 144: diabetes |= insulin
    df["Diabetes diagnosis"] = check_answer(
        df, 3, MED_FIELD_M, 4, 4, agnostic_field="Diabetes diagnosis")
    # cell 145 quirk: non-existent names -> creates two all-NA columns
    df.loc[df["Sex-0.0"] == 1,
           "Hormone replacement therapy regularly taken"] = pd.NA
    df.loc[df["Sex-0.0"] == 1,
           "Oral contraceptive pill or minipill regularly taken"] = pd.NA
    # cell 150: medication field (female questionnaire, 4x3), chained
    for i in range(4):
        for j in range(3):
            fid = f"{MED_FIELD_F}-{i}.{j}"
            _num(df, fid)
            _na(df, fid, -1, -3)
            _set(df, fid, -7, 0)
    for answer, name in enumerate(med_names[:3], start=1):
        df[name] = check_answer(df, answer, MED_FIELD_F, 4, 3,
                                agnostic_field=name)
    # cell 151: per-visit chained (field_name reverts to the male field)
    for answer, name in enumerate(med_names[:3], start=1):
        for visit in (0, 2):
            df[f"{name}-{visit}.0"] = check_answer_single_visit(
                df, answer, visit, MED_FIELD_M, 4,
                agnostic_field=f"{name}-{visit}.0")
    # cell 152: diabetes again via the male field (notebook state:
    # field_name=MED_FIELD_M, sizes 4x4)
    df["Diabetes diagnosis"] = check_answer(
        df, 3, MED_FIELD_M, 4, 4, agnostic_field="Diabetes diagnosis")
    # cells 170-172
    _num(df, "Total thigh fat-free muscle volume-2.0")
    _num(df, "Total trunk fat volume-2.0")
    # cell 208
    _num(df, "Substances taken for anxiety-0.1")
    _na(df, "Substances taken for anxiety-0.1", -818, -121)
    # cells 238-247: low-end outliers
    _num(df, "Basal metabolic rate-2.0")
    remove_outliers(df, "Basal metabolic rate-2.0", 10, greater=False)
    _num(df, "Waist circumference-2.0")
    remove_outliers(df, "Waist circumference-2.0", 10, greater=False)
    _num(df, "Hip circumference-2.0")
    remove_outliers(df, "Hip circumference-2.0", 10, greater=False)
    _num(df, "Weight-2.0")
    remove_outliers(df, "Weight-2.0", 2, greater=False)
    # cells 249-258
    _num(df, "Average heart rate-2.0")
    _num(df, "QRS duration-2.0")
    remove_outliers(df, "QRS duration-2.0", 2, greater=False)
    remove_outliers(df, "QRS duration-2.0", 200)
    _num(df, "Body surface area-2.0")
    # cell 259: tobacco smoking recode
    _num(df, "Tobacco smoking-0.0")
    _na(df, "Tobacco smoking-0.0", -818)
    for code, value in ((111, 3), (112, 2), (113, 1), (114, 0)):
        _set(df, "Tobacco smoking-0.0", code, value)
    # cell 260
    _num(df, "Shortness of breath walking on level ground-2.0")
    _na(df, "Shortness of breath walking on level ground-2.0", -1, -3)
    # cells 264-270: activity days/durations
    _num(df, "Number of days/week walked 10+ minutes-2.0")
    _na(df, "Number of days/week walked 10+ minutes-2.0", -1, -2, -3)
    _num(df, "Duration of walks-2.0")
    _na(df, "Duration of walks-2.0", -1, -3)
    df.loc[df["Number of days/week walked 10+ minutes-2.0"] == 0,
           "Duration of walks-2.0"] = 0
    remove_outliers(df, "Duration of walks-2.0", 1000)
    _num(df, "Number of days/week of moderate physical activity"
             " 10+ minutes-2.0")
    _na(df, "Number of days/week of moderate physical activity"
            " 10+ minutes-2.0", -1, -3)
    _num(df, "Duration of moderate activity-2.0")
    _na(df, "Duration of moderate activity-2.0", -1, -3)
    df.loc[df["Number of days/week of moderate physical activity"
              " 10+ minutes-2.0"] == 0,
           "Duration of moderate activity-2.0"] = 0
    remove_outliers(df, "Duration of moderate activity-2.0", 1000)
    _num(df, "Number of days/week of vigorous physical activity"
             " 10+ minutes-2.0")
    _na(df, "Number of days/week of vigorous physical activity"
            " 10+ minutes-2.0", -1, -3)
    _num(df, "Duration of vigorous activity-2.0")
    _na(df, "Duration of vigorous activity-2.0", -1, -3)
    df.loc[df["Number of days/week of vigorous physical activity"
              " 10+ minutes-2.0"] == 0,
           "Duration of vigorous activity-2.0"] = 0
    remove_outliers(df, "Duration of vigorous activity-2.0", 1000)
    _num(df, "Usual walking pace-2.0")
    _na(df, "Usual walking pace-2.0", -7, -3)
    # cell 275: strenuous sports (NA->0 BEFORE the negative codes)
    _num(df, "Duration of strenuous sports-2.0")
    _fill_na(df, "Duration of strenuous sports-2.0", 0)
    _na(df, "Duration of strenuous sports-2.0", -1, -3)
    remove_outliers(df, "Duration of strenuous sports-2.0", 1000)
    # cells 284-290: activity types (items 0..3 cleaned, scan width 5)
    for i in range(4):
        fid = f"{ACTIVITY_FIELD}-2.{i}"
        _num(df, fid)
        _na(df, fid, -1, -3)
    for answer, name in ((1, "Walking for pleasure-2.0"),
                         (2, "Other exercises-2.0"),
                         (3, "Strenuous sports-2.0"),
                         (4, "Light DIY-2.0"),
                         (5, "Heavy DIY-2.0"),
                         (-7, "No physical activity-2.0")):
        df[name] = check_answer_single_visit(df, answer, 2,
                                             ACTIVITY_FIELD, 5)
    # cell 292: outlier removal precedes to_numeric (faithful order)
    remove_outliers(df, "Diastolic brachial blood pressure-2.0", 1,
                    greater=False)
    _num(df, "Diastolic brachial blood pressure-2.0")
    # cell 293: PWA fields
    for field in PWA_FIELDS:
        _num(df, f"{field}-2.0")
    # cells 294-316
    _num(df, "Sleep duration-2.0")
    _na(df, "Sleep duration-2.0", -1, -3)
    _num(df, "Sleeplessness / insomnia-2.0")
    _na(df, "Sleeplessness / insomnia-2.0", -1, -3)
    _num(df, "Current tobacco smoking-2.0")
    _na(df, "Current tobacco smoking-2.0", -1, -3)
    _num(df, "Past tobacco smoking-2.0")
    _fill_na(df, "Past tobacco smoking-2.0", 1)
    _na(df, "Past tobacco smoking-2.0", -1, -3)
    _num(df, "Exposure to tobacco smoke at home-2.0")
    _fill_na(df, "Exposure to tobacco smoke at home-2.0", 7)
    _na(df, "Exposure to tobacco smoke at home-2.0", -1, -3)
    remove_outliers(df, "Exposure to tobacco smoke at home-2.0", 50)
    _num(df, "Exposure to tobacco smoke outside home-2.0")
    _fill_na(df, "Exposure to tobacco smoke outside home-2.0", 7)
    _na(df, "Exposure to tobacco smoke outside home-2.0", -1, -3)
    remove_outliers(df, "Exposure to tobacco smoke outside home-2.0", 50)
    _num(df, "Smoking status-2.0")
    _na(df, "Smoking status-2.0", -1, -3)
    _num(df, "Ever smoked-2.0")
    _num(df, "Age when attended assessment centre-2.0")
    _num(df, "Alcohol drinker status-2.0")
    _fill_na(df, "Alcohol drinker status-2.0", 0)
    _na(df, "Alcohol drinker status-2.0", -1, -3)
    _num(df, "Falls in the last year-2.0")
    df.loc[df["Falls in the last year-2.0"] < 0,
           "Falls in the last year-2.0"] = pd.NA
    _num(df, "Long-standing illness, disability or infirmity-2.0")
    _na(df, "Long-standing illness, disability or infirmity-2.0", -1, -3)


CLINICAL_COLUMNS = ("LVEDV (mL)", "LVESV (mL)", "LVSV (mL)", "LVEF (%)",
                    "LVCO (L/min)", "LVM (g)", "RVEDV (mL)",
                    "RVESV (mL)", "RVSV (mL)", "RVEF (%)")


def merge_clinical(df: pd.DataFrame,
                   clinical_df: pd.DataFrame) -> pd.DataFrame:
    """Left-merge the collated LV/RV clinical measures on eid
    (cell 319; an 'Unnamed: 0' id column is renamed to eid first)."""
    import pandas as pd
    clinical_df = clinical_df.rename(columns={"Unnamed: 0": "eid"})
    return pd.merge(df, clinical_df[["eid", *CLINICAL_COLUMNS]],
                    on="eid", how="left")


def filter_ethnicity(df: pd.DataFrame, keep: int = 1001) -> pd.DataFrame:
    """Drop subjects whose 'Ethnic background-0.0' != keep (cell 324)."""
    return df.drop(df[df["Ethnic background-0.0"] != keep].index)


# --------------------------------------------------------------------
# Vectorisation (cells 326/339: the kept feature set, in order)
# --------------------------------------------------------------------

# 49 continuous columns (cell 326 order)
CONTINUOUS_COLUMNS: Tuple[str, ...] = (
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
    *(f"{f}-2.0" for f in PWA_FIELDS),
    "Sleep duration-2.0",
    "Exposure to tobacco smoke at home-2.0",
    "Exposure to tobacco smoke outside home-2.0",
    *CLINICAL_COLUMNS,
)

# binary categoricals passed through clean_categorical (cell 326 order)
BINARY_COLUMNS: Tuple[str, ...] = (
    "Shortness of breath walking on level ground-2.0",
    "Sex-0.0",
    "Diabetes diagnosis",
    "Heart attack diagnosed by doctor",
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
)

# multi-class categoricals: (column, num_classes, one_based)
MULTICLASS_COLUMNS: Tuple[Tuple[str, int, bool], ...] = (
    ("Sleeplessness / insomnia-2.0", 3, True),
    ("Alcohol intake frequency.-2.0", 6, True),
    ("Overall health rating-2.0", 4, True),
    ("Alcohol drinker status-2.0", 3, False),
    ("Falls in the last year-2.0", 3, True),
    ("Number of days/week walked 10+ minutes-2.0", 8, False),
    ("Number of days/week of moderate physical activity"
     " 10+ minutes-2.0", 8, False),
    ("Number of days/week of vigorous physical activity"
     " 10+ minutes-2.0", 8, False),
    ("Usual walking pace-2.0", 3, True),
    ("Duration of strenuous sports-2.0", 8, False),
    ("Current tobacco smoking-2.0", 3, False),
    ("Past tobacco smoking-2.0", 4, True),
    ("Smoking status-2.0", 3, False),
)


def cardiac_features_to_vector(df: pd.DataFrame,
                               one_hot: bool = True) -> pd.DataFrame:
    """The kept feature set as a flat vector table (cells 326/339).

    With ``one_hot`` the multi-class columns expand to
    ``{name}-{i}`` scalar indicators (the reference stores list cells
    then ``expand_list``s downstream; we expand directly — same columns,
    same order). Without, they stay ordinal and the one-based ones are
    shifted to 0-based (cell 342)."""
    import pandas as pd
    parts: List[pd.DataFrame] = [df[["eid"]].reset_index(drop=True)]
    cont = df[list(CONTINUOUS_COLUMNS)].apply(
        pd.to_numeric, errors="coerce").reset_index(drop=True)
    parts.append(cont)
    cat = pd.DataFrame(index=cont.index)
    for c in BINARY_COLUMNS:
        cat[c] = clean_categorical_column(df[c]).reset_index(drop=True)
    parts.append(cat)
    if one_hot:
        for name, num_classes, one_based in MULTICLASS_COLUMNS:
            arr = one_hot_encode_column(df[name], num_classes, one_based)
            oh = pd.DataFrame(
                arr, columns=[f"{name}-{i}" for i in range(num_classes)],
                index=cont.index)
            parts.append(oh)
    else:
        mc = pd.DataFrame(index=cont.index)
        for name, num_classes, one_based in MULTICLASS_COLUMNS:
            col = clean_categorical_column(df[name]).reset_index(drop=True)
            if one_based:  # cell 342
                col = col - 1
            mc[name] = col
        parts.append(mc)
    return pd.concat(parts, axis=1)


def attach_labels(vector_df: pd.DataFrame, df: pd.DataFrame,
                  faithful: bool = True) -> pd.DataFrame:
    """ICD-derived Infarction/CAD/CAD_broad + Hypertension (cells
    334-336) via :func:`ukbb_split.derive_labels` (shares the
    missing-comma quirk handling)."""
    from stil_tta_torch.dataprep import ukbb_split

    icd_cols = [c for c in (f"Diagnoses - ICD10-0.{i}"
                            for i in range(ukbb_split.N_ICD_COLUMNS))
                if c in df.columns]
    icd_df = df[icd_cols].reset_index(drop=True)
    return ukbb_split.derive_labels(icd_df,
                                    vector_df.reset_index(drop=True),
                                    faithful=faithful)


def build_vector_tables(df: pd.DataFrame,
                        clinical_df: Optional[pd.DataFrame] = None,
                        out_dir: Optional[Path] = None,
                        faithful: bool = True) -> Dict[str, pd.DataFrame]:
    """Full chain from the renamed raw table to the four vector CSVs
    (cells 23-345). Returns the tables keyed by reference file stem;
    writes them under ``out_dir`` when given."""
    df = df.copy()
    clean_cardiac_table(df)
    if clinical_df is not None:
        df = merge_clinical(df, clinical_df)
    else:
        for c in CLINICAL_COLUMNS:
            if c not in df.columns:
                df[c] = np.nan
    df = filter_ethnicity(df)
    out: Dict[str, pd.DataFrame] = {}
    vec = cardiac_features_to_vector(df, one_hot=True)
    out["cardiac_feature_18545_vector"] = vec
    out["cardiac_feature_18545_vector_labeled"] = attach_labels(
        vec, df, faithful=faithful)
    noh = cardiac_features_to_vector(df, one_hot=False)
    out["cardiac_feature_18545_vector_noOH"] = noh
    out["cardiac_feature_18545_vector_labeled_noOH"] = attach_labels(
        noh, df, faithful=faithful)
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for stem, table in out.items():
            table.to_csv(out_dir / f"{stem}.csv", index=False)
    return out


def main(argv=None) -> int:  # pragma: no cover - needs the UKBB table
    import argparse

    import pandas as pd

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("features_csv", help="renamed cardiac feature table")
    p.add_argument("out_dir")
    p.add_argument("--clinical-csv", default=None,
                   help="collated LV/RV clinical measures (cell 319)")
    p.add_argument("--datadict-csv", default=None,
                   help="UKBB data dictionary; when given, the feature "
                        "table is first renamed from integer field ids")
    p.add_argument("--fixed-cad-codes", action="store_true",
                   help="repair the reference's CAD_codes missing comma")
    args = p.parse_args(argv)

    df = pd.read_csv(args.features_csv)
    if args.datadict_csv:
        datadict = pd.read_csv(args.datadict_csv, quotechar='"',
                               escapechar="\\")
        datadict.loc[datadict["FieldID"] == 23104,
                     "Field"] = "Body mass index (BMI) Impedance"
        rename_to_field_names(df, datadict)
    clinical = (pd.read_csv(args.clinical_csv)
                if args.clinical_csv else None)
    tables = build_vector_tables(df, clinical, Path(args.out_dir),
                                 faithful=not args.fixed_cad_codes)
    for stem, table in tables.items():
        print(f"{stem}: {table.shape[0]} rows x {table.shape[1]} cols")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

