"""UK Biobank cardiac preprocessing, the port's copy of
``stil_tta_tpu/dataprep/ukbb.py``.

The reference's ``data/preprocess_ukbb`` scripts: short-axis cardiac MR
NIfTI volumes -> fixed-size 2D arrays, and the UKBB phenotype table
filtered down to the cardiac feature set. Covered here:

- the reference's per-subject image packing (`pack_sa_es_ed`):
  ES / mid-beat / ED mid-ventricular slices, square padding, 210x210,
  per-channel max normalisation (``preprocess_cardiac_image.py:90-185``),
  including the overlap-argmax ES-frame search (`mid_beat_index`);
- the 156-entry cardiac FieldID table and ``{id}-{instance}.{array}``
  column selection (`CARDIAC_FIELD_IDS`, `select_cardiac_columns`) and
  the showcase ValueType -> dtype expansion (`ukbb_dtype_map`), as in
  ``filter_cardiac_tabular_feature.py:50-137``;
- generic packing/normalisation and tabular encode/impute for converted
  tables (the 26 categorical and 49 continuous features the cardiac
  YAMLs use).

nibabel (NIfTI reading, `load_nifti`) and pandas (`filter_tabular`, the
CLI) are imported inside the functions that read raw files, so the
numeric pipeline (crop, normalise, pack) imports and runs without them.

    python -m stil_tta_torch.dataprep.ukbb --nifti-list volumes.txt \
        --mode sa_es_ed --table cardiac.csv --cat-cols ... --con-cols ... \
        --label-col CAD --out data/cardiac/all
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


def center_crop(volume: np.ndarray, size: int) -> np.ndarray:
    """Crop (H, W, ...) to (size, size, ...) about the centre, padding
    with zeros if needed."""
    h, w = volume.shape[:2]
    out_shape = (size, size) + volume.shape[2:]
    out = np.zeros(out_shape, volume.dtype)
    ys = max((h - size) // 2, 0)
    xs = max((w - size) // 2, 0)
    yo = max((size - h) // 2, 0)
    xo = max((size - w) // 2, 0)
    ch = min(h, size)
    cw = min(w, size)
    out[yo:yo + ch, xo:xo + cw] = volume[ys:ys + ch, xs:xs + cw]
    return out


def normalise_intensity(img: np.ndarray, lo_pct: float = 1.0,
                        hi_pct: float = 99.0) -> np.ndarray:
    """Percentile-clip + [0, 1] scale (standard cardiac MR recipe)."""
    lo, hi = np.percentile(img, [lo_pct, hi_pct])
    img = np.clip(img, lo, hi)
    return ((img - lo) / max(hi - lo, 1e-6)).astype(np.float32)


def pack_cardiac_image(volume_t: np.ndarray, size: int = 128,
                       timepoints: Sequence[int] = (0,),
                       mid_slice: Optional[int] = None) -> np.ndarray:
    """(H, W, Z, T) cine volume -> (size, size, len(timepoints)) float32:
    mid-ventricular slice at the chosen cardiac phases, normalised and
    centre-cropped (the reference stacks ED/ES/mid phases as channels)."""
    h, w, z, t = volume_t.shape
    zmid = z // 2 if mid_slice is None else mid_slice
    chans = []
    for tp in timepoints:
        sl = normalise_intensity(volume_t[:, :, zmid, tp % t])
        chans.append(center_crop(sl, size))
    return np.stack(chans, axis=-1)


# ---------------------------------------------------------------------------
# reference-exact ES / mid-beat / ED packing
# (``preprocess_cardiac_image.py:90-185``)
# ---------------------------------------------------------------------------

def mid_beat_index(sa_4d: np.ndarray, es_slice: np.ndarray,
                   max_t: int = 50):
    """Locate the ES frame in the full-cycle cine by pixel-overlap argmax
    over timepoints at the mid-ventricular z slice, and return half that
    index as the "middle of heart beat" frame
    (``preprocess_cardiac_image.py:90-111`` get_mid_beat_slice).

    Returns (mid_beat_i, es_i, match) where ``match`` is whether the
    located frame equals the ES slice exactly (the reference logs
    non-matching subjects).
    """
    zmid = sa_4d.shape[2] // 2
    best_overlap, best_i = -1, 0
    for i in range(min(max_t, sa_4d.shape[3])):
        overlap = int((sa_4d[:, :, zmid, i] == es_slice).sum())
        if overlap > best_overlap:
            best_overlap, best_i = overlap, i
    match = bool(np.allclose(sa_4d[:, :, zmid, best_i], es_slice))
    return best_i // 2, best_i, match


def pad_square(sl: np.ndarray) -> np.ndarray:
    """Zero-pad a 2-D slice to square about the centre
    (``preprocess_cardiac_image.py:151-155``). The reference pads
    ``(w-h)//2`` on both sides and asserts squareness, so subjects with
    an odd height-width difference are rejected rather than silently
    emitting a non-square (and later non-210) array; callers skip them
    (the ``main`` CLI below)."""
    h, w = sl.shape
    if abs(h - w) % 2:
        raise ValueError(
            f"odd height-width difference ({h}x{w}): the reference "
            "skips such subjects (preprocess_cardiac_image.py assert)")
    if w > h:
        p = (w - h) // 2
        return np.pad(sl, ((p, p), (0, 0)))
    p = (h - w) // 2
    return np.pad(sl, ((0, 0), (p, p)))


def pack_sa_es_ed(es_vol: np.ndarray, sa_4d: np.ndarray,
                  ed_vol: np.ndarray, out_size: int = 210) -> np.ndarray:
    """The reference's per-subject cardiac image
    (``preprocess_cardiac_image.py:113-180`` create_sa_es_ed_mm):
    channels = [ES mid-slice, mid-beat frame from the full cycle,
    ED mid-slice], each padded square, stacked, padded to
    (out_size, out_size), per-channel max-normalised, returned HWC
    float32 — the (210, 210, 3) array the cardiac datasets read.
    """
    es_slice = es_vol[:, :, es_vol.shape[2] // 2]
    mb_i, _, _ = mid_beat_index(sa_4d, es_slice)
    mid_slice = sa_4d[:, :, sa_4d.shape[2] // 2, mb_i]
    ed_slice = ed_vol[:, :, ed_vol.shape[2] // 2]
    stack = [pad_square(s) for s in (es_slice, mid_slice, ed_slice)]
    stacked = np.stack(stack, axis=0)
    w = stacked.shape[1]
    pad = (((out_size - w) // 2, (out_size - w) // 2 + 1) if w % 2
           else ((out_size - w) // 2, (out_size - w) // 2))
    stacked = np.pad(stacked, ((0, 0), pad, pad)).astype(np.float32)
    hwc = stacked.transpose(1, 2, 0)
    return hwc / np.maximum(hwc.max(axis=(0, 1), keepdims=True), 1e-6)


# ---------------------------------------------------------------------------
# UKBB field-ID mapping (``filter_cardiac_tabular_feature.py:50-137``)
# ---------------------------------------------------------------------------

# the 156 cardiac-relevant UKBB showcase FieldIDs the reference filters
# the phenotype table down to (``filter_cardiac_tabular_feature.py:113``)
CARDIAC_FIELD_IDS = sorted([
    49, 21001, 12675, 12144, 874, 12338, 904, 20116, 1001, 20406, 50,
    12697, 20415, 22425, 20421, 2634, 42008, 1349, 3894, 22334, 3627,
    2188, 22508, 1279, 22330, 2966, 22432, 120007, 1379, 1299, 22426,
    4079, 6164, 22506, 22507, 23283, 20162, 22410, 981, 23100, 22409,
    22434, 12671, 1239, 93, 20428, 12674, 924, 2296, 12684, 22331,
    20549, 1021, 22424, 22332, 4717, 12687, 2306, 1160, 12336, 12688,
    20403, 1249, 1389, 1980, 1080, 12678, 22415, 12681, 3637, 12683,
    12702, 12686, 41280, 991, 12685, 20004, 943, 1369, 20401, 22333,
    3647, 21021, 12698, 23105, 12673, 23281, 42002, 20160, 20420,
    22427, 12676, 971, 2443, 20432, 1289, 6177, 20161, 1070, 20404,
    21003, 42012, 21000, 48, 20414, 12677, 20015, 23099, 22433, 42000,
    6150, 42006, 864, 1269, 23101, 6153, 6162, 23102, 102, 1200, 94,
    95, 23106, 1090, 20457, 2976, 12143, 31, 12680, 12682, 1259, 4056,
    2624, 42004, 884, 20551, 20550, 12695, 20431, 20117, 894, 20416,
    1558, 1618, 20456, 4080, 12340, 21002, 914, 23104, 3079, 1990,
    41270, 12679, 42010, 2178])

# UKBB showcase ValueType -> storage dtype
# (``filter_cardiac_tabular_feature.py:55-57``; Int64 keeps NaN-able
# integers, field 46 forced float there)
UKBB_VALUE_TYPES = {
    "Integer": "Int64", "Categorical single": object, "Date": str,
    "Text": str, "Continuous": float, "Time": str, "Compound": object,
    "Categorical multiple": object,
}


def select_cardiac_columns(columns, field_ids=None):
    """Phenotype columns are named ``{FieldID}-{instance}.{array}``;
    keep every column whose FieldID is in the cardiac set, plus ``eid``
    (``filter_cardiac_tabular_feature.py:116-131``). Returns
    (kept_columns, have_ids, lack_ids)."""
    ids = [str(i) for i in (field_ids or CARDIAC_FIELD_IDS)]
    kept, have = [], set()
    for c in columns:
        if c == "eid":
            kept.append(c)
            continue
        fid = str(c).split("-")[0]
        if fid in ids:
            kept.append(c)
            have.add(fid)
    lack = [i for i in ids if i not in have]
    return kept, sorted(have, key=int), lack


def ukbb_dtype_map(datadict_rows):
    """Expand Data_Dictionary_Showcase rows into the per-column dtype /
    date-column maps the reference builds
    (``filter_cardiac_tabular_feature.py:59-77``). ``datadict_rows``:
    iterable of dicts with FieldID, Instances, Array, ValueType, Field.
    Returns (dtype_by_column, date_columns, field_id_to_name)."""
    dtype, dates, id2name = {}, [], {}
    for row in datadict_rows:
        base = int(row["FieldID"])
        name = row["Field"]
        if base == 23104:
            # two BMI fields share a name; the impedance one is renamed
            name = "Body mass index (BMI) Impedance"
        id2name[base] = name
        vt = row["ValueType"]
        for instance in range(int(row["Instances"])):
            for arr in range(int(row["Array"])):
                col = f"{base}-{instance}.{arr}"
                if vt in ("Time", "Date"):
                    dates.append(col)
                dt = UKBB_VALUE_TYPES.get(vt, object)
                if base == 46:
                    dt = float
                dtype[col] = dt
    return dtype, dates, id2name


def load_nifti(path) -> np.ndarray:
    try:
        import nibabel as nib
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "nibabel is required for NIfTI reading; install it or "
            "convert volumes to .npy upstream") from e
    return np.asarray(nib.load(str(path)).get_fdata())


def filter_tabular(df, cat_cols: List[str], con_cols: List[str],
                   max_missing_frac: float = 0.5):
    """Drop rows with too many missing fields, median/mode-impute the
    rest, label-encode categoricals, z-score continuous — the
    preprocess_ukbb tabular recipe. Returns (table, field_lengths)."""
    import pandas as pd
    cols = cat_cols + con_cols
    sub = df[cols].copy()
    keep = sub.isna().mean(axis=1) <= max_missing_frac
    sub = sub[keep]
    field_lengths = []
    arrays = []
    for c in cat_cols:
        col = sub[c].fillna(sub[c].mode().iloc[0])
        codes, uniq = pd.factorize(col, sort=True)
        field_lengths.append(len(uniq))
        arrays.append(codes.astype(np.float32))
    for c in con_cols:
        col = sub[c].fillna(sub[c].median()).astype(np.float32)
        std = col.std() or 1.0
        arrays.append(((col - col.mean()) / std).to_numpy())
        field_lengths.append(1)
    return np.stack(arrays, axis=1), field_lengths, keep.to_numpy()


def main(argv=None) -> int:  # pragma: no cover - needs raw UKBB data
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nifti-list", required=True,
                    help="file with one NIfTI path per line (mode="
                         "timepoints), or three comma-separated paths "
                         "per line: sa_ES.nii.gz,sa.nii.gz,sa_ED.nii.gz "
                         "(mode=sa_es_ed)")
    ap.add_argument("--mode", choices=["timepoints", "sa_es_ed"],
                    default="timepoints",
                    help="sa_es_ed = the reference's ES/mid-beat/ED "
                         "packing (preprocess_cardiac_image.py)")
    ap.add_argument("--table", required=True)
    ap.add_argument("--cat-cols", nargs="+", required=True)
    ap.add_argument("--con-cols", nargs="+", required=True)
    ap.add_argument("--label-col", required=True)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--timepoints", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import pandas as pd
    from stil_tta_torch.data.source import ArraySource

    df = pd.read_csv(args.table)
    tab, field_lengths, keep = filter_tabular(df, args.cat_cols,
                                              args.con_cols)
    labels = df.loc[keep, args.label_col].astype(int).to_numpy()
    paths = [p.strip() for p in open(args.nifti_list)]
    paths = [p for p, k in zip(paths, keep) if k]
    if args.mode == "sa_es_ed":
        imgs, ok = [], []
        for i, line in enumerate(paths):
            es_p, sa_p, ed_p = [s.strip() for s in line.split(",")]
            try:
                hwc = pack_sa_es_ed(load_nifti(es_p), load_nifti(sa_p),
                                    load_nifti(ed_p))
            except ValueError as e:  # odd-difference slice — skip subject
                print(f"skip subject {i} ({es_p}): {e}")
                continue
            ok.append(i)
            imgs.append(center_crop(hwc, args.size) if args.size != 210
                        else hwc)
        imgs = np.stack(imgs)
        tab, labels = tab[ok], labels[ok]
    else:
        imgs = np.stack([
            pack_cardiac_image(load_nifti(p), args.size, args.timepoints)
            for p in paths])
    src = ArraySource(images=imgs, tabular=tab, labels=labels,
                      labelled=np.ones(len(labels), bool),
                      field_lengths=field_lengths, num_classes=2,
                      target="CAD")
    src.save(args.out)
    print(f"wrote {len(src)} subjects -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
