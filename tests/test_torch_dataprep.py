"""The port's offline data prep (``stil_tta_torch/dataprep``) against the
JAX package's (``stil_tta_tpu/dataprep``) on the same synthetic tables.

The tables come from the JAX package's own dataprep tests
(``tests/test_dvm_raw.py``, ``tests/test_ukbb_split.py``,
``tests/test_ukbb_table.py``) and from the synthetic source. Split ids,
masks, label maps, encoded tables, packed images and imputed frames must
be exactly equal (pandas frames with ``check_exact``), the JS divergences
within 1e-12, and the directories the split functions and CLIs write
byte-equal (``.pt`` files, whose bytes carry a fresh serialization id on
each save, are compared by their loaded contents)."""

import copy
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from stil_tta_torch.data import source as psource
from stil_tta_torch.dataprep import dvm as pdvm
from stil_tta_torch.dataprep import dvm_raw as pdvm_raw
from stil_tta_torch.dataprep import shifted as pshifted
from stil_tta_torch.dataprep import ukbb as pukbb
from stil_tta_torch.dataprep import ukbb_split as psplit
from stil_tta_torch.dataprep import ukbb_table as ptable
from stil_tta_torch.dataprep import visualize as pvis
from stil_tta_tpu.data import source as jsource
from stil_tta_tpu.dataprep import dvm as jdvm
from stil_tta_tpu.dataprep import dvm_raw as jdvm_raw
from stil_tta_tpu.dataprep import shifted as jshifted
from stil_tta_tpu.dataprep import ukbb as jukbb
from stil_tta_tpu.dataprep import ukbb_split as jsplit
from stil_tta_tpu.dataprep import ukbb_table as jtable
from stil_tta_tpu.dataprep import visualize as jvis
from tests.test_dvm_raw import _fake_tables
from tests.test_ukbb_split import _icd_frame, _labeled_frame
from tests.test_ukbb_table import _base_df
from tests.torch_parity import one_torch_thread  # noqa: F401

JS_TOL = 1e-12
FIELDS = [5, 4, 2, 1, 1, 1]


def same(a, b, path="out"):
    """Exact equality of two outputs: frames, series, arrays (NaN equal
    to NaN, dtypes equal), ArraySources field by field, containers
    recursively."""
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_exact=True, obj=path)
    elif isinstance(a, pd.Series):
        pd.testing.assert_series_equal(a, b, check_exact=True, obj=path)
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (psource.ArraySource, jsource.ArraySource)):
        for k in ("images", "tabular", "labels", "labelled", "missing",
                  "field_lengths", "num_classes", "target"):
            x, y = getattr(a, k), getattr(b, k)
            same(np.asarray(x) if isinstance(x, np.ndarray) else x,
                 np.asarray(y) if isinstance(y, np.ndarray) else y,
                 f"{path}.{k}")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, (float, np.floating)) and np.isnan(a):
        assert np.isnan(b) and type(a) is type(b), path
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def both(port_fn, jax_fn, *args, **kw):
    """``(port_fn(...), jax_fn(...))`` on deep copies of the same inputs
    (some functions change their frame in place)."""
    return (port_fn(*copy.deepcopy(args), **copy.deepcopy(kw)),
            jax_fn(*copy.deepcopy(args), **copy.deepcopy(kw)))


def same_tree(a: Path, b: Path) -> None:
    """Two directories hold the same files with the same bytes; ``.pt``
    files hold the same objects."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb and fa, (fa, fb)
    for rel in fa:
        if rel.suffix == ".pt":
            same(torch.load(a / rel, weights_only=False),
                 torch.load(b / rel, weights_only=False), str(rel))
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def run_cli(monkeypatch, main, argv, port: bool):
    """A module's CLI: the port's ``main(argv)``, the JAX one through
    ``sys.argv``."""
    if port:
        assert main(argv) == 0
    else:
        monkeypatch.setattr(sys, "argv", ["prog"] + argv)
        main()


def dvm_source(n=240, classes=6, seed=0):
    """The synthetic source as both packages make it (bit-identical,
    ``test_torch_data_config``), with column 0 a 5-value colour and
    column 3 a mileage."""
    src = jsource.synthetic_source(n, num_classes=classes,
                                   field_lengths=FIELDS, image_size=8,
                                   seed=seed)
    src.tabular[:, 0] = np.random.RandomState(seed).randint(
        0, 5, n).astype(np.float32)
    return src


# ---------------------------------------------------------------- shifted

@pytest.mark.parametrize("pair", ["same", "apart", "overlap", "constant",
                                  "ints"])
def test_js_divergence_matches_jax(pair):
    rng = np.random.RandomState(1)
    a = rng.randn(500)
    b = {"same": a, "apart": rng.randn(300) + 5,
         "overlap": rng.randn(400) * 2 + 0.5,
         "constant": np.zeros(500), "ints": rng.randint(0, 4, 50)}[pair]
    if pair == "constant":
        a = np.zeros(7)
    for bins in (30, 7):
        got = pshifted.js_divergence(a, b, bins)
        want = jshifted.js_divergence(a, b, bins)
        assert abs(got - want) <= JS_TOL and type(got) is type(want)


def test_shift_report_and_common_label_space_match_jax():
    src = dvm_source(300)
    splits = {"a": src, "b": jsource.ArraySource(
        images=src.images[::2], tabular=src.tabular[::2] + 0.5,
        labels=src.labels[::2] % 4, labelled=src.labelled[::2],
        field_lengths=src.field_lengths, num_classes=6)}
    rep = both(pshifted.shift_report, jshifted.shift_report,
               splits["a"], splits["b"])
    assert list(rep[0]) == list(rep[1])
    for k in rep[0]:
        assert abs(rep[0][k] - rep[1][k]) <= JS_TOL, k
    got, want = both(pshifted.ensure_common_label_space,
                     jshifted.ensure_common_label_space, splits)
    same(got, want)


SPECS = {
    "black": ("make_column_value_shift", ("black", 0, [3.0])),
    "b-s-g": ("make_column_value_shift", ("b-s-g", 0, [0.0, 1.0, 3.0])),
    "miles": ("make_quantile_shift", ("miles", 3, 0.8)),
    "year_low": ("make_quantile_shift", ("adv_year", 4, 0.3, False)),
    "label_subset": ("make_label_subset_shift", ("l45", [4, 5])),
    "normal": ("make_normal_shift", ("normal", 0.2, 3)),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_build_shifted_splits_writes_the_same_files(name, tmp_path):
    maker, args = SPECS[name]
    src = dvm_source()
    out = {}
    for tag, mod in (("port", pshifted), ("jax", jshifted)):
        spec = getattr(mod, maker)(*args)
        assert spec.description == getattr(jshifted, maker)(*args).description
        out[tag] = mod.build_shifted_splits(src, spec, label_fraction=0.1,
                                            seed=2,
                                            out_dir=tmp_path / tag)
    same(out["port"], out["jax"])
    same_tree(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("fraction", [0.1, 0.01])
def test_build_label_dist_shifted_splits_writes_the_same_files(fraction,
                                                              tmp_path):
    src = dvm_source(400)
    out = {tag: mod.build_label_dist_shifted_splits(
               src, 0, [0.0], [1.0, 2.0], label_fraction=fraction,
               seed=1, out_dir=tmp_path / tag)
           for tag, mod in (("port", pshifted), ("jax", jshifted))}
    same(out["port"], out["jax"])
    same_tree(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("argv", [
    ["--shift", "column", "--name", "black", "--column", "0",
     "--values", "3", "--label-fraction", "0.1"],
    ["--shift", "quantile", "--name", "miles", "--column", "3",
     "--quantile", "0.8"],
    ["--shift", "labels", "--name", "labels", "--column", "0",
     "--labeled-values", "0", "--unlabeled-values", "1", "2",
     "--label-fraction", "0.1"],
    ["--shift", "normal", "--name", "normal", "--seed", "4"],
])
def test_shifted_cli_writes_the_same_files(argv, tmp_path, monkeypatch,
                                           capsys):
    dvm_source().save(tmp_path / "all")
    for tag, main in (("port", pshifted.main), ("jax", jshifted.main)):
        run_cli(monkeypatch, main, argv + ["--source", str(tmp_path / "all"),
                                           "--out", str(tmp_path / tag)],
                tag == "port")
    printed = capsys.readouterr().out
    same_tree(tmp_path / "port", tmp_path / "jax")
    half = len(printed) // 2
    assert printed[:half] == printed[half:]


# -------------------------------------------------------------------- dvm

def test_dvm_tables_and_semi_splits_match_jax():
    df = pd.DataFrame({
        "color": ["red", "blue", "red", "green"] * 5,
        "body": ["suv", "hatch"] * 10,
        "price": np.arange(20.0),
        "miles": np.linspace(0, 1e5, 20),
    })
    same(*both(pdvm.label_encode, jdvm.label_encode, list(df["color"])))
    for jitter in (0.0, 0.5):
        same(*both(pdvm.build_tabular, jdvm.build_tabular, df,
                   ["color", "body"], ["price", "miles"], jitter, 3))
    src = dvm_source(60)
    for frac, val, test in ((0.1, 0.2, 0.2), (0.5, 0.1, 0.1)):
        same(*both(pdvm.build_semi_splits, jdvm.build_semi_splits, src,
                   frac, val, test, 5))


def _image_files(root: Path, n: int = 6) -> list:
    from PIL import Image
    rng = np.random.RandomState(0)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        arr = rng.randint(0, 255, (12 + i, 10, 3), np.uint8)
        if i % 3 == 2:
            p = root / f"im{i}.npy"
            np.save(p, arr)
        else:
            p = root / f"im{i}.{'png' if i % 3 else 'jpg'}"
            Image.fromarray(arr).save(p)
        paths.append(p.name)
    return paths


def test_dvm_images_and_cli_match_jax(tmp_path, monkeypatch, capsys):
    names = _image_files(tmp_path / "img", 10)
    paths = [str(tmp_path / "img" / n) for n in names]
    same(*both(pdvm.load_images, jdvm.load_images, paths, 8))
    pd.DataFrame({
        "Image_path": names, "Genmodel_ID": [f"m{i % 3}" for i in range(10)],
        "Color": ["a", "b"] * 5, "Price": np.arange(10.0) ** 2,
    }).to_csv(tmp_path / "ads.csv", index=False)
    argv = ["--table", str(tmp_path / "ads.csv"), "--image-root",
            str(tmp_path / "img"), "--cat-cols", "Color", "--con-cols",
            "Price", "--size", "8", "--label-fraction", "0.3"]
    for tag, main in (("port", pdvm.main), ("jax", jdvm.main)):
        run_cli(monkeypatch, main, argv + ["--out", str(tmp_path / tag)],
                tag == "port")
    same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(set(capsys.readouterr().out.splitlines())) == 1


# ---------------------------------------------------------------- dvm_raw

def test_dvm_raw_steps_match_jax():
    ad, img, phys = _fake_tables()
    same(*both(pdvm_raw.parse_adv_id, jdvm_raw.parse_adv_id,
               list(img[" Image_ID"])))
    for front in (False, True):
        same(*both(pdvm_raw.prepare_image_table,
                   jdvm_raw.prepare_image_table, img, front))
        same(*both(pdvm_raw.join_ad_and_images, jdvm_raw.join_ad_and_images,
                   ad, img, front))
    same(*both(pdvm_raw.extract_engine_size, jdvm_raw.extract_engine_size,
               ad["Engin_size"]))
    df = jdvm_raw.join_ad_and_images(ad, img)
    small = df["Genmodel_ID"] == "10_0"
    df = pd.concat([df[~small], df[small].head(3)])
    same(*both(pdvm_raw.filter_populated_classes,
               jdvm_raw.filter_populated_classes, df, 10))
    phys2 = phys.copy()
    phys2.loc[0, "Adv_ID"] = "69_36$$0"
    phys2.loc[0, " Genmodel_ID"] = "69_36"
    same(*both(pdvm_raw.fill_physical_attributes,
               jdvm_raw.fill_physical_attributes, phys2))
    filled = jdvm_raw.fill_physical_attributes(phys)
    same(*both(pdvm_raw.jitter_physical, jdvm_raw.jitter_physical, filled,
               30, 7))
    pop, _ = jdvm_raw.filter_populated_classes(
        jdvm_raw.join_ad_and_images(ad, img), 10)
    # the notebook's misaligned stratification quirk stays on both sides
    same(*both(pdvm_raw.reference_splits, jdvm_raw.reference_splits, pop))
    for frac in (0.1, 0.3, 0.01):
        same(*both(pdvm_raw.low_data_split, jdvm_raw.low_data_split, pop,
                   5, frac))
    jittered = jdvm_raw.jitter_physical(filled)
    for drop in (False, True):
        same(*both(pdvm_raw.build_feature_frame,
                   jdvm_raw.build_feature_frame, pop, jittered, drop))


def test_dvm_raw_assembly_and_sources_match_jax(tmp_path):
    from PIL import Image
    ad, img, phys = _fake_tables(n_models=3, ads_per_model=25)
    got, want = both(pdvm_raw.assemble_raw_dvm, jdvm_raw.assemble_raw_dvm,
                     ad, img, phys, label_fractions=(0.1, 0.2),
                     min_population=10)
    same(got, want)
    rng = np.random.RandomState(0)
    for split in want["splits"].values():
        for name in split[3]:
            parts = str(name).split("$$")
            p = tmp_path.joinpath(*parts[:4])
            p.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.randint(0, 255, (20, 20, 3), np.uint8)
                            ).save(p / name, format="JPEG")
    same(*both(pdvm_raw.splits_to_sources, jdvm_raw.splits_to_sources,
               want, tmp_path, size=16, label_fraction=0.2))


# ------------------------------------------------------------------- ukbb

def test_ukbb_image_packing_matches_jax():
    rng = np.random.RandomState(0)
    vol = rng.rand(50, 60, 8, 10) * 1000
    for size in (32, 70):
        same(*both(pukbb.center_crop, jukbb.center_crop, vol, size))
    same(*both(pukbb.normalise_intensity, jukbb.normalise_intensity,
               vol[..., 0, 0], 2.0, 97.0))
    same(*both(pukbb.pack_cardiac_image, jukbb.pack_cardiac_image, vol, 32,
               (0, 5, 13), 3))
    h, w, z, t = 40, 32, 5, 20
    sa = rng.rand(h, w, z, t) * 100
    es_vol = np.zeros((h, w, z))
    es_vol[:, :, z // 2] = sa[:, :, z // 2, 13]
    ed_vol = rng.rand(h, w, z) * 100
    same(*both(pukbb.mid_beat_index, jukbb.mid_beat_index, sa,
               es_vol[:, :, z // 2]))
    for sl in (np.ones((6, 10)), np.ones((10, 4))):
        same(*both(pukbb.pad_square, jukbb.pad_square, sl))
    for mod in (pukbb, jukbb):
        with pytest.raises(ValueError, match="odd height-width"):
            mod.pad_square(np.ones((5, 8)))
    same(*both(pukbb.pack_sa_es_ed, jukbb.pack_sa_es_ed, es_vol, sa, ed_vol))
    same(*both(pukbb.pack_sa_es_ed, jukbb.pack_sa_es_ed, es_vol[:38], sa[:38],
               ed_vol[:38], 101))


def test_ukbb_tables_match_jax():
    assert pukbb.CARDIAC_FIELD_IDS == jukbb.CARDIAC_FIELD_IDS
    assert pukbb.UKBB_VALUE_TYPES == jukbb.UKBB_VALUE_TYPES
    cols = ["eid", "31-0.0", "9999-0.0", "21001-0.0", "21001-1.0", "46-0.0"]
    same(*both(pukbb.select_cardiac_columns, jukbb.select_cardiac_columns,
               cols))
    same(*both(pukbb.select_cardiac_columns, jukbb.select_cardiac_columns,
               cols, [31, 46, 7]))
    rows = [
        {"FieldID": 21001, "Instances": 2, "Array": 1,
         "ValueType": "Continuous", "Field": "Body mass index (BMI)"},
        {"FieldID": 23104, "Instances": 1, "Array": 2,
         "ValueType": "Continuous", "Field": "Body mass index (BMI)"},
        {"FieldID": 53, "Instances": 1, "Array": 1,
         "ValueType": "Date", "Field": "Date of attending"},
        {"FieldID": 46, "Instances": 1, "Array": 1,
         "ValueType": "Integer", "Field": "Hand grip (left)"},
        {"FieldID": 7, "Instances": 1, "Array": 1,
         "ValueType": "Unknown", "Field": "x"},
    ]
    same(*both(pukbb.ukbb_dtype_map, jukbb.ukbb_dtype_map, rows))
    df = pd.DataFrame({
        "sex": ["m", "f", "m", None, "f", None],
        "age": [50.0, None, 60.0, 55.0, 65.0, None],
        "bmi": [22.0, 25.0, None, 28.0, 30.0, None],
    })
    for frac in (0.5, 0.2):
        same(*both(pukbb.filter_tabular, jukbb.filter_tabular, df, ["sex"],
                   ["age", "bmi"], frac))


def test_load_nifti_without_nibabel_names_the_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "nibabel", None)
    for mod in (pukbb, jukbb):
        with pytest.raises(ImportError, match="nibabel"):
            mod.load_nifti("x.nii.gz")


# ------------------------------------------------------------- ukbb_split

def test_ukbb_split_labels_and_imputation_match_jax():
    feat = _labeled_frame(n=12)
    icd = _icd_frame(12, codes_at={(0, 0): "I210", (1, 5): "I252",
                                   (2, 100): "I249", (3, 7): "I250",
                                   (4, 0): "I500", (5, 3): "I200",
                                   (6, 9): "I7091"})
    for faithful in (True, False):
        assert psplit.broad_cad_codes(faithful) == \
            jsplit.broad_cad_codes(faithful)
        same(*both(psplit.derive_labels, jsplit.derive_labels, icd, feat,
                   faithful))
    same(*both(psplit.drop_subjects, jsplit.drop_subjects, feat,
               [1000, 1003]))
    same(*both(psplit.split_subject_ids, jsplit.split_subject_ids,
               list(range(100, 180))))
    cont = feat.loc[:, jsplit.CONTINUOUS_COLUMNS]
    cat = feat.loc[:, jsplit.CATEGORICAL_COLUMNS].copy()
    cat.iloc[2, 3] = np.nan
    cat.iloc[5, 0] = np.nan
    same(*both(psplit.normalise_continuous, jsplit.normalise_continuous,
               cont))
    same(*both(psplit.impute_simple, jsplit.impute_simple,
               jsplit.normalise_continuous(cont), cat))
    # the iterative imputers on a narrow slice (their cost grows with the
    # columns; the column count proves nothing here)
    few = jsplit.normalise_continuous(cont.iloc[:, :4])
    same(*both(psplit.impute_iterative, jsplit.impute_iterative, few,
               cat.iloc[:, :3], 3, 4, 1))
    same(*both(psplit.assemble_feature_table, jsplit.assemble_feature_table,
               feat, "simple"))
    same(*both(psplit.assemble_feature_table, jsplit.assemble_feature_table,
               feat, "iterative",
               continuous_columns=list(jsplit.CONTINUOUS_COLUMNS[:3]),
               categorical_columns=list(jsplit.CATEGORICAL_COLUMNS[:2])))
    for mod in (psplit, jsplit):
        with pytest.raises(ValueError, match="unknown impute strategy"):
            mod.assemble_feature_table(feat, "mean")
    imputed = jsplit.assemble_feature_table(feat, "simple")
    lengths = jsplit.compute_field_lengths(imputed)
    same(*both(psplit.compute_field_lengths, jsplit.compute_field_lengths,
               imputed))
    same(*both(psplit.reorder_indices, jsplit.reorder_indices, lengths))


def test_ukbb_split_balancing_matches_jax():
    feat = jsplit.derive_labels(_icd_frame(40, {
        (i, i % 9): "I210" for i in range(0, 40, 3)}), _labeled_frame(40))
    ids = list(feat["eid"])[:30]
    same(*both(psplit.balance_split, jsplit.balance_split, feat, ids, "CAD"))
    for mod in (psplit, jsplit):
        with pytest.raises(ValueError, match="cannot balance"):
            mod.balance_split(feat.assign(CAD=1), ids, "CAD")
    labels = [int(i % 2) for i in range(40)]
    same(*both(psplit.low_data_indices, jsplit.low_data_indices, labels,
               0.25))


def test_ukbb_split_artifacts_match_jax(tmp_path):
    """The whole assembly (its chained 0.01 subset needs about 400
    subjects) writes the same artifacts on both sides."""
    n = 400
    feat = _labeled_frame(n=n)
    icd = _icd_frame(n, codes_at={(i, i % jsplit.N_ICD_COLUMNS): "I210"
                                  for i in range(0, n, 3)})
    labeled = jsplit.derive_labels(icd, feat)
    paths = {int(e): f"img/{int(e)}.npy" for e in labeled["eid"]}
    got, want = (mod.assemble_cardiac_splits(
        labeled, paths, tmp_path / tag, targets=("CAD",),
        invalid_ids=[1000, 1001], problem_ids=[1002])
        for tag, mod in (("port", psplit), ("jax", jsplit)))
    same(got, want)
    same_tree(tmp_path / "port", tmp_path / "jax")


# ------------------------------------------------------------- ukbb_table

def test_ukbb_table_utils_match_jax():
    df = pd.DataFrame({
        "eid": [1, 2, 3, 4],
        "f-2.0": [1.0, 2.0, np.nan, 9.0],
        "f-2.1": [3.0, np.nan, np.nan, 1.0],
        "g-0.0": [1, 5, 3, np.nan],
    })
    same(*both(ptable.get_all_features_same_id,
               jtable.get_all_features_same_id, df, "f"))
    same(*both(ptable.check_coverage, jtable.check_coverage, df,
               ["f-2.0", "g-0.0"]))
    for desc in (True, False):
        same(*both(ptable.grab_sorted_values, jtable.grab_sorted_values, df,
                   "f-2.0", desc))

    def mutated(fn_p, fn_j, *args):
        dp, dj = df.copy(), df.copy()
        fn_p(dp, *args)
        fn_j(dj, *args)
        same(dp, dj)

    mutated(ptable.remove_outliers, jtable.remove_outliers, "f-2.0", 1.5)
    mutated(ptable.remove_outliers, jtable.remove_outliers, "f-2.0", 1.5,
            False)
    mutated(ptable.calc_and_save_mean, jtable.calc_and_save_mean, "f-2.0")
    mutated(ptable.update_through_age, jtable.update_through_age, "g-0.0",
            "f-2.1")
    datadict = pd.DataFrame({"FieldID": [7, 9], "Field": ["Seven", "Nine"]})
    raw = pd.DataFrame({"eid": [1], "7-0.0": [1.0], "9-2.1": [2.0],
                        "age": [3]})
    same(*both(ptable.get_name, jtable.get_name, "9-2.1", datadict))
    rp, rj = raw.copy(), raw.copy()
    ptable.rename_to_field_names(rp, datadict)
    jtable.rename_to_field_names(rj, datadict)
    same(rp, rj)
    ans = pd.DataFrame({f"q-{i}.{j}": [i, j, 1, 0] for i in range(2)
                        for j in range(3)}).assign(flag=[True, False] * 2)
    same(*both(ptable.check_answer, jtable.check_answer, ans, 1, "q", 2, 3))
    same(*both(ptable.check_answer, jtable.check_answer, ans, 2, "q", 2, 3,
               "flag"))
    same(*both(ptable.check_answer_single_visit,
               jtable.check_answer_single_visit, ans, 1, 1, "q", 3, "flag"))
    ops = pd.DataFrame({f"Operation code-{i}.{j}": [np.nan, np.nan]
                        for i in range(3) for j in range(32)})
    ops["Operation code-0.0"] = ["1096", np.nan]
    ops["Operation code-2.31"] = ["1548", "9999"]
    same(*both(ptable.operations_performed, jtable.operations_performed, ops,
               "Operation code", ["1096", "1548"]))
    col = pd.Series([1.0, 3.0, np.nan, "2"])
    for one_based in (True, False):
        same(*both(ptable.one_hot_encode_column,
                   jtable.one_hot_encode_column, col, 4, one_based))
    same(*both(ptable.clean_categorical_column,
               jtable.clean_categorical_column, col))
    same(*both(ptable.expand_list, jtable.expand_list,
               pd.DataFrame({"x": [[1, 0], [0, 1]], "y": [5, 6]}), "x"))


def test_ukbb_table_cleaning_and_vectors_match_jax():
    df = _base_df()
    dp, dj = df.copy(), df.copy()
    ptable.clean_cardiac_table(dp)
    jtable.clean_cardiac_table(dj)
    same(dp, dj)
    for c in jtable.CLINICAL_COLUMNS:
        dj[c] = np.nan
    clinical = pd.DataFrame({"Unnamed: 0": dj["eid"],
                             **{c: np.linspace(1, 2, len(dj))
                                for c in jtable.CLINICAL_COLUMNS}})
    same(*both(ptable.merge_clinical, jtable.merge_clinical,
               dj.drop(columns=list(jtable.CLINICAL_COLUMNS)), clinical))
    kept = jtable.filter_ethnicity(dj)
    same(*both(ptable.filter_ethnicity, jtable.filter_ethnicity, dj))
    for one_hot in (True, False):
        same(*both(ptable.cardiac_features_to_vector,
                   jtable.cardiac_features_to_vector, kept, one_hot))
    vec = jtable.cardiac_features_to_vector(kept, False)
    for faithful in (True, False):
        same(*both(ptable.attach_labels, jtable.attach_labels, vec, kept,
                   faithful))


def test_ukbb_table_cli_writes_the_same_files(tmp_path, monkeypatch, capsys):
    df = _base_df()
    df.to_csv(tmp_path / "features.csv", index=False)
    pd.DataFrame({"Unnamed: 0": df["eid"],
                  **{c: np.linspace(1, 2, len(df))
                     for c in jtable.CLINICAL_COLUMNS}}
                 ).to_csv(tmp_path / "clinical.csv", index=False)
    for tag, main in (("port", ptable.main), ("jax", jtable.main)):
        run_cli(monkeypatch, main, [
            str(tmp_path / "features.csv"), str(tmp_path / tag),
            "--clinical-csv", str(tmp_path / "clinical.csv"),
            "--fixed-cad-codes"], tag == "port")
    same_tree(tmp_path / "port", tmp_path / "jax")
    lines = capsys.readouterr().out.splitlines()
    assert lines[:4] == lines[4:] and len(lines) == 8


# -------------------------------------------------------------- visualize

def test_visualize_matches_jax(tmp_path, monkeypatch, capsys):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 255, (11, 6, 5, 3), np.uint8)
    for rows, cols in ((4, 8), (2, 3)):
        same(*both(pvis.image_grid, jvis.image_grid, imgs, rows, cols))
    feats = rng.randn(24, 5)
    same(*both(pvis.tsne_embedding, jvis.tsne_embedding, feats, 5.0, 1))
    xy = rng.randn(30, 2)
    labels = rng.randint(0, 4, 30)
    gray = rng.rand(7, 9, 1)
    for tag, mod in (("port", pvis), ("jax", jvis)):
        (tmp_path / tag).mkdir()
        mod.save_png(tmp_path / tag / "float.png", gray)
        mod.save_png(tmp_path / tag / "grid.png", imgs[0])
        mod.scatter_png(tmp_path / tag / "scatter.png", xy, labels, 64)
    same_tree(tmp_path / "port", tmp_path / "jax")
    jsource.synthetic_source(20, 3, FIELDS, 8, seed=1).save(tmp_path / "src")
    for tag, main in (("port", pvis.main), ("jax", jvis.main)):
        run_cli(monkeypatch, main, ["--source", str(tmp_path / "src"),
                                    "--out", str(tmp_path / f"cli_{tag}"),
                                    "--n", "16"], tag == "port")
    same_tree(tmp_path / "cli_port", tmp_path / "cli_jax")
