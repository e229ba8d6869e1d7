"""The port's config loader, data path, metrics and losses against the
JAX package, and the port's import rule."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import roc_auc_score

import stil_tta_torch
from stil_tta_torch.config import load_config
from stil_tta_torch.data import augment, datasets, loader, source
from stil_tta_torch.losses.clip_loss import clip_loss
from stil_tta_torch.losses.club import club_losses
from stil_tta_torch.losses.common import cross_entropy
from stil_tta_torch.models.tabular_transformer import build_attention_mask
from stil_tta_torch.train import evaluate
from stil_tta_torch.tta.tent import tta_batches
from stil_tta_tpu.config import load_config as jax_load_config
from stil_tta_tpu.data import augment as jaug
from stil_tta_tpu.data import datasets as jdatasets
from stil_tta_tpu.data import loader as jloader
from stil_tta_tpu.data import source as jsource
from stil_tta_tpu.losses import clip_loss as jax_clip_loss
from stil_tta_tpu.losses import club_losses as jax_club_losses
from stil_tta_tpu.losses import cross_entropy as jax_cross_entropy
from stil_tta_tpu.models import tabular_transformer as jtt
from stil_tta_tpu.train import evaluate as jevaluate
from stil_tta_tpu.tta import tent as jtent
from tests.torch_parity import assert_close, x64
from tests.torch_parity import one_torch_thread  # noqa: F401

CONFIG_DIR = Path(stil_tta_torch.__file__).parent / "config" / "configs"
DATASETS = sorted(p.stem for p in (CONFIG_DIR / "dataset").rglob("*.yaml"))


@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("models", ["resnet18", "resnet50"])
def test_config_composition_matches_jax_loader(dataset, models):
    ov = [f"dataset={dataset}", f"models={models}", "batch_size=512",
          "test=True", "tta=True", "tta_strategy=bn_adapt",
          "field_lengths=[5,4,2,1]", "+extra.key=3.e-4", "logdir=null"]
    ours = load_config("config_dvm_STiL", ov)
    ref = jax_load_config("config_dvm_STiL", ov)
    assert ours.to_dict() == ref.to_dict()
    assert type(ours.extra).__name__ == "Config" and ours.extra.key == 3e-4


@pytest.mark.parametrize("n,size,seed", [(7, 16, 0), (33, 40, 3)])
def test_synthetic_source_is_bit_identical(n, size, seed):
    fl = [5, 4, 2, 1, 1, 1]
    ours = source.synthetic_source(n, 4, fl, size, 0.5, seed=seed)
    ref = jsource.synthetic_source(n, 4, fl, size, 0.5, seed=seed)
    for k in ("images", "tabular", "labels", "labelled"):
        a, b = getattr(ours, k), getattr(ref, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (ours.field_lengths, ours.num_classes, ours.num_cat,
            ours.num_con) == (ref.field_lengths, ref.num_classes,
                              ref.num_cat, ref.num_con)


def test_native_splits_load_like_jax(tmp_path):
    """``load_sources`` on native split directories (``data_base``)."""
    for i, split in enumerate(datasets.SPLITS):
        jsource.synthetic_source(4 + i, 3, [3, 1], 8, seed=i).save(
            tmp_path / split)
    ov = ["dataset=dvm_all_server_reordered", f"data_base={tmp_path}"]
    ours = datasets.load_sources(load_config("config_dvm_STiL", ov))
    ref = jdatasets.load_sources(jax_load_config("config_dvm_STiL", ov))
    assert list(ours) == list(ref) == list(datasets.SPLITS)
    for split in ref:
        np.testing.assert_array_equal(ours[split].images, ref[split].images)
        np.testing.assert_array_equal(ours[split].labels, ref[split].labels)


def test_array_source_loads_jax_saved_split(tmp_path):
    ref = jsource.synthetic_source(9, 3, [3, 1, 1], 8, seed=1)
    ref.save(tmp_path)
    ours = source.ArraySource.load(tmp_path)
    for k in ("images", "tabular", "labels", "labelled"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))
    assert len(ours.truncate(4)) == 4 and len(ours.truncate(40)) == 9


def _synthetic_cfgs(**extra):
    ov = ["dataset=synthetic_dvm", "synthetic_labelled=5",
          "synthetic_unlabelled=6", "synthetic_val=7", "synthetic_test=8",
          "synthetic_image_size=12"] + [f"{k}={v}" for k, v in extra.items()]
    return load_config("config_dvm_STiL", ov), \
        jax_load_config("config_dvm_STiL", ov)


@pytest.mark.parametrize("extra", [{}, {"sweep": True},
                                   {"delete_segmentation": True}])
def test_load_sources_and_truncation_match_jax(extra):
    cfg, jcfg = _synthetic_cfgs(**extra)
    ours = datasets.apply_sweep_truncation(datasets.load_sources(cfg), cfg)
    ref = jdatasets.apply_sweep_truncation(jdatasets.load_sources(jcfg),
                                           jcfg)
    assert list(ours) == list(ref)
    for split in ref:
        np.testing.assert_array_equal(ours[split].images, ref[split].images)
        np.testing.assert_array_equal(ours[split].tabular,
                                      ref[split].tabular)
    assert datasets.attach_missing_masks(ours, cfg) is ours
    # with missing_tabular, the masks of the JAX package (the strategies
    # are in tests/test_torch_missing.py)
    cfg.missing_tabular = jcfg.missing_tabular = True
    masked = datasets.attach_missing_masks(ours, cfg)
    jmasked = jdatasets.attach_missing_masks(ref, jcfg)
    for split in jmasked:
        np.testing.assert_array_equal(masked[split].missing,
                                      jmasked[split].missing)


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, False),
                                               (True, True)])
def test_epoch_sampler_matches_jax(shuffle, drop_last):
    ours = loader.EpochSampler(23, 8, shuffle, drop_last, seed=4)
    ref = jloader.EpochSampler(23, 8, shuffle, drop_last, seed=4)
    assert ours.steps_per_epoch() == ref.steps_per_epoch()
    for _ in range(2):  # two epochs: the generator state advances alike
        got, want = list(ours.epoch()), list(ref.epoch())
        assert len(got) == len(want)
        for (i, w), (ri, rw) in zip(got, want):
            np.testing.assert_array_equal(i, ri)
            np.testing.assert_array_equal(w, rw)


def test_device_cache_gather_and_tta_batches_match_jax():
    src = jsource.synthetic_source(13, 4, [5, 1, 1], 8, seed=2)
    cache = loader.DeviceCache(src, device="cpu").as_dict()
    jcache = jloader.DeviceCache(src).as_dict()
    idx = np.array([3, 0, 12, 3], np.int32)
    got = loader.gather_batch(cache, torch.from_numpy(idx).long())
    want = jloader.gather_batch(jcache, jnp.asarray(idx))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    ours = list(tta_batches(cache, 5))
    ref = list(jtent.tta_batches(jcache, 5))
    assert [len(b[0]) for b in ours] == [5, 5, 3]   # pad rows removed
    for (img, tab, _), (ri, rt, _) in zip(ours, ref):
        np.testing.assert_array_equal(img.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(tab.numpy(), np.asarray(rt))


@pytest.mark.parametrize("stored,out,target", [(40, 32, "dvm"),
                                               (32, 32, "dvm"),
                                               (20, 32, "dvm"),
                                               (24, 16, "cardiac")])
def test_resize_transform_matches_jax(stored, out, target):
    """Both compute in float32 with the same triangle matrices; only the
    summation order differs (atol 1e-6 on [0, 1] pixels, 1e-5 on raw
    cardiac values)."""
    rng = np.random.RandomState(stored)
    if target == "dvm":
        imgs = rng.randint(0, 256, (3, stored, stored, 3), dtype=np.uint8)
    else:
        imgs = rng.randn(3, stored, stored, 3).astype(np.float32) * 4
    got = augment.default_pipeline(out, target)(torch.from_numpy(imgs))
    want = jaug.default_pipeline(out, target)(
        jax.random.key(0), jnp.asarray(imgs))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert_close(got, np.asarray(want), 0,
                 1e-6 if target == "dvm" else 1e-5)


def _probs(rng, n, c):
    p = rng.rand(n, c)
    return p / p.sum(1, keepdims=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auroc_matches_sklearn(seed):
    """The port's AUROC is exact Mann-Whitney arithmetic; sklearn
    integrates the ROC curve. Both are exact up to float64 rounding."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, 50)
    s = np.round(rng.rand(50), 1)  # ties
    assert evaluate.binary_auroc(y, s) == pytest.approx(
        roc_auc_score(y, s), abs=1e-12)
    y = rng.randint(0, 5, 60)
    p = _probs(rng, 60, 5)
    assert evaluate.ovr_macro_auroc(y, p, 5) == pytest.approx(
        roc_auc_score(y, p, multi_class="ovr", average="macro",
                      labels=np.arange(5)), abs=1e-12)


def test_auroc_edge_cases_match_sklearn():
    rng = np.random.RandomState(3)
    # one class present: nan
    assert np.isnan(evaluate.binary_auroc(np.ones(5, int), rng.rand(5)))
    with pytest.warns(Warning):
        assert np.isnan(roc_auc_score(np.ones(5, int), rng.rand(5)))
    # an absent class: macro OVR is nan
    y = np.array([0, 1, 1, 0, 2])
    p = _probs(rng, 5, 4)
    assert np.isnan(evaluate.ovr_macro_auroc(y, p, 4))
    # rows that are not probabilities, labels outside range(C): raise
    for yy, pp in ((y, p * 1.1), (np.array([0, 1, 5, 0, 2]), p)):
        with pytest.raises(ValueError):
            roc_auc_score(yy, pp, multi_class="ovr", average="macro",
                          labels=np.arange(4))
        with pytest.raises(ValueError):
            evaluate.ovr_macro_auroc(yy, pp, 4)


@pytest.mark.parametrize("case", ["binary", "binary_one_class", "multi",
                                  "multi_absent", "multi_not_probs"])
def test_compute_eval_metrics_matches_jax(case):
    rng = np.random.RandomState(4)
    c = 2 if case.startswith("binary") else 4
    y = rng.randint(0, c, 40)
    if case == "binary_one_class":
        y[:] = 1
    if case == "multi_absent":
        y[y == 3] = 0
    p = _probs(rng, 40, c)
    if case == "multi_not_probs":
        p = p * 2
    ours = evaluate.compute_eval_metrics(p, y, c, "test")
    ref = jevaluate.compute_eval_metrics(p, y, c, "test")
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], abs=1e-12, nan_ok=True), k


@pytest.mark.parametrize("limit", [None, 1.0, 1, 0, 0.5, 0.01, 3, 100, 2.0])
def test_apply_batch_limit_matches_jax(limit):
    assert evaluate.apply_batch_limit(10, limit) == \
        jevaluate.apply_batch_limit(10, limit)


@pytest.mark.parametrize("weighted", [False, True])
def test_eval_losses_match_jax(weighted):
    """clip_loss, club_losses and cross_entropy at float64: same formulas,
    rtol 1e-10."""
    rng = np.random.RandomState(5)
    a, b, mu, yy = (rng.randn(6, 8) for _ in range(4))
    labels = rng.randint(0, 8, 6)
    w = np.array([1, 1, 1, 1, 0, 0], np.float32) if weighted else None
    tw = None if w is None else torch.from_numpy(w)
    with x64():
        jw = None if w is None else jnp.asarray(w)
        jl, jlog, _ = jax_clip_loss(jnp.asarray(a), jnp.asarray(b), 0.1,
                                      0.5, row_weights=jw)
        jmi, jll = jax_club_losses(jnp.asarray(mu), jnp.asarray(yy), jw)
        jce = jax_cross_entropy(jnp.asarray(a), jnp.asarray(labels))
        l, logits, _ = clip_loss(torch.from_numpy(a), torch.from_numpy(b),
                                 0.1, 0.5, row_weights=tw)
        mi, ll = club_losses(torch.from_numpy(mu), torch.from_numpy(yy), tw)
        ce = cross_entropy(torch.from_numpy(a), torch.from_numpy(labels))
        for got, want in ((l, jl), (logits, jlog), (mi, jmi), (ll, jll),
                          (ce, jce)):
            assert_close(got, np.asarray(want), 1e-10, 1e-12)


def test_attention_mask_matches_jax():
    missing = np.random.RandomState(6).rand(3, 5) < 0.5
    got = build_attention_mask(torch.from_numpy(missing))
    want = jtt.build_attention_mask(jnp.asarray(missing))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_imports_no_jax_jax_package_or_triton():
    """Importing every module of stil_tta_torch loads neither JAX (nor
    flax/optax/orbax) nor the JAX package nor triton, nor any of the
    raw-file parsers' packages (pandas, sklearn, PIL, nibabel), which
    only the dataprep functions import, inside their bodies."""
    code = (
        "import importlib, pkgutil, sys, stil_tta_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "stil_tta_torch.__path__, 'stil_tta_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'stil_tta_tpu', "
        "'triton', 'pandas', 'sklearn', 'PIL', 'nibabel'))\n"
        "print(len(mods), bad)\n"
        "print(' '.join(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=Path(stil_tta_torch.__file__).parents[1])
    first, names = out.stdout.splitlines()[:2]
    n, bad = first.split(" ", 1)
    # 50 modules: slice 1's, slice 2's (algorithms.base, data.corrupt,
    # losses.prototype_loss, ops.metrics, train.checkpoint, train.optim),
    # slice 3's (ops.conv_chain, tta.methods, tools and
    # tools.bench_conv_probe), slice 6's (algorithms.registry,
    # models.saint), slice 7's (algorithms.match_common,
    # algorithms.mmatch, algorithms.cotrain) and slice 8's
    # (algorithms.simmatch, algorithms.comatch, algorithms.freematch);
    # slice 11's ops.quant_conv and tools.bn_repeat; slice 12's parallel,
    # parallel.mesh, parallel.collectives and tools.dryrun_multichip;
    # slice 13's data.native_loader, models.vit and utils.profiling;
    # slice 14's seven dataprep modules, tools.tta_demo and
    # utils.embeddings
    assert int(n) >= 66 and bad.strip() == "[]", out.stdout
    assert {"stil_tta_torch.algorithms.registry",
            "stil_tta_torch.models.saint",
            "stil_tta_torch.algorithms.match_common",
            "stil_tta_torch.algorithms.mmatch",
            "stil_tta_torch.algorithms.cotrain",
            "stil_tta_torch.algorithms.simmatch",
            "stil_tta_torch.algorithms.comatch",
            "stil_tta_torch.algorithms.freematch",
            "stil_tta_torch.ops.quant_conv",
            "stil_tta_torch.tools.bn_repeat",
            "stil_tta_torch.parallel",
            "stil_tta_torch.parallel.mesh",
            "stil_tta_torch.parallel.collectives",
            "stil_tta_torch.tools.dryrun_multichip",
            "stil_tta_torch.data.native_loader",
            "stil_tta_torch.models.vit",
            "stil_tta_torch.utils.profiling",
            "stil_tta_torch.dataprep.dvm",
            "stil_tta_torch.dataprep.dvm_raw",
            "stil_tta_torch.dataprep.shifted",
            "stil_tta_torch.dataprep.ukbb",
            "stil_tta_torch.dataprep.ukbb_split",
            "stil_tta_torch.dataprep.ukbb_table",
            "stil_tta_torch.dataprep.visualize",
            "stil_tta_torch.tools.tta_demo",
            "stil_tta_torch.utils.embeddings"} <= set(names.split())
