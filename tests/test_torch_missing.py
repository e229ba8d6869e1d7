"""``missing_tabular`` and the weighted sampler in the port against the
JAX package: the masks of ``dataprep/missing_mask.py`` and
``attach_missing_masks`` bit for bit, a masked STiL eval step, the
``missing_mask`` keyword of every net, and ``WeightedSampler`` index for
index, also as ``evaluate`` seeds it.

The eval step runs ``resnet18`` on 32x32 images in float64, JAX in x64,
on the weights of ``tests/test_torch_train_step.py``'s initial state.
Tolerances: rtol 1e-8 (float64 sums in two orders) on what the masks
reach, the tabular head and its CLUB terms; rtol 2e-6 on what the image
tower reaches, whose float32 image transform the two packages run
differently, as ``tests/test_torch_slice.py`` states."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms.registry import get_algorithm
from stil_tta_torch.algorithms.stil import STiL
from stil_tta_torch.config import load_config
from stil_tta_torch.data import datasets
from stil_tta_torch.data.loader import WeightedSampler
from stil_tta_torch.dataprep import missing_mask
from stil_tta_torch.train import evaluate as port_evaluate
from stil_tta_torch.train.test import test as run_test
from stil_tta_torch.tta.tent import missing_kw
from stil_tta_tpu.algorithms.registry import get_algorithm as jax_algorithm
from stil_tta_tpu.algorithms.stil import STiL as JaxSTiL
from stil_tta_tpu.config import load_config as jax_load_config
from stil_tta_tpu.data import datasets as jdatasets
from stil_tta_tpu.data.loader import WeightedSampler as JaxWeightedSampler
from stil_tta_tpu.dataprep import missing_mask as jmissing
from stil_tta_tpu.tta.tent import missing_kw as jax_missing_kw
from tests.test_torch_train_step import (C, F64, FL, _cfg,
                                         _port_initial_state)
from tests.test_torch_train_step import _jax_state as jax_stil_state
from tests.torch_parity import FIX_CLI, assert_close, match_cfg, x64
from tests.torch_parity import one_torch_thread  # noqa: F401

SYNTH = ["dataset=synthetic_dvm", "synthetic_labelled=12",
         "synthetic_unlabelled=20", "synthetic_val=9", "synthetic_test=14",
         "synthetic_image_size=8", "img_size=8", "num_classes=3"]


def test_mask_functions_match_jax():
    for seed in (0, 1003):
        np.testing.assert_array_equal(
            missing_mask.random_missing_mask(37, 17, 0.3, seed),
            jmissing.random_missing_mask(37, 17, 0.3, seed))
        np.testing.assert_array_equal(
            missing_mask.feature_missing_mask(37, 17, 0.3, seed),
            jmissing.feature_missing_mask(37, 17, 0.3, seed))
    importance = np.random.RandomState(5).rand(17)
    np.testing.assert_array_equal(
        missing_mask.feature_missing_mask(5, 17, 0.4, importance=importance),
        jmissing.feature_missing_mask(5, 17, 0.4, importance=importance))
    mask = missing_mask.feature_missing_mask(5, 17, 0.3)
    assert mask.sum(1).tolist() == [5] * 5 and (mask == mask[0]).all()


def test_mask_cli_writes_the_jax_mask(tmp_path):
    out = tmp_path / "d" / "missing_mask.npy"
    assert missing_mask.main(["--n", "11", "--num-features", "6", "--rate",
                              "0.5", "--strategy", "feature", "--seed", "3",
                              "--out", str(out)]) == 0
    np.testing.assert_array_equal(
        np.load(out), jmissing.feature_missing_mask(11, 6, 0.5, 3))


@pytest.mark.parametrize("strategy", ["random", "feature", "MI", "LI",
                                      "file"])
def test_attach_missing_masks_matches_jax(strategy, tmp_path):
    """Per split: a ``missing_mask.npy`` in the split's directory (here the
    test split's), else the same columns in every split for ``feature``,
    ``MI`` and ``LI``, else an i.i.d. mask at seed 1000 + i."""
    over = SYNTH + ["missing_tabular=true", "missing_rate=0.3",
                    f"missing_strategy="
                    f"{'random' if strategy == 'file' else strategy}"]
    cfg, jcfg = load_config("config_dvm_STiL", over), \
        jax_load_config("config_dvm_STiL", over)
    if strategy == "file":
        (tmp_path / "test").mkdir()
        np.save(tmp_path / "test" / "missing_mask.npy",
                np.random.RandomState(9).rand(14, 17) < 0.5)
        cfg.data_test = jcfg.data_test = str(tmp_path / "test")
    ours = datasets.attach_missing_masks(datasets.load_sources(cfg), cfg)
    ref = jdatasets.attach_missing_masks(jdatasets.load_sources(jcfg), jcfg)
    assert list(ours) == list(ref)
    for split in ref:
        assert ours[split].missing.dtype == bool
        np.testing.assert_array_equal(ours[split].missing,
                                      ref[split].missing)
    masks = [ours[s].missing for s in ours]
    same_columns = strategy in ("feature", "MI", "LI")
    assert all((m[0] == masks[0][0]).all() for m in masks) == same_columns
    if strategy == "file":
        np.testing.assert_array_equal(
            ours["test"].missing,
            np.load(tmp_path / "test" / "missing_mask.npy"))


@pytest.fixture(scope="module")
def masked_eval():
    """The STiL eval step of both packages on 8 rows with random masks at
    rate 0.3, from one set of weights; the port's also without masks."""
    rng = np.random.RandomState(4)
    n = 8
    imgs = rng.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
    tabs = np.concatenate([np.stack([rng.randint(0, c, n) for c in FL[:3]],
                                    1), rng.randn(n, 3)], 1).astype(
        np.float32)
    y = rng.randint(0, C, n)
    mask = missing_mask.random_missing_mask(n, len(FL), 0.3, seed=7)
    algo = STiL(_cfg(load_config), FL, dtype=F64, device="cpu")
    state = _port_initial_state(algo)
    with x64():
        jalgo = JaxSTiL(_cfg(jax_load_config), FL, dtype=jnp.float64)
        jstate = jax_stil_state(jalgo, state)
        jcache = {"images": jnp.asarray(imgs), "tabular": jnp.asarray(tabs),
                  "labels": jnp.asarray(y.astype(np.int32)),
                  "labelled": jnp.ones(n, bool), "missing": jnp.asarray(mask)}
        want = jax.device_get(jalgo.make_eval_step()(
            jstate.params, jstate.batch_stats, jcache,
            jnp.arange(n, dtype=jnp.int32)))
    cache = {"images": torch.from_numpy(imgs),
             "tabular": torch.from_numpy(tabs),
             "labels": torch.from_numpy(y),
             "labelled": torch.ones(n, dtype=bool),
             "missing": torch.from_numpy(mask)}
    step = algo.make_eval_step()
    got = step(cache, torch.arange(n))
    clean = step({k: v for k, v in cache.items() if k != "missing"},
                 torch.arange(n))
    return want, got, clean, mask


def test_masked_stil_eval_step_matches_jax(masked_eval):
    want, got, clean, mask = masked_eval
    assert 0 < mask.sum() < mask.size
    tabular_only = ("prob_t", "CLUBloss_tabular", "CLUBloss_tabular_est")
    for k in ("prob_m", "prob_i", "prob_t"):
        assert_close(got[k], want[k], 1e-8 if k in tabular_only else 2e-6,
                     1e-12, k)
    for k, v in want["losses"].items():
        assert_close(got["losses"][k], v,
                     1e-8 if k in tabular_only else 2e-6, 1e-12, k)
    # the masks reach the tabular encoder: the tabular head moves
    assert float((got["prob_t"] - clean["prob_t"]).abs().max()) > 1e-6


NETS = {"STiL": "config_dvm_STiL", "SimMatch": "config_dvm_SimMatch",
        "MultiSimMatch": "config_dvm_MultiSimMatch",
        "MMatch": "config_dvm_MMatch", "TabularEval": "config_dvm_STiL"}


@pytest.mark.parametrize("name", list(NETS))
def test_only_stils_net_takes_the_mask_on_both_sides(name):
    """``missing_kw`` (``tta/tent.py:80-101``): STiL's net gets the
    masks; the Match families' and ``TabularNet``, whose forward takes
    none, get no keyword, in both packages."""
    extra = (["algorithm_name=TabularEval", "eval_datatype=tabular"]
             if name == "TabularEval" else [])
    cfg = match_cfg(load_config, NETS[name], *extra)
    jcfg = match_cfg(jax_load_config, NETS[name], *extra)
    net = get_algorithm(cfg.algorithm_name)(cfg, FL, device="cpu").net
    jnet = jax_algorithm(jcfg.algorithm_name)(jcfg, FL).net
    assert type(net).__name__ == type(jnet).__name__
    mask = torch.zeros(2, len(FL), dtype=torch.bool)
    takes = name == "STiL"
    assert set(missing_kw(mask, net)) == set(
        jax_missing_kw(mask.numpy(), jnet)) == ({"missing_mask"} if takes
                                                else set())


def test_match_family_tests_under_missing_tabular(tmp_path):
    """A Match family's test entry point with the masks in its cache:
    BN-adapt and scoring run without them."""
    metrics = run_test(load_config("config_dvm_MultiSimMatch", FIX_CLI[2:] + [
        "missing_tabular=true", "missing_rate=0.3", "tta=True",
        "tta_strategy=bn_adapt"]), logdir=tmp_path, device="cpu")
    assert set(metrics) == {"test.acc", "test.auc"}


def test_weighted_sampler_matches_jax_index_for_index():
    labels = np.random.RandomState(1).randint(0, 3, 25)
    for seed, weights in ((0, [1.0, 2.0, 0.5]), (100004, [0.2, 0.0, 3.0])):
        ours = WeightedSampler(labels, weights, 6, seed=seed)
        ref = JaxWeightedSampler(labels, weights, 6, seed=seed)
        for _ in range(4):
            (idx, w), (jidx, jw) = ours.next(), ref.next()
            assert idx.dtype == jidx.dtype == np.int32
            np.testing.assert_array_equal(idx, jidx)
            np.testing.assert_array_equal(w, jw)
        if weights[1] == 0.0:
            assert not (labels[ours.next()[0]] == 1).any()


def test_evaluate_draws_the_labelled_rows_as_jax_seeds_them(tmp_path,
                                                            monkeypatch):
    """``weighted_sampler`` with class ``weights``: each epoch's labelled
    batches are the JAX package's sampler's at seed ``seed + 100003 *
    epoch + 1`` (``train/evaluate.py:247-250``)."""
    drawn = []

    class Recording(WeightedSampler):
        def __init__(self, labels, class_weights, batch_size, seed=0):
            super().__init__(labels, class_weights, batch_size, seed)
            self.args = (np.array(labels), list(class_weights), batch_size,
                         seed)
            drawn.append((self.args, []))

        def next(self):
            out = super().next()
            drawn[-1][1].append(out[0])
            return out

    monkeypatch.setattr(port_evaluate, "WeightedSampler", Recording)
    cfg = load_config("config_dvm_STiL", SYNTH + [
        "algorithm_name=TabularEval", "eval_datatype=tabular",
        "tabular_embedding_dim=16", "tabular_transformer_num_layers=1",
        "batch_size=4", "unlabelled_ratio=3", "max_epochs=2",
        "weighted_sampler=true", "weights=[1.0,3.0,0.5]",
        "enable_progress_bar=false", f"logdir={tmp_path}"])
    port_evaluate.evaluate(cfg, device="cpu")
    seeds = [args[3] for args, _ in drawn]
    seed0 = int(cfg.seed)
    # the samplers of epochs 0 and 1, after the shape probe of epoch 0
    assert seeds[-2:] == [seed0 + 1, seed0 + 100003 + 1]
    for args, batches in drawn[-2:]:
        assert len(batches) == 20 // 3  # the unlabelled epoch's steps
        ref = JaxWeightedSampler(*args)
        for idx in batches:
            np.testing.assert_array_equal(idx, ref.next()[0])
