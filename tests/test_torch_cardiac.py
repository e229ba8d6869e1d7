"""The cardiac task in the port against the JAX package: the rotation
warp, the cardiac recipes given the JAX package's draws, the nine cardiac
YAMLs, and the port's CLI on cardiac
STiL and a cardiac Match family (synthetic data with ``target=CAD``, two
classes, AUC, as ``tests/test_evaluate_variants.py`` runs the JAX
package's).

Images are 40 x 36 (rows x columns, so that a swapped axis shows) at the
cardiac raw scale 0-255, warped to 24 x 24 or 32 x 32. Both sides compute
in float32, the JAX package's dtype here (its grids are float32 even under
x64). The warp is bilinear and so continuous in the sample point: where
the two sides' float32 coordinates straddle an integer, the floors differ
but the values do not jump. Its tolerance follows from that: a sample
point below 40 carries a few float32 roundings (and cos/sin one ulp each),
under 2e-5 pixels, and the image changes by at most 255 a pixel, so atol
5e-3 on the raw scale; on [0, 1] values, atol 2e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch import run as port_run
from stil_tta_torch.config import load_config
from stil_tta_torch.data import augment
from stil_tta_torch.train.test import test as run_test
from stil_tta_tpu.config import load_config as jax_load_config
from stil_tta_tpu.data import augment as jaug
from tests.torch_parity import (FIX_CLI, assert_close, cli_resume_exact,
                                cli_train_resume_test, jax_augment_draws)
from tests.torch_parity import one_torch_thread  # noqa: F401

B, H, W = 6, 40, 36
RAW_ATOL, UNIT_ATOL = 5e-3, 2e-5
CARDIAC = ("STiL", "CoTrain", "MMatch", "SimMatch", "CoMatch", "FreeMatch",
           "MultiSimMatch", "MultiCoMatch", "MultiFreeMatch")
CLI = ("num_classes=2", "target=CAD", "eval_metric=auc")


def _images(seed=8):
    return np.random.RandomState(seed).randint(0, 256, (B, H, W, 3),
                                               dtype=np.uint8)


# boxes, flips and angles of six samples: the full image, boxes inside
# it, and angles of either sign up to the contrastive recipe's 45 degrees
BOX = {"y0": [0.0, 5.7, 0.3, 2.2, 11.1, 9.5],
       "x0": [0.0, 0.7, 1.3, 4.2, 2.1, 3.5],
       "ch": [40.0, 30.3, 20.1, 17.7, 28.3, 25.5],
       "cw": [36.0, 31.3, 20.4, 17.2, 30.3, 25.1]}
FLIP = [False, True, False, True, True, False]
ANGLE = [0.3, -0.7, 0.05, 0.01, 0.785, -0.2]


@pytest.mark.parametrize("rotated", [True, False])
def test_affine_warp_matches_jax(rotated):
    """The warp of each sample to 24 x 24 against the JAX ``affine_warp``
    (vmapped); at angle 0 also against the JAX ``crop_resize_flip``, the
    matrix path the rotation-free recipes take."""
    imgs = _images()
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    box = {k: f32(v) for k, v in BOX.items()}
    flip = np.asarray(FLIP)
    angle = f32(ANGLE) if rotated else np.zeros(B, np.float32)
    warp = jax.jit(jax.vmap(
        lambda im, y0, x0, ch, cw, fl, a: jaug.affine_warp(
            im, y0, x0, ch, cw, 24, fl, a)))
    args = (box["y0"], box["x0"], box["ch"], box["cw"], flip)
    want = np.asarray(warp(jnp.asarray(imgs, jnp.float32), *args, angle))
    t = [torch.from_numpy(a) for a in args]
    got = augment.affine_warp(torch.from_numpy(imgs).float(), *t[:4], 24,
                              t[4], torch.from_numpy(angle))
    assert got.shape == (B, 24, 24, 3) and got.dtype == torch.float32
    assert_close(got, want, 0, RAW_ATOL)
    if not rotated:
        crf = jax.jit(jax.vmap(
            lambda im, y0, x0, ch, cw, fl: jaug.crop_resize_flip(
                im, y0, x0, ch, cw, 24, fl)))
        assert_close(got, np.asarray(crf(jnp.asarray(imgs, jnp.float32),
                                         *args)), 0, RAW_ATOL)


def _blurred_contrastive(mod):
    """The cardiac contrastive recipe with a 29-tap blur before the crop:
    no factory builds it, but ``AugmentPipeline`` takes it (the full
    image's reflect blur, then the warp)."""
    return dataclasses.replace(mod.contrastive_pipeline(32, "CAD"),
                               blur_ksize=29, blur_p=0.5)


RECIPES = {
    "contrastive": lambda mod: mod.contrastive_pipeline(32, "CAD"),
    "hard_eval": lambda mod: mod.hard_eval_pipeline(32, "CAD"),
    "soft_eval": lambda mod: mod.soft_eval_pipeline(32, "CAD"),
    "soft_eval_dvm": lambda mod: mod.soft_eval_pipeline(32, "dvm"),
    "blur_before_warp": _blurred_contrastive,
}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_recipe_matches_jax_given_its_draws(recipe):
    """Each rotating recipe at 40 x 36 -> 32 on six images, gated per
    sample at 0.7, with the JAX package's draws from key 0: the cardiac
    contrastive recipe (a (0.2, 1) crop, 45 degrees, jitter 0.5 with p 1,
    raw scale), the cardiac hard-eval one (its (0.6, 1) crop), the
    soft-eval one of both targets ((0.8, 1), 20 degrees, jitter 0.25; DVM
    scaled to [0, 1]) and the blur-before-warp branch."""
    imgs = _images()
    jpipe, pipe = RECIPES[recipe](jaug), RECIPES[recipe](augment)
    assert pipe.rotate_limit == jpipe.rotate_limit > 0
    assert pipe.scale_255 == jpipe.scale_255 == (recipe == "soft_eval_dvm")
    key = jax.random.key(0)
    want = np.asarray(jax.jit(lambda k, x: jpipe(k, x, apply_rate=0.7))(
        key, jnp.asarray(imgs)))
    draws = jax_augment_draws(jpipe, key, B, H, W, 0.7)
    flags = ("gate", "flip") + (("blur_on",) if pipe.blur_ksize else ())
    for k in flags:
        assert 0 < int(draws[k].sum()) < B, k
    assert float(draws["angle"].abs().max()) > 0.1
    got = pipe.apply(torch.from_numpy(imgs), draws)
    assert got.shape == want.shape == (B, 32, 32, 3)
    # the gate-off rows keep the raw scale on the cardiac recipes
    assert float(got.max()) > (0.99 if pipe.scale_255 else 200.0)
    assert_close(got, want, 0, UNIT_ATOL if pipe.scale_255 else RAW_ATOL)
    own = pipe(torch.Generator().manual_seed(0), torch.from_numpy(imgs), 0.7)
    assert own.shape == want.shape and bool(torch.isfinite(own).all())


@pytest.mark.parametrize("name", [f"config_cardiac_{n}" for n in CARDIAC])
def test_cardiac_config_composes_like_jax(name):
    """Each of the nine YAMLs key for key; the ten cardiac dataset YAMLs
    are cases of ``tests/test_torch_data_config.py::
    test_config_composition_matches_jax_loader``."""
    ours = load_config(name).to_dict()
    ref = jax_load_config(name).to_dict()
    assert ours == ref
    assert ours["dataset_name"] == "cardiac" and ours["num_classes"] == 2
    assert ours["batch_size"] == 256 and ours["eval_metric"] == "auc"


def test_cli_cardiac_stil_trains_resumes_and_tests(tmp_path):
    """Cardiac STiL through the port's CLI: the rotating contrastive
    views, a bitwise resume, then ``test()`` with BN-adapt on the resumed
    weights, scored by AUC."""
    extra = CLI + ("strict_prototypes=false",)
    resumed = cli_resume_exact("config_cardiac_STiL", tmp_path, *extra)
    assert resumed["prototypes"].shape == (2, 8)
    cfg = load_config("config_cardiac_STiL", FIX_CLI[2:] + list(extra) + [
        "test=True", "tta=True", "tta_strategy=bn_adapt"])
    assert cfg.target == "CAD" and cfg.img_size == 32
    path = tmp_path / "weights.ckpt"
    torch.save({"state_dict": resumed["net"]}, path)
    cfg.checkpoint = str(path)
    metrics = run_test(cfg, logdir=tmp_path / "t", device="cpu")
    assert set(metrics) >= {"test.acc", "test.auc"}
    assert all(0.0 <= v <= 1.0 for v in metrics.values())
    assert port_run.main(["--config-name", "config_cardiac_STiL"] + FIX_CLI
                         + list(extra) + ["test=True", "evaluate=False",
                                          "tta=True", f"checkpoint={path}",
                                          f"logdir={tmp_path / 'u'}"]) == 0


def test_cli_cardiac_match_family_trains_resumes_and_tests(tmp_path):
    """Cardiac MultiSimMatch (the rotating hard-eval labelled view)
    through the CLI: a bitwise resume, ``test()`` with BN-adapt on the
    reference's checkpoint layout, and ``Predictor``."""
    resumed = cli_train_resume_test("config_cardiac_MultiSimMatch",
                                    tmp_path, *CLI)
    assert resumed["extra"]["bank"].shape[0] == 8
