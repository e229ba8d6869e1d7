"""The FixMatch families' views and nets in the port against the JAX
package: the hard-eval, weak and strong recipes given the JAX package's
draws (the strong one with the HSV hue round trip and the reflect blur at
the output resolution), how ``labeled_views`` and ``weak_strong_views``
compose them with the tabular corruption, the forwards of
``MatchBackbone`` (through ``MatchMultimodalNet``) and ``ImagingNet`` with
their train-mode BatchNorm statistics, and the converter key for key.
No JAX train step is compiled here.

The recipes compute in float32 on both sides in different orders (the
post-crop blur is one matrix a sample here, shifted adds there): atol
2e-5 on [0, 1] pixels. The nets run in float64 on both sides: rtol 1e-8,
atol 1e-9 on outputs, rtol 1e-8 on running statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms.freematch import FreeMatch
from stil_tta_torch.algorithms.match_common import (ImagingNet,
                                                    MatchMultimodalNet,
                                                    ema_source, image_tower)
from stil_tta_torch.config import load_config
from stil_tta_torch.data import augment
from stil_tta_torch.data.loader import dataset_indices
from stil_tta_torch.train import convert
from stil_tta_tpu.algorithms import match_common as jmc
from stil_tta_tpu.data import augment as jaug
from stil_tta_tpu.train import convert as jconvert
from tests.test_torch_train_step import C, F64, FL, IMG
from tests.torch_parity import (as_torch, assert_close, jax_augment_draws,
                                match_cfg, to_numpy, x64)
from tests.torch_parity import one_torch_thread  # noqa: F401

B = 8
FLAGS = ("gate", "jitter_on", "gray_on", "blur_on", "flip")


@pytest.mark.parametrize("recipe,rate", [("hard_eval", 0.7), ("weak", 1.0),
                                         ("strong", 1.0)])
def test_recipe_matches_jax_given_its_draws(recipe, rate):
    """Each DVM recipe at 40 -> 32 on 8 images with the JAX package's
    draws from key 0, every random choice taken both ways: the hard-eval
    recipe (the contrastive one at a (0.6, 1) crop scale, gated per
    sample at 0.7), the weak one (crop and flip), the strong one (crop,
    flip, then on the crop jitter with hue, grayscale and the 19-tap
    reflect blur)."""
    imgs = np.random.RandomState(8).randint(0, 256, (B, 40, 40, 3),
                                            dtype=np.uint8)
    jpipe = getattr(jaug, f"{recipe}_pipeline")(IMG, "dvm")
    key = jax.random.key(0)
    want = np.asarray(jax.jit(lambda k, x: jpipe(k, x, apply_rate=rate))(
        key, jnp.asarray(imgs)))
    pipe = getattr(augment, f"{recipe}_pipeline")(IMG, "dvm")
    draws = jax_augment_draws(jpipe, key, B, 40, 40, rate)
    for k in FLAGS:
        if k in draws and not (k == "gate" and rate >= 1.0):
            assert 0 < int(draws[k].sum()) < B, k
    assert ("hue" in draws) == (recipe == "strong")
    got = pipe.apply(torch.from_numpy(imgs), draws)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert_close(got, want, 0, 2e-5)
    own = pipe(torch.Generator().manual_seed(0), torch.from_numpy(imgs),
               rate)
    assert own.shape == want.shape
    assert 0 <= float(own.min()) <= float(own.max()) <= 1


def test_hue_round_trip_and_reflect_blur_match_jax():
    """The HSV round trip on colours with ties and grays, and the reflect
    blur matrix against ``gaussian_blur``'s shifted adds."""
    rng = np.random.RandomState(3)
    img = rng.rand(2, 6, 6, 3).astype(np.float32)
    img[0, 0, :3] = 0.5                       # grays
    img[0, 1, :, 1] = img[0, 1, :, 0]         # r == g
    img[1, 2, :, 2] = img[1, 2, :, 0]         # r == b
    h, s, v = jaug._rgb_to_hsv(jnp.asarray(img))
    want = np.asarray(jaug._hsv_to_rgb((h + 0.07) % 1.0, s, v))
    ph, ps, pv = augment._rgb_to_hsv(torch.from_numpy(img))
    assert_close(ph, np.asarray(h), 0, 1e-6)
    got = augment._hsv_to_rgb((ph + 0.07) % 1.0, ps, pv)
    assert_close(got, want, 0, 1e-6)
    assert_close(augment._hsv_to_rgb(ph, ps, pv), img, 0, 1e-6)

    x = rng.rand(12, 12, 3).astype(np.float32)
    key = jax.random.key(4)
    want = np.asarray(jaug.gaussian_blur(jnp.asarray(x), key, 9, 1.5, 1.5,
                                         1.0))
    taps = augment._gaussian_kernels(torch.tensor([1.5]), 9)
    m = augment._reflect_blur_matrix(taps, 12)
    assert_close(m.sum(2), np.ones((1, 12)), 0, 1e-6)
    got = torch.einsum("btw,bswc->bstc", m, torch.einsum(
        "bsh,bhwc->bswc", m, torch.from_numpy(x)[None]))[0]
    assert_close(got, want, 0, 2e-6)


def test_rotating_recipes_are_refused():
    """No recipe is refused any more: the cardiac hard-eval recipe rotates
    (its parity is in ``tests/test_torch_cardiac.py``), and the cardiac
    weak and strong recipes do not rotate."""
    hard = augment.hard_eval_pipeline(IMG, "cardiac")
    jhard = jaug.hard_eval_pipeline(IMG, "cardiac")
    for k in ("rotate_limit", "crop_scale", "jitter", "jitter_p",
              "scale_255", "blur_ksize", "gray_p"):
        assert getattr(hard, k) == getattr(jhard, k), k
    assert hard.rotate_limit == 45.0 and not hard.scale_255
    assert not augment.weak_pipeline(IMG, "cardiac").scale_255
    assert augment.strong_pipeline(IMG, "cardiac").gray_p == 0.0
    assert augment.weak_pipeline(IMG, "cardiac").rotate_limit == \
        augment.strong_pipeline(IMG, "cardiac").rotate_limit == 0.0


@pytest.mark.parametrize("multimodal", [False, True])
def test_views_compose_recipes_and_corruption(multimodal):
    """``labeled_views`` applies the hard-eval recipe at
    ``eval_train_augment_rate`` (imaging) or ``augmentation_rate``
    (multimodal) and corrupts the rows at ``corruption_rate`` only when
    multimodal; ``weak_strong_views`` corrupts the weak rows at 0.1 and
    the strong ones at ``corruption_rate`` (multimodal), and adds a
    second strong view on request."""
    name = "config_dvm_MultiFreeMatch" if multimodal \
        else "config_dvm_FreeMatch"
    cfg = match_cfg(load_config, name, "augmentation_rate=0.0",
                    "eval_train_augment_rate=0.0", "corruption_rate=0.5",
                    field_lengths=(3,) * 4 + (1,) * 16)
    algo = FreeMatch(cfg, cfg.field_lengths, dtype=torch.float32,
                     device="cpu")
    algo._prepare_views()
    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.randint(0, 256, (6, 40, 40, 3),
                                        dtype=np.uint8))
    tab = torch.from_numpy(rng.rand(6, 20).astype(np.float32))
    marginal = torch.from_numpy(rng.rand(9, 20).astype(np.float32) + 2)
    gen = torch.Generator().manual_seed(0)
    img_x, tab_x = algo.labeled_views(gen, imgs, tab, marginal)
    # rate 0: every row gets the resize-only view
    assert torch.equal(img_x, augment.default_pipeline(IMG, "dvm")(imgs))
    changed = lambda t: (t != tab).sum(1)  # noqa: E731
    assert changed(tab_x).tolist() == [10 if multimodal else 0] * 6
    w, s, s2 = algo.weak_strong_views(gen, imgs, tab, marginal,
                                      two_strong=True)
    for view in (w, s, s2):
        assert view[0].shape == (6, IMG, IMG, 3)
    assert changed(w[1]).tolist() == [2 if multimodal else 0] * 6
    assert changed(s[1]).tolist() == [10 if multimodal else 0] * 6
    assert not torch.equal(s[0], s2[0])
    _, _, none = algo.weak_strong_views(gen, imgs, tab, marginal)
    assert none == (None, None)


def test_dataset_indices():
    idx = torch.tensor([2, 0])
    assert dataset_indices({}, idx) is idx
    cache = {"index": torch.tensor([7, 5, 9])}
    assert dataset_indices(cache, idx).tolist() == [9, 7]


# ---- the nets -------------------------------------------------------------

def _tabular(b, seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate([np.stack([rng.randint(0, c, b) for c in FL[:3]],
                                    1), rng.randn(b, 3)], 1)


# (net, tabular width): the transformer at 16 against a fusion width of
# 32 takes tabular_proj, at 32 it does not
NETS = [("imaging", None), ("multimodal", 16), ("multimodal", 32)]


def _nets(kind, tab_dim, dtype):
    if kind == "imaging":
        return (jmc.ImagingNet(encoder="resnet18", num_classes=C,
                               projection_dim=8, dtype=jnp.float64),
                ImagingNet("resnet18", C, projection_dim=8,
                           dtype=dtype).to(dtype))
    kw = dict(field_lengths=tuple(FL), num_classes=C, projection_dim=8,
              tabular_embedding_dim=tab_dim, multimodal_embedding_dim=32,
              tabular_num_layers=1)
    return (jmc.MatchMultimodalNet(encoder="resnet18", dtype=jnp.float64,
                                   **kw),
            MatchMultimodalNet("resnet18", dtype=dtype, **kw).to(dtype))


def _target(jnet):
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda: jnet.init(
        {"params": key, "dropout": key}, jnp.zeros((2, IMG, IMG, 3)),
        jnp.zeros((2, len(FL))), train=False))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float64),
                                  dict(shapes))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind,tab_dim", NETS)
def test_net_forward_matches_jax(kind, tab_dim, train):
    """Logits and the unit embedding of six rows, and in train mode the
    BatchNorm running statistics."""
    jnet, port = _nets(kind, tab_dim, F64)
    torch.manual_seed(0)
    with torch.no_grad():
        for p in port.parameters():
            p.normal_(0, 0.2)
    img = np.random.RandomState(1).rand(6, IMG, IMG, 3)
    tab = _tabular(6)
    with x64():
        sd = {k: v.numpy() for k, v in port.state_dict().items()}
        variables, _ = jconvert.convert_torch_state_dict(sd, _target(jnet))
        # jitted: an eager apply compiles the net op by op
        want, mut = jax.jit(lambda v, i, t: jnet.apply(
            v, i, t, train=train, mutable=["batch_stats"]))(
                variables, jnp.asarray(img), jnp.asarray(tab))
    port.train(train)
    with torch.no_grad():
        got = port(as_torch(img), as_torch(tab))
    assert len(got) == 2
    for name, g, w in zip(("logits", "embedding"), got, want):
        assert g.shape == w.shape and g.dtype == F64, name
        assert_close(g, np.asarray(w), 1e-8, 1e-9, name)
    assert_close(got[1].norm(dim=1), np.ones(6), 1e-12, 0)
    if train:
        stats = convert.state_dict_from_jax(variables["params"],
                                            to_numpy(mut["batch_stats"]))
        n = 0
        for k, v in port.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert_close(v, stats[k].numpy(), 1e-8, 1e-12, k)
                n += 1
        assert n == 2 * 20   # resnet18's 20 BatchNorms


@pytest.mark.parametrize("kind,tab_dim", NETS)
def test_converter_matches_jax_exporter(kind, tab_dim):
    """``export_state_dict`` of the net's JAX tree equals
    ``export_torch_state_dict`` key for key (in order) and value for
    value, and loads strictly into the port's net; the EMA tree of a JAX
    ``MatchState`` (the whole net's) loads strictly into the port's
    teacher."""
    jnet, port = _nets(kind, tab_dim, torch.float32)
    rng = np.random.RandomState(9)
    tree = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), _target(jnet))
    ours = convert.export_state_dict(tree["params"], tree["batch_stats"])
    ref = jconvert.export_torch_state_dict(tree)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), k)
    pre = "" if kind == "imaging" else "model."
    heads = (["classifier.weight", "backbone.conv1.weight"]
             if kind == "imaging" else
             ["classifier_multimodal.weight", "image_proj.weight",
              "encoder_imaging.conv1.weight"])
    for k in heads + ["head.0.weight", "head.2.bias"]:
        assert pre + k in ours, k
    assert ("model.tabular_proj.weight" in ours) == (tab_dim == 16)
    port.load_state_dict(convert.state_dict_from_jax(
        tree["params"], tree["batch_stats"]), strict=True)
    assert set(port.state_dict()) == set(ref)
    assert isinstance(image_tower(port), torch.nn.Module)

    class JState:   # the fields train_state_from_jax reads
        params, batch_stats = tree["params"], tree["batch_stats"]
        ema_params, ema_batch_stats = tree["params"], tree["batch_stats"]
        extra, da = {"time_p": np.float32(0.3), "ptr": np.int32(5)}, None

    carried = convert.train_state_from_jax(JState)
    ema_source(port).load_state_dict(carried["ema"], strict=True)
    assert carried["extra"]["ptr"] == 5
    assert isinstance(carried["extra"]["time_p"], torch.Tensor)
