"""The port's modules against the JAX package's, on the same weights and
inputs: ResNet image tower, tabular encoder, fusion layer, DisCoBackbone
and STiLNet, and the weight carry that moves JAX trees into the port.

Everything runs at float64 on both sides (JAX x64 inside ``x64()``): the
modules compute the same formulas, so what separates them is float64
rounding in different summation orders, and the tolerances are 1e-8
relative unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms.stil import STiLNet
from stil_tta_torch.models.backbones import OUTPUT_KEYS, DisCoBackbone
from stil_tta_torch.models.disentangle import MITransformerLayer
from stil_tta_torch.models.resnet import Bottleneck, resnet18, resnet50
from stil_tta_torch.models.tabular_transformer import \
    TabularTransformerEncoder
from stil_tta_torch.train.convert import export_state_dict
from stil_tta_tpu.algorithms.stil import STiLNet as JaxSTiLNet
from stil_tta_tpu.models import backbones as jb
from stil_tta_tpu.models import disentangle as jd
from stil_tta_tpu.models import resnet as jr
from stil_tta_tpu.models import tabular_transformer as jt
from stil_tta_tpu.train.convert import export_torch_state_dict
from tests.torch_parity import (as_torch, assert_close, init_jax, load_port,
                                to_numpy, x64)
from tests.torch_parity import one_torch_thread  # noqa: F401

F64 = torch.float64
FIELD_LENGTHS = (5, 4, 2, 1, 1, 1)


def _images(seed, b, size):
    return np.random.RandomState(seed).rand(b, size, size, 3)


def _tabular(seed, b, field_lengths=FIELD_LENGTHS):
    rng = np.random.RandomState(seed)
    cat = [rng.randint(0, f, b) for f in field_lengths if f > 1]
    ncon = sum(1 for f in field_lengths if f == 1)
    return np.concatenate([np.stack(cat, 1), rng.randn(b, ncon)], 1)


def _tower_parity(jax_tower, port_tower, x, train):
    with x64():
        variables = init_jax(jax_tower, jnp.asarray(x), train=False)
        if train:
            jfeats, mut = jax_tower.apply(variables, jnp.asarray(x),
                                          train=True,
                                          mutable=["batch_stats"])
            stats = to_numpy(mut["batch_stats"])
        else:
            jfeats = jax_tower.apply(variables, jnp.asarray(x), train=False)
            stats = variables["batch_stats"]
    port = load_port(port_tower.to(F64), variables).train(train)
    with torch.no_grad():
        feats = port(as_torch(x))
    assert len(feats) == len(jfeats)
    for i, (f, jf) in enumerate(zip(feats, jfeats)):
        assert tuple(f.shape) == jf.shape
        assert_close(f, np.asarray(jf), 1e-8, 1e-9, f"feature map {i}")
    # train mode: the running statistics after one update
    port_sd = port.state_dict()
    for k, v in export_state_dict({}, stats).items():
        if not k.endswith("num_batches_tracked"):
            assert_close(port_sd[k], v, 1e-8, 1e-10, k)


@pytest.mark.parametrize("train", [True, False])
def test_resnet18_matches_jax(train):
    _tower_parity(jr.resnet18(return_all_feature_maps=True,
                              dtype=jnp.float64),
                  resnet18(return_all_feature_maps=True, dtype=F64),
                  _images(0, 4, 32), train)


def test_resnet18_pooled_output_matches_jax():
    _tower_parity(jr.resnet18(dtype=jnp.float64), resnet18(dtype=F64),
                  _images(1, 2, 32), False)


@pytest.mark.slow
@pytest.mark.parametrize("train", [True, False])
def test_resnet50_matches_jax(train):
    _tower_parity(jr.resnet50(return_all_feature_maps=True,
                              dtype=jnp.float64),
                  resnet50(return_all_feature_maps=True, dtype=F64),
                  _images(2, 2, 64), train)


@pytest.mark.parametrize("train", [True, False])
def test_bottleneck_with_downsample_matches_jax(train):
    x = np.random.RandomState(3).randn(2, 8, 8, 32)
    with x64():
        block = jr.Bottleneck(planes=16, stride=2, downsample=True,
                              dtype=jnp.float64)
        variables = init_jax(block, jnp.asarray(x), False)
        y, mut = block.apply(variables, jnp.asarray(x), train,
                             mutable=["batch_stats"])
    port = load_port(Bottleneck(32, 16, 2, True).to(F64),
                     variables).train(train)
    with torch.no_grad():
        out = port(as_torch(x).permute(0, 3, 1, 2))
    assert_close(out.permute(0, 2, 3, 1), np.asarray(y), 1e-8, 1e-9)
    if train:
        sd = port.state_dict()
        for k, v in export_state_dict({}, to_numpy(
                mut["batch_stats"])).items():
            if "num_batches" not in k:
                assert_close(sd[k], v, 1e-8, 1e-10, k)


@pytest.mark.parametrize("masked", [False, True])
def test_tabular_encoder_matches_jax(masked):
    b = 5
    tab = _tabular(4, b)
    missing = np.random.RandomState(5).rand(b, len(FIELD_LENGTHS)) < 0.4
    cat, con = jt.split_field_lengths(FIELD_LENGTHS)
    kw = {"missing_mask": jnp.asarray(missing)} if masked else {}
    with x64():
        enc = jt.TabularTransformerEncoder(
            cat_lengths=cat, con_lengths=con, embedding_dim=32,
            num_layers=2, dtype=jnp.float64)
        variables = init_jax(enc, jnp.asarray(tab))
        y = enc.apply(variables, jnp.asarray(tab), **kw)
    port = load_port(TabularTransformerEncoder(
        cat, con, embedding_dim=32, num_layers=2, dtype=F64).to(F64),
        variables).eval()
    with torch.no_grad():
        out = port(as_torch(tab), as_torch(missing) if masked else None)
    assert_close(out, np.asarray(y), 1e-8, 1e-9)


def test_mi_transformer_layer_matches_jax():
    rng = np.random.RandomState(6)
    xs = [rng.randn(3, n, 32) for n in (4, 7, 1)]
    with x64():
        layer = jd.MITransformerLayer(num_heads=4, mlp_ratio=1.0,
                                      qkv_bias=True, attn_drop=0.1,
                                      proj_drop=0.1, drop_path=0.1,
                                      dtype=jnp.float64)
        variables = init_jax(layer, *map(jnp.asarray, xs))
        ys = layer.apply(variables, *map(jnp.asarray, xs),
                         deterministic=True)
    port = load_port(MITransformerLayer(
        32, num_heads=4, mlp_ratio=1.0, qkv_bias=True, attn_drop=0.1,
        proj_drop=0.1, drop_path=0.1, dtype=F64).to(F64), variables).eval()
    with torch.no_grad():
        outs = port(*map(as_torch, xs))
    for o, y in zip(outs, ys):
        assert_close(o, np.asarray(y), 1e-8, 1e-9)


def _tiny_net_kw():
    return dict(field_lengths=FIELD_LENGTHS, num_classes=4,
                tabular_embedding_dim=32, multimodal_embedding_dim=32,
                tabular_num_layers=1)


def test_disco_backbone_all_outputs_match_jax():
    img, tab = _images(7, 3, 32), _tabular(7, 3)
    with x64():
        net = jb.DisCoBackbone(model="resnet18", dtype=jnp.float64,
                               **_tiny_net_kw())
        variables = init_jax(net, jnp.asarray(img), jnp.asarray(tab),
                             train=False)
        y = net.apply(variables, jnp.asarray(img), jnp.asarray(tab),
                      train=False)
    port = load_port(DisCoBackbone("resnet18", dtype=F64,
                                   **_tiny_net_kw()).to(F64),
                     variables).eval()
    with torch.no_grad():
        out = port(as_torch(img), as_torch(tab))
    assert set(out) == set(OUTPUT_KEYS) == set(y)
    for k in OUTPUT_KEYS:
        assert_close(out[k], np.asarray(y[k]), 1e-8, 1e-9, k)


def _jax_stil_net(dtype, target="dvm"):
    return JaxSTiLNet(encoder="resnet18", projection_dim=8, dtype=dtype,
                      target=target, **_tiny_net_kw())


@pytest.mark.parametrize("target", ["dvm", "cardiac"])
def test_stilnet_all_outputs_match_jax(target):
    """DVM has linear ITC projectors, other targets SimCLR heads."""
    img, tab = _images(8, 3, 32), _tabular(8, 3)
    with x64():
        net = _jax_stil_net(jnp.float64, target)
        variables = init_jax(net, jnp.asarray(img), jnp.asarray(tab),
                             train=False)
        y = net.apply(variables, jnp.asarray(img), jnp.asarray(tab),
                      train=False)
    port = load_port(STiLNet("resnet18", projection_dim=8, dtype=F64,
                             target=target, **_tiny_net_kw()).to(F64),
                     variables).eval()
    with torch.no_grad():
        out = port(as_torch(img), as_torch(tab))
    assert set(out) == set(y)
    for k in y:
        assert_close(out[k], np.asarray(y[k]), 1e-8, 1e-9, k)


def test_weight_carry_equals_export_torch_state_dict():
    """The port's converter equals the JAX package's exporter key for key
    and value for value, and loads into the port's STiLNet strictly."""
    img, tab = _images(9, 2, 32), _tabular(9, 2)
    net = _jax_stil_net(jnp.float32)
    # the tree's shapes from an abstract init, filled with seeded values
    shapes = jax.eval_shape(lambda: net.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)},
        jnp.asarray(img), jnp.asarray(tab), train=False))
    rng = np.random.RandomState(9)
    variables = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(s.dtype), dict(shapes))
    ours = export_state_dict(variables["params"], variables["batch_stats"])
    ref = export_torch_state_dict(variables)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), k)
    port = STiLNet("resnet18", projection_dim=8, dtype=torch.float32,
                   **_tiny_net_kw())
    load_port(port, variables)
    assert set(port.state_dict()) == set(ref)
