"""The rest of the image-encoder zoo (``models/resnet.py``,
``models/vit.py``), the grouped int8 convolution, TIP's cross-attention
modules and attention capture of the port against the JAX package, on
the CPU at float64 and small sizes.

- every name JAX's ``image_encoder`` resolves: the port's ``state_dict``
  keys and shapes equal JAX's export of the same net (the JAX shapes from
  ``jax.eval_shape`` of the init, broadcast zeros for values; the port's
  tower built on the meta device);
- a grouped (ResNeXt, 32 groups) and a wide ``Bottleneck`` ResNet at
  depth (1, 1, 1, 1): every feature map in train and eval mode, the new
  running statistics, and the grouped tower's int8 eval forward;
- a small ViT (d = 32, depth 2, 4 heads, patch 8, 32² images): the
  [CLS] embedding and the patch grid;
- ``quant_conv2d_plain`` with 32 groups bitwise equal to
  ``quant_conv_apply(groups=32)``, and the card route's grouped im2col
  and per-group GEMMs (``torch._int_mm`` runs on the CPU too) bitwise
  equal to the plain sums;
- the cross-attention ``Block``, ``MultimodalTransformerEncoder``,
  ``TabularPredictor``, ``capture_attention`` and
  ``attention_gradients``;
- a STiL train step on a ViT-backed net (the small ViT above under the
  name ``vit_small`` on both sides), the file's one JAX step compile;
- the ViT refusals (``teacher_int8``, int8 serving) and BN-adapt, Tent,
  EATA and SAR on a ViT-backed net, which change nothing on either side.

Tolerances: float64 sums in two orders, rtol 1e-9 (forwards) and the
train-step test's own (``tests/test_torch_train_step.py``); the int8
conv and the attention maps' structure exactly. JAX is imported inside
the CPU tests only: the ``gpu`` tests at the end run on the card's
machine, which has no JAX (``python -m pytest --noconftest -m gpu
tests/test_torch_model_zoo.py``)."""

import types

import numpy as np
import pytest
import torch

from stil_tta_torch.models import resnet as port_resnet
from stil_tta_torch.models import vit as port_vit
from stil_tta_torch.ops import quant_conv as qc
from stil_tta_torch.ops.batch_norm import BatchNorm2d

ZOO = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
       "resnext50_32x4d", "resnext101_32x8d", "wide_resnet50_2",
       "wide_resnet101_2", "vit_small", "vit_base"]
IMG = 32
F64 = torch.float64
RTOL, ATOL = 1e-9, 1e-11
TINY_VIT = dict(embedding_dim=32, depth=2, num_heads=4, patch_size=8)
# the ViT tower of the STiL-net tests: one block (the forward test above
# holds the depth-2 chain), so their JAX traces stay short
NET_VIT = dict(TINY_VIT, depth=1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test (``tests/torch_parity.py``'s fixture,
    defined here: that module imports JAX, which the card's machine
    lacks)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _zeros_like_init(module, *args, **kw):
    """The JAX variables of ``module`` as broadcast float64 zeros, from
    ``jax.eval_shape`` of its init (no weights are drawn)."""
    import jax
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda *a: module.init(
        {"params": key, "dropout": key}, *a, **kw), *args)
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float64), s.shape),
        dict(shapes))


def _to_jax(port_module, target):
    """The port module's weights as a JAX variable tree shaped as
    ``target`` (the JAX package's own converter)."""
    import jax.numpy as jnp
    import jax
    from stil_tta_tpu.train.convert import convert_torch_state_dict
    sd = {k: v.detach().numpy() for k, v in port_module.state_dict().items()}
    variables, _ = convert_torch_state_dict(sd, target)
    return jax.tree_util.tree_map(jnp.asarray, variables)


def _init_apply(module, args, *calls):
    """Float64 variables of ``module`` (a jitted init with key 0) and the
    jitted ``module.apply`` for each ``(args, kwargs)`` of ``calls``
    (a jitted init and apply cost a third of eager ones)."""
    import jax
    import jax.numpy as jnp
    from tests.torch_parity import to_numpy
    key = jax.random.key(0)
    variables = to_numpy(dict(jax.jit(lambda *a: module.init(
        {"params": key, "dropout": key}, *a))(*map(jnp.asarray, args))),
        np.float64)
    outs = []
    for a, kw in calls:
        outs.append(jax.jit(lambda v, *x: module.apply(v, *x, **kw))(
            variables, *map(jnp.asarray, a)))
    return variables, outs


def _randomize(module, seed):
    """Seeded random values in every parameter and BN statistic."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            else:
                fan = t[0].numel() if t.dim() > 1 else 1
                t.copy_(torch.randn(t.shape, generator=gen) / fan ** 0.5)
    return module


def _images(b=2, seed=0):
    return np.random.RandomState(seed).rand(b, IMG, IMG, 3)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


# ---- the zoo's layouts -----------------------------------------------------

@pytest.mark.parametrize("name", ZOO)
def test_zoo_state_dict_layout_matches_jax_export(name):
    """Keys and shapes of the port's tower equal JAX's torch export (the
    grouped kernels (O, I/g, kh, kw), ViT's patch-embedding bias, tokens
    and ``transformer_blocks.{i}``), and so do the port converter's."""
    import jax.numpy as jnp
    from stil_tta_tpu.models.resnet import image_encoder as jax_encoder
    from stil_tta_tpu.train.convert import export_torch_state_dict
    from stil_tta_torch.train.convert import export_state_dict
    tree = _zeros_like_init(
        jax_encoder(name, return_all_feature_maps=True, dtype=jnp.float32),
        jnp.zeros((1, IMG, IMG, 3)))
    want = {k: np.shape(v) for k, v in export_torch_state_dict(tree).items()}
    ported = export_state_dict(tree["params"], tree.get("batch_stats", {}))
    assert {k: np.shape(v) for k, v in ported.items()} == want
    with torch.device("meta"):
        tower = port_resnet.image_encoder(name, return_all_feature_maps=True,
                                          img_size=IMG)
    assert {k: tuple(v.shape) for k, v in tower.state_dict().items()} == want
    assert port_resnet.EMBEDDING_DIM[name] == (
        tower.norm.weight.shape[0] if name.startswith("vit")
        else tower.layer4[-1].conv3.out_channels
        if hasattr(tower.layer4[-1], "conv3")
        else tower.layer4[-1].conv2.out_channels)


def test_unknown_encoder_names_raise_as_in_jax():
    from stil_tta_tpu.models.resnet import image_encoder as jax_encoder
    for name, match in (("resnet77", "Unknown image encoder"),
                        ("vit_huge", "Unknown ViT variant")):
        with pytest.raises(ValueError, match=match):
            jax_encoder(name)
        with pytest.raises(ValueError, match=match):
            port_resnet.image_encoder(name)


# ---- grouped and wide Bottleneck ResNets --------------------------------

@pytest.mark.parametrize("kind", ["resnext", "wide"])
def test_bottleneck_variants_match_jax(kind):
    """Depth (1, 1, 1, 1): ResNeXt's 32 groups of width 4 and the wide
    net's width_per_group 128. Train mode: the five feature maps and the
    new running statistics; eval mode: the feature maps; the ResNeXt
    tower's int8 eval forward too (its grouped int8 convs)."""
    import jax
    import jax.numpy as jnp
    from stil_tta_tpu.models import resnet as jr
    from tests.torch_parity import jnp64, x64
    kw = ({"groups": 32, "width_per_group": 4} if kind == "resnext"
          else {"width_per_group": 128})
    torch.manual_seed(0)
    port = _randomize(port_resnet.ResNet(
        port_resnet.Bottleneck, (1, 1, 1, 1), return_all_feature_maps=True,
        dtype=F64, **kw).double(), 1)
    x = _images()
    with x64(), pytest.MonkeyPatch.context() as mp:
        # the int8 scales and epilogue in float64, as the port's float64
        # tower computes them (``tests/test_torch_int8.py``)
        mp.setattr(jr, "jnp", jnp64())
        jnet = jr.ResNet(block=jr.Bottleneck, layers=(1, 1, 1, 1),
                         return_all_feature_maps=True, dtype=jnp.float64,
                         **kw)
        variables = _to_jax(port, _zeros_like_init(jnet, jnp.asarray(x)))
        apply = jax.jit(jnet.apply,
                        static_argnames=("train", "int8", "mutable"))
        jtrain, mut = apply(variables, jnp.asarray(x), train=True,
                            mutable=("batch_stats",))
        jeval = apply(variables, jnp.asarray(x), train=False)
        jint8 = (apply(variables, jnp.asarray(x), train=False, int8=True)
                 if kind == "resnext" else None)
    port.eval()
    with torch.no_grad():
        for got, want in zip(port(torch.from_numpy(x)), jeval):
            _close(got, want, msg="eval")
        if jint8 is not None:
            for got, want in zip(port(torch.from_numpy(x), int8=True),
                                 jint8):
                _close(got, want, msg="int8")
        port.train()
        for got, want in zip(port(torch.from_numpy(x)), jtrain):
            _close(got, want, msg="train")
    from stil_tta_torch.train.convert import export_state_dict
    new = export_state_dict({}, jax.tree_util.tree_map(
        np.asarray, mut["batch_stats"]), with_bn_counters=False)
    sd = port.state_dict()
    assert len(new) == 2 * sum(isinstance(m, BatchNorm2d)
                               for m in port.modules())
    for k, v in new.items():
        _close(sd[k], v, msg=k)


# ---- ViT -------------------------------------------------------------------

@pytest.mark.parametrize("grid", [False, True])
def test_vit_matches_jax(grid):
    """The [CLS] embedding, or the (B, 4, 4, 32) patch grid."""
    import jax
    import jax.numpy as jnp
    from stil_tta_tpu.models import vit as jvit
    from tests.torch_parity import x64
    port = _randomize(port_vit.ViT(return_all_feature_maps=grid,
                                   img_size=IMG, dtype=F64,
                                   **TINY_VIT).double(), 2)
    x = _images(3)
    with x64():
        jnet = jvit.ViT(return_all_feature_maps=grid, dtype=jnp.float64,
                        **TINY_VIT)
        want = jax.jit(jnet.apply)(_to_jax(port, _zeros_like_init(
            jnet, jnp.asarray(x))), jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 1
    assert got[0].shape == ((3, 4, 4, 32) if grid else (3, 32))
    _close(got[0], want[0])


# ---- the grouped int8 convolution -----------------------------------------

@pytest.mark.parametrize("shape", [
    # (B, H, Cin, Cout, k, stride, pad): ResNeXt's grouped 3x3 convs
    (2, 8, 128, 128, 3, 1, 1), (2, 8, 256, 256, 3, 2, 1),
    (1, 5, 64, 64, 3, 1, 1)])
def test_grouped_int8_conv_matches_jax_bitwise(shape):
    """bf16 x, float32 w, 32 groups (K = 36, N = 4 a group at 128
    channels): the plain route equals ``quant_conv_apply(groups=32)``
    bit for bit in bf16 and float32; the card route's grouped im2col and
    its per-group integer GEMMs give the plain route's s32 sums."""
    import jax.numpy as jnp
    from stil_tta_tpu.models.resnet import quant_conv_apply
    b, h, cin, cout, k, s, p = shape
    g = 32
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(b, h, h, cin).astype(np.float32)
    w = (rng.randn(k, k, cin // g, cout) * 0.1).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    for out in ("bfloat16", "float32"):
        want = np.asarray(quant_conv_apply(
            xb, jnp.asarray(w), s, p, getattr(jnp, out), groups=g)
            .astype(jnp.float32))
        got = qc.quant_conv2d_plain(xt, wt, s, p, getattr(torch, out), g)
        assert np.array_equal(got.float().permute(0, 2, 3, 1).numpy(),
                              want), out
    x_q, w_q, _, _ = qc.quantize(xt, wt)
    assert torch.equal(qc.int8_conv_card(x_q, w_q, s, p, g),
                       qc.int8_conv_plain(x_q, w_q, s, p, g))


# ---- TIP's transformer modules and attention capture ----------------------

def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape)


def test_cross_attention_block_matches_jax():
    """The pre-norm block with ``cross_norm`` and cross-attention over the
    encoder states; with ``return_attn`` the self-attention map."""
    import jax.numpy as jnp
    from stil_tta_tpu.models import layers as jl
    from stil_tta_torch.models.layers import Block
    from tests.torch_parity import load_port, x64
    x, enc = _rand(2, 5, 32), _rand(2, 7, 32, seed=1)
    with x64():
        jblock = jl.Block(num_heads=4, is_cross_attention=True,
                          qkv_bias=True, dtype=jnp.float64)
        v, [(want, wmap)] = _init_apply(jblock, (x, enc),
                                        ((x, enc), {"return_attn": True}))
    port = load_port(Block(32, num_heads=4, qkv_bias=True, dtype=F64,
                           is_cross_attention=True).double(), v).eval()
    with torch.no_grad():
        got, gmap = port(torch.from_numpy(x),
                         encoder_hidden_states=torch.from_numpy(enc),
                         return_attn=True)
    _close(got, want)
    _close(gmap, wmap)
    with pytest.raises(ValueError, match="encoder_hidden_states"):
        port(torch.from_numpy(x))


def test_multimodal_encoder_and_predictor_match_jax():
    """``MultimodalTransformerEncoder`` (a (B, H, W, C) image map, the
    tabular projection) and ``TabularPredictor`` (float32 heads on both
    sides: float32 rounding, rtol 1e-6)."""
    import jax.numpy as jnp
    from stil_tta_tpu.models import tabular_transformer as jtt
    from stil_tta_torch.models.tabular_transformer import (
        MultimodalTransformerEncoder, TabularPredictor)
    from tests.torch_parity import load_port, x64
    tab, img = _rand(2, 6, 24), _rand(2, 2, 2, 48, seed=1)
    tokens = _rand(2, 7, 32, seed=2)
    with x64():
        jenc = jtt.MultimodalTransformerEncoder(
            embedding_dim=48, multimodal_embedding_dim=32,
            tabular_embedding_dim=24, num_layers=2, dtype=jnp.float64)
        venc, [want] = _init_apply(jenc, (tab, img), ((tab, img), {}))
        jpred = jtt.TabularPredictor(cat_lengths=(5, 4, 2),
                                     con_lengths=(1, 1, 1))
        vpred, [(want_cat, want_con)] = _init_apply(
            jpred, (tokens,), ((tokens,), {}))
    enc = load_port(MultimodalTransformerEncoder(
        48, 32, 24, num_layers=2, dtype=F64).double(), venc).eval()
    pred = load_port(TabularPredictor((5, 4, 2), (1, 1, 1), 32).double(),
                     vpred)
    with torch.no_grad():
        _close(enc(torch.from_numpy(tab), torch.from_numpy(img)), want)
        cat, con = pred(torch.from_numpy(tokens))
    assert cat.shape == (2, 3, 11) and con.shape == (2, 3, 1)
    _close(cat, want_cat, 1e-6, 1e-7)
    _close(con, want_con, 1e-6, 1e-7)


def test_attention_capture_and_gradients_match_jax():
    """``capture_attention``: the tokens and each block's map (rows sum
    to 1, masked columns 0; JAX's ``capture_attention`` is its encoder's
    ``return_attn`` apply); ``attention_gradients``: the gradient of the
    CLS-sum with respect to each map."""
    import jax
    import jax.numpy as jnp
    from stil_tta_tpu.models import tabular_transformer as jtt
    from stil_tta_tpu.utils import profiling as jprof
    from stil_tta_torch.models.tabular_transformer import \
        TabularTransformerEncoder
    from stil_tta_torch.utils import profiling
    from tests.torch_parity import load_port, x64
    rng = np.random.RandomState(4)
    x = np.concatenate([rng.randint(0, 4, (3, 2)), rng.randn(3, 2)], 1)
    missing = np.zeros((3, 4), bool)
    missing[0, 1] = missing[2, 3] = True
    with x64():
        jenc = jtt.TabularTransformerEncoder(
            cat_lengths=(5, 4), con_lengths=(1, 1), embedding_dim=32,
            num_layers=2, dtype=jnp.float64)
        v, [(jtok, jmaps)] = _init_apply(
            jenc, (x,), ((x, missing), {"return_attn": True}))
        jgrads = jax.jit(lambda v, x, m: jprof.attention_gradients(
            jenc, v, x, lambda t: t[:, 0, :].sum(), m))(
            v, jnp.asarray(x), jnp.asarray(missing))
    enc = load_port(TabularTransformerEncoder(
        (5, 4), (1, 1), embedding_dim=32, num_layers=2, dtype=F64).double(),
        v).eval()
    xt, mt = torch.from_numpy(x), torch.from_numpy(missing)
    tok, maps = profiling.capture_attention(enc, xt, mt)
    _close(tok, jtok)
    assert len(maps) == len(jmaps) == 2 and maps[0].shape == (3, 8, 5, 5)
    for got, want in zip(maps, jmaps):
        _close(got, want)
    np.testing.assert_allclose(maps[0].sum(-1).detach().numpy(), 1.0,
                               rtol=1e-12)
    assert bool((maps[1][0, :, 0, 2] == 0).all())    # a missing column
    grads = profiling.attention_gradients(enc, xt,
                                          lambda t: t[:, 0, :].sum(), mt)
    assert len(grads) == 2 and all(p.grad is None for p in enc.parameters())
    for got, want in zip(grads, jgrads):
        _close(got, want, 1e-8, 1e-12)
    assert float(grads[0].abs().sum()) > 0


# ---- a ViT-backed STiL net ------------------------------------------------

@pytest.fixture
def tiny_vit(monkeypatch):
    """``vit_small`` is the small ViT on both sides."""
    from stil_tta_tpu.models import vit as jvit
    monkeypatch.setattr(jvit, "vit_small",
                        lambda **kw: jvit.ViT(**NET_VIT, **kw))
    monkeypatch.setattr(port_vit, "vit_small",
                        lambda **kw: port_vit.ViT(**NET_VIT, **kw))
    monkeypatch.setitem(port_resnet.EMBEDDING_DIM, "vit_small", 32)


def test_vit_stil_train_step_matches_jax(tiny_vit):
    """One STiL step at epoch 1 (the pseudo-label losses on) on a
    ViT-backed net, as ``tests/test_torch_train_step.py`` holds the
    ResNet-backed one: the losses, the student and EMA weights, the
    prototype sums and DA ring; no BN kernel runs."""
    import jax
    import jax.numpy as jnp
    from stil_tta_torch.algorithms.stil import STiL
    from stil_tta_torch.config import load_config
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    from stil_tta_torch.train.convert import (load_train_state,
                                              train_state_from_jax)
    from stil_tta_tpu.algorithms.stil import STiL as JaxSTiL
    from stil_tta_tpu.config import load_config as jax_load_config
    from stil_tta_tpu.models import backbones as jbackbones
    from tests import test_torch_train_step as ts
    from tests.torch_parity import x64

    def cfg_of(loader):
        cfg = ts._cfg(loader)
        cfg.model = "vit_small"
        return cfg

    def dropfree(**kw):
        kw.update(attn_drop=0.0, proj_drop=0.0, drop_path=0.0)
        return real_layer(**kw)

    real_layer = jbackbones.MITransformerLayer
    (jcl, cl), (jcu, cu) = ts._data()
    with x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbackbones, "MITransformerLayer", dropfree)
        jalgo = JaxSTiL(cfg_of(jax_load_config), ts.FL, dtype=jnp.float64)
        jalgo._views = lambda key, il, tl, iu, tu, ml, mu: (il, tl, iu, tu)
        algo = STiL(cfg_of(load_config), ts.FL, dtype=F64, device="cpu")
        assert isinstance(algo.net.model.encoder_imaging, port_vit.ViT)
        ts._no_fusion_dropout(algo.net)
        state0 = ts._port_initial_state(algo)
        j0 = _jax_vit_state(jalgo, state0)
        carried = train_state_from_jax(j0)
        state = algo.init_state(seed=0)
        load_train_state(state, carried)
        mask = torch.tensor(ts._mask_rand(j0))
        jstate = jax.jit(jalgo.make_train_step().__wrapped__)(
            j0, jcl, jcu, jnp.arange(ts.B_L, dtype=jnp.int32),
            jnp.arange(ts.B_U, dtype=jnp.int32), jnp.asarray(1, jnp.int32))
        bn_stats.launches = bn_bwd_reduce.launches = 0
        algo.make_train_step()(state, cl, cu, torch.arange(ts.B_L),
                               torch.arange(ts.B_U), 1, mask_rand=mask)
    assert bn_stats.launches == bn_bwd_reduce.launches == 0
    assert state.step == 1 == int(jstate.step)
    ts._compare_states(jstate, state)
    # the ViT tower trained
    key = "model.encoder_imaging.pos_embed"
    assert not torch.equal(state.net.state_dict()[key],
                           carried["net"][key].double())


@pytest.mark.parametrize("model", ["vit_small", "resnext50_32x4d"])
def test_warm_start_of_zoo_encoders_matches_jax(tiny_vit, model, tmp_path,
                                                capsys):
    """``load_pretrained_encoders`` on a ViT and a ResNeXt tower, as
    ``tests/test_torch_warm_start.py`` holds the ResNet-18 one: from a
    checkpoint the port writes, both sides give every parameter and BN
    statistic bit for bit and print the same ``Loaded n/N`` lines."""
    import jax
    import jax.numpy as jnp
    from stil_tta_torch.algorithms.stil import STiL
    from stil_tta_torch.config import load_config
    from stil_tta_torch.train.convert import (export_state_dict,
                                              load_pretrained_encoders)
    from stil_tta_tpu.algorithms.stil import STiL as JaxSTiL
    from stil_tta_tpu.config import load_config as jax_load_config
    from stil_tta_tpu.train.convert import \
        load_pretrained_encoders as jax_load_encoders
    from tests import test_torch_warm_start as ws
    flags = ws.SMALL + [f"model={model}"]
    algo = STiL(load_config("config_dvm_STiL", flags), ws.FL, device="cpu")
    state = algo.init_state(seed=0)
    other = STiL(load_config("config_dvm_STiL", flags), ws.FL, device="cpu")
    ckpt = ws._pretrained(other.net.model, tmp_path / "pretrained.ckpt")
    jalgo = JaxSTiL(jax_load_config("config_dvm_STiL", flags), ws.FL)
    variables = ws._jax_variables(jalgo, algo.net, jnp, jax)
    capsys.readouterr()
    out = jax_load_encoders(variables, str(ckpt))
    jax_lines = capsys.readouterr().out
    load_pretrained_encoders(state.net, ckpt)
    assert capsys.readouterr().out == jax_lines
    assert len(jax_lines.splitlines()) == 2
    want = export_state_dict(out["params"], out.get("batch_stats", {}))
    pre = torch.load(ckpt, weights_only=True)["state_dict"]
    for k, v in state.net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue   # the JAX state keeps no BN counters
        assert np.array_equal(v.numpy(), want[k]), k
        if k.startswith("model.encoder_imaging."):
            assert torch.equal(v, pre[k[len("model."):]]), k


def _jax_vit_state(jalgo, port_state):
    """``tests/test_torch_train_step.py:_jax_state`` for a net without
    BatchNorm, whose JAX ``init_state`` holds empty ``batch_stats``."""
    import jax
    import jax.numpy as jnp
    from stil_tta_torch.algorithms.stil import LOG_KEYS
    from stil_tta_tpu.algorithms.base import DAState
    from stil_tta_tpu.algorithms.stil import STiLState
    from stil_tta_tpu.ops.metrics import accuracy_init
    from stil_tta_tpu.train.convert import convert_torch_state_dict
    from tests import test_torch_train_step as ts
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda: jalgo.net.init(
        {"params": key, "dropout": key}, jnp.zeros((2, IMG, IMG, 3)),
        jnp.zeros((2, len(ts.FL))), train=False))
    assert set(shapes) == {"params"}
    target = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float64), dict(shapes))
    sd = {k: v.numpy() for k, v in port_state.net.state_dict().items()}
    params = convert_torch_state_dict(sd, target)[0]["params"]
    sd.update({"model." + k: v.numpy()
               for k, v in port_state.ema.state_dict().items()})
    ema = convert_torch_state_dict(sd, target)[0]["params"]["backbone"]
    z = lambda *s: jnp.zeros(s, jnp.float64)  # noqa: E731
    return STiLState(
        params=params, batch_stats={}, opt_state=jalgo.tx.init(params),
        ema_params=ema, ema_batch_stats={}, rng=jax.random.key(5),
        step=jnp.zeros((), jnp.int32),
        prototypes=jnp.asarray(port_state.prototypes.numpy()),
        prototypes_sum=z(ts.C, ts.P), prototypes_count=z(ts.C, 1),
        da=DAState(z(256, ts.C), jnp.zeros((), jnp.int32)),
        acc_train=accuracy_init(), acc_train_u=accuracy_init(),
        log_sums={k: z() for k in LOG_KEYS}, log_count=z())


def test_vit_refusals_match_jax():
    """``teacher_int8`` and int8 serving refuse ``vit_small`` and
    ``vit_base`` on both sides."""
    import dataclasses
    from stil_tta_torch.algorithms.stil import STiL
    from stil_tta_torch.config import load_config
    from stil_tta_torch.serve import Predictor
    from stil_tta_tpu.algorithms.stil import STiL as JaxSTiL
    from stil_tta_tpu.config import load_config as jax_load_config
    from stil_tta_tpu.serve import Predictor as JaxPredictor
    from tests import test_torch_train_step as ts

    @dataclasses.dataclass
    class _State:
        params: dict
        batch_stats: dict

    for model in ("vit_small", "vit_base"):
        for loader, cls in ((jax_load_config, JaxSTiL),
                            (load_config, STiL)):
            cfg = ts._cfg(loader)
            cfg.model, cfg.teacher_int8 = model, True
            with pytest.raises(ValueError, match="ViT unsupported"):
                cls(cfg, ts.FL)
        jcfg = ts._cfg(jax_load_config)
        jcfg.model = model
        jalgo = JaxSTiL(jcfg, ts.FL)
        with pytest.raises(ValueError, match="ViT image encoders"):
            JaxPredictor(jalgo, _State({}, {}), int8=True)
        cfg = ts._cfg(load_config)
        cfg.model = model
        # the port's Predictor reads the net's forward and the config
        # before anything else
        with pytest.raises(ValueError, match="ViT image encoders"):
            Predictor(types.SimpleNamespace(net=_Int8Net(), cfg=cfg),
                      int8=True)


class _Int8Net(torch.nn.Module):
    def forward(self, image, tabular, int8_image: bool = False):
        return image


_JAX_TARGETS = {}


@pytest.mark.parametrize("strategy", ["bn_adapt", "tent", "eata", "sar"])
def test_tta_on_a_vit_net_changes_nothing_as_in_jax(tiny_vit, strategy):
    """A ViT tower has no BatchNorm: BN-adapt runs its batches and
    changes nothing, and Tent, EATA and SAR, whose Adam is masked to the
    BN affine leaves in JAX, leave every parameter as it was, on both
    sides; the adapted net's probabilities equal the unadapted ones."""
    import jax
    import jax.numpy as jnp
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.train.test import build_algo, load_test_split
    from stil_tta_torch.tta import adapt
    from stil_tta_tpu.algorithms.stil import STiL as JaxSTiL
    from stil_tta_tpu.data.loader import DeviceCache as JaxDeviceCache
    from stil_tta_tpu.tta import adapt as jax_adapt
    from tests.torch_tta_parity import _State, cfg_for
    from stil_tta_tpu.config import load_config as jax_load_config
    from stil_tta_torch.config import load_config

    cfg = cfg_for(load_config, strategy, tta_steps=1)
    cfg.model = "vit_small"
    src = load_test_split(cfg)
    algo = build_algo(cfg, src.field_lengths, device="cpu", dtype=F64)
    cache = DeviceCache(src, device="cpu").as_dict()
    before = {k: v.clone() for k, v in algo.net.state_dict().items()}
    step = algo.make_eval_step()
    idx = torch.arange(8)
    prob0 = step(cache, idx)["prob_m"]
    counts = adapt(cfg, algo, cache)
    assert counts["stats_batches"] == 2
    assert counts.get("steps", 0) == 0
    for k, v in algo.net.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(step(cache, idx)["prob_m"], prob0)

    jcfg = cfg_for(jax_load_config, strategy, tta_steps=1)
    jcfg.model = "vit_small"
    jalgo = JaxSTiL(jcfg, src.field_lengths, dtype=jnp.float32)
    if "vit_net" not in _JAX_TARGETS:
        # the same net for every strategy: its shapes traced once
        _JAX_TARGETS["vit_net"] = _zeros_like_init(
            jalgo.net, jnp.zeros((2, IMG, IMG, 3)),
            jnp.asarray(src.tabular[:2]), train=False)
    v = _to_jax(algo.net.float(), _JAX_TARGETS["vit_net"])
    assert "batch_stats" not in v
    out = jax_adapt(jcfg, jalgo, _State(v["params"], {}),
                    JaxDeviceCache(src).as_dict())
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)),
        out.params, v["params"]))


# ---- on the card -----------------------------------------------------------

def zoo_bn_shapes(name: str, batch: int = 512, img: int = 128) -> list:
    """(M, C) of each BatchNorm input of the ``name`` tower at ``batch``
    and ``img``², in forward order (read on the meta device)."""
    with torch.device("meta"):
        tower = port_resnet.image_encoder(name).eval()
    seen = []
    for m in tower.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_pre_hook(lambda mod, inp: seen.append(
                (batch * inp[0].shape[2] * inp[0].shape[3], inp[0].shape[1])))
    with torch.no_grad():
        tower(torch.zeros(1, img, img, 3, device="meta"))
    return seen


def test_zoo_bn_counts_and_new_shapes():
    """The BatchNorm count of each ResNet of the zoo (the kernels'
    launches a train step) and the (M, C) it adds over ResNet-50's at
    batch 512, 128² (held on the card below and in chip_smoke)."""
    shapes = {n: zoo_bn_shapes(n) for n in ZOO
              if not n.startswith(("vit", "resnet18"))}
    base = set(shapes.pop("resnet50"))
    counts = {n: len(s) for n, s in shapes.items()}
    assert counts == {"resnet34": 36, "resnet101": 104, "resnet152": 155,
                      "resnext50_32x4d": 53, "resnext101_32x8d": 104,
                      "wide_resnet50_2": 53, "wide_resnet101_2": 104}
    new = sorted({s for v in shapes.values() for s in v} - base)
    assert new == [(8192, 1024), (32768, 2048), (131072, 1024),
                   (524288, 512)]


@pytest.mark.gpu
def test_zoo_bn_shapes_match_plain_on_card():
    """Both BN kernels against their plain versions at the (M, C) the zoo
    adds, bf16 and float32 (tolerance: 1e-5 of the sums of magnitudes, as
    ``tests/test_torch_kernels.py`` and ``test_torch_bn_train.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from stil_tta_torch.ops.batch_norm import (bn_bwd_reduce,
                                               bn_bwd_reduce_plain,
                                               bn_stats, bn_stats_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rel(a, b, scale):
        return float(((a - b).abs() / scale.clamp_min(1e-30)).max())

    for dtype in (torch.bfloat16, torch.float32):
        for m, c in ((8192, 1024), (32768, 2048), (131072, 1024),
                     (524288, 512)):
            x = (torch.randn(m, c, generator=gen, device="cuda")
                 + 0.5).to(dtype)
            dy = torch.randn(m, c, generator=gen, device="cuda").to(dtype)
            s, ss = bn_stats(x)
            ps, pss = bn_stats_plain(x)
            assert rel(s, ps, x.float().abs().sum(0)) < 1e-5, (m, c)
            assert rel(ss, pss, pss) < 1e-5, (m, c)
            mean = torch.rand(c, generator=gen, device="cuda")
            inv = torch.rand(c, generator=gen, device="cuda") + 0.5
            g, gx = bn_bwd_reduce(x, dy, mean, inv)
            pg, pgx = bn_bwd_reduce_plain(x, dy, mean, inv)
            xhat = (x.float() - mean) * inv
            assert rel(g, pg, dy.float().abs().sum(0)) < 1e-5, (m, c)
            assert rel(gx, pgx, (dy.float() * xhat).abs().sum(0)) < 1e-5
            del x, dy, xhat


@pytest.mark.gpu
def test_grouped_int8_conv_on_card_matches_plain_bitwise():
    """Every grouped conv shape of ResNeXt-50 (32x4d) and ResNeXt-101
    (32x8d) at batch 8, 128²: the per-group integer GEMMs' s32 sums equal
    the float64 conv's, and the bf16 output the plain route's on the
    card and on the CPU; a CUDA tensor never takes the plain route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in ("resnext50_32x4d", "resnext101_32x8d"):
        tower = port_resnet.image_encoder(name)
        seen = set()
        for mod in tower.modules():
            if isinstance(mod, port_resnet.Conv2d) and mod.groups > 1:
                seen.add((mod.in_channels, mod.out_channels, mod.stride[0]))
        for cin, cout, s in sorted(seen):
            h = {128: 32, 256: 32, 512: 16, 1024: 8, 2048: 4}[cin]
            h = h * s if s == 2 else h
            x = torch.randn(8, cin, h, h, generator=gen, device="cuda").to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            w = torch.randn(cout, cin // 32, 3, 3, generator=gen,
                            device="cuda") * 0.05
            x_q, w_q, _, _ = qc.quantize(x, w)
            y = qc.int8_conv_card(x_q, w_q, s, 1, 32)
            assert torch.equal(y, qc.int8_conv_plain(x_q, w_q, s, 1, 32))
            got = qc.quant_conv2d(x, w, s, 1, torch.bfloat16, 32)
            assert torch.equal(got, qc.quant_conv2d_plain(
                x, w, s, 1, torch.bfloat16, 32))
            assert torch.equal(got.cpu(), qc.quant_conv2d(
                x.cpu(), w.cpu(), s, 1, torch.bfloat16, 32))
