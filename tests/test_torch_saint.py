"""STiL_SAINT's modules and test-time path against the JAX package's: the
SAINT encoder, the converter's SAINT paths (against both JAX exporters),
``checkpoint_SAINT``, the STiL_SAINT eval forward, and the test entry
point (BN-adapt, then scoring with a ragged tail batch) and ``Predictor``
from a full-model checkpoint; then the refusals of this slice.

Sizes as ``tests/test_torch_slice.py``: ``resnet18`` on 32x32 images,
field lengths (5, 4, 2, 1, 1, 1), float64 on both sides (JAX x64 inside
``x64()``), SAINT's feed-forward dropout at 0. Module tolerances: rtol
1e-8, atol 1e-9 (float64 in two summation orders). The test entry point
and ``Predictor``: rtol 2e-6, as ``tests/test_torch_slice.py`` states for
the float32 resize transform both sides run."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms.registry import get_algorithm
from stil_tta_torch.algorithms.stil import STiL_SAINT, STiLNet, init_weights
from stil_tta_torch.config import load_config
from stil_tta_torch.data.loader import DeviceCache
from stil_tta_torch.models.saint import SAINTEncoder
from stil_tta_torch.serve import Predictor
from stil_tta_torch.train import convert
from stil_tta_torch.train.evaluate import evaluate
from stil_tta_torch.train.test import build_algo, load_test_split
from stil_tta_torch.train.test import test as run_test
from stil_tta_torch.tta import adapt
from stil_tta_tpu.algorithms.stil import STiL_SAINT as JaxSTiL_SAINT
from stil_tta_tpu.algorithms.stil import STiLNet as JaxSTiLNet
from stil_tta_tpu.config import load_config as jax_load_config
from stil_tta_tpu.data.datasets import load_sources as jax_load_sources
from stil_tta_tpu.data.loader import DeviceCache as JaxDeviceCache
from stil_tta_tpu.models.saint import SAINTEncoder as JaxSAINTEncoder
from stil_tta_tpu.train import convert as jconvert
from stil_tta_tpu.train.evaluate import run_validation as jax_run_validation
from stil_tta_tpu.tta import adapt as jax_adapt
from tests.torch_parity import as_torch, assert_close, to_numpy, x64
from tests.torch_parity import one_torch_thread  # noqa: F401

F64 = torch.float64
FL = [5, 4, 2, 1, 1, 1]
CATS, NCON = (5, 4, 2), 3
OVERRIDES = [
    "dataset=synthetic_dvm", "models=resnet18", "batch_size=8",
    "img_size=32", "synthetic_image_size=40", "synthetic_test=20",
    "num_classes=4", "tabular_embedding_dim=32",
    "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
    "projection_dim=8", "test=True", "tta=True", "tta_strategy=bn_adapt",
    "enable_progress_bar=false", "saint_ff_dropout=0",
]
NET_KW = dict(field_lengths=tuple(FL), num_classes=4, projection_dim=8,
              tabular_embedding_dim=32, multimodal_embedding_dim=32,
              tabular_num_layers=1, tabular_encoder="saint",
              saint_ff_dropout=0.0)
# SAINT entries of a reference checkpoint its forward never reads
INERT = ("model.encoder_tabular.mlp1.layers.0.weight",
         "model.encoder_tabular.categories_offset", "model.cls_token")


def _tabular(seed, b):
    rng = np.random.RandomState(seed)
    cat = [rng.randint(0, c, b) for c in CATS]
    # one category past its column's cardinality: SAINT clamps it
    cat[0][0] = CATS[0] + 2
    return np.concatenate([np.stack(cat, 1), rng.randn(b, NCON)], 1)


def _seeded_variables(module, state_dict, *args, **kw):
    """A JAX variable tree (float64 numpy) holding a seeded port
    ``state_dict``, through the JAX package's converter: no JAX init to
    compile (an eager ResNet init takes tens of seconds on the CPU)."""
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": key, "dropout": key}, *args, **kw))
    target = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float64), dict(shapes))
    sd = {k: v.detach().numpy() for k, v in state_dict.items()}
    if "batch_stats" in target:
        return jconvert.convert_torch_state_dict(sd, target)[0]
    return jconvert.load_saint_state_dict(target, sd)[0]


def _cfg(loader, **extra):
    cfg = loader("config_dvm_STiL_SAINT", OVERRIDES
                 + [f"{k}={v}" for k, v in extra.items()])
    cfg.field_lengths = list(FL)
    return cfg


@pytest.fixture(scope="module")
def jax_encoder():
    """Seeded JAX SAINT encoder weights and its tokens of five rows
    (intersample attention mixes them), in eval and train mode."""
    x = _tabular(0, 5)
    enc = JaxSAINTEncoder(cat_lengths=CATS, num_continuous=NCON,
                          ff_dropout=0.0, dtype=jnp.float64)
    port = SAINTEncoder(CATS, NCON, dtype=F64).to(F64)
    gen = torch.Generator().manual_seed(0)
    for p in port.parameters():
        torch.nn.init.normal_(p, 0.0, 0.3, generator=gen)
    with x64():
        variables = _seeded_variables(enc, port.state_dict(), jnp.asarray(x))
        tokens = {train: np.asarray(enc.apply(
            variables, jnp.asarray(x), deterministic=not train,
            rngs={"dropout": jax.random.key(1)})) for train in (False, True)}
    return x, variables, tokens


@pytest.mark.parametrize("train", [False, True])
def test_saint_encoder_matches_jax(jax_encoder, train):
    """The encoder's tokens, the JAX weights carried by the port's SAINT
    exporter."""
    x, variables, tokens = jax_encoder
    want = tokens[train]
    port = SAINTEncoder(CATS, NCON, ff_dropout=0.0, dtype=F64).to(F64)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          convert.export_saint_state_dict(
                              variables["params"]).items()}, strict=True)
    with torch.no_grad():
        got = port.train(train)(as_torch(x))
    assert got.shape == (5, 1 + len(CATS) + NCON, 32)
    assert_close(got, np.asarray(want), 1e-8, 1e-9)


def _jax_tree(dtype=np.float32):
    """A STiL_SAINT variable tree of seeded values (abstract init)."""
    img, tab = np.zeros((2, 32, 32, 3)), _tabular(1, 2)
    net = JaxSTiLNet(encoder="resnet18", dtype=jnp.float32, **NET_KW)
    shapes = jax.eval_shape(lambda: net.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)},
        jnp.asarray(img), jnp.asarray(tab), train=False))
    rng = np.random.RandomState(9)
    return jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(dtype), dict(shapes))


def test_converter_saint_paths_equal_jax_exporters():
    """The port's export equals ``export_torch_state_dict`` key for key
    (in order) and value for value, loads strictly into the port's
    STiL_SAINT net, and its SAINT export equals
    ``export_saint_state_dict``."""
    variables = _jax_tree()
    ours = convert.export_state_dict(variables["params"],
                                     variables["batch_stats"])
    ref = jconvert.export_torch_state_dict(variables)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), k)
    assert "model.encoder_tabular.simple_MLP.2.layers.2.weight" in ours
    port = STiLNet("resnet18", dtype=torch.float32, **NET_KW)
    port.load_state_dict(convert.state_dict_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    assert set(port.state_dict()) == set(ref)
    saint = variables["params"]["backbone"]["encoder_tabular"]
    ours = convert.export_saint_state_dict(saint)
    ref = jconvert.export_saint_state_dict({"params": saint})
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), k)


def test_checkpoint_saint_pth_loads_into_the_port(jax_encoder, tmp_path):
    """A somepago/saint-layout ``.pth`` made by the JAX exporter from
    seeded JAX weights (with pretraining heads the encoder does not use)
    loads into STiL_SAINT's tabular encoder; its tokens then equal the
    JAX encoder's on those weights."""
    x, variables, tokens = jax_encoder
    want = tokens[False]
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          jconvert.export_saint_state_dict(variables).items()}
    sd["mlp1.layers.0.weight"] = torch.zeros(3, 3)
    torch.save(sd, tmp_path / "saint.pth")
    net = STiLNet("resnet18", dtype=F64, **NET_KW).to(F64).eval()
    n_used = convert.load_saint_state_dict(
        net.model.encoder_tabular,
        convert.load_torch_state_dict(tmp_path / "saint.pth"))
    # embeds, pos_encodings, 4 a continuous column, 22 in the layer
    assert n_used == len(sd) - 1 == 2 + 4 * NCON + 22
    with torch.no_grad():
        got = net.model.encoder_tabular(as_torch(x))
    assert_close(got, np.asarray(want), 1e-8, 1e-9)
    with pytest.raises(ValueError, match="STiL_SAINT"):
        convert.load_saint_state_dict(
            STiLNet("resnet18", **{**NET_KW, "tabular_encoder":
                                   "transformer"}).model.encoder_tabular, sd)


def test_checkpoint_saint_option_of_evaluate(tmp_path, capsys):
    """``checkpoint_SAINT`` in the training entry point: the ``.pth`` is
    read and its tensors go into the student's SAINT encoder."""
    enc = SAINTEncoder(CATS, NCON, dtype=torch.float32)
    torch.nn.init.normal_(enc.embeds.weight)
    torch.save(enc.state_dict(), tmp_path / "saint.pth")
    cfg = load_config("config_dvm_STiL_SAINT", [
        "dataset=synthetic_dvm", "models=resnet18", "img_size=32",
        "synthetic_image_size=40", "batch_size=8", "unlabelled_ratio=3",
        "synthetic_labelled=8", "synthetic_unlabelled=6",
        "synthetic_val=8", "synthetic_test=8", "num_classes=4",
        "projection_dim=8", "multimodal_embedding_dim=32", "max_epochs=1",
        "evaluate=True", "strict_prototypes=false", "save_checkpoints=false",
        "enable_progress_bar=false", "field_lengths=[5,4,2,1,1,1]",
        f"checkpoint_SAINT={tmp_path / 'saint.pth'}",
        f"logdir={tmp_path / 'run'}"])
    evaluate(cfg, device="cpu")
    n = len(enc.state_dict())
    assert f"Loaded SAINT weights ({n} tensors)" in capsys.readouterr().out


@dataclasses.dataclass
class _State:
    params: dict
    batch_stats: dict


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """JAX STiL_SAINT: init, BN-adapt on the 20-row test split, scoring
    in batches of 8 (the tail batch of 4 padded), and the padded tail
    batch's probabilities. Returns them and a full-model ``.ckpt`` of the
    initial weights, with the EMA and SAINT entries a reference
    checkpoint also holds."""
    with x64():
        cfg = _cfg(jax_load_config)
        src = jax_load_sources(cfg)["test"]
        algo = JaxSTiL_SAINT(cfg, FL, dtype=jnp.float64)
        port = STiLNet("resnet18", dtype=F64, **NET_KW).to(F64)
        init_weights(port, torch.Generator().manual_seed(0))
        variables = _seeded_variables(
            algo.net, port.state_dict(), jnp.zeros((2, 32, 32, 3)),
            jnp.asarray(src.tabular[:2]), train=False)
        # the eval forward of three rows, every output
        img = np.random.RandomState(3).rand(3, 32, 32, 3)
        tab = _tabular(3, 3)
        forward = (img, tab, to_numpy(jax.jit(
            lambda v, a, b: algo.net.apply(v, a, b, train=False))(
                variables, jnp.asarray(img), jnp.asarray(tab))))
        state = _State(variables["params"], variables["batch_stats"])
        cache = JaxDeviceCache(src).as_dict()
        adapted = jax_adapt(cfg, algo, state, cache)
        eval_step = algo.make_eval_step()
        metrics = jax_run_validation(
            eval_step, adapted.params, adapted.batch_stats, cache,
            int(cfg.batch_size), 4, prefix="test")
        # the sampler pads the tail batch by repeating its first row
        idx = jnp.asarray([16, 17, 18, 19, 16, 16, 16, 16], jnp.int32)
        tail = np.asarray(eval_step(adapted.params, adapted.batch_stats,
                                    cache, idx)["prob_m"])
    sd = convert.state_dict_from_jax(variables["params"],
                                     variables["batch_stats"])
    sd.update({k: torch.zeros(2) for k in INERT})
    sd["ema.encoder_tabular.embeds.weight"] = torch.zeros(2)
    ckpt = tmp_path_factory.mktemp("ckpt") / "init.ckpt"
    torch.save({"state_dict": sd}, ckpt)
    return {"ckpt": str(ckpt), "metrics": metrics, "tail": tail,
            "variables": variables, "forward": forward}


def test_stil_saint_eval_forward_matches_jax(reference):
    """Every output (the three heads included) of the eval forward."""
    img, tab, y = reference["forward"]
    variables = reference["variables"]
    port = STiLNet("resnet18", dtype=F64, **NET_KW).to(F64).eval()
    port.load_state_dict(convert.state_dict_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    with torch.no_grad():
        out = port(as_torch(img), as_torch(tab))
    assert set(out) == set(y)
    for k in ("out_m", "out_i", "out_t"):
        assert out[k].shape == (3, 4)
    for k in y:
        assert_close(out[k], np.asarray(y[k]), 1e-8, 1e-9, k)


def test_test_entry_point_matches_jax_with_a_ragged_tail(reference,
                                                         tmp_path):
    """``test()``: the full-model checkpoint (EMA and inert SAINT entries
    left out), BN-adapt, then scoring 20 rows in batches of 8."""
    cfg = _cfg(load_config, checkpoint=reference["ckpt"])
    metrics = run_test(cfg, logdir=tmp_path, device="cpu", dtype=F64)
    ref = reference["metrics"]
    assert list(metrics) == list(ref)
    for k in ref:
        if ".acc" in k:
            assert metrics[k] == ref[k], k
        else:
            assert metrics[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-9)


def test_predictor_pads_the_tail_as_jax(reference):
    """``Predictor`` pads the tail batch by repeating its first row, as
    the JAX package does; intersample attention makes the padding part
    of the result, so the tail scored alone differs."""
    cfg = _cfg(load_config, checkpoint=reference["ckpt"])
    src = load_test_split(cfg)
    algo = build_algo(cfg, src.field_lengths, device="cpu", dtype=F64)
    adapt(cfg, algo, DeviceCache(src, device="cpu").as_dict())
    images, tabular = np.asarray(src.images), np.asarray(src.tabular)
    probs = Predictor(algo, batch_size=8)(images, tabular)
    assert probs.shape == (20, 4)
    assert_close(probs[16:], reference["tail"][:4], 2e-6, 1e-9)
    alone = Predictor(algo, batch_size=4)(images[16:], tabular[16:])
    assert np.abs(alone - probs[16:]).max() > 1e-4


def test_registry_holds_the_ported_algorithms():
    """The port's classes by name, one for each of the JAX registry's ten
    names; a name of neither registry raises ``ValueError``, as the JAX
    registry raises it."""
    assert get_algorithm("STiL_SAINT") is STiL_SAINT
    assert STiL_SAINT.tabular_encoder == "saint"
    from stil_tta_torch.algorithms.registry import ALGORITHMS
    from stil_tta_tpu.algorithms import registry as jax_registry
    jax_names = ["STiL", "STiL_SAINT", "MMatch", "CoTrain_Pseudo",
                 "CoTrain_Pseudo_SAINT", "SimMatch", "CoMatch", "FreeMatch",
                 "Supervised", "TabularEval"]
    for name in jax_names:
        jax_cls = jax_registry.get_algorithm(name)
        assert get_algorithm(name).name == jax_cls.name, name
    assert sorted(ALGORITHMS) == sorted(jax_names)
    with pytest.raises(ValueError, match="Algorithm name not found"):
        get_algorithm("CoTrainSAINT")
    with pytest.raises(ValueError, match="Algorithm name not found"):
        jax_registry.get_algorithm("CoTrainSAINT")


def test_stil_saint_config_composes_like_jax():
    ours = load_config("config_dvm_STiL_SAINT", ["dataset=synthetic_dvm"])
    ref = jax_load_config("config_dvm_STiL_SAINT", ["dataset=synthetic_dvm"])
    assert ours.to_dict() == ref.to_dict()


@pytest.mark.parametrize("entry", ["test", "predictor"])
def test_teacher_int8_is_refused(entry, tmp_path):
    """STiL_SAINT takes ``teacher_int8`` with a ResNet (STiL's int8
    teacher, ``tests/test_torch_int8.py``); both entry points refuse it
    for a ViT encoder with JAX's ``ValueError``, before any weights
    load."""
    cfg = _cfg(load_config, teacher_int8=True)
    cfg.model = "vit_base"
    with pytest.raises(ValueError, match="ViT unsupported"):
        if entry == "test":
            run_test(cfg, logdir=tmp_path, device="cpu")
        else:
            Predictor.from_checkpoint(cfg, str(tmp_path / "none.ckpt"), FL,
                                      device="cpu")
