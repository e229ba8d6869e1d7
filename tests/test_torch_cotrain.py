"""Co-Training (``CoTrain_Pseudo``, ``CoTrain_Pseudo_SAINT``) and the
three-head backbone of the port against the JAX package: the backbone's
forward with both tabular encoders, the converter, one train step with
the EMAN teacher on both sides of ``start_epoch``, the micro-batched step
at m = 2 and its documented divergences, the test entry point with
BN-adapt, the eval step and ``Predictor`` on CoTrain_Pseudo_SAINT, and
this slice's refusals and accepted flags; then an exact CLI resume.

Setup as ``tests/test_torch_train_step.py``: ``resnet18`` on 32x32
images, 4 labelled + 12 unlabelled rows, float64 on both sides (JAX in
x64), Adam, augmentation and corruption off (the JAX views are handed in
as data), ``co_threshold`` 0.336 so that both masks select some rows and
not all (at least 9e-4 from every teacher probability), the EMA backbone
of other weights than the student's and both with random BatchNorm
running statistics, so the EMAN lerp is visible. The backbone has no
dropout besides SAINT's feed-forward one, set to 0 here.

The JAX single-batch step and the JAX ``step_micro`` are compiled once
each for the file (``epoch`` is traced). The JAX module writes its masks,
its ``epoch > start_epoch`` gate and the micro step's chunk-loop carries
as float32; the gate times ``rate_uce`` is then a float32 product, 0.2
rounded to float32, 1.5e-8 off the float64 weight. In the package's
float32 numerics that is the weight both sides use; for the float64
comparison the test runs the module with ``jnp.float32`` read as float64,
as ``tests/test_torch_micro_step.py`` does for STiL. CoTrainSAINT gets
no JAX step of its own: its encoder is held against JAX in
``tests/test_torch_saint.py`` and its net here, its step runs on the
port alone.

Tolerances: float64 sums in two orders, rtol 1e-8 on losses and outputs,
atol 1e-9 on parameters against Adam steps of lr 1e-3; the ``*_ratio``
logs are float32 means on the port's side, rtol 2e-7. The test entry
point and ``Predictor`` run the float32 resize transform on both sides:
rtol 2e-6, as ``tests/test_torch_slice.py`` states."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch import run as port_run
from stil_tta_torch.algorithms.cotrain import CoTrain, CoTrainSAINT
from stil_tta_torch.algorithms.mmatch import SemiMultimodalNet
from stil_tta_torch.algorithms.registry import get_algorithm
from stil_tta_torch.algorithms.stil import STiL
from stil_tta_torch.config import load_config
from stil_tta_torch.data.loader import DeviceCache
from stil_tta_torch.serve import Predictor
from stil_tta_torch.train import convert
from stil_tta_torch.train.convert import (load_train_state,
                                          train_state_from_jax)
from stil_tta_torch.train.test import build_algo, load_test_split
from stil_tta_torch.train.test import test as run_test
from stil_tta_torch.tta import adapt
from stil_tta_tpu.algorithms import cotrain as jcotrain
from stil_tta_tpu.algorithms.mmatch import SemiMultimodalNet as JaxNet
from stil_tta_tpu.config import load_config as jax_load_config
from stil_tta_tpu.data.datasets import load_sources as jax_load_sources
from stil_tta_tpu.data.loader import DeviceCache as JaxDeviceCache
from stil_tta_tpu.train import convert as jconvert
from stil_tta_tpu.train.evaluate import run_validation as jax_run_validation
from stil_tta_tpu.tta import adapt as jax_adapt
from stil_tta_tpu.tta import methods as jmethods
from stil_tta_tpu.tta import tent as jtent
from tests.test_torch_train_step import B_L, B_U, C, F64, FL, IMG, _data
from tests.torch_parity import (as_torch, assert_close, assert_equal_tree,
                                compare_match_states, first_checkpoint_kept,
                                jax_match_state, match_cfg, port_match_state,
                                to_numpy, x64)
from tests.torch_parity import one_torch_thread  # noqa: F401

M = 2
EXTRA = ("co_threshold=0.336",)
PARAM_ATOL = 1e-9


def _cfg(loader, *extra, name="config_dvm_CoTrain"):
    return match_cfg(loader, name, *EXTRA, *extra)


def _views(key, images, tabular, marginal):
    return images, tabular


def _jnp64():
    """``jax.numpy`` with ``float32`` reading as float64, for the JAX
    module under test."""
    jnp64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    jnp64.float32 = jnp.float64
    return jnp64


def _port(micro=1, carried=None):
    algo = CoTrain(_cfg(load_config, f"micro_batches={micro}"), FL,
                   dtype=F64, device="cpu")
    if carried is None:
        return algo, port_match_state(algo)
    state = algo.init_state(seed=0)
    load_train_state(state, carried)
    return algo, state


@pytest.fixture(scope="module")
def run():
    """From one state: the JAX and port single-batch steps at epoch 0
    (= start_epoch, gate closed) and 1 (gate open); then the JAX and port
    micro steps at epoch 1, twice, and the port's single-batch step from
    the same state for the divergences."""
    (jcl, cl), (jcu, cu) = _data()
    il = jnp.arange(B_L, dtype=jnp.int32)
    iu = jnp.arange(B_U, dtype=jnp.int32)
    tl, tu = torch.arange(B_L), torch.arange(B_U)
    out = {}
    with x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcotrain, "jnp", _jnp64())
        jalgo = jcotrain.CoTrain(_cfg(jax_load_config), FL,
                                 dtype=jnp.float64)
        jalgo.contrastive_views = _views
        algo, state0 = _port()
        j0 = jax_match_state(jalgo, state0, IMG, len(FL))
        carried = train_state_from_jax(j0)
        out["initial"] = carried
        jstep = jax.jit(jalgo.make_train_step().__wrapped__)
        for e in (0, 1):
            algo, pstate = _port(1, carried)
            algo.make_train_step()(pstate, cl, cu, tl, tu, e)
            out[e] = (jstep(j0, jcl, jcu, il, iu,
                            jnp.asarray(e, jnp.int32)), pstate)
        out["single"] = out[1][1]

        jalgo_m = jcotrain.CoTrain(
            _cfg(jax_load_config, f"micro_batches={M}"), FL,
            dtype=jnp.float64)
        jalgo_m.contrastive_views = _views
        jmicro = jax.jit(jalgo_m.make_train_step().__wrapped__)
        algo_m, pstate = _port(M, carried)
        pstep = algo_m.make_train_step()
        epoch = jnp.asarray(1, jnp.int32)
        jstate = jmicro(j0, jcl, jcu, il, iu, epoch)
        pstep(pstate, cl, cu, tl, tu, 1)
        out["micro"] = train_state_from_jax(jstate)
        out["port_micro"] = {
            "net": {k: v.clone() for k, v in pstate.net.state_dict().items()},
            "ema": {k: v.clone() for k, v in pstate.ema.state_dict().items()}}
        jstate = jmicro(jstate, jcl, jcu, il, iu, epoch)
        pstep(pstate, cl, cu, tl, tu, 1)
        out["two_micro"] = (jstate, pstate)
    return out


# ---- the backbone and the converter -------------------------------------

def _tabular(b, seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate([np.stack([rng.randint(0, c, b) for c in FL[:3]],
                                    1), rng.randn(b, 3)], 1)


def _nets(encoder, tab_dim, dtype):
    kw = dict(field_lengths=tuple(FL), num_classes=C, projection_dim=8,
              tabular_embedding_dim=tab_dim, multimodal_embedding_dim=32,
              tabular_num_layers=1, tabular_encoder=encoder,
              saint_ff_dropout=0.0)
    return JaxNet(encoder="resnet18", dtype=jnp.float64, **kw), \
        SemiMultimodalNet("resnet18", dtype=dtype, **kw).to(dtype)


# (encoder, tabular width): the transformer at 16 against a fusion width
# of 32 takes tabular_proj; SAINT at the configured width 32 feeds its
# 32-wide CLS token in unprojected, as the DVM widths (512, 512) do
BACKBONES = [("transformer", 16), ("saint", 32)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("encoder,tab_dim", BACKBONES)
def test_backbone_forward_matches_jax(encoder, tab_dim, train):
    """All four outputs, and in train mode the BatchNorm running
    statistics, of six rows (SAINT's intersample attention mixes them)."""
    jnet, port = _nets(encoder, tab_dim, F64)
    torch.manual_seed(0)
    with torch.no_grad():
        for p in port.parameters():
            p.normal_(0, 0.2)
    img = np.random.RandomState(1).rand(6, IMG, IMG, 3)
    tab = _tabular(6)
    with x64():
        key = jax.random.key(0)
        shapes = jax.eval_shape(lambda: jnet.init(
            {"params": key, "dropout": key}, jnp.zeros((2, IMG, IMG, 3)),
            jnp.zeros((2, len(FL))), train=False))
        target = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float64), dict(shapes))
        sd = {k: v.numpy() for k, v in port.state_dict().items()}
        variables, _ = jconvert.convert_torch_state_dict(sd, target)
        want, mut = jnet.apply(variables, jnp.asarray(img), jnp.asarray(tab),
                               train=train, mutable=["batch_stats"])
    port.train(train)
    with torch.no_grad():
        got = port(as_torch(img), as_torch(tab))
    assert len(got) == 4
    for name, g, w in zip(("out_m", "out_i", "out_t", "x_m"), got, want):
        assert g.shape == w.shape and g.dtype == F64, name
        assert_close(g, np.asarray(w), 1e-8, 1e-9, name)
    if train:
        stats = convert.state_dict_from_jax(variables["params"],
                                            to_numpy(mut["batch_stats"]))
        for k, v in port.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert_close(v, stats[k].numpy(), 1e-8, 1e-12, k)


@pytest.mark.parametrize("encoder,tab_dim", BACKBONES)
def test_converter_matches_jax_exporter(encoder, tab_dim):
    """``state_dict_from_jax`` of a SemiMultimodal tree equals
    ``export_torch_state_dict`` key for key (in order) and value for
    value, with the three classifiers, ``multimodal_proj`` and the SAINT
    paths, and loads strictly into the port's net."""
    jnet, port = _nets(encoder, tab_dim, torch.float32)
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda: jnet.init(
        {"params": key, "dropout": key}, jnp.zeros((2, IMG, IMG, 3)),
        jnp.zeros((2, len(FL))), train=False))
    rng = np.random.RandomState(9)
    tree = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), dict(shapes))
    ours = convert.export_state_dict(tree["params"], tree["batch_stats"])
    ref = jconvert.export_torch_state_dict(tree)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), k)
    for k in ("model.classifier_multimodal.weight",
              "model.classifier_imaging.weight",
              "model.classifier_tabular.weight",
              "model.multimodal_proj.weight", "model.image_proj.weight"):
        assert k in ours, k
    assert ("model.tabular_proj.weight" in ours) == (tab_dim != 32)
    if encoder == "saint":
        assert "model.encoder_tabular.simple_MLP.2.layers.2.weight" in ours
    port.load_state_dict(convert.state_dict_from_jax(
        tree["params"], tree["batch_stats"]), strict=True)
    assert set(port.state_dict()) == set(ref)


# ---- the train steps ------------------------------------------------------

@pytest.mark.parametrize("epoch", [0, 1])
def test_train_step_matches_jax(run, epoch):
    """Logs, student, EMA (lerped from the post-forward statistics) and
    accuracies; at epoch 0 (= start_epoch) the gate keeps the cross-modal
    losses out of the loss, at epoch 1 they count."""
    jstate, pstate = run[epoch]
    assert pstate.step == 1 == int(jstate.step)
    compare_match_states(jstate, pstate, CoTrain.LOG_KEYS)
    logs = {k: float(v) for k, v in pstate.log_sums.items()}
    extra = logs["loss"] - 0.2 * logs["CEloss"]
    assert (abs(extra) > 1e-6) == (epoch == 1)
    for k in ("threshold_i_ratio", "threshold_t_ratio"):
        assert 0 < logs[k] < 1, k
    assert logs["CEloss_unlabelled_i"] > 0
    assert logs["CEloss_unlabelled_t"] > 0
    key = "classifier_imaging.weight"
    start = run["initial"]["ema"][key].double()
    assert not torch.equal(pstate.ema.state_dict()[key], start)


def test_two_micro_steps_match_jax_step_micro(run):
    jstate, pstate = run["two_micro"]
    assert pstate.step == 2 == int(jstate.step)
    assert float(pstate.log_count) == 2.0
    compare_match_states(jstate, pstate, CoTrain.LOG_KEYS)


def _bn_stats(sd):
    return {k: v.double() for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _far(a: dict, b: dict, atol: float) -> bool:
    return any(float((a[k] - b[k].double()).abs().max()) > atol for k in a)


def test_ghost_batch_norm_running_stats(run):
    """The student's running statistics are lerped once a chunk with the
    chunk's statistics: after one micro step the port's equal JAX's, and
    one lerp with the batch's (the single-batch step) lands outside the
    tolerance."""
    micro = _bn_stats(run["port_micro"]["net"])
    want = _bn_stats(run["micro"]["net"])
    for k, v in micro.items():
        assert_close(v, want[k].numpy(), 0, PARAM_ATOL, k)
    single = _bn_stats(run["single"].net.state_dict())
    assert _far(single, micro, 1e-6)


def test_eman_lerps_pre_forward_statistics(run):
    """``step_micro`` lerps the EMA once, before the first chunk, from the
    pre-step running statistics: after one step the port's and JAX's EMA
    statistics are exactly that lerp, which the single-batch order
    (post-forward statistics) misses."""
    init = run["initial"]
    pre = {k: 0.9 * v.double() + 0.1 * init["net"]["model." + k].double()
           for k, v in _bn_stats(init["ema"]).items()}
    for micro in (run["port_micro"]["ema"], run["micro"]["ema"]):
        for k, v in pre.items():
            assert_close(micro[k], v.numpy(), 0, PARAM_ATOL, k)
    assert _far(pre, _bn_stats(run["single"].ema.state_dict()), 1e-6)


def test_cotrain_saint_steps_on_the_port():
    """CoTrain_Pseudo_SAINT's single-batch and micro steps run (SAINT's
    feed-forward dropout on) and move the student and the EMA; under
    chunking its intersample attention sees the chunk's rows only, so a
    chunk's tabular tokens are not the batch's (the divergence the JAX
    ``step_micro`` docstring names)."""
    (_, cl), (_, cu) = _data()
    for micro in (1, M):
        cfg = _cfg(load_config, f"micro_batches={micro}",
                   "saint_ff_dropout=0.5",
                   name="config_dvm_CoTrain_SAINT")
        algo = get_algorithm(cfg.algorithm_name)(cfg, FL, dtype=F64,
                                                 device="cpu")
        assert isinstance(algo, CoTrainSAINT)
        state = port_match_state(algo)
        w0 = state.net.model.encoder_tabular.embeds.weight.clone()
        e0 = state.ema.encoder_tabular.embeds.weight.clone()
        algo.make_train_step()(state, cl, cu, torch.arange(B_L),
                               torch.arange(B_U), 1)
        logs = {k: float(v) for k, v in state.log_sums.items()}
        assert all(np.isfinite(v) for v in logs.values()), logs
        assert not torch.equal(state.net.model.encoder_tabular.embeds.weight,
                               w0)
        assert not torch.equal(state.ema.encoder_tabular.embeds.weight, e0)
    enc = state.net.model.encoder_tabular.eval()
    tabs = torch.cat([cl["tabular"], cu["tabular"]]).double()
    with torch.no_grad():
        whole = enc(tabs)
        chunk = enc(tabs[:(B_L + B_U) // M])
    assert float((whole[:len(chunk)] - chunk).abs().max()) > 1e-6


def test_without_ema_the_student_heads_teach():
    """``use_ema: false``: no EMA copy is kept, and the soft labels come
    from the student's own detached heads: with the same weights, the
    masks equal those of the student's imaging and tabular heads."""
    (_, cl), (_, cu) = _data()
    algo = CoTrain(_cfg(load_config, "use_ema=false"), FL, dtype=F64,
                   device="cpu")
    state = port_match_state(algo)
    assert state.ema is None
    images = torch.cat([cl["images"], cu["images"]]).double() / 255
    tabs = torch.cat([cl["tabular"], cu["tabular"]]).double()
    state.net.train()
    with torch.no_grad():
        _, oi, ot, _ = state.net(images, tabs)
    masks = [float((torch.softmax(o[B_L:], 1).amax(1) >= 0.336).float()
                   .mean()) for o in (oi, ot)]
    state = port_match_state(algo)
    algo.make_train_step()(state, cl, cu, torch.arange(B_L),
                           torch.arange(B_U), 1)
    got = [float(state.log_sums[k]) for k in ("threshold_i_ratio",
                                              "threshold_t_ratio")]
    assert got == pytest.approx(masks, rel=2e-7)
    assert state.ema is None


# ---- test entry point, eval step and Predictor: CoTrain_Pseudo_SAINT -----

TEST_EXTRA = ("batch_size=8", "synthetic_image_size=40", "synthetic_test=16",
              "test=True", "tta=True", "tta_strategy=bn_adapt",
              "enable_progress_bar=false")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """JAX CoTrain_Pseudo_SAINT on the port's seeded weights: BN-adapt on
    the 16-row test split, scoring in batches of 8, and a batch of the
    last 4 rows padded by repeating its first. Returns them and a
    reference-layout ``.ckpt`` of the weights with the entries a
    reference Co-Training checkpoint also holds (the EMA teacher)."""
    with x64():
        cfg = _cfg(jax_load_config, *TEST_EXTRA,
                   name="config_dvm_CoTrain_SAINT")
        src = jax_load_sources(cfg)["test"]
        jalgo = jcotrain.CoTrainSAINT(cfg, FL, dtype=jnp.float64)
        algo = CoTrainSAINT(_cfg(load_config, *TEST_EXTRA,
                                 name="config_dvm_CoTrain_SAINT"), FL,
                            dtype=F64, device="cpu")
        state = port_match_state(algo)
        jstate = jax_match_state(jalgo, state, IMG, len(FL))
        cache = JaxDeviceCache(src).as_dict()
        adapted = jax_adapt(cfg, jalgo, jstate, cache)
        eval_step = jalgo.make_eval_step()
        metrics = jax_run_validation(
            eval_step, adapted.params, adapted.batch_stats, cache,
            int(cfg.batch_size), C, prefix="test")
        idx = jnp.asarray([12, 13, 14, 15, 12, 12, 12, 12], jnp.int32)
        first = {k: np.asarray(v) for k, v in eval_step(
            adapted.params, adapted.batch_stats, cache,
            jnp.arange(8, dtype=jnp.int32)).items()}
        tail = np.asarray(eval_step(adapted.params, adapted.batch_stats,
                                    cache, idx)["prob_m"])
    sd = dict(state.net.state_dict())
    sd.update({"ema." + k: v for k, v in state.ema.state_dict().items()})
    ckpt = tmp_path_factory.mktemp("ckpt") / "init.ckpt"
    torch.save({"state_dict": sd}, ckpt)
    return {"ckpt": str(ckpt), "metrics": metrics, "first": first,
            "tail": tail}


def _adapted(reference):
    cfg = _cfg(load_config, *TEST_EXTRA, f"checkpoint={reference['ckpt']}",
               name="config_dvm_CoTrain_SAINT")
    src = load_test_split(cfg)
    algo = build_algo(cfg, src.field_lengths, device="cpu", dtype=F64)
    cache = DeviceCache(src, device="cpu").as_dict()
    adapt(cfg, algo, cache)
    return cfg, src, algo, cache


def test_test_entry_point_matches_jax(reference, tmp_path):
    """``test()``: the reference-layout checkpoint (its EMA entries left
    out), BN-adapt, scoring of the three heads."""
    cfg = _cfg(load_config, *TEST_EXTRA, f"checkpoint={reference['ckpt']}",
               name="config_dvm_CoTrain_SAINT")
    metrics = run_test(cfg, logdir=tmp_path, device="cpu", dtype=F64)
    ref = reference["metrics"]
    assert list(metrics) == list(ref)
    for k in ref:
        if ".acc" in k:
            assert metrics[k] == ref[k], k
        else:
            assert metrics[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-9)


def test_three_head_eval_step_matches_jax(reference):
    _, _, algo, cache = _adapted(reference)
    got = algo.make_eval_step()(cache, torch.arange(8))
    want = reference["first"]
    assert set(got) == set(want)
    for k in ("prob_m", "prob_i", "prob_t"):
        assert_close(got[k], want[k], 2e-6, 1e-9, k)
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])


def test_predictor_pads_the_tail_as_jax(reference):
    """``Predictor`` takes the multimodal head of the tuple and pads the
    tail batch by repeating its first row; SAINT's intersample attention
    makes the padding part of the result."""
    _, src, algo, _ = _adapted(reference)
    images, tabular = np.asarray(src.images), np.asarray(src.tabular)
    # rows 4..15: a full batch, then rows 12..15 padded with row 12
    probs = Predictor(algo, batch_size=8)(images[4:], tabular[4:])
    assert probs.shape == (12, C)
    assert_close(probs[8:], reference["tail"][:4], 2e-6, 1e-9)
    alone = Predictor(algo, batch_size=4)(images[12:], tabular[12:])
    assert np.abs(alone - probs[8:]).max() > 1e-4


# ---- refusals and accepted flags --------------------------------------------

@pytest.mark.parametrize("strategy", ["tent", "eata", "sar"])
def test_entropy_tta_is_refused_on_both_sides(strategy):
    """Tent, EATA and SAR read the ``out_m`` head by name: the JAX package
    fails on the tuple these nets return, and the port refuses the
    strategy up front rather than pick a head."""
    cfg = _cfg(load_config, *TEST_EXTRA, f"tta_strategy={strategy}")
    src = load_test_split(cfg)
    algo = build_algo(cfg, src.field_lengths, device="cpu")
    with pytest.raises(ValueError, match="bn_adapt only"):
        adapt(cfg, algo, DeviceCache(src, device="cpu").as_dict())
    jcfg = _cfg(jax_load_config, *TEST_EXTRA, f"tta_strategy={strategy}")
    jalgo = jcotrain.CoTrain(jcfg, FL)
    jstate = jax_match_state(jalgo, port_match_state(algo), IMG, len(FL))
    phase = {"tent": jtent._tent_phase, "eata": jmethods.eata_adapt,
             "sar": jmethods.sar_adapt}[strategy]
    jcache = JaxDeviceCache(jax_load_sources(jcfg)["test"]).as_dict()
    with pytest.raises((TypeError, IndexError)):
        phase(jcfg, jalgo, jstate, jcache)


def test_bfloat16_adam_moment_does_not_reach_cotrain():
    """``adam_mu_dtype=bfloat16``: the JAX ``MatchBase`` builds its Adam
    without it, so the first moment stays float32 in both packages."""
    cfg = _cfg(load_config, "adam_mu_dtype=bfloat16")
    algo = CoTrain(cfg, FL, dtype=torch.float32, device="cpu")
    state = algo.init_state(0)
    (_, cl), (_, cu) = _data()
    algo.make_train_step()(state, cl, cu, torch.arange(B_L),
                           torch.arange(B_U), 1)
    moments = list(state.optimizer.state.values())
    assert moments and {m["exp_avg"].dtype for m in moments} == \
        {torch.float32}
    jalgo = jcotrain.CoTrain(_cfg(jax_load_config,
                                  "adam_mu_dtype=bfloat16"), FL)
    mu = [leaf for leaf in jax.tree_util.tree_leaves(
        jalgo.tx.init({"w": jnp.zeros((3, 2), jnp.float32)}))
        if getattr(leaf, "shape", ()) == (3, 2)]
    assert mu and {leaf.dtype for leaf in mu} == {jnp.dtype(jnp.float32)}


def test_teacher_int8_is_ignored_by_cotrain_and_refused_by_stil():
    """Co-Training accepts and ignores ``teacher_int8``, on both sides;
    STiL takes it (its EMA teacher's image tower runs int8,
    ``tests/test_torch_int8.py``) and refuses it for a ViT encoder with
    JAX's ``ValueError``, before the encoder is built."""
    cfg = _cfg(load_config, "teacher_int8=true")
    algo = get_algorithm("CoTrain_Pseudo")(cfg, FL, device="cpu")
    state = algo.init_state(0)
    assert state.ema is not None
    assert not hasattr(algo.net, "teacher_int8")
    jcotrain.CoTrain(_cfg(jax_load_config, "teacher_int8=true"), FL)
    stil = load_config("config_dvm_STiL", ["teacher_int8=true"])
    assert STiL(stil, FL, device="cpu").net.teacher_int8
    from stil_tta_tpu.algorithms.stil import STiL as JaxSTiL
    for loader, cls, kw in ((load_config, STiL, {"device": "cpu"}),
                            (jax_load_config, JaxSTiL, {})):
        vit = loader("config_dvm_STiL", ["teacher_int8=true"])
        vit.model = "vit_base"
        with pytest.raises(ValueError, match="ViT unsupported"):
            cls(vit, FL, **kw)


# ---- exact resume through the CLI -------------------------------------------

CLI = ["--config-name", "config_dvm_CoTrain", "--device", "cpu",
       "evaluate=True", "dataset=synthetic_dvm", "models=resnet18",
       "img_size=32", "synthetic_image_size=40", "batch_size=8",
       "unlabelled_ratio=3", "synthetic_labelled=8",
       "synthetic_unlabelled=24", "synthetic_val=8", "synthetic_test=8",
       "num_classes=4",
       "tabular_embedding_dim=32", "multimodal_embedding_dim=32",
       "tabular_transformer_num_layers=1", "projection_dim=8",
       "start_epoch=0", "co_threshold=0.3", "enable_progress_bar=false",
       "checkpoint_every_n_epochs=1", "save_checkpoints=false",
       "test_and_eval=false", "lr_eval=1.0e-3"]


def test_cli_resume_is_bitwise_exact(tmp_path):
    """Two epochs straight through the CLI end bitwise equal to the same
    run's first-epoch checkpoint resumed for the second: student, EMA
    teacher, Adam, generators, sums."""
    with first_checkpoint_kept(tmp_path / "b"):
        assert port_run.main(CLI + ["max_epochs=2",
                                    f"logdir={tmp_path / 'a'}"]) == 0
    assert port_run.main([
        "--config-name", "config_dvm_CoTrain", "--device", "cpu",
        "resume_training=True",
        f"checkpoint={tmp_path / 'b' / 'checkpoint_last'}", "max_epochs=2",
        f"logdir={tmp_path / 'c'}"]) == 0
    straight = torch.load(tmp_path / "a" / "checkpoint_last",
                          weights_only=True)
    resumed = torch.load(tmp_path / "c" / "checkpoint_last",
                         weights_only=True)
    assert straight["step"] == resumed["step"] == 8
    assert straight["ema"] is not None
    assert_equal_tree(straight, resumed)
