"""The two baselines of the port against the JAX package: ``Supervised``
(STiL's net on the labelled rows alone) and ``TabularEval`` (the tabular
transformer with a linear head), and their entry points.

``Supervised``: ``resnet18`` on 32x32 images, a binary task (the cardiac
tasks' accuracy of the class-1 probability), 4 labelled + 12 unlabelled
rows, small widths, float64 on both sides (JAX in x64), augmentation and
corruption off (the JAX side is handed the [0, 1] view, as in
``tests/test_torch_train_step.py``), the fusion layer's dropout at 0 on
both sides, random BatchNorm running statistics and an EMA backbone of
other weights, which the step must leave as it is. Two steps and the epoch
end from one state; the JAX step is compiled once for the file.

``TabularEval``: a one-layer ``TabularNet`` at width 32, float64, the
step's draws (the corruption's noise and source rows, the row gate) taken
from the JAX step's key stream and fed to the port.

Tolerances: float64 sums in two orders, rtol 1e-8 on losses and
probabilities, atol 1e-9 on parameters against Adam steps of lr 1e-3.
The entry points run on the port alone, at test size on the CPU."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch import run as port_run
from stil_tta_torch.algorithms.registry import get_algorithm
from stil_tta_torch.algorithms.stil import LOG_KEYS, STiL, init_weights
from stil_tta_torch.algorithms.supervised import Supervised
from stil_tta_torch.algorithms.tabular_eval import TabularEval, TabularNet
from stil_tta_torch.config import load_config
from stil_tta_torch.data.loader import DeviceCache
from stil_tta_torch.ops.batch_norm import BatchNorm2d
from stil_tta_torch.serve import Predictor
from stil_tta_torch.train.convert import (load_train_state,
                                          state_dict_from_jax,
                                          train_state_from_jax)
from stil_tta_torch.train.test import build_algo, load_test_split
from stil_tta_torch.tta import adapt
from stil_tta_tpu.algorithms.base import DAState as JDAState
from stil_tta_tpu.algorithms.stil import STiLState as JSTiLState
from stil_tta_tpu.algorithms.supervised import Supervised as JaxSupervised
from stil_tta_tpu.algorithms.tabular_eval import TabularEval as JaxTabEval
from stil_tta_tpu.config import load_config as jax_load_config
from stil_tta_tpu.data.loader import DeviceCache as JaxDeviceCache
from stil_tta_tpu.data.source import synthetic_source as jax_synthetic
from stil_tta_tpu.models import backbones as jbackbones
from stil_tta_tpu.ops.metrics import accuracy_init, auroc_init
from stil_tta_tpu.train.convert import (convert_torch_state_dict,
                                        export_torch_state_dict)
from stil_tta_tpu.tta import adapt as jax_adapt
from tests.torch_parity import (FIX_CLI, assert_close,
                                assert_equal_tree, cli_resume_exact, x64)
from tests.torch_parity import one_torch_thread  # noqa: F401

FL = [5, 4, 2, 1, 1, 1]
B_L, B_U, IMG, C, P = 4, 12, 32, 2, 8
F64 = torch.float64
LOSS_RTOL, PARAM_ATOL = 1e-8, 1e-9
OVERRIDES = [
    "dataset=synthetic_dvm", "models=resnet18", f"img_size={IMG}",
    f"num_classes={C}", "tabular_embedding_dim=32",
    "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
    f"projection_dim={P}", "augmentation_rate=0.0", "corruption_rate=0.0",
    "DA=true", "start_epoch=0", "lr_eval=1e-3", "weight_decay_eval=1e-4",
    "strict_prototypes=true", "algorithm_name=Supervised",
]


def _cfg(loader, *extra):
    cfg = loader("config_dvm_STiL", OVERRIDES + list(extra))
    cfg.field_lengths = list(FL)
    cfg.repeat_ratio = 3
    return cfg


def _data():
    """The labelled and unlabelled caches: (JAX, port) each; the JAX
    images are the [0, 1] view the port computes with augmentation
    off."""
    rng = np.random.RandomState(3)
    n = B_L + B_U
    imgs = rng.randint(0, 256, (n, IMG, IMG, 3)).astype(np.uint8)
    tabs = np.concatenate([np.stack([rng.randint(0, c, n) for c in FL[:3]],
                                    1), rng.randn(n, 3)], 1).astype(
        np.float32)
    y = np.array([0, 1, 1, 0] + [0, 1] * (B_U // 2))
    caches = []
    for sl in (slice(0, B_L), slice(B_L, n)):
        caches.append(({"images": jnp.asarray(
                            imgs[sl].astype(np.float32) / np.float32(255)),
                        "tabular": jnp.asarray(tabs[sl]),
                        "labels": jnp.asarray(y[sl].astype(np.int32)),
                        "labelled": jnp.asarray(np.ones(y[sl].shape, bool))},
                       {"images": torch.from_numpy(imgs[sl]),
                        "tabular": torch.from_numpy(tabs[sl]),
                        "labels": torch.from_numpy(y[sl]),
                        "labelled": torch.ones(y[sl].shape, dtype=bool)}))
    return caches


def _port_state(algo):
    """Seeded weights, an EMA backbone of other weights, random running
    statistics on both."""
    for layer in algo.net.model.transformer:
        layer.drop_path = 0.0
        layer.mlp.drop = 0.0
        layer.attn.attn_drop = layer.attn.proj_drop = 0.0
    state = algo.init_state(seed=0)
    init_weights(state.ema, torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for mod in list(state.net.modules()) + list(state.ema.modules()):
            if isinstance(mod, BatchNorm2d):
                mod.running_mean.normal_(0, 0.05, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
    return state


def _jax_state(jalgo, port_state):
    """A JAX ``STiLState`` holding the port state's weights (float64)."""
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda: jalgo.net.init(
        {"params": key, "dropout": key}, jnp.zeros((2, IMG, IMG, 3)),
        jnp.zeros((2, len(FL))), train=False))
    target = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float64), dict(shapes))
    sd = {k: v.numpy() for k, v in port_state.net.state_dict().items()}
    variables, _ = convert_torch_state_dict(sd, target)
    sd.update({"model." + k: v.numpy()
               for k, v in port_state.ema.state_dict().items()})
    ema, _ = convert_torch_state_dict(sd, target)
    z = lambda *s: jnp.zeros(s, jnp.float64)  # noqa: E731
    return JSTiLState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jalgo.tx.init(variables["params"]),
        ema_params=ema["params"]["backbone"],
        ema_batch_stats=ema["batch_stats"]["backbone"],
        rng=jax.random.key(5), step=jnp.zeros((), jnp.int32),
        prototypes=z(C, P), prototypes_sum=z(C, P), prototypes_count=z(C, 1),
        da=JDAState(z(256, C), jnp.zeros((), jnp.int32)),
        acc_train=accuracy_init(), acc_train_u=accuracy_init(),
        auc_train=auroc_init(2), auc_train_u=auroc_init(2),
        log_sums={k: z() for k in LOG_KEYS}, log_count=z())


@pytest.fixture(scope="module")
def supervised():
    """Both sides from one state: two steps (epochs 1 and 2; the step
    reads neither), then the epoch end."""
    def dropfree(**kw):
        kw.update(attn_drop=0.0, proj_drop=0.0, drop_path=0.0)
        return real_layer(**kw)

    real_layer = jbackbones.MITransformerLayer
    (jcl, cl), (jcu, cu) = _data()
    il = jnp.arange(B_L, dtype=jnp.int32)
    iu = jnp.arange(B_U, dtype=jnp.int32)
    with x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbackbones, "MITransformerLayer", dropfree)
        jalgo = JaxSupervised(_cfg(jax_load_config), FL, dtype=jnp.float64)
        jalgo.aug_train = lambda key, images, apply_rate=1.0: images
        algo = Supervised(_cfg(load_config), FL, dtype=F64, device="cpu")
        pstate = _port_state(algo)
        j0 = _jax_state(jalgo, pstate)
        carried = train_state_from_jax(j0)
        load_train_state(pstate, carried)
        jstep = jax.jit(jalgo.make_train_step().__wrapped__)
        pstep = algo.make_train_step()
        jstate = j0
        for epoch in (1, 2):
            jstate = jstep(jstate, jcl, jcu, il, iu,
                           jnp.asarray(epoch, jnp.int32))
            pstep(pstate, cl, cu, torch.arange(B_L), torch.arange(B_U),
                  epoch)
        # the port's epoch end resets the state in place
        out = {"initial": carried, "steps": (jstate, copy.deepcopy(pstate))}
        jend, jlogs = jalgo.epoch_end(jstate)
        pend, plogs = algo.epoch_end(pstate)
        out["end"] = (jend, pend, jlogs, plogs)
    return out


def test_supervised_step_matches_jax(supervised):
    """Loss sums, student (parameters and BN running statistics),
    accuracy, prototype counts, and the untouched teacher, DA ring and
    unlabelled metrics, after two steps."""
    jstate, pstate = supervised["steps"]
    assert pstate.step == 2 == int(jstate.step)
    want = train_state_from_jax(jstate)
    for k in ("CEloss", "loss"):
        assert_close(pstate.log_sums[k], np.asarray(jstate.log_sums[k]),
                     LOSS_RTOL, 1e-12, k)
    assert float(pstate.log_sums["CEloss"]) > 0
    # the other logs stay at zero on both sides
    for k in set(LOG_KEYS) - {"CEloss", "loss"}:
        assert float(pstate.log_sums[k]) == 0 == float(jstate.log_sums[k])
    got = pstate.net.state_dict()
    assert set(got) == set(want["net"])
    for k, v in want["net"].items():
        if not k.endswith("num_batches_tracked"):
            assert_close(got[k], v.numpy(), 0, PARAM_ATOL, k)
    start = supervised["initial"]
    # the student moved, its BN statistics too; the teacher did not
    assert not torch.equal(got["model.reduce.weight"],
                           start["net"]["model.reduce.weight"].double())
    k_bn = "model.encoder_imaging.bn1.running_mean"
    assert not torch.equal(got[k_bn], start["net"][k_bn].double())
    assert_equal_tree(pstate.ema.state_dict(),
                      {k: v.double() if v.is_floating_point() else v
                       for k, v in start["ema"].items()})
    assert_close(want["ema"]["reduce.weight"].numpy(),
                 start["ema"]["reduce.weight"].numpy(), 0, 0)
    assert float(pstate.acc_train.correct) == \
        float(jstate.acc_train.correct)
    assert float(pstate.acc_train.total) == 2 * B_L
    assert float(pstate.acc_train_u.total) == 0 == \
        float(jstate.acc_train_u.total)
    assert_close(pstate.prototypes_count, want["prototypes_count"].numpy(),
                 0, 0, "prototypes_count")
    assert float(pstate.prototypes_count.min()) == 2.0
    assert pstate.da.ptr == 0 == want["da"][1]


def test_supervised_epoch_end_matches_jax(supervised):
    """Every class has the step's unit counts, so the prototypes become
    the zero sums over them, as in the JAX package; the logs agree."""
    jend, pend, jlogs, plogs = supervised["end"]
    assert set(plogs) == set(jlogs)
    for k, v in jlogs.items():
        assert plogs[k] == pytest.approx(v, rel=1e-8, abs=1e-12), k
    assert_close(pend.prototypes, np.asarray(jend.prototypes), 0, 0)
    assert float(pend.prototypes.abs().max()) == 0.0
    assert float(pend.prototypes_count.sum()) == 0.0


def test_supervised_replaces_stils_step_and_ignores_micro_batches():
    cfg = _cfg(load_config, "micro_batches=2")
    assert get_algorithm("Supervised") is Supervised
    assert issubclass(Supervised, STiL)
    algo = Supervised(cfg, FL, dtype=F64, device="cpu")
    assert algo.make_train_step().__qualname__.startswith(
        "Supervised.make_train_step")


# ---- TabularEval ---------------------------------------------------------

TAB_OVERRIDES = [
    "dataset=synthetic_dvm", "algorithm_name=TabularEval",
    "eval_datatype=tabular", "num_classes=3", "tabular_embedding_dim=32",
    "tabular_transformer_num_layers=1", "img_size=16", "lr_eval=1e-3",
    "weight_decay_eval=1e-4", "corruption_rate=0.3",
    "eval_train_augment_rate=0.5",
]


def _tab_cfg(loader, *extra):
    cfg = loader("config_dvm_STiL", TAB_OVERRIDES + list(extra))
    cfg.field_lengths = list(FL)
    return cfg


def _as64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _jax_tab_draws(jstate, b, f, n):
    """The JAX step's draws (``tabular_eval.py:66-77``) in the port's
    form."""
    _, kc, kg, _ = jax.random.split(jstate.rng, 4)
    k_perm, k_pick = jax.random.split(kc)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return {"corruption": {
                "noise": t(jax.random.uniform(k_perm, (b, f))),
                "src_rows": t(jax.random.randint(k_pick, (b, f), 0, n))},
            "gate": t(jax.random.uniform(kg, (b, 1)) < 0.5)}


@pytest.fixture(scope="module")
def tabular():
    """One JAX state (float64 parameters and moments) carried into the
    port; two steps on each side with the JAX draws; the eval step on
    both."""
    src = jax_synthetic(10, 3, FL, 16, seed=4)
    idx = np.array([3, 0, 7, 5, 9, 1], np.int32)
    with x64():
        jalgo = JaxTabEval(_tab_cfg(jax_load_config), FL, dtype=jnp.float64)
        j0 = jalgo.init_state(jax.random.key(2), jnp.zeros((2, 16, 16, 3)),
                              jnp.asarray(src.tabular[:2]))
        params = _as64(j0.params)
        j0 = dataclasses.replace(
            j0, params=params, ema_params=params,
            opt_state=jalgo.tx.init(params),
            log_sums={"loss": jnp.zeros((), jnp.float64)},
            log_count=jnp.zeros((), jnp.float64))
        algo = TabularEval(_tab_cfg(load_config), FL, dtype=F64,
                           device="cpu")
        pstate = algo.init_state(0)
        carried = train_state_from_jax(j0)
        load_train_state(pstate, carried)
        jcache = JaxDeviceCache(src).as_dict()
        pcache = DeviceCache(src, device="cpu").as_dict()
        jstep = jax.jit(jalgo.make_train_step().__wrapped__)
        pstep = algo.make_train_step()
        jstate = j0
        gates = []
        for _ in range(2):
            draws = _jax_tab_draws(jstate, len(idx), len(FL), len(src))
            gates.append(draws["gate"])
            pstep(pstate, pcache, None, torch.from_numpy(idx).long(), None,
                  1, draws=draws)
            jstate = jstep(jstate, jcache, jcache, jnp.asarray(idx),
                           jnp.asarray(idx), jnp.asarray(1, jnp.int32))
        jev = jalgo.make_eval_step()(jstate.params, jstate.batch_stats,
                                     jcache, jnp.arange(8, dtype=jnp.int32))
        pev = algo.make_eval_step()(pcache, torch.arange(8))
    return {"algo": algo, "jstate": jstate, "pstate": pstate, "gates": gates,
            "carried": carried, "eval": (jev, pev), "src": src}


def test_tabular_eval_step_matches_jax(tabular):
    jstate, pstate = tabular["jstate"], tabular["pstate"]
    # the gate corrupts some rows and not all
    assert all(0 < int(g.sum()) < g.numel() for g in tabular["gates"])
    assert pstate.step == 2 == int(jstate.step)
    assert_close(pstate.log_sums["loss"], np.asarray(jstate.log_sums["loss"]),
                 LOSS_RTOL, 1e-12, "loss")
    want = train_state_from_jax(jstate)["net"]
    got = pstate.net.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert_close(got[k], v.numpy(), 0, PARAM_ATOL, k)
    assert not torch.equal(got["classifier.weight"],
                           tabular["carried"]["net"]["classifier.weight"])
    assert float(pstate.acc_train.correct) == \
        float(jstate.acc_train.correct)
    assert float(pstate.acc_train.total) == 12.0


def test_tabular_eval_step_gives_probabilities_and_labels(tabular):
    jev, pev = tabular["eval"]
    assert set(pev) == set(jev) == {"prob_m", "labels"}
    assert_close(pev["prob_m"], np.asarray(jev["prob_m"]), LOSS_RTOL, 1e-12)
    np.testing.assert_array_equal(pev["labels"].numpy(),
                                  np.asarray(jev["labels"]))


def test_tabular_net_builds_no_image_tower(tabular):
    net = tabular["algo"].net
    assert isinstance(net, TabularNet)
    assert not any(isinstance(m, (BatchNorm2d, torch.nn.Conv2d))
                   for m in net.modules())
    assert set(dict(net.named_children())) == {"encoder_tabular",
                                               "classifier"}


def test_tabular_net_converter_matches_jax_exporter(tabular):
    """Key for key and value for value against
    ``export_torch_state_dict``; loads with ``strict=True``."""
    params = tabular["jstate"].params
    ref = export_torch_state_dict({"params": params})
    ours = state_dict_from_jax(params, {})
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v))
    net = TabularNet(FL, 3, tabular_embedding_dim=32, num_layers=1,
                     dtype=F64).double()
    net.load_state_dict(ours, strict=True)


@pytest.mark.parametrize("strategy", ["bn_adapt", "tent", "eata", "sar"])
def test_tta_on_tabular_net_matches_jax(tabular, strategy):
    """The JAX package's BN-adapt passes over a net without BatchNorm and
    changes nothing; its Tent, EATA and SAR index the logits by
    ``"out_m"`` and fail. The port changes nothing for BN-adapt and
    refuses the other three."""
    src = tabular["src"]
    with x64():
        cfg = _tab_cfg(jax_load_config, f"tta_strategy={strategy}",
                       "batch_size=4")
        jalgo = JaxTabEval(cfg, FL, dtype=jnp.float64)
        jstate = tabular["jstate"]
        cache = JaxDeviceCache(src).as_dict()
        if strategy == "bn_adapt":
            out = jax_adapt(cfg, jalgo, jstate, cache)
            assert out.batch_stats == {} and all(jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(lambda a, b: bool((a == b).all()),
                                       out.params, jstate.params)))
        else:
            with pytest.raises(TypeError, match="string indexing"):
                jax_adapt(cfg, jalgo, jstate, cache)
    algo = tabular["algo"]
    pcfg = _tab_cfg(load_config, f"tta_strategy={strategy}", "batch_size=4")
    before = {k: v.clone() for k, v in algo.net.state_dict().items()}
    pcache = DeviceCache(src, device="cpu").as_dict()
    if strategy == "bn_adapt":
        assert adapt(pcfg, algo, pcache) == {"stats_batches": 0}
    else:
        with pytest.raises(ValueError, match="bn_adapt only"):
            adapt(pcfg, algo, pcache)
    assert_equal_tree(algo.net.state_dict(), before)


# ---- the entry points ----------------------------------------------------

@pytest.mark.parametrize("name,extra", [
    ("Supervised", ("algorithm_name=Supervised", "strict_prototypes=false")),
    ("TabularEval", ("algorithm_name=TabularEval", "eval_datatype=tabular")),
])
def test_cli_trains_resumes_tests_and_serves(name, extra, tmp_path):
    """``python -m stil_tta_torch.run``: train, resume bitwise, then
    ``test()`` with BN-adapt on the weights in the reference's
    ``state_dict`` layout (a ``.ckpt`` of the net's keys, loaded
    strictly), and ``Predictor`` on them equal to the eval step."""
    resumed = cli_resume_exact("config_dvm_STiL", tmp_path, *extra)
    assert resumed["ema"] is None if name == "TabularEval" \
        else resumed["ema"] is not None
    ckpt = tmp_path / "reference.ckpt"
    torch.save({"state_dict": resumed["net"]}, ckpt)
    cfg = load_config("config_dvm_STiL", FIX_CLI[2:] + list(extra))
    cfg.checkpoint = str(ckpt)
    src = load_test_split(cfg)
    algo = build_algo(cfg, src.field_lengths, device="cpu",
                      dtype=torch.float32)
    assert type(algo).__name__ == name
    assert_equal_tree(algo.net.state_dict(), resumed["net"])
    cache = DeviceCache(src, device="cpu").as_dict()
    want = algo.make_eval_step()(cache, torch.arange(len(src)))["prob_m"]
    got = Predictor(algo, batch_size=len(src))(np.asarray(src.images),
                                               np.asarray(src.tabular))
    assert_close(got, want, 1e-6, 1e-7)
    assert port_run.main(["--config-name", "config_dvm_STiL"] + FIX_CLI + [
        "test=True", "evaluate=False", "tta=True", "tta_strategy=bn_adapt",
        f"checkpoint={ckpt}", f"logdir={tmp_path / 't'}"]
        + list(extra)) == 0
    assert (tmp_path / "t" / "test_results.csv").exists()
