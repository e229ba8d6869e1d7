"""The port's test-time slice as a whole against the JAX package, at tiny
size: ``config_dvm_STiL dataset=synthetic_dvm models=resnet18`` with
small widths, ``test=True tta=True tta_strategy=bn_adapt``, the same
weights on both sides (JAX init -> numpy -> a reference-layout ``.ckpt``
-> the port).

The nets run at float64 (JAX x64 inside ``x64()``), but the resize-only
eval transform computes in float32 on both sides (as the JAX pipeline
does), summing in different orders, so the images already differ by
float32 rounding (~1e-7 relative). The JAX stats pass runs the whole net
in train mode and inverts flax's running-stat blend; the port runs the
image tower alone and applies ``tta_momentum`` once. Tolerance for
statistics and probabilities: rtol 2e-6, ten times the observed float32
floor (a mean's error is measured in units of its channel's
standard deviation). Accuracies are equal and AUROCs agree to 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch.config import load_config
from stil_tta_torch.data.loader import DeviceCache
from stil_tta_torch.ops.batch_norm import bn_stats
from stil_tta_torch.run import main as port_main
from stil_tta_torch.serve import Predictor
from stil_tta_torch.serve import main as serve_main
from stil_tta_torch.train.convert import export_state_dict, \
    state_dict_from_jax
from stil_tta_torch.train.test import build_algo, load_test_split
from stil_tta_torch.train.test import test as run_test
from stil_tta_torch.tta import adapt
from stil_tta_tpu.algorithms.stil import STiL as JaxSTiL
from stil_tta_tpu.config import load_config as jax_load_config
from stil_tta_tpu.data.datasets import load_sources as jax_load_sources
from stil_tta_tpu.data.loader import DeviceCache as JaxDeviceCache
from stil_tta_tpu.train.evaluate import run_validation as jax_run_validation
from stil_tta_tpu.tta import adapt as jax_adapt
from tests.torch_parity import assert_close, to_numpy, x64
from tests.torch_parity import one_torch_thread  # noqa: F401

FIELD_LENGTHS = [5, 4, 2, 1, 1, 1]
OVERRIDES = [
    "dataset=synthetic_dvm", "models=resnet18", "batch_size=8",
    "img_size=32", "synthetic_image_size=40", "synthetic_test=20",
    "num_classes=4", "tabular_embedding_dim=32",
    "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
    "projection_dim=8", "test=True", "tta=True", "tta_strategy=bn_adapt",
    "enable_progress_bar=false",
]
F64 = torch.float64


@dataclasses.dataclass
class _State:
    params: dict
    batch_stats: dict


def _cfg(loader, **extra):
    cfg = loader("config_dvm_STiL", OVERRIDES
                 + [f"{k}={v}" for k, v in extra.items()])
    cfg.field_lengths = list(FIELD_LENGTHS)
    return cfg


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """JAX: init, BN-adapt on the test split (20 samples in batches of 8:
    the tail batch has 4), score. Returns numpy results and a ``.ckpt``
    of the initial weights."""
    with x64():
        cfg = _cfg(jax_load_config)
        src = jax_load_sources(cfg)["test"]
        algo = JaxSTiL(cfg, FIELD_LENGTHS, dtype=jnp.float64)
        # one jitted init: eager, the net's hundreds of small programs
        # take three times as long to compile
        key = jax.random.key(0)
        variables = to_numpy(dict(jax.jit(
            lambda img, tab: algo.net.init({"params": key, "dropout": key},
                                           img, tab, train=False))(
            jnp.zeros((2, 32, 32, 3)), jnp.asarray(src.tabular[:2]))),
            np.float64)
        state = _State(variables["params"], variables["batch_stats"])
        cache = JaxDeviceCache(src).as_dict()
        adapted = jax_adapt(cfg, algo, state, cache)
        eval_step = algo.make_eval_step()
        metrics = jax_run_validation(
            eval_step, adapted.params, adapted.batch_stats, cache,
            int(cfg.batch_size), 4, prefix="test")
        idx = jnp.arange(8, dtype=jnp.int32)
        prob_m = np.asarray(eval_step(adapted.params, adapted.batch_stats,
                                      cache, idx)["prob_m"])
    ckpt = tmp_path_factory.mktemp("ckpt") / "init.ckpt"
    torch.save({"state_dict": state_dict_from_jax(variables["params"],
                                                  variables["batch_stats"]),
                "hyper_parameters": {"algorithm_name": "STiL"}}, ckpt)
    return {"ckpt": str(ckpt), "metrics": metrics, "prob_m": prob_m,
            "stats": export_state_dict({}, to_numpy(adapted.batch_stats)),
            "init_stats": export_state_dict({}, variables["batch_stats"])}


def _port_algo(reference):
    cfg = _cfg(load_config, checkpoint=reference["ckpt"])
    src = load_test_split(cfg)
    algo = build_algo(cfg, src.field_lengths, device="cpu", dtype=F64)
    return cfg, src, algo, DeviceCache(src, device="cpu").as_dict()


def test_bn_adapt_statistics_match_jax_full_net_pass(reference):
    """Every BN's adapted running statistics, from the port's
    image-tower-only pass, equal the JAX full-net train-mode pass."""
    cfg, _, algo, cache = _port_algo(reference)
    launches = bn_stats.launches
    adapt(cfg, algo, cache)
    assert bn_stats.launches == launches  # CPU tensors: the plain version
    sd = algo.net.state_dict()
    # resnet18: 20 BatchNorms, each mean, var and counter
    assert len(reference["stats"]) == 3 * 20
    for k, v in reference["stats"].items():
        if not k.endswith("running_mean"):
            continue
        kv = k.replace("running_mean", "running_var")
        var = reference["stats"][kv]
        # the statistics did move from their initial values
        assert not np.allclose(v, reference["init_stats"][k])
        # a mean's error in units of its channel's std, a variance's
        # relative to itself
        d_mean = np.abs(sd[k].numpy() - v) / np.sqrt(var)
        assert d_mean.max() < 2e-6, (k, d_mean.max())
        assert_close(sd[kv], var, 2e-6, 0, kv)


def test_test_entry_point_metrics_match_jax(reference, tmp_path):
    cfg = _cfg(load_config, checkpoint=reference["ckpt"])
    metrics = run_test(cfg, logdir=tmp_path, device="cpu", dtype=F64)
    ref = reference["metrics"]
    assert list(metrics) == list(ref)
    for k in ref:
        if ".acc" in k:
            assert metrics[k] == ref[k], k
        else:
            assert metrics[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-9)
    assert (tmp_path / "test_results.csv").exists()
    assert (tmp_path / "metrics.jsonl").exists()


def test_predictor_matches_jax_eval_probabilities(reference):
    cfg, src, algo, cache = _port_algo(reference)
    adapt(cfg, algo, cache)
    probs = Predictor(algo, batch_size=3)(np.asarray(src.images[:8]),
                                          src.tabular[:8])
    assert_close(probs, reference["prob_m"], 2e-6, 1e-9)


@pytest.mark.parametrize("all_seeds", [False, True])
def test_cli_test_branch_runs_on_cpu(reference, tmp_path, all_seeds):
    logdir = tmp_path / "run"
    rc = port_main(["--config-name", "config_dvm_STiL", "--device", "cpu",
                    *OVERRIDES, "field_lengths=[5,4,2,1,1,1]",
                    f"checkpoint={reference['ckpt']}", f"logdir={logdir}",
                    f"run_all_seeds={all_seeds}", "seeds=[1,2]"])
    assert rc == 0
    if all_seeds:  # one run per seed, and a summary over them
        assert (tmp_path / "run_1" / "test_results.csv").exists()
        assert (tmp_path / "run_2" / "test_results.csv").exists()
        assert (tmp_path / "run_seed_summary.csv").exists()
    else:
        assert (logdir / "test_results.csv").exists()


def test_serve_cli_scores_a_split(reference, tmp_path):
    from stil_tta_tpu.data.source import synthetic_source
    synthetic_source(6, num_classes=4, field_lengths=FIELD_LENGTHS,
                     image_size=40, seed=5).save(tmp_path / "split")
    out = tmp_path / "pred.csv"
    rc = serve_main(["--config-name", "config_dvm_STiL", "--checkpoint",
                     reference["ckpt"], "--source", str(tmp_path / "split"),
                     "--out", str(out), "--device", "cpu", "--batch-size",
                     "4", *OVERRIDES])
    assert rc == 0
    assert out.read_text().splitlines()[0] == "index,prediction,confidence"
    assert len(out.read_text().splitlines()) == 7


@pytest.mark.parametrize("strategy", ["tent", "eata", "sar"])
def test_unported_strategies_raise_and_change_nothing(reference, strategy):
    """Every strategy is ported (``tests/test_torch_tta.py``); names are
    matched exactly, as in the JAX package, so one spelled otherwise is
    no strategy and raises before anything of the net changes."""
    cfg, _, algo, cache = _port_algo(reference)
    cfg.tta_strategy = strategy.upper()
    before = {k: v.clone() for k, v in algo.net.state_dict().items()}
    with pytest.raises(ValueError, match="tta_strategy"):
        adapt(cfg, algo, cache)
    for k, v in algo.net.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_unported_entry_points_raise():
    with pytest.raises(ValueError, match="tta_strategy"):
        adapt(_cfg(load_config, tta_strategy="tentt"), None, {})
    # training is ported, host_stream too (slice 13): the training
    # options' check passes it, and raises only for what stays refused
    from stil_tta_torch.train.evaluate import _refuse_unported
    hs = _cfg(load_config, host_stream=True)
    _refuse_unported(hs)
    hs.val_check_interval = 0.5
    with pytest.raises(ValueError, match="val_check_interval"):
        _refuse_unported(hs)
    # missing_tabular and Supervised are ported: the test split carries
    # its masks, and the registry builds Supervised
    cfg = _cfg(load_config, missing_tabular=True, missing_rate=0.5)
    src = load_test_split(cfg)
    assert src.missing.shape == src.tabular.shape and src.missing.any()
    algo = build_algo(_cfg(load_config, algorithm_name="Supervised"),
                      FIELD_LENGTHS, device="cpu")
    assert algo.name == "Supervised"
