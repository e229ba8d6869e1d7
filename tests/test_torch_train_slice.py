"""The port's training loop (``train.evaluate.evaluate``) on the CPU at a
tiny size: it runs, writes its CSVs and checkpoints and scores the test
split; it feeds the train step the same (idx_l, idx_u) stream and learning
rates as the JAX package's ``evaluate`` would (the per-epoch sampler seeds
``seed + 100003 * epoch (+1)`` and ``scheduled_lr``); and a run stopped
after one epoch and resumed through the CLI from ``checkpoint_last`` ends
bitwise equal to the straight two-epoch run, as
``tests/test_resume_exact.py`` holds the JAX package.

Sizes: ``resnet18`` on 32x32 images, batch 8 (2 labelled + 6
unlabelled), 8 labelled and 24 unlabelled rows (4 steps an epoch), 2
epochs. Every comparison is exact: index streams and learning rates are
host values, and a resumed run repeats the same float operations."""

import json
import math

import numpy as np
import pytest
import torch

from stil_tta_torch import run as port_run
from stil_tta_torch.algorithms.stil import STiL
from stil_tta_torch.config import load_config
from stil_tta_torch.train.evaluate import evaluate
from stil_tta_tpu.config import load_config as jax_load_config
from stil_tta_tpu.data.datasets import load_sources as jax_load_sources
from stil_tta_tpu.data.loader import CyclingSampler as JCyclingSampler
from stil_tta_tpu.data.loader import EpochSampler as JEpochSampler
from stil_tta_tpu.train import optim as joptim
from tests.torch_parity import first_checkpoint_kept
from tests.torch_parity import one_torch_thread  # noqa: F401

OVERRIDES = [
    "dataset=synthetic_dvm", "models=resnet18", "img_size=32",
    "synthetic_image_size=40", "batch_size=8", "unlabelled_ratio=3",
    "synthetic_labelled=8", "synthetic_unlabelled=24", "synthetic_val=12",
    "synthetic_test=12", "num_classes=4", "tabular_embedding_dim=32",
    "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
    "projection_dim=8", "start_epoch=0", "strict_prototypes=false",
    "enable_progress_bar=false", "checkpoint_every_n_epochs=1",
    "scheduler=cosine", "lr_eval=1.0e-3",
]
EPOCHS, STEPS = 2, 4


def _cli(*extra):
    return port_run.main(["--config-name", "config_dvm_STiL", "--device",
                          "cpu", "evaluate=True", *OVERRIDES, *extra])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A: two epochs straight through ``evaluate``, recording what each
    step is fed. B: one epoch through the CLI. C: the CLI resuming B's
    ``checkpoint_last`` for the second epoch."""
    root = tmp_path_factory.mktemp("train_slice")
    torch.set_num_threads(1)   # the autouse fixture is function-scoped
    fed = []
    real = STiL.make_train_step

    def recording(self):
        step = real(self)

        def rec(state, cache_l, cache_u, idx_l, idx_u, epoch, **kw):
            fed.append((epoch, idx_l.numpy().copy(), idx_u.numpy().copy(),
                        state.optimizer.param_groups[0]["lr"]))
            return step(state, cache_l, cache_u, idx_l, idx_u, epoch, **kw)
        return rec

    cfg = load_config("config_dvm_STiL", OVERRIDES + [
        f"max_epochs={EPOCHS}", "test_and_eval=true", "evaluate=True",
        f"logdir={root / 'a'}"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(STiL, "make_train_step", recording)
        results = evaluate(cfg, device="cpu")
    rc_b = _cli("max_epochs=1", "test_and_eval=false", f"logdir={root / 'b'}")
    rc_c = _cli("resume_training=True",
                f"checkpoint={root / 'b' / 'checkpoint_last'}",
                f"max_epochs={EPOCHS}", f"logdir={root / 'c'}")
    return {"root": root, "fed": fed, "results": results, "cfg": cfg,
            "rc": (rc_b, rc_c)}


def _train_logs(logdir):
    """epoch -> the train logs of ``metrics.jsonl``, wall-clock keys
    dropped."""
    out = {}
    for line in (logdir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if "multimodal.train.loss" in rec:
            out[rec["_step"]] = {k: v for k, v in rec.items()
                                 if not k.endswith(("samples_per_sec",
                                                    "_time"))}
    return out


def test_evaluate_trains_and_writes_outputs(runs):
    a = runs["root"] / "a"
    for name in ("metrics.jsonl", "eval_results.csv", "test_results.csv",
                 "checkpoint_best_acc", "checkpoint_best_acc_config.json",
                 "checkpoint_last", "checkpoint_last_config.json"):
        assert (a / name).exists(), name
    logs = _train_logs(a)
    assert sorted(logs) == list(range(EPOCHS))
    for epoch, rec in logs.items():
        assert all(math.isfinite(v) for k, v in rec.items()
                   if isinstance(v, float)), (epoch, rec)
    res = runs["results"]
    assert 0 <= res["best_val"] <= 1
    for k in ("test.acc", "test.auc", "test.acc_imaging", "test.acc_tabular"):
        assert math.isfinite(res[k]), k
    state = torch.load(a / "checkpoint_last", weights_only=True)
    assert state["step"] == EPOCHS * STEPS


def test_step_inputs_and_learning_rates_match_jax_evaluate(runs):
    jcfg = jax_load_config("config_dvm_STiL", OVERRIDES)
    src = jax_load_sources(jcfg)
    n_l, n_u = len(src["train_labelled"]), len(src["train_unlabelled"])
    seed0, l_batch, u_batch = int(jcfg.seed), 2, 6
    jcfg.dataset_length = STEPS
    want = []
    for epoch in range(EPOCHS):
        u = JEpochSampler(n_u, u_batch, shuffle=True, drop_last=True,
                          seed=seed0 + 100003 * epoch)
        lab = JCyclingSampler(n_l, l_batch, seed=seed0 + 100003 * epoch + 1)
        lr = joptim.scheduled_lr(jcfg, epoch, None, None)
        want += [(epoch, lab.next()[0], idx_u, lr)
                 for idx_u, _ in u.epoch()][:STEPS]
    fed = runs["fed"]
    assert len(fed) == len(want) == EPOCHS * STEPS
    for (e, il, iu, lr), (we, wil, wiu, wlr) in zip(fed, want):
        assert e == we
        np.testing.assert_array_equal(il, wil)
        np.testing.assert_array_equal(iu, wiu)
        assert lr == wlr
    assert fed[0][3] != fed[-1][3]   # the schedule moved between epochs


def _assert_equal_tree(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_equal_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_tree(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def test_cli_resume_is_bitwise_exact(runs):
    assert runs["rc"] == (0, 0)
    root = runs["root"]
    straight = torch.load(root / "a" / "checkpoint_last", weights_only=True)
    resumed = torch.load(root / "c" / "checkpoint_last", weights_only=True)
    _assert_equal_tree(straight, resumed)
    assert resumed["step"] == EPOCHS * STEPS
    # the resumed run trained epoch 1 only, and logged it as A did
    a_logs, c_logs = _train_logs(root / "a"), _train_logs(root / "c")
    assert sorted(c_logs) == [1]
    assert c_logs[1] == a_logs[1]


def test_cli_resume_is_bitwise_exact_in_the_fast_profile(tmp_path):
    """The fast numerics profile (``micro_batches=2
    adam_mu_dtype=bfloat16``): two epochs straight through the CLI end
    bitwise equal to the same run's first-epoch checkpoint resumed for the
    second, the bfloat16 first moment included."""
    # checkpoint_last only: each snapshot holds the net, the EMA backbone
    # and both Adam moments
    fast = ("micro_batches=2", "adam_mu_dtype=bfloat16",
            "save_checkpoints=false")
    with first_checkpoint_kept(tmp_path / "b"):
        assert _cli(*fast, "max_epochs=2", "test_and_eval=false",
                    f"logdir={tmp_path / 'a'}") == 0
    assert _cli("resume_training=True",
                f"checkpoint={tmp_path / 'b' / 'checkpoint_last'}",
                f"max_epochs={EPOCHS}", f"logdir={tmp_path / 'c'}") == 0
    straight = torch.load(tmp_path / "a" / "checkpoint_last",
                          weights_only=True)
    resumed = torch.load(tmp_path / "c" / "checkpoint_last",
                         weights_only=True)
    _assert_equal_tree(straight, resumed)
    assert resumed["step"] == EPOCHS * STEPS
    moments = straight["optimizer"]["state"].values()
    assert {m["exp_avg"].dtype for m in moments} == {torch.bfloat16}
    assert {m["exp_avg_sq"].dtype for m in moments} == {torch.float32}
    assert _train_logs(tmp_path / "c")[1] == _train_logs(tmp_path / "a")[1]


@pytest.mark.parametrize("override", [
    "host_stream=true", "teacher_int8=true", "checkpoint=warm.ckpt",
    "model=wide_resnet50_2", "algorithm_name=Tent",
])
def test_unported_training_options_raise(override, tmp_path):
    """Options still to port raise ``NotImplementedError`` naming
    ROADMAP.md (``host_stream``; the wider ResNet is the image encoder's
    refusal); a name that no registry knows (``Tent``) raises
    ``ValueError``, as the JAX registry does. ``teacher_int8`` and the
    ``.ckpt`` warm start are ported: STiL refuses the int8 teacher only
    for a ViT encoder (``ValueError``, as JAX), and the warm start reads
    the file (here missing: ``FileNotFoundError``)."""
    cfg = load_config("config_dvm_STiL", OVERRIDES + [
        override, f"logdir={tmp_path}"])
    error, match = {
        "algorithm_name=Tent": (ValueError, "Algorithm name not found"),
        "teacher_int8=true": (ValueError, "ViT unsupported"),
        "checkpoint=warm.ckpt": (FileNotFoundError, "warm.ckpt"),
    }.get(override, (NotImplementedError, "ROADMAP.md"))
    if override == "teacher_int8=true":
        cfg.model = "vit_base"
    with pytest.raises(error, match=match):
        evaluate(cfg, device="cpu")
