"""The port's shift workflow on the CPU: shifted splits, then the port's
``test()`` with BN-adapt on them; the TTA demo; and the shift sweep
script ``run_dist_shifts_torch.sh`` against ``run_dist_shifts.sh``.

The workflow runs at the size of ``tests/test_shifted_workflow.py`` (160
rows, resnet18, 32x32 images, batch 8)."""

import importlib.util
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest

from chip_smoke import recording_adapt, script_commands
from stil_tta_torch.config import load_config
from stil_tta_torch.data.source import synthetic_source
from stil_tta_torch.dataprep.shifted import (build_shifted_splits,
                                             make_column_value_shift)
from stil_tta_torch.tools import tta_demo
from stil_tta_torch.train.test import test as run_test
from tests.torch_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FIELDS = [5, 4, 2, 1, 1, 1]


def test_shifted_split_bn_adapt_workflow(tmp_path):
    src = synthetic_source(160, num_classes=4, field_lengths=FIELDS,
                           image_size=40, seed=0)
    res = build_shifted_splits(
        src, make_column_value_shift("black", column=0, values=[3.0]),
        label_fraction=0.2, out_dir=tmp_path / "shift")
    report = json.loads((tmp_path / "shift" / "shift_report.json")
                        .read_text())
    assert report["sizes"] == {k: len(v) for k, v in res["splits"].items()}
    assert (res["splits"]["test"].tabular[:, 0] == 3.0).all()

    cfg = _black_test_cfg(tmp_path, res["num_classes"], "bn_adapt")
    # the shifted YAMLs name no data and carry the reference's class count
    assert cfg.shift_name == "black" and cfg.field_lengths is None
    metrics = run_test(cfg, device="cpu")
    assert "test.acc" in metrics
    assert all(math.isfinite(v) for v in metrics.values())
    assert (tmp_path / "run" / "test_results.csv").exists()


def _black_test_cfg(tmp_path: Path, num_classes: int, strategy: str):
    shift = tmp_path / "shift"
    return load_config("config_dvm_STiL", overrides=[
        "dataset=dvm_all_server_reordered_SemiPseudo_0.1_black",
        "models=resnet18", "batch_size=8", "img_size=32",
        f"num_classes={num_classes}", "tabular_embedding_dim=32",
        "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
        "projection_dim=8", "test=True", "tta=true",
        f"tta_strategy={strategy}", "enable_progress_bar=false",
        f"data_base={shift}", f"data_val={shift / 'test'}",
        f"logdir={tmp_path / 'run'}"])


def test_recorded_adapt_tells_tent_from_bn_adapt(tmp_path):
    """chip_smoke's phase 20 (b) holds Tent on ``black`` to what
    ``recording_adapt`` sees inside ``test()``, since Tent's eval-mode
    entropy steps launch no kernel: BN-adapt runs its stats sweep and
    leaves the BN affine parameters as they were, Tent also runs one
    entropy step a batch and moves them."""
    src = synthetic_source(160, num_classes=4, field_lengths=FIELDS,
                           image_size=40, seed=0)
    res = build_shifted_splits(
        src, make_column_value_shift("black", column=0, values=[3.0]),
        label_fraction=0.2, out_dir=tmp_path / "shift")
    batches = math.ceil(len(res["splits"]["test"]) / 8)
    for strategy in ("bn_adapt", "tent"):
        cfg = _black_test_cfg(tmp_path, res["num_classes"], strategy)
        with recording_adapt({}) as adapted:
            run_test(cfg, device="cpu")
        want = {"stats_batches": batches}
        if strategy == "tent":
            want["steps"] = batches
        assert adapted["counts"] == want
        assert (adapted["moved"] > 0) == (strategy == "tent")


def _jax_demo_module():
    """``tools/tta_demo.py`` loaded as a module; its JAX imports live in
    ``main``, which is not called."""
    spec = importlib.util.spec_from_file_location(
        "jax_tta_demo", REPO / "tools" / "tta_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_shift_images_is_bitwise_the_jax_demo_s():
    jdemo = _jax_demo_module()
    imgs = np.random.RandomState(0).randint(0, 256, (5, 9, 7, 3), np.uint8)
    for x in (imgs, imgs.astype(np.float32)):
        got, want = tta_demo.shift_images(x), jdemo.shift_images(x)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()


def test_tta_demo_writes_the_jax_demo_s_keys(tmp_path):
    src = (REPO / "tools" / "tta_demo.py").read_text()
    strategies = re.findall(r'"(\w+)"', re.search(
        r"strategies = \(([^)]*)\)", src).group(1))
    assert tuple(strategies) == tta_demo.STRATEGIES
    keys = (["clean", "shift_no_tta"]
            + [f"shift_{s}" for s in strategies]
            + [f"recovered_{s}" for s in strategies])
    assert tta_demo.main([
        "--root", str(tmp_path), "--device", "cpu", "--epochs", "1",
        "--classes", "4", "--img-size", "16", "--batch-size", "4",
        "--n-train", "8", "--n-test", "8", "--tta-steps", "1"]) == 0
    out = json.loads((tmp_path / "tta_demo.json").read_text())
    assert list(out) == keys
    assert all(math.isfinite(v) for v in out.values())
    for s in strategies:
        assert out[f"recovered_{s}"] == out[f"shift_{s}"] - out[
            "shift_no_tta"]


@pytest.mark.parametrize("env", [{}, {"FRACTION": "0.01",
                                      "CHECKPOINT": "x"}])
def test_sweep_script_runs_the_jax_script_s_commands(env):
    jax_cmds, port_cmds = (
        script_commands(REPO / script, "data_base=/d", "data_val=/d/test",
                        env=env)
        for script in ("run_dist_shifts.sh", "run_dist_shifts_torch.sh"))
    assert len(jax_cmds) == 7
    assert all(c[0] == "run.py" for c in jax_cmds)
    assert port_cmds == [["-m", "stil_tta_torch.run"] + c[1:]
                         for c in jax_cmds]
    fraction = env.get("FRACTION", "0.1")
    assert [c[4] for c in port_cmds] == [
        f"dataset=dvm_all_server_reordered_SemiPseudo_{fraction}_{s}"
        for s in ("normal", "black", "b-s-g", "b-s-b-g-w", "miles",
                  "adv_year", "labels")]
    assert all(("checkpoint=x" in c) == ("CHECKPOINT" in env)
               and c[-2:] == ["data_base=/d", "data_val=/d/test"]
               for c in port_cmds)
