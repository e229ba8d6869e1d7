"""The harness on the CPU: the imports it may load, finding a cell's
files by name, the result line, the moves rule of ``BENCHMARK.json``,
and a run refused without a card."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import harness  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "stil_tta_tpu"}
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

# a tiny configuration for CPU runs: the DVM file with its widths cut
TINY = {"img_size": 32, "tabular_embedding_dim": 32,
        "tabular_transformer_num_layers": 1, "multimodal_embedding_dim": 32,
        "projection_dim": 8, "num_classes": 4, "batch_size": 8,
        "steps_per_dispatch": 3}


def loaded_modules(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
            f"{code}\nprint(sorted({{m.split('.')[0] for m in sys.modules}}))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_benchmark_modules_load_no_jax():
    code = "\n".join(
        ["import run, harness, counts, inputs, system, tracesum, "
         "bn_roofline, calibrate",
         "import reference.nets, reference.stil, reference.compare",
         "import stil_tta_torch.train.evaluate, stil_tta_torch.tta.tent",
         "import stil_tta_torch.train.multistep",
         "from pathlib import Path",
         "for p in sorted(Path(harness.BENCH, 'drivers').glob('*.py')) + "
         "sorted(Path(harness.BENCH, 'metrics').glob('*.py')):",
         "    harness.load_module(p, 'm_' + p.stem.replace('.', '_'))"])
    names = loaded_modules(code)
    assert "stil_tta_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = loaded_modules("import reference.nets, reference.stil, "
                           "reference.compare, reference.augment")
    assert not names & (FORBIDDEN | {"stil_tta_torch"})
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for mod in mods:
                assert mod.split(".")[0] not in FORBIDDEN | {
                    "stil_tta_torch"}, (path, mod)


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(["stil_tta_torch.ops", "jaxtyping",
                                      "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "stil_tta_tpu.x"]) == [
        "jax", "stil_tta_tpu"]


def test_spec_names_units_and_moves():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert (BENCH / "workloads" / f"{w['name']}.json").exists()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    for c in SPEC["configs"]:
        assert Path(ROOT, c["file"]).exists()
    for m in SPEC["per_layer"]:
        base = harness.base_name(m["name"])
        assert (BENCH / "metrics" / f"{base}.py").exists()
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            # every cell that reports the metric reports what it moves
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:
        reported = [m for m in SPEC["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in SPEC["per_layer"])
    budget = 2 + 14 * 24
    assert budget * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "stil_dvm.train",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def tiny_bench(tmp_path: Path) -> tuple:
    """A throwaway benchmark folder: the drivers, mixes and readers as
    they are, plus a tiny configuration, its cells, a new traffic mix and
    a new per-layer metric, each a file of its own; and its spec."""
    for d in ("drivers", "traffic", "metrics", "workloads"):
        shutil.copytree(BENCH / d, tmp_path / d)
    conf = json.loads((BENCH / "configs" / "stil_dvm.json").read_text())
    conf["cfg"].update(TINY)
    conf["reduced"] = sorted(TINY)
    conf["splits"] = {"labelled": 4, "unlabelled": 70, "val": 20}
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(conf))
    (tmp_path / "traffic" / "tiny_tent.json").write_text(json.dumps(
        {"driver": "tta", "splits": 2, "split_rows": 16}))
    (tmp_path / "metrics" / "splits_done.py").write_text(
        "def read(rec):\n    return rec['counts'].get('splits')\n")
    for cell, src in (("tiny.train", "stil_dvm.train"),
                      ("tiny.tent", "stil_dvm.tta_tent")):
        shutil.copy(BENCH / "workloads" / f"{src}.json",
                    tmp_path / "workloads" / f"{cell}.json")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"] = [
        {"name": "tiny.train", "config": "tiny", "traffic": "train",
         "chips": 1, "why": "tiny"},
        {"name": "tiny.tent", "config": "tiny", "traffic": "tiny_tent",
         "chips": 1, "why": "tiny"}]
    # the tiny cells take the DVM cells' metrics
    for key in ("end_to_end", "per_layer"):
        spec[key] = [m for m in spec[key] if m.get("workloads") != [
            "stil_cardiac.train"]]
        for m in spec[key]:
            if "workloads" in m:
                tta = any("tta" in w for w in m["workloads"])
                m["workloads"] = ["tiny.tent" if tta else "tiny.train"]
    spec["per_layer"].append(
        {"name": "splits_done", "unit": "splits", "better": "higher",
         "source": "program_counter", "layer": "TTA (tta/tent.py)",
         "moves": "tta_samples_per_s", "workloads": ["tiny.tent"]})
    return tmp_path, spec


def test_new_cell_config_mix_and_metric_are_found_by_name(tmp_path):
    bench, spec = tiny_bench(tmp_path)
    cell = harness.Cell(spec, "tiny.tent", bench)
    run = harness.Run(cell, 2 ** 31 + 17, 0.5, True, device="cpu")
    cell.driver.run(run)
    out = run.result({"platform": "cpu", "kind": "cpu", "count": 1})
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["metrics"]["splits_done"]["value"] >= 1
    assert set(out["checks"]) == set(cell.workload["limits"])
    assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
    assert len(out["breakdown"]["device_ops"]) <= 10
    json.dumps(out)


def test_train_cell_end_to_end_line(tmp_path):
    bench, spec = tiny_bench(tmp_path)
    cell = harness.Cell(spec, "tiny.train", bench)
    run = harness.Run(cell, 2 ** 31 + 23, 0.5, False, device="cpu")
    cell.driver.run(run)
    out = run.result({"platform": "cpu", "kind": "cpu", "count": 1})
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert out["attempted"] >= 1 and run.setup_s > 0
    assert set(out["checks"]) == set(cell.workload["limits"])


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["per_layer"]])
def test_readers_return_nothing_without_their_data(name):
    base = harness.base_name(name)
    read = harness.load_module(BENCH / "metrics" / f"{base}.py",
                               "t_" + base).read
    empty = {"counts": {}, "spans": {}, "window_s": 1.0, "trace": None,
             "config": json.loads((BENCH / "configs" /
                                   "stil_dvm.json").read_text())}
    assert read(empty) is None
