"""The readers of the port's program spans (``eager_step_host_ms``,
``eval_batch_host_ms``, ``eval_host_metric_ms``) on synthetic span
lists: the median of their span's durations in milliseconds, and
nothing without a traced window, without their span, or when the eager
step's span is the other driver's."""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import harness  # noqa: E402
from stil_tta_torch.utils import trace  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
MS = 1_000_000


def reader(base: str):
    return harness.load_module(BENCH / "metrics" / f"{base}.py",
                               "t_" + base).read


def record(driver: str) -> dict:
    return {"mix": {"driver": driver}, "counts": {}, "spans": {},
            "window_s": 40.0, "trace": {"busy_s": 30.0}}


def spans_of(name: str, ms) -> list:
    """Records of ``name`` lasting ``ms`` each, one after another, each
    with a nested span that must not count."""
    out, at = [], 0
    for d in ms:
        out.append((name, at, at + int(d * MS), -1))
        out.append(("inner", at, at + 1, len(out) - 1))
        at += int(d * MS) + 5
    return out


@pytest.mark.parametrize("base,driver,span", [
    ("eager_step_host_ms", "train", "train.step"),
    ("eager_step_host_ms", "tta", "tta.step"),
    ("eval_batch_host_ms", "train", "eval.batch"),
    ("eval_batch_host_ms", "tta", "eval.batch"),
    ("eval_host_metric_ms", "train", "eval.metrics"),
    ("eval_host_metric_ms", "tta", "eval.metrics")])
def test_reader_takes_the_median_of_its_span(monkeypatch, base, driver,
                                             span):
    read = reader(base)
    spans = spans_of(span, [150.0, 3.0, 240.0, 180.0]) + spans_of(
        "other", [1e4])
    monkeypatch.setattr(trace, "spans", lambda: spans)
    assert read(record(driver)) == pytest.approx(165.0)
    spans.append((span, 0, None, -1))     # still open: not read
    assert read(record(driver)) == pytest.approx(165.0)
    assert read(dict(record(driver), trace=None)) is None
    monkeypatch.setattr(trace, "spans", lambda: spans_of("other", [2.0]))
    assert read(record(driver)) is None


@pytest.mark.parametrize("driver,other", [("train", "tta.step"),
                                          ("tta", "train.step")])
def test_eager_step_reads_only_its_drivers_span(monkeypatch, driver, other):
    read = reader("eager_step_host_ms")
    monkeypatch.setattr(trace, "spans", lambda: spans_of(other, [100.0]))
    assert read(record(driver)) is None
    assert read(record("serve")) is None


def test_the_nine_entries_name_their_readers_and_cells():
    cells = {"train": "stil_dvm.train", "cardiac": "stil_cardiac.train",
             "tta": "stil_dvm.tta_tent"}
    moves = {"train": "train_samples_per_s",
             "cardiac": "train_samples_per_s.cardiac",
             "tta": "tta_samples_per_s"}
    got = {m["name"]: m for m in SPEC["per_layer"]
           if m["source"] == "program_span"
           and m["name"].split(".")[0] in ("eager_step_host_ms",
                                           "eval_batch_host_ms",
                                           "eval_host_metric_ms")}
    assert len(got) == 9
    for name, m in got.items():
        suffix = name.split(".")[1]
        assert m["workloads"] == [cells[suffix]]
        assert m["moves"] == moves[suffix]
        assert (m["unit"], m["better"]) == ("ms", "lower")
