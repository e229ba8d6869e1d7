"""The check of ``correct`` must fail what it exists to catch.

On the CPU at a tiny size, the program computing in float32 (its other
path; in bfloat16 a tiny net's rounding alone reads as large as a fault
does): a run with its timed path broken underneath (a step that leaves
the state as it was, half of each batch left out and the mean taken over
the rest, an answer altered where it is made) reads ``correct`` false,
by a number far beyond the same number of a sound run; and the control,
the reference computed in float8 in the program's place, reads
``correct`` false. The cells run on one card, so no exchange between
cards can be left out. At the cells' own sizes on the card, the same
readings come from ``benchmark/calibrate.py``.
"""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import calibrate  # noqa: E402
import harness  # noqa: E402
import system  # noqa: E402
from test_portbench_harness import tiny_bench  # noqa: E402

SEED = 2 ** 31 + 101


def verdict(cell, readings: dict) -> bool:
    limits = cell.workload["limits"]
    return all(readings[k] <= v for k, v in limits.items() if k in readings)


def tiny_cell(tmp_path, name):
    bench, spec = tiny_bench(tmp_path)
    return harness.Cell(spec, name, bench)


def still_step():
    """A train step that returns its state unchanged."""
    def step(state, *args, **kwargs):
        state.step += 1
        return state
    return step


@pytest.fixture(scope="module", autouse=True)
def float32_program():
    system.COMPUTE_DTYPE["dtype"] = torch.float32
    yield
    system.COMPUTE_DTYPE["dtype"] = torch.bfloat16


@pytest.fixture(scope="module")
def train_sound(tmp_path_factory, float32_program):
    cell = tiny_cell(tmp_path_factory.mktemp("t"), "tiny.train")
    return cell, calibrate.readings(cell, SEED, "cpu")


@pytest.fixture(scope="module")
def tent_sound(tmp_path_factory, float32_program):
    cell = tiny_cell(tmp_path_factory.mktemp("t"), "tiny.tent")
    return cell, calibrate.readings(cell, SEED, "cpu")


def test_control_fails_train(train_sound):
    cell, out = train_sound
    assert not verdict(cell, out["control"])


def test_control_fails_tent(tent_sound):
    cell, out = tent_sound
    assert not verdict(cell, out["control"])


@pytest.mark.parametrize("fault,caught_by", [
    ("still", "loss_gap"), ("half", "grad_median_gap"), ("answer", "val_kl")])
def test_train_faults_fail(train_sound, fault, caught_by):
    from stil_tta_torch.algorithms.stil import STiL
    cell, sound = train_sound
    if fault == "still":
        # the epoch end refuses a state no step moved (no prototype mass):
        # read what the set-up's steps left
        with calibrate.patched(STiL, "make_train_step",
                               lambda self: still_step()):
            run = harness.Run(cell, SEED, 0.0, False, device="cpu")
            out = cell.driver.check(run, cell.driver.prepare(run))["program"]
    else:
        with calibrate.FAULTS[fault]():
            out = calibrate.readings(cell, SEED, "cpu")["program"]
    assert not verdict(cell, out)
    assert out[caught_by] > cell.workload["limits"][caught_by]
    assert out[caught_by] >= 3 * sound["program"][caught_by]


@pytest.mark.parametrize("fault,caught_by", [
    ("still", "bn_stats_gap"), ("tta_half", "bn_stats_gap"),
    ("tta_frozen", "tent_change_median_gap"), ("answer", "score_kl")])
def test_tent_faults_fail(tent_sound, fault, caught_by):
    from stil_tta_torch.tta import tent
    cell, sound = tent_sound

    def still_adapt(cfg, algo, cache, *a, **k):
        return {"stats_batches": 0, "steps": 0}

    patch = (calibrate.patched(tent, "adapt", still_adapt)
             if fault == "still" else calibrate.FAULTS[fault]())
    with patch:
        out = calibrate.readings(cell, SEED, "cpu", control=False)[
            "program"]
    assert not verdict(cell, out)
    assert out[caught_by] > cell.workload["limits"][caught_by]
    assert out[caught_by] >= 3 * sound["program"][caught_by]
