"""Program spans (``stil_tta_torch/utils/trace.py``) on the CPU: off
outside a profiler session and inside a suspended block (a CUDA graph
capture), nested records with their parents, ``clear`` and the bound,
the clock shared with the profiler's Kineto events, and the spans at the
port's layer boundaries: one ``eval.batch`` a batch and one
``eval.metrics`` a ``run_validation``, one ``train.step`` an eager STiL
step, one ``tta.step`` a Tent, EATA or SAR step. Tiny widths
(``resnet18`` at 16x16, batch 4); no JAX."""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stil_tta_torch.algorithms.registry import get_algorithm
from stil_tta_torch.config import load_config
from stil_tta_torch.data.datasets import load_sources
from stil_tta_torch.data.loader import DeviceCache
from stil_tta_torch.train.evaluate import run_validation
from stil_tta_torch.train.multistep import EagerSteps
from stil_tta_torch.tta.tent import adapt
from stil_tta_torch.utils import trace

OVERRIDES = [
    "dataset=synthetic_dvm", "models=resnet18", "img_size=16",
    "synthetic_image_size=20", "batch_size=4", "unlabelled_ratio=3",
    "synthetic_labelled=4", "synthetic_unlabelled=12", "synthetic_val=4",
    "synthetic_test=8", "num_classes=4", "tabular_embedding_dim=16",
    "multimodal_embedding_dim=16", "tabular_transformer_num_layers=1",
    "projection_dim=8", "start_epoch=0", "strict_prototypes=false",
    "enable_progress_bar=false", "tta_steps=1", "tta_e_margin_scale=0.9",
]


@pytest.fixture(autouse=True)
def fresh_recorder():
    """An empty buffer and one intra-op thread per test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.clear()
    yield
    trace.clear()
    torch.set_num_threads(threads)


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


def names():
    return [s[0] for s in trace.spans()]


@pytest.mark.parametrize("off", ["no_profiler", "suspended"])
def test_nothing_is_recorded_while_off(off):
    """Outside a profiler session (after one has ended) and inside
    ``suspended`` (``GraphedStep``'s capture), a span is the shared no-op
    and keeps nothing."""
    with profiled():
        pass
    with contextlib.ExitStack() as stack:
        if off == "suspended":
            stack.enter_context(profiled())
            stack.enter_context(trace.suspended())
        with trace.span("train.step"), trace.span("eval.batch"):
            pass
        assert trace.span("a") is trace.span("b")
    assert trace.spans() == [] and trace.dropped == 0


def test_span_names_read_as_no_runtime_call():
    """Every span name in the package is a layer's (``<layer>.<part>``)
    and none reads as a CUDA runtime call to the benchmark's trace
    reduction (a name starting with ``cuda`` or ``cuLaunch``, or holding
    ``Launch``)."""
    package = Path(trace.__file__).resolve().parent.parent
    found = set()
    for path in package.rglob("*.py"):
        found.update(re.findall(r'trace\.(?:span|traced)\("([^"]+)"',
                                path.read_text()))
    assert found == {"train.step", "tta.step", "eval.batch", "eval.metrics",
                     "dp.all_reduce", "dp.all_gather"}
    for name in found:
        assert not name.startswith(("cuda", "cuLaunch"))
        assert "Launch" not in name


def test_nested_spans_parents_clear_and_bound(monkeypatch):
    with profiled():
        with trace.span("outer"):
            with trace.span("inner"):
                pass
            with trace.span("inner"):
                pass
        with trace.span("next"):
            pass
    got = trace.spans()
    assert [(n, p) for n, _, _, p in got] == [
        ("outer", -1), ("inner", 0), ("inner", 0), ("next", -1)]
    outer = got[0]
    assert all(a <= b for _, a, b, _ in got)
    assert all(outer[1] <= s[1] and s[2] <= outer[2] for s in got[1:3])
    assert got[2][1] >= got[1][2] and got[3][1] >= outer[2]
    trace.clear()
    assert trace.spans() == []
    monkeypatch.setattr(trace, "LIMIT", 2)
    with profiled():
        for _ in range(5):
            with trace.span("s"):
                pass
    assert names() == ["s", "s"] and trace.dropped == 3
    trace.clear()
    assert trace.dropped == 0


def test_a_span_shares_the_profilers_clock():
    """The ``aten::mm`` inside a span, and the span's own profiler range
    by its name, lie within the span's [start_ns, end_ns]."""
    a = torch.randn(64, 64)
    with profiled() as prof:
        with trace.span("clock.mm"):
            torch.mm(a, a)
    (_, start, end, _), = trace.spans()
    events = prof.profiler.kineto_results.events()
    inside = [e for e in events if e.name() in ("aten::mm", "clock.mm")]
    assert sorted(e.name() for e in inside) == ["aten::mm", "clock.mm"]
    for e in inside:
        assert start <= e.start_ns() <= e.start_ns() + e.duration_ns() <= end


def test_run_validation_spans_each_batch_and_the_metrics():
    """Three batches (10 rows at 4, the tail padded): three ``eval.batch``
    spans, then one ``eval.metrics``, after all of them."""
    gen = torch.Generator().manual_seed(0)
    cache = {"labels": torch.arange(10) % 3}

    def eval_step(cache, idx, w):
        logits = torch.randn(idx.shape[0], 3, generator=gen)
        return {"prob_m": torch.softmax(logits, 1),
                "labels": cache["labels"][idx]}

    with profiled():
        metrics = run_validation(eval_step, cache, 4, 3)
    assert set(metrics) == {"eval.val.acc", "eval.val.auc"}
    assert names() == ["eval.batch"] * 3 + ["eval.metrics"]
    got = trace.spans()
    assert all(p == -1 for *_, p in got)
    assert got[3][1] >= got[2][2]


@pytest.fixture(scope="module")
def tiny():
    """A tiny STiL algorithm and its device caches."""
    cfg = load_config("config_dvm_STiL", OVERRIDES)
    sources = load_sources(cfg)
    cfg.num_classes = 4
    algo = get_algorithm("STiL")(cfg, sources["train_labelled"].field_lengths,
                                 device="cpu")
    caches = {k: DeviceCache(sources[k], device="cpu").as_dict()
              for k in ("train_labelled", "train_unlabelled", "test")}
    return cfg, algo, caches


def test_one_train_step_span_an_eager_step(tiny):
    """A direct call, then an :class:`EagerSteps` dispatch of two: one
    ``train.step`` a step."""
    torch.manual_seed(0)
    cfg, algo, caches = tiny
    state = algo.init_state(0)
    step = algo.make_train_step()
    rows = (caches["train_labelled"], caches["train_unlabelled"],
            torch.arange(1), torch.arange(3))
    with profiled():
        step(state, *rows, 1)
        assert names() == ["train.step"]
        EagerSteps(step)(state, [rows, rows], 1)
    assert names() == ["train.step"] * 3 and state.step == 3


@pytest.mark.parametrize("strategy", ["tent", "eata", "sar"])
def test_one_tta_step_span_an_adaptation_step(tiny, strategy):
    """8 test rows at batch 4, one epoch: two steps, two ``tta.step``
    spans; the statistics pass records none."""
    cfg, algo, caches = tiny
    cfg.tta_strategy = strategy
    with profiled():
        counts = adapt(cfg, algo, caches["test"])
    assert counts["steps"] == 2
    assert names() == ["tta.step"] * 2
    assert np.all([p == -1 for *_, p in trace.spans()])
