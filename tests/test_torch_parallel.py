"""Data-parallel training and serving of the port against its own single
process (``python -m stil_tta_torch.tools.dryrun_multichip``).

The dry run is started twice, at once, for the whole module: on 2 gloo
ranks over every case of the tool (the JAX dry run's ten, the rest of the
registry, ``teacher_int8``, serving bf16-path and int8 with a padded tail,
an indivisible batch), and on 4 ranks in a 2 x 2 hybrid layout for STiL.
Each case trains one float64 step (as the JAX dry run does) on the ranks
and in one process from one seeded state and compares every leaf of the
two states: integers (ring pointers, bank labels, counters, step,
generator states) exactly, floats within rtol 1e-7 / atol 1e-10 (the
tool's ``TOLERANCE``: BatchNorm's one-pass variance turns the ranks'
summation order into up to 1.5e-8 relative on Supervised's parameters
after two steps, where a per-rank statistic or a gradient summed twice
is off by order 1). The first step's gradients, summed over the ranks,
are within a relative L2 gap of 1e-6 of the single process's on every
parameter (the tool's ``GRAD_LIMIT``: the sound layouts read at most
1.5e-13 here, a BatchNorm backward whose sums stay per rank 0.75 and
more). The ranks' states are bitwise equal, and each family's watched
buffers and its parameters moved.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from stil_tta_torch.algorithms.registry import ALGORITHMS
from stil_tta_torch.parallel import backend_for, collectives
from stil_tta_torch.parallel.collectives import _shard_of, rank_index
from stil_tta_torch.parallel.mesh import Mesh, rank_rows
from stil_tta_torch.tools.dryrun_multichip import (CASES, DRYRUN_ALGORITHMS,
                                                 _config)

ROOT = Path(__file__).resolve().parents[1]
RUNS = {2: ["--ranks", "2", "--cases", "all"],
        4: ["--ranks", "4", "--hybrid", "2x2", "--cases", "STiL"]}
TRAIN = [c for c, spec in CASES.items() if spec[1] == "train"]


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """Each run's results by case, from its ``dryrun_<ranks>.json``."""
    out = tmp_path_factory.mktemp("dryrun")
    procs = {n: subprocess.Popen(
        [sys.executable, "-m", "stil_tta_torch.tools.dryrun_multichip",
         "--device", "cpu", "--out", str(out)] + args, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, args in RUNS.items()}
    logs = {n: p.communicate(timeout=900)[0] for n, p in procs.items()}
    results = {}
    for n, p in procs.items():
        # exit code 1: a case failed, and its test says which
        assert p.returncode in (0, 1), logs[n][-4000:]
        results[n] = {r["case"]: r for r in json.loads(
            (out / f"dryrun_{n}.json").read_text())}
        results[n]["log"] = logs[n]
    return results


@pytest.mark.parametrize("case", TRAIN)
def test_two_rank_step_equals_the_single_process_step(dryrun, case):
    r = dryrun[2][case]
    assert r["leaves"] > 100
    assert not r["mismatches"], r["mismatches"]
    assert r["grad_gap"] <= r["grad_limit"] == 1e-6, r["grad_worst"]
    assert r["ranks_equal"], "the ranks' states differ"
    assert not r["unmoved"], f"never updated: {r['unmoved']}"
    assert r["ok"]
    # no kernel on the CPU: the plain sums ran, on both layouts
    assert r["launches_single"] == [[0, 0]]


def test_the_cases_cover_the_registry_and_the_jax_dry_run():
    names = {_config(CASES[c], "tiny").algorithm_name for c in TRAIN}
    assert names == set(ALGORITHMS)
    assert set(DRYRUN_ALGORITHMS) <= set(TRAIN)
    assert sum("micro_batches=2" in c for c in DRYRUN_ALGORITHMS) == 3


def test_saint_case_has_dropout_and_global_intersample_attention(dryrun):
    """STiL_SAINT trains with its feed-forward dropout on (the config
    leaves it to the reference's 0.8), so the equality above holds the
    masks and the intersample attention to the single process's."""
    r = dryrun[2]["STiL_SAINT"]
    assert r["config"]["saint_ff_dropout"] in (None, 0.8) and r["ok"]


def test_micro_batched_and_int8_cases_ran_as_configured(dryrun):
    for case in ("STiL[micro_batches=2]", "SimMatch[micro_batches=2]",
                 "CoMatch[micro_batches=2]"):
        assert dryrun[2][case]["config"]["micro_batches"] == 2
    assert dryrun[2]["STiL[teacher_int8=true]"]["config"]["teacher_int8"]


@pytest.mark.parametrize("case", ["serve", "serve[int8]"])
def test_two_rank_predictor_equals_the_single_predictor(dryrun, case):
    r = dryrun[2][case]
    assert r["ranks_equal"] and r["argmax_equal"]
    assert r["max_abs_diff"] <= r["atol"]
    assert r["ok"]


def test_hybrid_2x2_layout_equals_the_single_process(dryrun):
    r = dryrun[4]["STiL"]
    assert r["mesh"] == [2, 2]
    assert not r["mismatches"] and r["ranks_equal"] and not r["unmoved"]
    assert r["grad_gap"] <= r["grad_limit"], r["grad_worst"]
    assert r["backend"] == "gloo"
    assert r["ok"]


def test_an_indivisible_batch_raises_value_error_on_every_rank(dryrun):
    r = dryrun[2]["indivisible"]
    assert len(r["raised"]) == 2 and all("does not split" in m
                                         for m in r["raised"])


def test_dryrun_prints_a_pass_line_per_case(dryrun):
    lines = [ln for ln in dryrun[2]["log"].splitlines()
             if ln.startswith("dryrun_multichip(2)")]
    assert len(lines) == len(CASES)
    assert all(": PASS;" in ln for ln in lines), lines


def _mesh(rank, size):
    return Mesh((size,), (None,), None, rank)


def test_rank_rows_and_the_gather_order():
    """Rank r's rows are its share of each segment; stacking the ranks'
    rows and applying ``order`` restores the single-process order."""
    assert rank_rows(8, 1, 2).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError):
        rank_rows(6, 0, 4)
    shards = [_shard_of(_mesh(r, 2), (4, 12), "cpu") for r in range(2)]
    assert shards[0].index.tolist() == [0, 1, 4, 5, 6, 7, 8, 9]
    assert shards[1].index.tolist() == [2, 3, 10, 11, 12, 13, 14, 15]
    stacked = torch.cat([s.index for s in shards])
    assert stacked[shards[0].order].tolist() == list(range(16))
    assert shards[0].rows == 16
    assert rank_index(_mesh(1, 2), (4, 12)).tolist() == \
        shards[1].index.tolist()


@pytest.mark.parametrize("device,local_ranks,cards,backend", [
    ("cpu", 2, 0, "gloo"),
    ("cuda", 2, 1, "gloo"),      # two ranks share the one card
    ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"),      # a card a rank
    ("cuda", 8, 4, "gloo"),      # eight ranks on a four-card node
])
def test_backend_is_chosen_from_the_ranks_on_this_node(device, local_ranks,
                                                        cards, backend):
    assert backend_for(device, local_ranks, cards) == backend


@pytest.mark.parametrize("local_world,backend", [("4", "nccl"),
                                                 (None, "gloo")])
def test_a_two_node_job_takes_nccl_from_local_world_size(monkeypatch,
                                                         local_world,
                                                         backend):
    """Rank 5 of 2 nodes x 4 cards under ``torch.distributed.run``: the
    world (8) outnumbers the node's cards, its own ranks (4) do not.
    Without ``LOCAL_WORLD_SIZE`` every rank counts as this node's."""
    from stil_tta_torch.parallel import mesh as mesh_mod
    seen = {}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(mesh_mod.dist, "init_process_group",
                        lambda b, **kw: seen.update(backend=b, **kw))
    env = {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1"}
    if local_world:
        env["LOCAL_WORLD_SIZE"] = local_world
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if not local_world:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    dev = mesh_mod.init_process_group("cuda")
    assert dev == torch.device("cuda", 1)
    assert seen == {"backend": backend, "init_method": "env://", "rank": 5,
                    "world_size": 8}


def test_meshes_do_not_nest():
    a, b = _mesh(0, 2), _mesh(1, 2)
    with a:
        assert collectives.active_mesh() is a
        with pytest.raises(RuntimeError):
            b.__enter__()
        assert collectives.active_mesh() is a
    assert collectives.active_mesh() is None
