"""CoMatch of the port against the JAX package: the imaging single-batch
step and the multimodal ``step_micro`` at m = 2 (both queues and their
probabilities and positions, the DA history ring), the two enqueues (one
truncated at column 2,560), the ring's length before it is full, the
momentum encoder's BatchNorm statistics left as they were by its
train-mode forward, a checkpoint round trip of the buffers, and both DVM
YAMLs through the CLI (train, exact resume, test with BN-adapt on the
checkpoint in the reference's layout).

Setup as ``tests/test_torch_freematch.py`` (float64 on both sides, the
JAX module with ``jnp.float32`` read as float64, fixed distinct views
with two strong ones, ``start_epoch`` 0 at epoch 1, so the pseudo labels
are smoothed through the weak queue and ``lam_c`` is 2). The queues hold
the JAX package's own embeddings (``queue_s`` from
``jax.random.key(11)``, normalised; ``queue_w`` from key 13, not
normalised), carried into the port as data, with random probability
columns; ``ptr_s`` is 100 and ``ptr_w`` 2,550, so the weak enqueue of 16
rows writes 10 and drops 6; the DA ring holds 5 random distributions
(``hist_len`` 5, position 5). ``co_threshold`` and ``contrast_th`` are
0.45 and 0.45 (imaging), 0.55 and 0.5 (multimodal): the mask keeps some
rows and not all, and the graph has edges off its diagonal; moving
either by 1e-6 either way changes no mask entry and no edge, so no
margin lies within 1e-6 of a threshold.

Two JAX steps are compiled for the file. Tolerances: rtol 1e-8 on
losses, atol 1e-9 on parameters, rtol 1e-9 on the buffers; the
``threshold1_ratio`` log is a float32 mean on the port's side, rtol
2e-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms.comatch import DA_WINDOW, CoMatch
from stil_tta_torch.algorithms.registry import get_algorithm
from stil_tta_torch.config import load_config
from stil_tta_torch.train.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from stil_tta_torch.train.convert import train_state_from_jax
from stil_tta_tpu.algorithms import comatch as jcomatch
from stil_tta_tpu.config import load_config as jax_load_config
from tests.torch_parity import (IDX_L, assert_close, cli_train_resume_test,
                                compare_match_states, fixmatch_data,
                                fixmatch_steps, match_cfg,
                                port_fixmatch_step)
from tests.torch_parity import one_torch_thread  # noqa: F401

C, K = 4, 2560
PTR_S, PTR_W, FILLED = 100, K - 10, 5
THRESHOLDS = {"imaging": (0.45, 0.45), "multimodal": (0.55, 0.5)}


def _cfg_of(kind):
    name = ("config_dvm_CoMatch" if kind == "imaging"
            else "config_dvm_MultiCoMatch")
    thr, edge = THRESHOLDS[kind]
    micro = ["micro_batches=2"] if kind == "multimodal" else []

    def cfg_of(loader, *extra):
        return match_cfg(loader, name, *micro, f"co_threshold={thr}",
                         f"contrast_th={edge}", *extra)
    return cfg_of


CFG = {kind: _cfg_of(kind) for kind in THRESHOLDS}


def _fill(jstate):
    rng = np.random.RandomState(4)
    hist = np.zeros((DA_WINDOW, C))
    hist[:FILLED] = rng.dirichlet(np.ones(C), FILLED)
    i32 = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    return jstate.replace(extra=dict(
        jstate.extra,
        probs_u=jnp.asarray(rng.dirichlet(np.ones(C), K).T),
        probs_xu=jnp.asarray(rng.dirichlet(np.ones(C), K).T),
        hist_prob=jnp.asarray(hist), hist_len=i32(FILLED),
        hist_ptr=i32(FILLED), ptr_s=i32(PTR_S), ptr_w=i32(PTR_W)))


@pytest.fixture(scope="module")
def run():
    return {kind: fixmatch_steps(jcomatch, jcomatch.CoMatch, CoMatch,
                                 cfg_of, _fill)
            for kind, cfg_of in CFG.items()}


def test_registry_and_configs():
    assert get_algorithm("CoMatch") is CoMatch
    for name in ("config_dvm_CoMatch", "config_dvm_MultiCoMatch"):
        ours = load_config(name, ["dataset=synthetic_dvm"])
        ref = jax_load_config(name, ["dataset=synthetic_dvm"])
        assert ours.to_dict() == ref.to_dict(), name


@pytest.mark.parametrize("kind", ["imaging", "multimodal"])
def test_step_matches_jax(run, kind):
    """Logs, parameters, running statistics, the momentum encoder, both
    queues, their probabilities and positions, the DA ring and the
    accuracies after the imaging single-batch step and the multimodal
    ``step_micro`` at m = 2."""
    jstate, pstate, _ = run[kind]
    assert pstate.step == 1 == int(jstate.step)
    compare_match_states(jstate, pstate, CoMatch.LOG_KEYS)
    logs = {k: float(v) for k, v in pstate.log_sums.items()}
    assert 0 < logs["threshold1_ratio"] < 1
    assert logs["loss_u"] > 0 and logs["loss_contrast"] > 0
    assert logs["loss"] == pytest.approx(
        logs["loss_x"] + 10 * logs["loss_u"] + 2 * logs["loss_contrast"],
        rel=1e-9)


@pytest.mark.parametrize("kind", ["imaging", "multimodal"])
def test_both_enqueues(run, kind):
    """The 12 strong embeddings fill ``queue_s`` columns 100-111 (unit
    columns) with their pseudo labels; the 16 labelled and weak rows,
    labelled one-hots first, fill ``queue_w`` columns 2,550-2,559 and the
    6 past the end are dropped, so ``ptr_w`` returns to 0. Every other
    column is unchanged, and the written ones equal JAX's."""
    jstate, pstate, carried = run[kind]
    want = train_state_from_jax(jstate)["extra"]
    start = carried["extra"]
    ex = pstate.extra
    assert (ex["ptr_s"], ex["ptr_w"]) == (PTR_S + 12, 0) == \
        (want["ptr_s"], want["ptr_w"])
    spans = {"queue_s": (PTR_S, PTR_S + 12), "probs_u": (PTR_S, PTR_S + 12),
             "queue_w": (PTR_W, K), "probs_xu": (PTR_W, K)}
    for k, (lo, hi) in spans.items():
        assert_close(ex[k][:, lo:hi], want[k][:, lo:hi].numpy(), 1e-9,
                     1e-12, k)
        assert torch.equal(ex[k][:, :lo], start[k][:, :lo]), k
        assert torch.equal(ex[k][:, hi:], start[k][:, hi:]), k
        assert (ex[k][:, lo:hi] != start[k][:, lo:hi]).any(0).all(), k
    assert_close(ex["queue_s"][:, PTR_S:PTR_S + 12].norm(dim=0),
                 np.ones(12), 1e-10, 0)
    y_l = fixmatch_data()[0][1]["labels"][IDX_L]
    np.testing.assert_array_equal(
        ex["probs_xu"][:, PTR_W:PTR_W + 4].T.numpy(), np.eye(C)[y_l])


@pytest.mark.parametrize("kind", ["imaging", "multimodal"])
def test_da_ring_before_it_is_full(run, kind):
    """One slot written at position 5 (the batch's mean; in ``step_micro``
    the mean of the chunk means), ``hist_len`` 6 and the mean taken over
    6 slots, not 128; the other slots unchanged."""
    jstate, pstate, carried = run[kind]
    ex, start = pstate.extra, carried["extra"]
    assert (ex["hist_len"], ex["hist_ptr"]) == (FILLED + 1, FILLED + 1)
    assert int(jstate.extra["hist_len"]) == FILLED + 1
    changed = (ex["hist_prob"] != start["hist_prob"]).any(1)
    assert changed.nonzero().flatten().tolist() == [FILLED]
    assert_close(ex["hist_prob"][FILLED].sum(), 1.0, 1e-12, 0)


@pytest.mark.parametrize("kind", ["imaging", "multimodal"])
def test_momentum_encoder_statistics_unchanged(run, kind):
    """The momentum encoder runs in train-mode BatchNorm (its batch's
    statistics) and its running statistics and counters stay as they
    were, on both sides (``comatch.py:116-124``); the student's moved.
    Its parameters moved by the parameters-only lerp."""
    jstate, pstate, carried = run[kind]
    want = train_state_from_jax(jstate)["ema"]
    n = 0
    for k, v in pstate.ema.state_dict().items():
        if k.endswith(("running_mean", "running_var",
                       "num_batches_tracked")):
            assert torch.equal(v, carried["ema"][k]), k
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(want[k], carried["ema"][k]), k
            n += 1
        elif k.endswith("conv1.weight"):
            assert not torch.equal(v, carried["ema"][k]), k
    assert n == 3 * 20
    net = pstate.net.state_dict()
    key = next(k for k in net if k.endswith("bn1.running_mean"))
    assert not torch.equal(net[key], carried["net"][key])


@pytest.mark.parametrize("kind", ["imaging", "multimodal"])
def test_no_mask_or_edge_margin_within_1e6(run, kind):
    _, pstate, carried = run[kind]
    thr, edge = THRESHOLDS[kind]
    for d in (-1e-6, 1e-6):
        _, state = port_fixmatch_step(CoMatch, CFG[kind], carried, 1,
                                      f"co_threshold={thr + d}")
        assert float(state.log_sums["threshold1_ratio"]) == \
            float(pstate.log_sums["threshold1_ratio"])
        _, state = port_fixmatch_step(CoMatch, CFG[kind], carried, 1,
                                      f"contrast_th={edge + d}")
        # an edge that flips moves the loss by ~1e-2; without one the
        # sums agree to the summation order (1e-12)
        assert float(state.log_sums["loss_contrast"]) == pytest.approx(
            float(pstate.log_sums["loss_contrast"]), rel=1e-12)


def test_checkpoint_round_trip_of_the_buffers(run, tmp_path):
    _, pstate, _ = run["multimodal"]
    save_checkpoint(tmp_path, pstate, name="ckpt")
    cfg = CFG["multimodal"](load_config)
    fresh = CoMatch(cfg, cfg.field_lengths, dtype=torch.float64,
                    device="cpu").init_state(0)
    restore_checkpoint(tmp_path, fresh, name="ckpt")
    assert set(fresh.extra) == set(pstate.extra)
    for k, v in pstate.extra.items():
        if isinstance(v, int):
            assert fresh.extra[k] == v, k
        else:
            assert torch.equal(fresh.extra[k], v), k
    assert fresh.extra["ptr_w"] == 0 and fresh.extra["hist_len"] == 6


@pytest.mark.parametrize("name", ["config_dvm_CoMatch",
                                  "config_dvm_MultiCoMatch"])
def test_cli_trains_resumes_exactly_and_tests(name, tmp_path):
    cli_train_resume_test(name, tmp_path)
