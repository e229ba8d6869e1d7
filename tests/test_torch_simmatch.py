"""SimMatch of the port against the JAX package: the imaging single-batch
step and the multimodal ``step_micro`` at m = 2 (the instance bank and
its labels, the DA ring), the bank scatter at the labelled rows' dataset
indices, a checkpoint round trip of the bank, and both DVM YAMLs through
the CLI (train with ``K`` left to the labelled set's size, exact resume,
test with BN-adapt on the checkpoint in the reference's layout).

Setup as ``tests/test_torch_freematch.py`` (float64 on both sides, the
JAX module with ``jnp.float32`` read as float64, fixed distinct views,
``start_epoch`` 0 at epoch 1, the labelled batch at dataset rows 4, 1, 5,
2 of 6). The bank (K = 6) holds the JAX package's own embeddings (drawn
from ``jax.random.key(7)``, carried into the port as data) with random
labels, and the DA ring random distributions at position 3, so the
smoothing and the alignment act on more than the init. ``sim_threshold``
is 0.35 (imaging) and 0.5 (multimodal), where the mask keeps some rows
and not all; moving it by 1e-6 either way changes no mask entry, so no
margin lies within 1e-6 of the threshold.

Two JAX steps are compiled for the file. Tolerances: rtol 1e-8 on
losses, atol 1e-9 on parameters, rtol 1e-9 on the bank and the DA ring;
the ``threshold1_ratio`` log is a float32 mean on the port's side, rtol
2e-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms.registry import get_algorithm
from stil_tta_torch.algorithms.simmatch import SimMatch
from stil_tta_torch.config import load_config
from stil_tta_torch.train.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from stil_tta_torch.train.convert import train_state_from_jax
from stil_tta_tpu.algorithms import simmatch as jsimmatch
from stil_tta_tpu.algorithms.base import DAState as JDAState
from stil_tta_tpu.config import load_config as jax_load_config
from tests.torch_parity import (FIX_L, IDX_L, assert_close,
                                cli_train_resume_test, compare_match_states,
                                fixmatch_data, fixmatch_steps, match_cfg,
                                port_fixmatch_step)
from tests.torch_parity import one_torch_thread  # noqa: F401

C, K = 4, FIX_L
THRESHOLD = {"imaging": 0.35, "multimodal": 0.5}


def _imaging(loader, *extra):
    return match_cfg(loader, "config_dvm_SimMatch", f"K={K}",
                     f"sim_threshold={THRESHOLD['imaging']}", *extra)


def _multimodal(loader, *extra):
    return match_cfg(loader, "config_dvm_MultiSimMatch", f"K={K}",
                     "micro_batches=2",
                     f"sim_threshold={THRESHOLD['multimodal']}", *extra)


CFG = {"imaging": _imaging, "multimodal": _multimodal}


def _fill(jstate):
    """Random labels in the bank; random distributions in the DA ring,
    its position at 3."""
    rng = np.random.RandomState(4)
    ring = rng.dirichlet(np.ones(C), 256)
    extra = dict(jstate.extra, bank_labels=jnp.asarray(
        rng.randint(0, C, K).astype(np.int32)))
    return jstate.replace(extra=extra, da=JDAState(
        jnp.asarray(ring), jnp.asarray(3, jnp.int32)))


@pytest.fixture(scope="module")
def run():
    return {kind: fixmatch_steps(jsimmatch, jsimmatch.SimMatch, SimMatch,
                                 cfg_of, _fill)
            for kind, cfg_of in CFG.items()}


def test_registry_and_configs():
    assert get_algorithm("SimMatch") is SimMatch
    for name in ("config_dvm_SimMatch", "config_dvm_MultiSimMatch"):
        ours = load_config(name, ["dataset=synthetic_dvm"])
        ref = jax_load_config(name, ["dataset=synthetic_dvm"])
        assert ours.to_dict() == ref.to_dict(), name
    cfg = _imaging(load_config, "K=null")
    with pytest.raises(ValueError, match="K"):
        SimMatch(cfg, cfg.field_lengths, device="cpu").init_state(0)


@pytest.mark.parametrize("kind", ["imaging", "multimodal"])
def test_step_matches_jax(run, kind):
    """Logs, parameters, running statistics, the EMA teacher, the bank,
    its labels, the DA ring and the accuracies after the imaging
    single-batch step and the multimodal ``step_micro`` at m = 2."""
    jstate, pstate, _ = run[kind]
    assert pstate.step == 1 == int(jstate.step)
    compare_match_states(jstate, pstate, SimMatch.LOG_KEYS)
    logs = {k: float(v) for k, v in pstate.log_sums.items()}
    assert 0 < logs["threshold1_ratio"] < 1
    assert logs["loss_u"] > 0 and logs["loss_in"] > 0
    assert logs["loss"] == pytest.approx(
        logs["loss_x"] + 10 * logs["loss_u"] + 5 * logs["loss_in"],
        rel=1e-9)
    assert pstate.da.ptr == 4


@pytest.mark.parametrize("kind", ["imaging", "multimodal"])
def test_bank_scatter_at_dataset_indices(run, kind):
    """The labelled rows are dataset rows 4, 1, 5, 2: their teacher
    embeddings (unit columns) and labels land in those columns, equal to
    JAX's, and columns 0 and 3 keep the initial bank."""
    jstate, pstate, carried = run[kind]
    want = train_state_from_jax(jstate)["extra"]
    start = carried["extra"]
    bank, labels = pstate.extra["bank"], pstate.extra["bank_labels"]
    assert_close(bank[:, IDX_L], want["bank"][:, IDX_L].numpy(), 1e-9,
                 1e-12)
    assert_close(bank[:, IDX_L].norm(dim=0), np.ones(4), 1e-10, 0)
    for col in (0, 3):
        assert torch.equal(bank[:, col], start["bank"][:, col]), col
        assert int(labels[col]) == int(start["bank_labels"][col])
    y_l = fixmatch_data()[0][1]["labels"][IDX_L]
    assert labels[IDX_L].tolist() == y_l.tolist() == \
        want["bank_labels"][IDX_L].tolist()
    assert (bank[:, IDX_L] != start["bank"][:, IDX_L]).all()


@pytest.mark.parametrize("kind", ["imaging", "multimodal"])
def test_no_mask_margin_within_1e6(run, kind):
    _, pstate, carried = run[kind]
    for d in (-1e-6, 1e-6):
        _, state = port_fixmatch_step(
            SimMatch, CFG[kind], carried, 1,
            f"sim_threshold={THRESHOLD[kind] + d}")
        assert float(state.log_sums["threshold1_ratio"]) == \
            float(pstate.log_sums["threshold1_ratio"])


def test_checkpoint_round_trip_of_the_bank(run, tmp_path):
    _, pstate, _ = run["multimodal"]
    save_checkpoint(tmp_path, pstate, name="ckpt")
    cfg = _multimodal(load_config)
    fresh = SimMatch(cfg, cfg.field_lengths, dtype=torch.float64,
                     device="cpu").init_state(0)
    restore_checkpoint(tmp_path, fresh, name="ckpt")
    for k in ("bank", "bank_labels"):
        assert torch.equal(fresh.extra[k], pstate.extra[k]), k
    assert torch.equal(fresh.da.queue, pstate.da.queue)
    assert fresh.da.ptr == pstate.da.ptr == 4


@pytest.mark.parametrize("name", ["config_dvm_SimMatch",
                                  "config_dvm_MultiSimMatch"])
def test_cli_trains_resumes_exactly_and_tests(name, tmp_path):
    """``K`` unset: ``evaluate`` gives the bank one column per labelled
    sample (8)."""
    ckpt = cli_train_resume_test(name, tmp_path)
    assert ckpt["extra"]["bank"].shape == (8, 8)
