"""FreeMatch of the port against the JAX package: its fairness loss, the
imaging single-batch step and the multimodal ``step_micro`` at m = 2
(every buffer of ``extra``: ``time_p``, ``p_model``, ``label_hist``), a
checkpoint round trip of the buffers, and both DVM YAMLs through the CLI
(train, exact resume, test with BN-adapt on the checkpoint in the
reference's layout).

Setup as ``tests/test_torch_mmatch.py``: ``resnet18`` on 32x32 images,
float64 on both sides (JAX in x64, the JAX modules run with
``jnp.float32`` read as float64, so the masks, the gate and the float32
buffers are float64), Adam, ``start_epoch`` 0 at epoch 1 so the
unlabelled losses count, the EMA teacher of other weights than the
student's and both with random BatchNorm running statistics. The batch
is 4 labelled rows (dataset rows 4, 1, 5, 2 of 6) and 12 unlabelled; the
views are fixed and distinct on both sides (``tests/torch_parity.py:
fixed_views``; the recipes are held in ``tests/test_torch_match_views.
py``). The buffers start away from their uniform init (``time_p`` 0.42
imaging, 0.57 multimodal; random ``p_model`` and ``label_hist``), so the
mask ``max_prob >= time_p * mod[y_hat]`` keeps some rows and not all;
moving ``time_p`` by 1e-6 either way changes no mask entry, so no margin
lies within 1e-6 of the threshold (the masks are hard thresholds).

Two JAX steps are compiled for the file. Tolerances: rtol 1e-8 on
losses, atol 1e-9 on parameters, rtol 1e-9 on the buffers (float64 sums
in two orders); the ``threshold1_ratio`` log is a float32 mean on the
port's side, rtol 2e-7; ``entropy_loss`` alone rtol 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms.freematch import SELF_ADAPT_M, FreeMatch
from stil_tta_torch.algorithms.match_common import ImagingNet
from stil_tta_torch.algorithms.registry import get_algorithm
from stil_tta_torch.config import load_config
from stil_tta_torch.losses.common import entropy_loss
from stil_tta_torch.train.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from stil_tta_tpu.algorithms import freematch as jfreematch
from stil_tta_tpu.config import load_config as jax_load_config
from stil_tta_tpu.losses import common as jcommon
from tests.torch_parity import (cli_train_resume_test,
                                compare_match_states, fixmatch_steps, jnp64,
                                match_cfg, port_fixmatch_step, x64)
from tests.torch_parity import one_torch_thread  # noqa: F401

C = 4


def _imaging(loader, *extra):
    return match_cfg(loader, "config_dvm_FreeMatch", *extra)


def _multimodal(loader, *extra):
    return match_cfg(loader, "config_dvm_MultiFreeMatch", "micro_batches=2",
                     *extra)


def _fill(time_p):
    def fill(jstate):
        rng = np.random.RandomState(5)
        return jstate.replace(extra={
            "p_model": jnp.asarray(rng.dirichlet(np.ones(C) * 40)),
            "label_hist": jnp.asarray(rng.dirichlet(np.ones(C) * 40)),
            "time_p": jnp.asarray(time_p, jnp.float64)})
    return fill


@pytest.fixture(scope="module")
def run():
    patch = (jcommon,)
    return {
        "imaging": fixmatch_steps(jfreematch, jfreematch.FreeMatch,
                                  FreeMatch, _imaging, _fill(0.42), patch),
        "multimodal": fixmatch_steps(jfreematch, jfreematch.FreeMatch,
                                     FreeMatch, _multimodal, _fill(0.57),
                                     patch)}


def test_registry_and_configs():
    assert get_algorithm("FreeMatch") is FreeMatch
    for name in ("config_dvm_FreeMatch", "config_dvm_MultiFreeMatch"):
        ours = load_config(name, ["dataset=synthetic_dvm"])
        ref = jax_load_config(name, ["dataset=synthetic_dvm"])
        assert ours.to_dict() == ref.to_dict(), name


@pytest.mark.parametrize("masked", [5, 0])
def test_entropy_loss_matches_jax(masked):
    """The masked histogram and mean of the strong predictions against
    the EMA buffers, with an empty bin in ``label_hist``; an empty mask
    gives 0."""
    rng = np.random.RandomState(masked)
    logits = rng.randn(9, C) * 2
    mask = np.zeros(9)
    mask[:masked] = 1.0
    p_model = rng.dirichlet(np.ones(C))
    hist = rng.dirichlet(np.ones(C))
    hist[2] = 0.0
    with x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcommon, "jnp", jnp64())
        want = float(jcommon.entropy_loss(*map(jnp.asarray, (
            mask, logits, p_model, hist))))
    got = entropy_loss(*map(torch.from_numpy, (mask, logits, p_model,
                                               hist)))
    assert got.dtype == torch.float64
    assert float(got) == pytest.approx(want, rel=1e-12, abs=0)
    assert (want == 0.0) == (masked == 0)


@pytest.mark.parametrize("kind", ["imaging", "multimodal"])
def test_step_matches_jax(run, kind):
    """Logs, parameters, running statistics, the EMA teacher, the three
    buffers and the accuracies after the imaging single-batch step and
    the multimodal ``step_micro`` at m = 2."""
    jstate, pstate, carried = run[kind]
    assert pstate.step == 1 == int(jstate.step)
    assert isinstance(pstate.net, ImagingNet) == (kind == "imaging")
    compare_match_states(jstate, pstate, FreeMatch.LOG_KEYS)
    logs = {k: float(v) for k, v in pstate.log_sums.items()}
    assert 0 < logs["threshold1_ratio"] < 1
    assert logs["loss_u"] > 0 and logs["loss_e"] != 0
    assert logs["loss"] == pytest.approx(
        logs["loss_x"] + logs["loss_u"] + 0.001 * logs["loss_e"], rel=1e-9)
    # the buffers moved by (1 - m) of the batch's statistics
    for k in ("time_p", "p_model", "label_hist"):
        step = (pstate.extra[k] - SELF_ADAPT_M * carried["extra"][k])
        assert float(step.abs().max()) <= 1 - SELF_ADAPT_M + 1e-12, k


@pytest.mark.parametrize("kind", ["imaging", "multimodal"])
def test_no_mask_margin_within_1e6(run, kind):
    """The port's step with ``time_p`` 1e-6 lower and higher keeps the
    same mask: the parity does not rest on a near-tie."""
    _, pstate, carried = run[kind]
    cfg_of = _imaging if kind == "imaging" else _multimodal
    for d in (-1e-6, 1e-6):
        moved = dict(carried, extra=dict(
            carried["extra"], time_p=carried["extra"]["time_p"] + d))
        _, state = port_fixmatch_step(FreeMatch, cfg_of, moved)
        assert float(state.log_sums["threshold1_ratio"]) == \
            float(pstate.log_sums["threshold1_ratio"])


def test_checkpoint_round_trip_of_the_buffers(run, tmp_path):
    _, pstate, _ = run["multimodal"]
    save_checkpoint(tmp_path, pstate, name="ckpt")
    cfg = _multimodal(load_config)
    fresh = FreeMatch(cfg, cfg.field_lengths, dtype=torch.float64,
                      device="cpu").init_state(0)
    restore_checkpoint(tmp_path, fresh, name="ckpt")
    for k, v in pstate.extra.items():
        assert torch.equal(fresh.extra[k], v), k
    assert fresh.step == 1


# ---- the CLI ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["config_dvm_FreeMatch",
                                  "config_dvm_MultiFreeMatch"])
def test_cli_trains_resumes_exactly_and_tests(name, tmp_path):
    cli_train_resume_test(name, tmp_path)
