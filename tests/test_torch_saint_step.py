"""A STiL_SAINT train step of the port against the JAX package's, from
one state.

Setup as ``tests/test_torch_train_step.py`` (``resnet18`` on 32x32
images, 4 labelled + 12 unlabelled rows, float64 on both sides, Adam, DA
and EMA on, augmentation and corruption off, the fusion dropout at 0),
with ``config_dvm_STiL_SAINT`` and SAINT's feed-forward dropout at 0
(``saint_ff_dropout=0``). The JAX step is compiled once for the file.
Tolerances as there (rtol 1e-8 on losses, rtol 2e-7 on the float32
ratio logs), but atol 5e-9 on parameters, statistics and the EMA tree:
Adam's first step moves a parameter by lr g / (|g| + eps), so a float64
difference d in the (decayed) gradient moves it by up to lr d / (4 eps)
where |g| = eps; with lr 1e-3 and eps 1e-8, 5e-9 admits d <= 2e-13, the
summation noise of a gradient that passed through a train-mode BN's
mean-subtracting backward. Here one conv weight's decayed gradient lands
at 1.7e-8 and its parameter moves 1.3e-9 apart; SAINT's own parameters
agree within 2e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms.stil import STiL_SAINT
from stil_tta_torch.config import load_config
from stil_tta_torch.models.saint import SAINTEncoder
from stil_tta_torch.train.convert import (load_train_state,
                                          train_state_from_jax)
from stil_tta_tpu.algorithms.stil import STiL_SAINT as JaxSTiL_SAINT
from stil_tta_tpu.config import load_config as jax_load_config
from stil_tta_tpu.models import backbones as jbackbones
from tests.test_torch_train_step import (B_L, B_U, F64, FL, OVERRIDES,
                                         _compare_states, _data, _jax_state,
                                         _mask_rand, _no_fusion_dropout,
                                         _port_initial_state)
from tests.torch_parity import x64
from tests.torch_parity import one_torch_thread  # noqa: F401


def _cfg(loader):
    cfg = loader("config_dvm_STiL_SAINT", OVERRIDES + ["saint_ff_dropout=0"])
    cfg.field_lengths = list(FL)
    cfg.repeat_ratio = 3
    return cfg


@pytest.fixture(scope="module")
def run():
    """Both sides from one state, one step at epoch 1."""
    def dropfree(**kw):
        kw.update(attn_drop=0.0, proj_drop=0.0, drop_path=0.0)
        return real_layer(**kw)

    real_layer = jbackbones.MITransformerLayer
    (jcl, cl), (jcu, cu) = _data()
    il, iu = jnp.arange(B_L, dtype=jnp.int32), jnp.arange(B_U,
                                                          dtype=jnp.int32)
    with x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbackbones, "MITransformerLayer", dropfree)
        jalgo = JaxSTiL_SAINT(_cfg(jax_load_config), FL, dtype=jnp.float64)
        jalgo._views = lambda key, il, tl, iu, tu, ml, mu: (il, tl, iu, tu)
        algo = STiL_SAINT(_cfg(load_config), FL, dtype=F64, device="cpu")
        _no_fusion_dropout(algo.net)
        j0 = _jax_state(jalgo, _port_initial_state(algo))
        carried = train_state_from_jax(j0)
        state = algo.init_state(seed=0)
        load_train_state(state, carried)
        jstep = jax.jit(jalgo.make_train_step().__wrapped__)
        pstep = algo.make_train_step()
        out = {"initial": carried}
        mask = torch.tensor(_mask_rand(j0))
        jstate = jstep(j0, jcl, jcu, il, iu, jnp.asarray(1, jnp.int32))
        pstep(state, cl, cu, torch.arange(B_L), torch.arange(B_U), 1,
              mask_rand=mask)
        out["final"] = (jstate, state)
    return out


def test_stil_saint_net_has_the_saint_encoder(run):
    jstate, state = run["final"]
    assert isinstance(state.net.model.encoder_tabular, SAINTEncoder)
    assert isinstance(state.ema.encoder_tabular, SAINTEncoder)
    assert "encoder_tabular" in jstate.params["backbone"]
    assert any(k.startswith("model.encoder_tabular.simple_MLP.")
               for k in run["initial"]["net"])


def test_stil_saint_step_matches_jax(run):
    """Logs, parameters (SAINT's included), BN statistics, the EMA tree,
    prototypes, DA and accuracy after the step."""
    jstate, state = run["final"]
    assert state.step == 1 == int(jstate.step)
    _compare_states(jstate, state, param_atol=5e-9)
    # the SAINT encoder moved in both the student and the EMA teacher
    for name, key in (("net", "model.encoder_tabular.embeds.weight"),
                      ("ema", "encoder_tabular.embeds.weight")):
        got = (state.net if name == "net" else state.ema).state_dict()
        assert not torch.equal(got[key],
                               run["initial"][name][key].double()), name


def test_stil_saint_step_logs_are_finite_and_past_start_epoch(run):
    first = {k: float(v) for k, v in run["final"][1].log_sums.items()}
    assert all(np.isfinite(v) for v in first.values())
    # epoch 1 > start_epoch: the pseudo-label terms count in the loss
    extra = first["loss"] - (
        0.2 * first["CEloss"] + 3.0 * first["ITCloss"] + 0.5 * sum(
            first[k] for k in ("CLUBloss_imaging", "CLUBloss_imaging_est",
                               "CLUBloss_tabular", "CLUBloss_tabular_est")))
    assert abs(extra) > 1e-6
