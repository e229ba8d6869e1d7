"""The micro-batched STiL step (``micro_batches: 2``) of the port against
the JAX package's ``step_micro`` at m = 2, and the four divergences from
the single-batch step that the JAX package documents
(``stil_tta_tpu/algorithms/stil.py:553-568``).

Setup as ``tests/test_torch_train_step.py``: ``resnet18`` on 32x32
images, 4 labelled + 12 unlabelled rows (chunks of 2 + 6), float64 on
both sides, Adam, DA on, EMA on, augmentation and corruption off, the
fusion dropout at 0, one initial state carried into both sides. JAX
draws the case-3 routing per chunk (``k_case3`` split in two); the port
is handed the two draws concatenated, which it cuts back into chunks.
The JAX step's chunk-loop carries (gradient, DA, prototype and log
accumulators) are float32 zeros in its source; the test runs that module
with ``jnp.float32`` read as float64, so the whole JAX step is float64
like the port's. The JAX step is compiled once for the file.

Each divergence test compares one quantity with JAX and shows that the
single-batch step (the port's, from the same state) gives a value more
than the tolerance away, so the comparison would fail if the port used
the single-batch semantics there. Tolerances as in
``tests/test_torch_train_step.py``: float64 sums in two orders, rtol
1e-8 on losses, atol 1e-9 on parameters and statistics."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms.stil import STiL
from stil_tta_torch.config import load_config
from stil_tta_torch.train.convert import (load_train_state,
                                          train_state_from_jax)
from stil_tta_tpu.algorithms import stil as jstil
from stil_tta_tpu.config import load_config as jax_load_config
from stil_tta_tpu.models import backbones as jbackbones
from tests.test_torch_train_step import (B_L, B_U, F64, FL, OVERRIDES,
                                         PARAM_ATOL, _compare_states, _data,
                                         _jax_state, _no_fusion_dropout,
                                         _port_initial_state)
from tests.torch_parity import assert_close, x64
from tests.torch_parity import one_torch_thread  # noqa: F401

M = 2


def _cfg(loader, micro):
    cfg = loader("config_dvm_STiL", OVERRIDES + [f"micro_batches={micro}"])
    cfg.field_lengths = list(FL)
    cfg.repeat_ratio = 3
    return cfg


def _chunk_masks(jstate):
    """The per-chunk case-3 draws of ``step_micro`` (``stil.py:598,
    608``), concatenated in chunk order."""
    k_case3 = jax.random.split(jstate.rng, 4)[3]
    return np.concatenate([np.asarray(jax.random.uniform(k, (B_U // M,))
                                      >= 0.5)
                           for k in jax.random.split(k_case3, M)])


@pytest.fixture(scope="module")
def run():
    """From one state: the JAX micro step, the port's micro step and the
    port's single-batch step at epoch 1 (past start_epoch), then a second
    step of both micro steps."""
    def dropfree(**kw):
        kw.update(attn_drop=0.0, proj_drop=0.0, drop_path=0.0)
        return real_layer(**kw)

    real_layer = jbackbones.MITransformerLayer
    (jcl, cl), (jcu, cu) = _data()
    il, iu = jnp.arange(B_L, dtype=jnp.int32), jnp.arange(B_U,
                                                          dtype=jnp.int32)
    jnp64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    jnp64.float32 = jnp.float64
    with x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbackbones, "MITransformerLayer", dropfree)
        mp.setattr(jstil, "jnp", jnp64)
        jalgo = jstil.STiL(_cfg(jax_load_config, M), FL, dtype=jnp.float64)
        jalgo._views = lambda key, il, tl, iu, tu, ml, mu: (il, tl, iu, tu)

        def port(micro, carried=None):
            algo = STiL(_cfg(load_config, micro), FL, dtype=F64,
                        device="cpu")
            _no_fusion_dropout(algo.net)
            if carried is None:
                return algo, _port_initial_state(algo)
            state = algo.init_state(seed=0)
            load_train_state(state, carried)
            return algo, state

        algo, state0 = port(M)
        j0 = _jax_state(jalgo, state0)
        carried = train_state_from_jax(j0)
        jstep = jax.jit(jalgo.make_train_step().__wrapped__)
        epoch = jnp.asarray(1, jnp.int32)
        out = {"masks": []}

        def both(jstate, pstate, pstep):
            mask = _chunk_masks(jstate)
            out["masks"].append(mask)
            jstate = jstep(jstate, jcl, jcu, il, iu, epoch)
            pstep(pstate, cl, cu, torch.arange(B_L), torch.arange(B_U), 1,
                  mask_rand=torch.tensor(mask))
            return jstate, pstate

        algo, pstate = port(M, carried)
        pstep = algo.make_train_step()
        out["micro"] = both(j0, pstate, pstep)
        out["two_steps"] = both(*out["micro"], pstep)[0], pstate
        # the single-batch step from the same state, fed the same draws
        algo1, single = port(1, carried)
        algo1.make_train_step()(single, cl, cu, torch.arange(B_L),
                                torch.arange(B_U), 1,
                                mask_rand=torch.tensor(out["masks"][0]))
        out["single"] = single
        out["initial"] = carried
    return out


def _bn_stats(sd):
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _far(a: dict, b: dict, atol=PARAM_ATOL) -> bool:
    """Some tensor of ``a`` differs from ``b``'s by more than ``atol``."""
    return any(float((a[k].double() - b[k].double()).abs().max()) > atol
               for k in a)


def test_two_micro_steps_match_jax_step_micro(run):
    """Logs, parameters, BN running statistics, the EMA tree, prototype
    sums, the DA queue and pointer, and the train accuracy after two
    steps."""
    jstate, pstate = run["two_steps"]
    assert pstate.step == 2 == int(jstate.step)
    assert float(pstate.log_count) == 2.0
    _compare_states(jstate, pstate)


def test_ghost_batch_norm_running_stats(run):
    """The student's BN running statistics are lerped once per chunk with
    the chunk's statistics: equal to JAX's after two steps, and not what
    one lerp with the whole batch's statistics gives."""
    jstate, pstate = run["two_steps"]
    want = train_state_from_jax(jstate)["net"]
    got = _bn_stats(pstate.net.state_dict())
    for k, v in got.items():
        assert_close(v, want[k].numpy(), 0, PARAM_ATOL, k)
    micro1 = _bn_stats(train_state_from_jax(run["micro"][0])["net"])
    single = _bn_stats(run["single"].net.state_dict())
    assert _far(single, micro1, 1e-6)


def test_eman_lerps_pre_step_statistics(run):
    """The EMA lerp runs once, before the first chunk, on the pre-step
    running statistics: the EMA tree equals JAX's, and differs from the
    single-batch order's (post-forward statistics)."""
    jstate, pstate = run["two_steps"]
    want = train_state_from_jax(jstate)["ema"]
    for k, v in pstate.ema.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert_close(v, want[k].numpy(), 0, PARAM_ATOL, k)
    micro1 = train_state_from_jax(run["micro"][0])["ema"]
    init = run["initial"]["net"]
    pre = {k: 0.9 * v + 0.1 * init["model." + k].double()
           for k, v in _bn_stats(run["initial"]["ema"]).items()}
    # one step: the EMA statistics are exactly the lerp of the pre-step ones
    for k, v in pre.items():
        assert_close(micro1[k], v.numpy(), 0, PARAM_ATOL, k)
    assert _far(_bn_stats(run["single"].ema.state_dict()), pre, 1e-6)


def test_in_chunk_negatives_itc_and_club(run):
    """ITC and CLUB take their negatives from the chunk: their logs equal
    JAX's and differ from the single-batch step's."""
    jstate, pstate = run["two_steps"]
    single = run["single"]
    jmicro = run["micro"][0]
    for k in ("ITCloss", "CLUBloss_imaging", "CLUBloss_tabular"):
        assert_close(pstate.log_sums[k], np.asarray(jstate.log_sums[k]),
                     1e-8, 1e-12, k)
        assert abs(float(single.log_sums[k])
                   - float(jmicro.log_sums[k])) > 1e-6, k


def test_distribution_alignment_per_chunk(run):
    """Each chunk aligns against the pre-step queue with its own mean in
    slot ptr; the committed slot is the mean of the chunk means and ptr
    advances once a step."""
    jstate, pstate = run["two_steps"]
    want = train_state_from_jax(jstate)["da"]
    assert pstate.da.ptr == want[1] == 2
    assert_close(pstate.da.queue, want[0].numpy(), 1e-9, 1e-12, "queue")
    assert float(pstate.da.queue[2:].abs().max()) == 0.0
    # the single-batch step commits the mean of the whole batch's
    # (ghost-BN-free) probabilities instead
    slot = train_state_from_jax(run["micro"][0])["da"][0][0]
    assert float((run["single"].da.queue[0] - slot).abs().max()) > 1e-6
