"""MMatch of the port against the JAX package: one train step at epoch 1
(the memory bank smooths the pseudo labels) whose enqueue runs into the
bank's end, the micro-batched step at m = 2 and each of its documented
divergences, and a checkpoint round trip of the bank.

Setup as ``tests/test_torch_cotrain.py``: ``resnet18`` on 32x32 images,
4 labelled + 12 unlabelled rows, float64 on both sides (JAX in x64, the
JAX module run with ``jnp.float32`` read as float64, so its float32
masks, gate and chunk-loop carries are float64), Adam, augmentation and
corruption off (views handed in as data), ``start_epoch`` 0 so the
unlabelled losses count at epoch 1, ``th1`` at its config value 0.6. The
bank's embeddings are the JAX package's own (drawn from
``jax.random.key(17)``, carried into the port as data); its targets and
the DA ring are filled with seeded random distributions, so that the
smoothing and the alignment act on more than zeros. The single step
starts with the bank's write position at 630 of 640: its 16 rows fill
the last 10 columns and the rest are dropped (``comatch.py:76``), so the
position goes back to 0.

The JAX single-batch step and ``step_micro`` are compiled once each for
the file. Tolerances as ``tests/test_torch_cotrain.py``: rtol 1e-8 on
losses, atol 1e-9 on parameters, rtol 1e-9 on the bank and the DA ring
(float64 sums in two orders); the ``threshold1_ratio`` log is a float32
mean on the port's side, rtol 2e-7."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms.match_common import enqueue
from stil_tta_torch.algorithms.mmatch import MMATCH_K, MMatch
from stil_tta_torch.algorithms.registry import get_algorithm
from stil_tta_torch.config import load_config
from stil_tta_torch.train.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from stil_tta_torch.train.convert import (load_train_state,
                                          train_state_from_jax)
from stil_tta_tpu.algorithms import mmatch as jmmatch
from stil_tta_tpu.algorithms.base import DAState as JDAState
from stil_tta_tpu.config import load_config as jax_load_config
from tests.test_torch_train_step import B_L, B_U, C, F64, FL, IMG, _data
from tests.torch_parity import (assert_close, compare_match_states,
                                jax_match_state, match_cfg, port_match_state,
                                x64)
from tests.torch_parity import one_torch_thread  # noqa: F401

M = 2
B = B_L + B_U
P = 8                  # projection_dim
PARAM_ATOL = 1e-9


def _cfg(loader, *extra):
    return match_cfg(loader, "config_dvm_MMatch", *extra)


def _views(key, images, tabular, marginal):
    return images, tabular


def _port(micro=1, carried=None):
    algo = MMatch(_cfg(load_config, f"micro_batches={micro}"), FL,
                  dtype=F64, device="cpu")
    if carried is None:
        return algo, port_match_state(algo)
    state = algo.init_state(seed=0)
    load_train_state(state, carried)
    return algo, state


def _filled(jstate, ptr):
    """``jstate`` with random target distributions in the bank, the write
    position at ``ptr``, and random distributions in the DA ring
    (position 3)."""
    rng = np.random.RandomState(4)
    probs = rng.dirichlet(np.ones(C), MMATCH_K).T
    ring = rng.dirichlet(np.ones(C), 256)
    extra = dict(jstate.extra, probs_queue=jnp.asarray(probs),
                 ptr=jnp.asarray(ptr, jnp.int32))
    return jstate.replace(extra=extra, da=JDAState(
        jnp.asarray(ring), jnp.asarray(3, jnp.int32)))


@pytest.fixture(scope="module")
def run():
    """The single-batch step of both sides at epoch 1 from a bank written
    up to column 630; then from the same weights with the position at 0,
    two micro steps of both sides and the port's single-batch step."""
    (jcl, cl), (jcu, cu) = _data()
    il = jnp.arange(B_L, dtype=jnp.int32)
    iu = jnp.arange(B_U, dtype=jnp.int32)
    tl, tu = torch.arange(B_L), torch.arange(B_U)
    jnp64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    jnp64.float32 = jnp.float64
    epoch = jnp.asarray(1, jnp.int32)
    out = {}
    with x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmmatch, "jnp", jnp64)
        jalgo = jmmatch.MMatch(_cfg(jax_load_config), FL, dtype=jnp.float64)
        jalgo.contrastive_views = _views
        _, state0 = _port()
        j0 = jax_match_state(jalgo, state0, IMG, len(FL))

        jend = _filled(j0, MMATCH_K - 10)
        out["end_initial"] = train_state_from_jax(jend)
        jstep = jax.jit(jalgo.make_train_step().__wrapped__)
        algo, pstate = _port(1, out["end_initial"])
        algo.make_train_step()(pstate, cl, cu, tl, tu, 1)
        out["single"] = (jstep(jend, jcl, jcu, il, iu, epoch), pstate)

        jzero = _filled(j0, 0)
        carried = train_state_from_jax(jzero)
        out["initial"] = carried
        jalgo_m = jmmatch.MMatch(_cfg(jax_load_config, f"micro_batches={M}"),
                                 FL, dtype=jnp.float64)
        jalgo_m.contrastive_views = _views
        jmicro = jax.jit(jalgo_m.make_train_step().__wrapped__)
        algo_m, pstate = _port(M, carried)
        pstep = algo_m.make_train_step()
        jstate = jmicro(jzero, jcl, jcu, il, iu, epoch)
        pstep(pstate, cl, cu, tl, tu, 1)
        out["micro"] = train_state_from_jax(jstate)
        out["port_micro"] = {
            "net": {k: v.clone() for k, v in pstate.net.state_dict().items()},
            "da": (pstate.da.queue.clone(), int(pstate.da.ptr)),
            "extra": {k: v if isinstance(v, int) else v.clone()
                      for k, v in pstate.extra.items()}}
        jstate = jmicro(jstate, jcl, jcu, il, iu, epoch)
        pstep(pstate, cl, cu, tl, tu, 1)
        out["two_micro"] = (jstate, pstate)
        algo1, single = _port(1, carried)
        algo1.make_train_step()(single, cl, cu, tl, tu, 1)
        out["single_from_zero"] = single
    return out


def test_registry_and_config():
    assert get_algorithm("MMatch") is MMatch
    ours = load_config("config_dvm_MMatch", ["dataset=synthetic_dvm"])
    ref = jax_load_config("config_dvm_MMatch", ["dataset=synthetic_dvm"])
    assert ours.to_dict() == ref.to_dict()


def test_train_step_matches_jax(run):
    """Logs, parameters, running statistics, the DA ring, the bank and the
    accuracies after one step at epoch 1."""
    jstate, pstate = run["single"]
    assert pstate.step == 1 == int(jstate.step)
    compare_match_states(jstate, pstate, MMatch.LOG_KEYS)
    logs = {k: float(v) for k, v in pstate.log_sums.items()}
    assert 0 < logs["threshold1_ratio"] < 1
    assert logs["CEloss_unlabelled_i"] > 0 and logs["CEloss_unlabelled_t"] > 0
    assert logs["loss"] == pytest.approx(
        logs["CEloss"] + 5.0 * (logs["CEloss_unlabelled_i"]
                                + logs["CEloss_unlabelled_t"]), rel=1e-12)


def test_enqueue_truncates_at_the_bank_end(run):
    """The step's 16 rows, labelled one-hots first, fill columns 630-639
    element by element as JAX's, the 6 past the end are dropped, every
    other column is unchanged, and the position returns to 0."""
    jstate, pstate = run["single"]
    want = train_state_from_jax(jstate)["extra"]
    start = run["end_initial"]["extra"]
    assert pstate.extra["ptr"] == want["ptr"] == 0
    for k in ("embed_queue", "probs_queue"):
        got = pstate.extra[k]
        assert_close(got[:, -10:], want[k][:, -10:].numpy(), 1e-9, 1e-12, k)
        assert torch.equal(got[:, :-10], start[k][:, :-10].double()), k
        assert torch.equal(want[k][:, :-10], start[k][:, :-10]), k
    y_l = _data()[0][1]["labels"]
    np.testing.assert_array_equal(
        pstate.extra["probs_queue"][:, -10:-10 + B_L].T.numpy(),
        np.eye(C)[y_l.numpy()])
    # the rows are unit embeddings
    norms = pstate.extra["embed_queue"][:, -10:].norm(dim=0)
    assert_close(norms, np.ones(10), 1e-12, 0)


def test_enqueue_position_rule():
    """``(ptr + min(B, K - ptr)) % K``: 0 -> 512 -> 0 at the DVM batch."""
    q, p = torch.zeros(P, 640), torch.zeros(C, 640)
    z, t = torch.ones(512, P), torch.ones(512, C)
    ptr = enqueue(q, p, 0, z, t)
    assert ptr == 512
    ptr = enqueue(q, p, ptr, 2 * z, 2 * t)
    assert ptr == 0
    assert float(q[0, 511]) == 1.0 and float(q[0, 512]) == 2.0


def test_two_micro_steps_match_jax_step_micro(run):
    jstate, pstate = run["two_micro"]
    assert pstate.step == 2 == int(jstate.step)
    assert pstate.extra["ptr"] == 2 * B
    compare_match_states(jstate, pstate, MMatch.LOG_KEYS)


def _bn_stats(sd):
    return {k: v.double() for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _far(a: dict, b: dict, atol: float) -> bool:
    return any(float((a[k] - b[k].double()).abs().max()) > atol for k in a)


def test_ghost_batch_norm_running_stats(run):
    """Running statistics lerped once a chunk: the port's equal JAX's
    after one micro step; the single-batch step's are off."""
    micro = _bn_stats(run["port_micro"]["net"])
    want = _bn_stats(run["micro"]["net"])
    for k, v in micro.items():
        assert_close(v, want[k].numpy(), 0, PARAM_ATOL, k)
    single = _bn_stats(run["single_from_zero"].net.state_dict())
    assert _far(single, micro, 1e-6)


def test_distribution_alignment_per_chunk(run):
    """One slot written a step (the mean of the chunk means, equal to
    JAX's) and the position advanced once; the single-batch step's slot
    is the whole batch's mean, off by more than the tolerance."""
    micro = run["port_micro"]["da"]
    want = run["micro"]["da"]
    assert_close(micro[0], want[0].numpy(), 1e-9, 1e-12)
    single = run["single_from_zero"].da
    assert micro[1] == want[1] == single.ptr == 4
    ring0 = run["initial"]["da"][0]
    changed = (micro[0] != ring0).any(1)
    assert changed.nonzero().flatten().tolist() == [3]
    assert float((single.queue[3] - micro[0][3]).abs().max()) > 1e-6


def _columns(extra, lo, hi):
    return extra["embed_queue"][:, lo:hi].double(), \
        extra["probs_queue"][:, lo:hi].double()


def test_bank_frozen_within_the_step(run):
    """The second chunk smooths its pseudo labels through the pre-step
    bank: had the first chunk's rows been enqueued before it, its targets
    would move by more than the tolerance. The rows the step wrote
    (labelled 0-3, then chunk 1's unlabelled 4-9, chunk 2's 10-15) give
    chunk 2's embeddings and chunk 1's rows."""
    temp = 0.1
    after = run["port_micro"]["extra"]
    want = run["micro"]["extra"]
    for k in ("embed_queue", "probs_queue"):
        assert_close(after[k], want[k].numpy(), 1e-9, 1e-12, k)
    pre = run["initial"]["extra"]
    f2, _ = _columns(after, 10, 16)
    q0, p0 = _columns(pre, 0, MMATCH_K)

    def smoothing(q, p):
        a = torch.exp(f2.T @ q / temp)
        return 0.1 * (a / a.sum(1, keepdim=True)) @ p.T

    q1, p1 = q0.clone(), p0.clone()
    # what an enqueue after chunk 1 would have written: its labelled rows
    # (0-1) and its unlabelled rows (4-9)
    rows = list(range(0, 2)) + list(range(4, 10))
    fq, fp = _columns(after, 0, 16)
    q1[:, :8], p1[:, :8] = fq[:, rows], fp[:, rows]
    assert float((smoothing(q1, p1) - smoothing(q0, p0)).abs().max()) > 1e-6


def test_enqueue_order_labelled_first(run):
    """The end-of-step enqueue writes ``[labelled..., unlabelled...]`` of
    the whole batch (equal to JAX's); in chunk order columns 2-3 would
    hold chunk 1's unlabelled rows, not chunk 2's labelled ones."""
    got = run["port_micro"]["extra"]
    _, pstate = run["two_micro"]
    y_l = _data()[0][1]["labels"].numpy()
    np.testing.assert_array_equal(got["probs_queue"][:, :B_L].T.numpy(),
                                  np.eye(C)[y_l])
    f, _ = _columns(got, 0, 16)
    assert float((f[:, 2:4] - f[:, 4:6]).abs().max()) > 1e-6
    # the port's bank after two steps: 32 columns, as JAX's
    jstate, _ = run["two_micro"]
    got = pstate.extra["embed_queue"][:, :2 * B]
    assert_close(got, np.asarray(jstate.extra["embed_queue"])[:, :2 * B],
                 1e-9, 1e-12)


def test_checkpoint_round_trip_of_the_bank(run, tmp_path):
    """``save_checkpoint`` / ``restore_checkpoint`` carry the bank, its
    position and the DA ring exactly."""
    _, pstate = run["two_micro"]
    save_checkpoint(tmp_path, pstate, name="ckpt")
    algo, fresh = _port(M)
    restore_checkpoint(tmp_path, fresh, name="ckpt")
    assert fresh.extra["ptr"] == pstate.extra["ptr"] == 2 * B
    for k in ("embed_queue", "probs_queue"):
        assert torch.equal(fresh.extra[k], pstate.extra[k]), k
    assert torch.equal(fresh.da.queue, pstate.da.queue)
    assert fresh.da.ptr == pstate.da.ptr and fresh.step == 2
    assert fresh.ema is None
