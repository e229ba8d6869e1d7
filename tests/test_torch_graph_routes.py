"""The graph route of ``steps_per_dispatch`` for every family of the
registry (``train/multistep.py``), on the CPU: what a captured step
needs of each family, checked where no card is.

- CoMatch's circular enqueue (``algorithms/match_common.py:enqueue``,
  also MMatch's bank) with a device position writes what the plain slice
  rule with an int position writes, across the wrap (fewer free columns than rows) and with more
  rows than columns, and advances the position in place;
- each family's ``set_epoch`` fills its device gates with the values the
  steps computed on the host before (``float(epoch > start_epoch)``,
  CoMatch's ``min(epoch + 1, lam_c)``, MMatch's ``float(epoch > 0)``);
- ``choose_route`` sends every registry name to the graph on a card, at
  ``micro_batches`` 1 and 4, and keeps ``teacher_int8``, a mesh and the
  CPU eager;
- ``evaluate`` at ``steps_per_dispatch=3`` ends bitwise equal to its run
  at 1 for a multimodal family (MultiCoMatch, whose queues and DA ring
  positions move on the device) and for ``TabularEval``;
- a checkpoint holds the positions as ints and a restore gives the state
  0-dim int64 tensors again;
- :class:`~stil_tta_torch.train.optim.CapturableAdam` (bias corrections
  once a step) is bit for bit torch's capturable Adam (once a parameter),
  run here by letting torch's update accept CPU tensors.

No JAX step is compiled here; the families' JAX parity is their own
files'. Sizes: ``resnet18`` on 32x32 images, batch 8 (2 + 6), 8 labelled
and 24 unlabelled rows, 4 steps an epoch (``tests/test_torch_multistep.py``'s
setup)."""

import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms import registry
from stil_tta_torch.algorithms.match_common import enqueue, position
from stil_tta_torch.config import load_config
from stil_tta_torch.data.datasets import load_sources
from stil_tta_torch.parallel import mesh as mesh_mod
from stil_tta_torch.train import multistep, optim
from stil_tta_torch.train.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from tests.test_torch_multistep import (OVERRIDES, STEPS, _assert_same_state,
                                        _train)
from tests.test_torch_multistep import one_torch_thread  # noqa: F401

# the families' YAMLs: name -> config
FAMILIES = {
    "SimMatch": "config_dvm_SimMatch", "CoMatch": "config_dvm_CoMatch",
    "FreeMatch": "config_dvm_FreeMatch",
    "MultiSimMatch": "config_dvm_MultiSimMatch",
    "MultiCoMatch": "config_dvm_MultiCoMatch",
    "MultiFreeMatch": "config_dvm_MultiFreeMatch",
    "MMatch": "config_dvm_MMatch", "CoTrain": "config_dvm_CoTrain",
    "CoTrain_SAINT": "config_dvm_CoTrain_SAINT"}


@pytest.mark.parametrize("k,b,ptr", [
    (32, 12, 0), (32, 12, 26), (32, 12, 31), (32, 40, 5), (640, 16, 630),
    (640, 512, 512)])
def test_enqueue_device_position_equals_the_int_one(k, b, ptr):
    """CoMatch's queues (K = 32 here, 2,560 in its YAML) and MMatch's bank
    (640): the device position's enqueue writes the columns of the plain
    slice rule with an int position (``comatch.py:59-77``: ``n = min(B,
    K - ptr)`` rows into ``ptr:ptr + n``), bitwise, and advances the
    position it was given in place to ``(ptr + n) % K``."""
    gen = torch.Generator().manual_seed(k + b + ptr)
    d, c = 8, 4
    q0, p0 = (torch.randn(n, k, generator=gen) for n in (d, c))
    z = torch.randn(b, d, generator=gen, dtype=torch.float64)
    t = torch.rand(b, c, generator=gen, dtype=torch.float64)
    qi, pi = q0.clone(), p0.clone()
    n = min(b, k - ptr)
    qi[:, ptr:ptr + n] = z[:n].T.to(qi.dtype)
    pi[:, ptr:ptr + n] = t[:n].T.to(pi.dtype)
    qt, pt = q0.clone(), p0.clone()
    dev_ptr = position(ptr, "cpu")
    got = enqueue(qt, pt, dev_ptr, z, t)
    assert got is dev_ptr and got.dtype == torch.long and got.dim() == 0
    assert int(got) == (ptr + n) % k
    assert torch.equal(qt, qi) and torch.equal(pt, pi)


@pytest.fixture(scope="module")
def field_lengths():
    return load_sources(load_config("config_dvm_STiL", OVERRIDES))[
        "train_labelled"].field_lengths


def _algo(config: str, field_lengths, *extra):
    cfg = load_config(config, OVERRIDES + ["start_epoch=2", "K=32",
                                           *extra])
    return registry.get_algorithm(cfg.algorithm_name)(
        cfg, field_lengths, dtype=torch.float64, device="cpu"), cfg


@pytest.mark.parametrize("family", sorted(FAMILIES) + ["TabularEval"])
def test_set_epoch_fills_the_gates_the_host_computed(family, field_lengths):
    """Across ``start_epoch`` (2 here): each gate a device scalar holding
    the host value of the step before the graph route, filled only when
    the epoch changes it."""
    if family == "TabularEval":
        algo, cfg = _algo("config_dvm_STiL", field_lengths,
                          "algorithm_name=TabularEval",
                          "eval_datatype=tabular")
    else:
        algo, cfg = _algo(FAMILIES[family], field_lengths)
    held = dict(algo.epoch_scalars.tensors)
    for epoch in range(5):
        got = algo.set_epoch(epoch)
        want = {}
        if family != "TabularEval":
            want["gate"] = float(epoch > int(cfg.start_epoch))
        if family.endswith("CoMatch"):
            want["lam_c"] = min(float(epoch) + 1.0, float(cfg.lam_c))
        if family == "MMatch":
            want["smooth"] = float(epoch > 0)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] is held[k]          # filled in place
            assert got[k].dtype == torch.float64 and float(got[k]) == v, k


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("name", sorted(registry.ALGORITHMS))
def test_every_family_takes_the_graph_route_on_a_card(name, m):
    cfg = load_config("config_dvm_STiL", OVERRIDES + [
        f"algorithm_name={name}", f"micro_batches={m}"])
    route, why = multistep.choose_route(registry.get_algorithm(name), cfg,
                                        torch.device("cuda"))
    assert route == "graph", why
    assert multistep.choose_route(registry.get_algorithm(name), cfg,
                                  torch.device("cpu"))[0] == "eager"


def test_teacher_int8_and_a_mesh_stay_eager():
    cfg = load_config("config_dvm_STiL", OVERRIDES + ["teacher_int8=true"])
    route, why = multistep.choose_route(registry.STiL, cfg, "cuda")
    assert (route, why) == ("eager", "teacher_int8")
    cfg = load_config("config_dvm_CoMatch", OVERRIDES)
    with mesh_mod.Mesh(shape=(2,), groups=(None,), group=None, rank=0):
        route, why = multistep.choose_route(registry.CoMatch, cfg, "cuda")
    assert route == "eager" and "mesh" in why


@pytest.mark.parametrize("config,extra", [
    ("config_dvm_MultiCoMatch", ("K=32",)),
    ("config_dvm_STiL", ("algorithm_name=TabularEval",
                         "eval_datatype=tabular"))])
def test_evaluate_spd3_equals_spd1_bitwise(tmp_path, config, extra):
    """One epoch of 4 steps: a block of 3 and a tail of 1 at K = 3,
    bitwise the single steps (nets, EMA, Adam, queues and their device
    positions, DA ring, metrics, generator)."""
    single, _, _ = _train(config, 1, tmp_path / "1", *extra, epochs=1)
    multi, _, out = _train(config, 3, tmp_path / "3", *extra, epochs=1)
    assert "eager route (not on a CUDA card)" in out
    _assert_same_state(multi, single, steps=STEPS)
    if config.endswith("CoMatch"):
        ex = multi.extra
        # 4 steps of 6 strong rows and 8 labelled and weak rows, K = 32
        assert (int(ex["ptr_s"]), int(ex["ptr_w"]), int(ex["hist_len"]),
                int(ex["hist_ptr"])) == (24, 0, 4, 4)


def test_checkpoint_round_trip_keeps_the_positions(tmp_path, field_lengths):
    """CoMatch's and MMatch's positions and lengths go into a checkpoint
    as ints (as the DA ring's does) and come back as 0-dim int64 tensors
    on the state's device, with their values."""
    for config, keys in (("config_dvm_CoMatch", ("ptr_s", "ptr_w",
                                                 "hist_len", "hist_ptr")),
                         ("config_dvm_MMatch", ("ptr",))):
        algo, _ = _algo(config, field_lengths)
        state = algo.init_state(0)
        for i, k in enumerate(keys):
            state.extra[k].fill_(3 + i)
        path = save_checkpoint(tmp_path, state, name=config)
        saved = torch.load(path, weights_only=True)["extra"]
        assert {k: saved[k] for k in keys} == {
            k: 3 + i for i, k in enumerate(keys)}
        fresh = algo.init_state(1)
        restore_checkpoint(tmp_path, fresh, name=config)
        for i, k in enumerate(keys):
            t = fresh.extra[k]
            assert isinstance(t, torch.Tensor) and t.dim() == 0
            assert t.dtype == torch.long and int(t) == 3 + i, k


@pytest.mark.parametrize("weight_decay,frozen", [(0.0, False), (1e-4, True)])
def test_capturable_adam_is_torch_s_capturable_adam(monkeypatch,
                                                    weight_decay, frozen):
    """300 steps of :class:`CapturableAdam` and of
    ``torch.optim.Adam(capturable=True)`` (its multi-tensor update, let
    onto CPU tensors) from the same parameters, gradients and learning
    rate tensor: parameters, moments and counts bitwise equal. With
    ``frozen`` a second group at learning rate 0, as
    ``build_optimizer`` makes it."""
    import torch.optim.adam as torch_adam
    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda supports_xla=True: ["cpu", "cuda"])
    gen = torch.Generator().manual_seed(0)
    ps = [torch.nn.Parameter(torch.randn(n, generator=gen))
          for n in (5, 3, 7)]
    qs = [torch.nn.Parameter(p.detach().clone()) for p in ps]

    def groups(params):
        lr = torch.tensor(1e-2)
        if not frozen:
            return [{"params": params, "lr": lr}]
        return [{"params": params[:2], "lr": lr},
                {"params": params[2:], "lr": 0.0, "frozen": True}]

    ours = optim.CapturableAdam(groups(ps), betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay, capturable=True)
    theirs = torch.optim.Adam(groups(qs), betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=weight_decay, capturable=True,
                              foreach=True)
    theirs._warned_capturable_if_run_uncaptured = True
    for _ in range(300):
        for p, q in zip(ps, qs):
            p.grad = torch.randn(p.shape, generator=gen)
            q.grad = p.grad.clone()
        ours.step()
        theirs.step()
    for p, q in zip(ps, qs):
        assert torch.equal(p, q)
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(ours.state[p][k], theirs.state[q][k]), k
    assert ours.state_dict()["state"].keys() == \
        theirs.state_dict()["state"].keys()


def test_build_optimizer_is_capturable_adam_only_on_the_graph_route():
    p = torch.nn.Parameter(torch.zeros(3))
    assert type(optim.build_optimizer([p], 1e-3)) is torch.optim.Adam
    assert type(optim.build_optimizer([p], 1e-3, capturable=True)) \
        is optim.CapturableAdam
    assert type(optim.build_optimizer([p], 1e-3, mu_dtype="bfloat16",
                                      capturable=True)) is optim.Adam


def test_a_tensor_position_in_extra_is_a_state_tensor(field_lengths):
    """The dispatcher's address check covers the positions: each is a
    state tensor by name, and no number of the state lives on the host
    (where a capture would freeze it)."""
    algo, _ = _algo("config_dvm_CoMatch", field_lengths)
    state = algo.init_state(0)
    names = multistep.state_tensors(state)
    for k in ("ptr_s", "ptr_w", "hist_len", "hist_ptr"):
        assert f"state.extra.{k}" in names
    assert multistep._host_values(state) == {}
    np.testing.assert_array_equal(
        [int(state.extra[k]) for k in ("ptr_s", "ptr_w")], [0, 0])
