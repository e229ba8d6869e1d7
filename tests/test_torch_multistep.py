"""``steps_per_dispatch`` in the port (``train/multistep.py``): K steps a
dispatch give the state of K single steps.

On the CPU every dispatch runs its K steps one by one, so the port's
``evaluate`` at ``steps_per_dispatch=3`` must end bitwise equal to its run
at 1, through the device cache (index blocks from ``chunk_indices``) and
the host stream (``HostStream.epoch_blocks``), for STiL and for a
FixMatch family; it feeds its steps the index stream and learning rates
that the JAX package's ``evaluate`` computes (exact: host values). A STiL
trajectory whose DA ring position wraps on the device, run through a
dispatch of 3 and a tail of 1, is held to the JAX package's steps in
``tests/test_torch_train_step.py``, with that file's JAX step compile
(this file compiles no JAX step). The card
tests (``gpu``) hold a graphed dispatch bitwise equal to eager steps at
a small width for STiL and for every other family of the registry (and
STiL's micro-batched step), with the BN counters advancing under replay;
hold the port's capturable Adam to torch's on the card; and refuse a
capture that syncs with the host or changes a number the state holds on
the host.

Sizes: ``resnet18`` on 32x32 images, batch 8 (2 labelled + 6
unlabelled), 8 labelled and 24 unlabelled rows: 4 steps an epoch, one
block of 3 and a tail of 1 at ``steps_per_dispatch=3``; 2 epochs, so
the second is past ``start_epoch``."""

import contextlib
import io

import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms import registry
from stil_tta_torch.algorithms.stil import STiL
from stil_tta_torch.config import load_config
from stil_tta_torch.data.loader import EpochSampler, HostStream
from stil_tta_torch.data.source import synthetic_source
from stil_tta_torch.train import multistep, optim
from stil_tta_torch.train.evaluate import evaluate

# JAX (and tests/torch_parity.py, which imports it) only inside the CPU
# tests: the card's machine has no JAX


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test, as ``tests/torch_parity.py``'s."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


OVERRIDES = [
    "dataset=synthetic_dvm", "models=resnet18", "img_size=32",
    "synthetic_image_size=40", "batch_size=8", "unlabelled_ratio=3",
    "synthetic_labelled=8", "synthetic_unlabelled=24", "synthetic_val=8",
    "synthetic_test=8", "num_classes=4", "tabular_embedding_dim=32",
    "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
    "projection_dim=8", "start_epoch=0", "strict_prototypes=false",
    "enable_progress_bar=false", "test_and_eval=false",
    "save_checkpoints=false", "scheduler=cosine", "lr_eval=1.0e-3",
]
EPOCHS, STEPS, K = 2, 4, 3


def _train(name: str, spd: int, logdir, *extra, record: bool = False,
           epochs: int = EPOCHS, device: str = "cpu"):
    """``evaluate`` of ``name`` on ``device`` for ``epochs`` epochs;
    returns the trained state, what each step was fed (``record``) and
    the printed route."""
    cfg = load_config(name, OVERRIDES + list(extra) + [
        f"steps_per_dispatch={spd}", f"max_epochs={epochs}",
        f"logdir={logdir}"])
    states, fed = [], []
    real = registry.get_algorithm

    def capturing(algo_name):
        cls = real(algo_name)

        class Capturing(cls):
            def init_state(self, *a, **kw):
                states.append(super().init_state(*a, **kw))
                return states[-1]

            def make_train_step(self):
                step = super().make_train_step()
                if not record:
                    return step

                def rec(state, cache_l, cache_u, idx_l, idx_u, epoch, **kw):
                    fed.append((epoch, idx_l.numpy().copy(),
                                idx_u.numpy().copy(),
                                state.optimizer.param_groups[0]["lr"]))
                    return step(state, cache_l, cache_u, idx_l, idx_u, epoch,
                                **kw)
                return rec
        return Capturing

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(registry, "get_algorithm", capturing)
        evaluate(cfg, device=device)
    return states[0], fed, out.getvalue()


def _assert_same_state(a, b, steps: int = EPOCHS * STEPS):
    """Every tensor of the two states bitwise equal (nets, EMA, Adam,
    buffers, DA ring and position, metric states), and the step counts
    and generator states."""
    ta, tb = multistep.state_tensors(a), multistep.state_tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        assert torch.equal(ta[k], tb[k]), k
    assert a.step == b.step == steps
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.fixture(scope="module")
def stil_runs(tmp_path_factory):
    torch.set_num_threads(1)   # the autouse fixture is function-scoped
    root = tmp_path_factory.mktemp("multistep")
    return {(spd, hs): _train("config_dvm_STiL", spd, root / f"{spd}{hs}",
                              "DA=true", f"host_stream={str(hs).lower()}",
                              record=not hs)
            for spd, hs in ((1, False), (K, False), (K, True))}


@pytest.mark.parametrize("n,k", [(4, 3), (8, 3), (6, 3), (2, 3), (5, 1)])
def test_chunk_indices_matches_jax(n, k):
    from stil_tta_tpu.train.multistep import chunk_indices as jax_chunks
    rng = np.random.RandomState(n)
    pairs = [(rng.randint(0, 99, 2).astype(np.int32),
              rng.randint(0, 99, 6).astype(np.int32)) for _ in range(n)]
    blocks, tail = multistep.chunk_indices(pairs, k)
    jblocks, jtail = jax_chunks(pairs, k)
    assert len(blocks) == len(jblocks) == n // k
    for (il, iu), (jil, jiu) in zip(blocks, jblocks):
        assert il.shape == (k, 2) and iu.shape == (k, 6)
        np.testing.assert_array_equal(il, jil)
        np.testing.assert_array_equal(iu, jiu)
    assert len(tail) == len(jtail) == n % k
    for (il, iu), (jil, jiu) in zip(tail, jtail):
        np.testing.assert_array_equal(il, jil)
        np.testing.assert_array_equal(iu, jiu)


def test_evaluate_spd3_equals_spd1_bitwise(stil_runs):
    single, fed1, out1 = stil_runs[(1, False)]
    multi, fed3, out3 = stil_runs[(K, False)]
    _assert_same_state(multi, single)
    # the route is printed once, and only when K > 1
    assert out3.count("steps_per_dispatch 3: eager route (not on a CUDA "
                      "card)") == 1
    assert "steps_per_dispatch" not in out1
    assert len(fed3) == len(fed1) == EPOCHS * STEPS
    for a, b in zip(fed3, fed1):
        assert a[0] == b[0] and a[3] == b[3]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])


def test_evaluate_spd3_feeds_the_jax_evaluate_stream(stil_runs):
    """The (epoch, idx_l, idx_u, lr) of each step at K = 3 are those the
    JAX package's ``evaluate`` gives its steps (its samplers, seeds and
    ``scheduled_lr``; its ``spd=3`` scans the same stream,
    ``tests/test_host_stream_mode.py``)."""
    from stil_tta_tpu.config import load_config as jax_load_config
    from stil_tta_tpu.data.datasets import load_sources as jax_load_sources
    from stil_tta_tpu.data.loader import CyclingSampler as JCyclingSampler
    from stil_tta_tpu.data.loader import EpochSampler as JEpochSampler
    from stil_tta_tpu.train import optim as joptim
    jcfg = jax_load_config("config_dvm_STiL", OVERRIDES)
    src = jax_load_sources(jcfg)
    n_l, n_u = len(src["train_labelled"]), len(src["train_unlabelled"])
    seed0 = int(jcfg.seed)
    jcfg.dataset_length = STEPS
    want = []
    for epoch in range(EPOCHS):
        u = JEpochSampler(n_u, 6, shuffle=True, drop_last=True,
                          seed=seed0 + 100003 * epoch)
        lab = JCyclingSampler(n_l, 2, seed=seed0 + 100003 * epoch + 1)
        lr = joptim.scheduled_lr(jcfg, epoch, None, None)
        want += [(epoch, lab.next()[0], idx_u, lr)
                 for idx_u, _ in u.epoch()][:STEPS]
    fed = stil_runs[(K, False)][1]
    assert len(fed) == len(want)
    for (e, il, iu, lr), (we, wil, wiu, wlr) in zip(fed, want):
        assert e == we and lr == wlr
        np.testing.assert_array_equal(il, wil)
        np.testing.assert_array_equal(iu, wiu)


def test_host_stream_spd3_equals_the_cache_run_bitwise(stil_runs):
    """Through ``HostStream.epoch_blocks``: blocks of 3 stacked batches
    and a tail of single ones, bitwise the device cache's single steps."""
    _assert_same_state(stil_runs[(K, True)][0], stil_runs[(1, False)][0])


def test_host_stream_epoch_blocks_stack_the_epoch_batches():
    """``epoch_blocks(k, max_steps)`` yields the batches of ``epoch()``:
    k at a time stacked (k, B, ...) with a (k, B) weight, then the tail
    as single batches, cut at ``max_steps``."""
    src = synthetic_source(29, num_classes=4, field_lengths=[5, 4, 2, 1, 1,
                                                             1],
                           image_size=8, labelled_frac=0.5, seed=3)
    for max_steps, kinds in ((None, ["block", "block", "single", "single"]),
                             (6, ["block", "block"]),
                             (4, ["block", "single"])):
        singles = list(HostStream(src, EpochSampler(
            len(src), 4, shuffle=True, drop_last=False, seed=5),
            device="cpu").epoch())
        got = list(HostStream(src, EpochSampler(
            len(src), 4, shuffle=True, drop_last=False, seed=5),
            device="cpu").epoch_blocks(3, max_steps))
        assert [kind for kind, _ in got] == kinds
        flat = []
        for kind, batch in got:
            if kind == "single":
                flat.append(batch)
                continue
            assert batch["weight"].shape == (3, 4)
            for i in range(3):
                flat.append({k: v[i] for k, v in batch.items()})
        assert len(flat) == (max_steps or len(singles))
        for a, b in zip(flat, singles):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)
    # the tail batch of 29 rows is padded, its weight marks it
    assert (singles[-1]["weight"] == 0).sum() == 3


def test_fixmatch_family_spd3_equals_spd1_bitwise(tmp_path):
    """On the CPU FreeMatch's block of K = 3 runs eagerly, bitwise its
    single steps (one epoch: a block of 3 and a tail of 1)."""
    single, _, _ = _train("config_dvm_FreeMatch", 1, tmp_path / "1",
                          epochs=1)
    multi, _, out = _train("config_dvm_FreeMatch", K, tmp_path / "3",
                           epochs=1)
    assert "eager route" in out
    _assert_same_state(multi, single, steps=STEPS)


@pytest.mark.parametrize("case,device,route", [
    ({}, "cpu", "eager"),
    ({}, "cuda", "graph"),
    ({"algorithm_name": "STiL_SAINT"}, "cuda", "graph"),
    ({"algorithm_name": "Supervised", "micro_batches": 2}, "cuda", "graph"),
    ({"micro_batches": 2}, "cuda", "graph"),
    ({"teacher_int8": True}, "cuda", "eager"),
    ({"algorithm_name": "SimMatch"}, "cuda", "graph"),
    ({"algorithm_name": "CoTrain_Pseudo"}, "cuda", "graph"),
])
def test_route_is_chosen_from_the_config(case, device, route):
    cfg = load_config("config_dvm_STiL", OVERRIDES)
    for k, v in case.items():
        setattr(cfg, k, v)
    got, why = multistep.choose_route(
        registry.get_algorithm(cfg.algorithm_name), cfg, torch.device(device))
    assert got == route, why


def _stepped(opt, gen, steps: int = 2):
    """``steps`` optimizer steps on seeded gradients."""
    for _ in range(steps):
        for group in opt.param_groups:
            for p in group["params"]:
                p.grad = torch.randn(p.shape, generator=gen, dtype=p.dtype)
        optim.step(opt)
    return opt


@pytest.fixture(scope="module")
def cpu_stil():
    """A small STiL on the CPU (float64), built once for the file."""
    from stil_tta_torch.data.datasets import load_sources
    cfg = load_config("config_dvm_STiL", OVERRIDES)
    return STiL(cfg, load_sources(cfg)["train_labelled"].field_lengths,
                dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_restore_keeps_the_optimizer_s_learning_rate_kind(tmp_path, cpu_stil,
                                                          mu_dtype):
    """A checkpoint whose learning rate is a number (saved on the CPU or
    on a route that is not captured) restored into a state whose
    optimizer is capturable: the group stays capturable and keeps the
    very tensor it held, filled with the saved rate (``load_state_dict``
    alone leaves the number, which a capture would bake in). The other
    way round, a capturable run's checkpoint gives a plain optimizer a
    number. The moments and counts are the saved ones either way."""
    from stil_tta_torch.train.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    algo = cpu_stil
    algo.cfg.adam_mu_dtype = mu_dtype
    gen = torch.Generator().manual_seed(0)
    state = algo.init_state(0)
    assert not state.optimizer.param_groups[0]["capturable"]
    optim.set_learning_rate(_stepped(state.optimizer, gen), 0.123)
    save_checkpoint(tmp_path, state, name="plain")
    saved = [t.clone() for t in multistep.state_tensors(
        state.optimizer).values()]

    state.optimizer = optim.build_optimizer(
        state.net.parameters(), 1e-3, mu_dtype=mu_dtype, capturable=True)
    held = state.optimizer.param_groups[0]["lr"]
    restore_checkpoint(tmp_path, state, name="plain")
    group = state.optimizer.param_groups[0]
    assert group["capturable"] and group["lr"] is held
    assert float(held) == float(torch.tensor(0.123, dtype=torch.float32))
    multistep.require_capturable(state.optimizer)
    got = list(multistep.state_tensors(state.optimizer).values())
    assert len(got) == len(saved) + 1   # and the learning rate's tensor
    for a, b in zip([t for t in got if t is not held], saved):
        assert torch.equal(a, b)

    # (torch's capturable Adam steps only on a card)
    optim.set_learning_rate(state.optimizer, 0.5)
    save_checkpoint(tmp_path, state, name="capturable")
    state.optimizer = optim.build_optimizer(
        state.net.parameters(), 1e-3, mu_dtype=mu_dtype)
    restore_checkpoint(tmp_path, state, name="capturable")
    group = state.optimizer.param_groups[0]
    assert not group["capturable"] and group["lr"] == 0.5
    assert type(group["lr"]) is float
    _stepped(state.optimizer, gen, 1)   # torch's eager Adam takes it


def test_a_graphed_step_refuses_a_learning_rate_it_would_bake_in():
    """``GraphedStep`` captures only a capturable optimizer whose moving
    learning rates are tensors (the frozen group's stays the number 0);
    ``set_learning_rate`` fills a capturable group's tensor in place."""
    p, q = torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(
        torch.zeros(2))
    with pytest.raises(RuntimeError, match="not capturable"):
        multistep.require_capturable(optim.build_optimizer([p], 1e-3))
    opt = optim.build_optimizer([p, q], 1e-3, frozen=[q], capturable=True)
    multistep.require_capturable(opt)
    assert opt.param_groups[1]["lr"] == 0.0
    lr = opt.param_groups[0]["lr"]
    optim.set_learning_rate(opt, 2e-3)
    assert opt.param_groups[0]["lr"] is lr and lr.dtype == torch.float32
    assert float(lr) == float(torch.tensor(2e-3, dtype=torch.float32))
    assert opt.param_groups[1]["lr"] == 0.0
    opt.param_groups[0]["lr"] = 1e-3
    with pytest.raises(RuntimeError, match="bake in"):
        multistep.require_capturable(opt)


def test_capturable_bf16_adam_matches_the_host_counted_one():
    """The port's bf16-moment Adam counts on the parameters' device when
    capturable (bias corrections by ``torch.pow``) and on the host
    otherwise (numpy float32 powers): 300 steps of each from the same
    parameters and gradients end bitwise equal."""
    gen = torch.Generator().manual_seed(0)
    ps = [torch.nn.Parameter(torch.randn(n, generator=gen)) for n in (5, 3)]
    qs = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    host = optim.build_optimizer(ps, 1e-2, 1e-4, mu_dtype="bfloat16")
    card = optim.build_optimizer(qs, 1e-2, 1e-4, mu_dtype="bfloat16",
                                 capturable=True)
    for _ in range(300):
        for p, q in zip(ps, qs):
            p.grad = torch.randn(p.shape, generator=gen)
            q.grad = p.grad.clone()
        host.step()
        card.step()
    for p, q in zip(ps, qs):
        assert torch.equal(p, q)
        assert torch.equal(host.state[p]["exp_avg"], card.state[q]["exp_avg"])


# ---- on the card ---------------------------------------------------------

CARD_OVERRIDES = [o for o in OVERRIDES if not o.startswith("batch_size")] + [
    "batch_size=16", "synthetic_labelled=16", "synthetic_unlabelled=48",
    "DA=true", "augmentation_rate=1.0", "corruption_rate=0.3"]


def _card_run(graphed: bool, plant=None, config: str = "config_dvm_STiL",
              extra=()):
    """Two dispatches of 3 steps of ``config`` (epoch 0, then 1: the
    pseudo-label gate, or a family's gates, turn on) from a seeded state
    on the card, graphed or eager; returns the state, the dispatcher and
    the BN launches counted."""
    from stil_tta_torch.data.datasets import load_sources
    from stil_tta_torch.data.loader import DeviceCache
    from stil_tta_torch.ops.batch_norm import bn_bwd_reduce, bn_stats
    cfg = load_config(config, CARD_OVERRIDES + list(extra))
    src = load_sources(cfg)
    dev = torch.device("cuda")
    algo = registry.get_algorithm(cfg.algorithm_name)(
        cfg, src["train_labelled"].field_lengths, device=dev)
    caches = [DeviceCache(src[k], device=dev).as_dict()
              for k in ("train_labelled", "train_unlabelled")]
    torch.manual_seed(0)
    state = algo.init_state(0)
    step = algo.make_train_step()
    if plant is not None:
        step = plant(step)
    dispatch = (multistep.GraphedStep(algo, step) if graphed
                else multistep.EagerSteps(step))
    rng = np.random.RandomState(0)
    bn_stats.launches = bn_bwd_reduce.launches = 0
    for epoch in (0, 1):
        il = torch.from_numpy(rng.randint(0, 16, (3, 4)).astype(np.int32))
        iu = torch.from_numpy(rng.randint(0, 48, (3, 12)).astype(np.int32))
        il, iu = il.to(dev), iu.to(dev)
        dispatch(state, [(*caches, il[i], iu[i]) for i in range(3)], epoch)
    torch.cuda.synchronize()
    return state, dispatch, (bn_stats.launches, bn_bwd_reduce.launches)


@pytest.mark.gpu
def test_graphed_dispatch_matches_eager_steps_on_card():
    """At a small width: the graphed dispatches end bitwise equal to six
    eager steps (every state tensor, the generator), and the BN kernels'
    counters advance under replay as the eager steps advance them (20
    launches of each a ResNet-18 step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager, _, n_eager = _card_run(False)
        graphed, dispatch, n_graph = _card_run(True)
    finally:
        torch.backends.cudnn.deterministic = cudnn
    assert n_eager == n_graph == (6 * 20, 6 * 20)
    assert dispatch.launches_per_replay["bn_stats.launches"] == 20
    assert dispatch.launches_per_replay["bn_bwd_reduce.launches"] == 20
    te, tg = (multistep.state_tensors(s) for s in (eager, graphed))
    assert set(te) == set(tg)
    off = [k for k in te if not torch.equal(te[k], tg[k])]
    assert not off, off[:10]
    assert eager.step == graphed.step == 6
    assert torch.equal(eager.generator.get_state(),
                       graphed.generator.get_state())


@pytest.mark.gpu
def test_evaluate_graphed_equals_single_steps_on_card(tmp_path):
    """``evaluate`` on the card at a small width, two epochs of 4 steps:
    at ``steps_per_dispatch=3`` (the graph route: a captured step replayed
    in both epochs, through the device cache and through the host
    stream) bitwise its run at 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {(spd, hs): _train("config_dvm_STiL", spd, tmp_path / f"{spd}"
                                  f"{hs}", "DA=true",
                                  f"host_stream={str(hs).lower()}",
                                  device="cuda")
                for spd, hs in ((1, False), (K, False), (K, True))}
    finally:
        torch.backends.cudnn.deterministic = cudnn
    assert "graph route" in runs[(K, False)][2]
    for key in ((K, False), (K, True)):
        _assert_same_state(runs[key][0], runs[(1, False)][0])


@pytest.mark.gpu
def test_capture_of_a_host_sync_fails_on_card():
    """A step that reads a device value on the host cannot be captured:
    the dispatch raises instead of running eager steps, and leaves the
    default generator able to draw eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def plant(step):
        def synced(state, *args):
            float(state.log_count)     # a host sync
            return step(state, *args)
        return synced

    with pytest.raises(RuntimeError):
        _card_run(True, plant=plant)
    assert torch.rand(2, device="cuda").shape == (2,)


# each newly captured route at the card tests' width (ResNet-18: 20
# BatchNorms): (config, overrides, (bn_stats, bn_bwd_reduce) a step)
CARD_ROUTES = {
    "SimMatch": ("config_dvm_SimMatch", ["K=16"], (20, 20)),
    "CoMatch": ("config_dvm_CoMatch", ["K=32"], (40, 20)),
    "FreeMatch": ("config_dvm_FreeMatch", [], (20, 20)),
    "MultiSimMatch": ("config_dvm_MultiSimMatch", ["K=16"], (20, 20)),
    "MultiCoMatch": ("config_dvm_MultiCoMatch", ["K=32"], (40, 20)),
    "MultiFreeMatch": ("config_dvm_MultiFreeMatch", [], (20, 20)),
    "MMatch": ("config_dvm_MMatch", [], (20, 20)),
    "CoTrain_Pseudo": ("config_dvm_CoTrain", [], (20, 20)),
    "CoTrain_Pseudo_SAINT": ("config_dvm_CoTrain_SAINT", [], (20, 20)),
    "TabularEval": ("config_dvm_STiL", ["algorithm_name=TabularEval",
                                        "eval_datatype=tabular"], (0, 0)),
    "STiL m=4": ("config_dvm_STiL", ["micro_batches=4"], (80, 80)),
    "CoMatch m=4": ("config_dvm_CoMatch", ["K=32", "micro_batches=4"],
                    (160, 80)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", sorted(CARD_ROUTES))
def test_every_family_s_graphed_dispatch_matches_eager_on_card(route):
    """Each family of the registry (and the micro-batched steps of STiL
    and CoMatch): the graphed dispatches end bitwise equal to six eager
    steps (every state tensor, the queues' and banks' positions among
    them, the generator), and the BN counters advance under replay as the
    eager steps advance them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    config, extra, per_step = CARD_ROUTES[route]
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager, _, n_eager = _card_run(False, config=config, extra=extra)
        graphed, dispatch, n_graph = _card_run(True, config=config,
                                               extra=extra)
    finally:
        torch.backends.cudnn.deterministic = cudnn
    assert dispatch.route == "graph"
    assert n_eager == n_graph == tuple(6 * n for n in per_step)
    assert (dispatch.launches_per_replay["bn_stats.launches"],
            dispatch.launches_per_replay["bn_bwd_reduce.launches"]) \
        == per_step
    te, tg = (multistep.state_tensors(s) for s in (eager, graphed))
    assert set(te) == set(tg)
    off = [k for k in te if not torch.equal(te[k], tg[k])]
    assert not off, off[:10]
    assert eager.step == graphed.step == 6
    assert torch.equal(eager.generator.get_state(),
                       graphed.generator.get_state())


@pytest.mark.gpu
def test_capture_of_a_host_number_change_fails_on_card():
    """A step that moves a number the state holds on the host (here a
    write position kept as an int, as the families kept theirs) cannot
    be captured: a replay would not move it, so the dispatch raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def plant(step):
        def counted(state, *args):
            state.extra["host_ptr"] = state.extra.get("host_ptr", 0) + 1
            return step(state, *args)
        return counted

    with pytest.raises(RuntimeError, match="host values"):
        _card_run(True, plant=plant, config="config_dvm_FreeMatch")


@pytest.mark.gpu
def test_capturable_adam_matches_torch_s_on_card():
    """300 steps of the port's :class:`CapturableAdam` and of
    ``torch.optim.Adam(capturable=True)`` on the card from the same
    parameters, gradients and learning-rate tensor, with weight decay:
    bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ps = [torch.nn.Parameter(torch.randn(n, generator=gen, device="cuda"))
          for n in (5, 300, 7)]
    qs = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    ours = optim.build_optimizer(ps, 1e-2, 1e-4, capturable=True)
    theirs = torch.optim.Adam(qs, lr=torch.tensor(1e-2, device="cuda"),
                              weight_decay=1e-4, capturable=True)
    assert type(ours) is optim.CapturableAdam
    for _ in range(300):
        for p, q in zip(ps, qs):
            p.grad = torch.randn(p.shape, generator=gen, device="cuda")
            q.grad = p.grad.clone()
        ours.step()
        theirs.step()
    for p, q in zip(ps, qs):
        assert torch.equal(p, q)
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(ours.state[p][k], theirs.state[q][k]), k
