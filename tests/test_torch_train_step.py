"""One STiL train step of the port against the JAX package's, on both
sides of ``start_epoch``, then a short trajectory through ``epoch_end``.

Setup: ``resnet18`` on 32x32 images, 4 labelled + 12 unlabelled rows,
small widths, float64 on both sides (JAX in x64), Adam, DA on,
augmentation and corruption off, the fusion layer's dropout at
0 on both sides (monkeypatching the JAX ``MITransformerLayer`` as
``tests/test_train_step_parity.py`` does), the case-3 routing draw made
by JAX from its step key and fed to the port as data. The EMA backbone
differs from the student and both carry non-trivial BatchNorm running
statistics, so the EMAN lerp is visible. With augmentation off the
view is the image scaled to [0, 1]; the port computes it (x / 255 in
float32), while the JAX side is handed that view directly, because its
jitted step computes x * (1/255), one float32 rounding away on half the
pixel values, and float64 comparisons would see it.

The two sides start from one state: the port's seeded weights go into a
JAX ``STiLState`` (the JAX converter), and that state comes back into
the port through ``train_state_from_jax``. The JAX step is compiled once
for the file (``epoch`` is traced). Tolerances: float64 sums in two
orders, rtol 1e-8 on losses, and on parameters atol 1e-9 against Adam
steps of lr 1e-3 (a parameter moves by at most lr per step); the
``*_ratio`` logs are float32 on both sides, rtol 2e-7."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms.stil import LOG_KEYS, STiL, init_weights
from stil_tta_torch.config import load_config
from stil_tta_torch.ops.batch_norm import BatchNorm2d
from stil_tta_torch.train.convert import (load_train_state,
                                          train_state_from_jax)
from stil_tta_tpu.algorithms.base import DAState as JDAState
from stil_tta_tpu.algorithms.stil import STiL as JaxSTiL
from stil_tta_tpu.algorithms.stil import STiLState as JSTiLState
from stil_tta_tpu.config import load_config as jax_load_config
from stil_tta_tpu.models import backbones as jbackbones
from stil_tta_tpu.ops.metrics import accuracy_init
from stil_tta_tpu.train.convert import convert_torch_state_dict
from tests.torch_parity import assert_close, x64
from tests.torch_parity import one_torch_thread  # noqa: F401

FL = [5, 4, 2, 1, 1, 1]
B_L, B_U, IMG, C, P = 4, 12, 32, 4, 8
OVERRIDES = [
    "dataset=synthetic_dvm", "models=resnet18", f"img_size={IMG}",
    f"num_classes={C}", "tabular_embedding_dim=32",
    "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
    f"projection_dim={P}", "augmentation_rate=0.0", "corruption_rate=0.0",
    "DA=true", "start_epoch=0", "th1=0.3", "ema_momentum=0.9",
    "lr_eval=1e-3", "weight_decay_eval=1e-4", "strict_prototypes=false",
]
F64 = torch.float64
LOSS_RTOL, PARAM_ATOL = 1e-8, 1e-9
# the *_ratio logs are float32 means on both sides; JAX's mean multiplies
# the sum by float32(1/n), torch's divides: one float32 rounding apart
RATIO_RTOL = 2e-7


def _cfg(loader):
    cfg = loader("config_dvm_STiL", OVERRIDES)
    cfg.field_lengths = list(FL)
    cfg.repeat_ratio = 3
    return cfg


def _no_fusion_dropout(net):
    for layer in net.model.transformer:
        layer.drop_path = 0.0
        layer.mlp.drop = 0.0
        layer.attn.attn_drop = layer.attn.proj_drop = 0.0


def _data():
    rng = np.random.RandomState(0)
    n = B_L + B_U
    imgs = rng.randint(0, 256, (n, IMG, IMG, 3)).astype(np.uint8)
    tabs = np.concatenate([np.stack([rng.randint(0, c, n) for c in FL[:3]],
                                    1), rng.randn(n, 3)], 1).astype(
        np.float32)
    y = rng.randint(0, C, n)
    caches = []
    for sl in (slice(0, B_L), slice(B_L, n)):
        caches.append(({"images": jnp.asarray(
                            imgs[sl].astype(np.float32) / np.float32(255)),
                        "tabular": jnp.asarray(tabs[sl]),
                        "labels": jnp.asarray(y[sl].astype(np.int32)),
                        "labelled": jnp.asarray(np.ones(y[sl].shape, bool))},
                       {"images": torch.from_numpy(imgs[sl]),
                        "tabular": torch.from_numpy(tabs[sl]),
                        "labels": torch.from_numpy(y[sl]),
                        "labelled": torch.ones(y[sl].shape, dtype=bool)}))
    return caches


def _port_initial_state(algo):
    """Seeded weights, an EMA backbone of other weights, random running
    statistics on both, random unit prototypes."""
    state = algo.init_state(seed=0)
    init_weights(state.ema, torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for mod in list(state.net.modules()) + list(state.ema.modules()):
            if isinstance(mod, BatchNorm2d):
                mod.running_mean.normal_(0, 0.05, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
        protos = torch.randn(C, P, generator=gen, dtype=F64)
        state.prototypes = protos / protos.norm(dim=1, keepdim=True)
    return state


def _jax_state(jalgo, port_state):
    """A JAX ``STiLState`` holding the port state's weights (float64)."""
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda: jalgo.net.init(
        {"params": key, "dropout": key}, jnp.zeros((2, IMG, IMG, 3)),
        jnp.zeros((2, len(FL))), train=False))
    target = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float64), dict(shapes))
    sd = {k: v.numpy() for k, v in port_state.net.state_dict().items()}
    variables, _ = convert_torch_state_dict(sd, target)
    sd.update({"model." + k: v.numpy()
               for k, v in port_state.ema.state_dict().items()})
    ema, _ = convert_torch_state_dict(sd, target)
    z = lambda *s: jnp.zeros(s, jnp.float64)  # noqa: E731
    return JSTiLState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jalgo.tx.init(variables["params"]),
        ema_params=ema["params"]["backbone"],
        ema_batch_stats=ema["batch_stats"]["backbone"],
        rng=jax.random.key(5), step=jnp.zeros((), jnp.int32),
        prototypes=jnp.asarray(port_state.prototypes.numpy()),
        prototypes_sum=z(C, P), prototypes_count=z(C, 1),
        da=JDAState(z(256, C), jnp.zeros((), jnp.int32)),
        acc_train=accuracy_init(), acc_train_u=accuracy_init(),
        log_sums={k: z() for k in LOG_KEYS}, log_count=z())


def _mask_rand(jstate):
    """The case-3 routing draw of the JAX step (``stil.py:436, 359``)."""
    k_case3 = jax.random.split(jstate.rng, 4)[3]
    return np.asarray(jax.random.uniform(k_case3, (B_U,)) >= 0.5)


@pytest.fixture(scope="module")
def run():
    """Both sides from one initial state: one step at epoch 0 (=
    start_epoch: no pseudo-label losses), one at epoch 1, and a
    trajectory of 4 steps at epoch 1, ``epoch_end``, 1 step at epoch 2."""
    def dropfree(**kw):
        kw.update(attn_drop=0.0, proj_drop=0.0, drop_path=0.0)
        return real_layer(**kw)

    real_layer = jbackbones.MITransformerLayer
    (jcl, cl), (jcu, cu) = _data()
    il, iu = jnp.arange(B_L, dtype=jnp.int32), jnp.arange(B_U,
                                                          dtype=jnp.int32)
    with x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbackbones, "MITransformerLayer", dropfree)
        jalgo = JaxSTiL(_cfg(jax_load_config), FL, dtype=jnp.float64)
        jalgo._views = lambda key, il, tl, iu, tu, ml, mu: (il, tl, iu, tu)

        def port_state(carried=None):
            """A state of its own net, from ``carried`` if given."""
            algo = STiL(_cfg(load_config), FL, dtype=F64, device="cpu")
            _no_fusion_dropout(algo.net)
            if carried is None:
                return algo, _port_initial_state(algo)
            state = algo.init_state(seed=0)
            load_train_state(state, carried)
            return algo, state

        algo, state0 = port_state()
        j0 = _jax_state(jalgo, state0)
        carried = train_state_from_jax(j0)
        # the package's step donates its input state; this one does not,
        # so every run can start from j0
        jstep = jax.jit(jalgo.make_train_step().__wrapped__)
        pstep = algo.make_train_step()

        def both(jstate, pstate, epoch):
            mask = torch.tensor(_mask_rand(jstate))
            jstate = jstep(jstate, jcl, jcu, il, iu,
                           jnp.asarray(epoch, jnp.int32))
            pstep(pstate, cl, cu, torch.arange(B_L), torch.arange(B_U),
                  epoch, mask_rand=mask)
            return jstate, pstate

        out = {"initial": carried,
               "steps": {e: both(j0, port_state(carried)[1], e)
                         for e in (0, 1)}}
        jstate, pstate = j0, port_state(carried)[1]
        for _ in range(4):
            jstate, pstate = both(jstate, pstate, 1)
        jstate, jlogs = jalgo.epoch_end(jstate)
        # epoch_end resets the sums as float32 zeros; float64 zeros keep
        # the compiled step's input types
        jstate = dataclasses.replace(jstate, **{
            k: jax.tree_util.tree_map(lambda a: a.astype(jnp.float64),
                                      getattr(jstate, k))
            for k in ("prototypes_sum", "prototypes_count", "log_sums",
                      "log_count")})
        pstate, plogs = algo.epoch_end(pstate)
        out["epoch_logs"] = (jlogs, plogs)
        out["trajectory"] = both(jstate, pstate, 2)
    return out


def _compare_states(jstate, pstate, logs=True, param_atol=PARAM_ATOL):
    want = train_state_from_jax(jstate)
    if logs:
        for k in LOG_KEYS:
            rtol = RATIO_RTOL if k.endswith("_ratio") else LOSS_RTOL
            assert_close(pstate.log_sums[k], np.asarray(jstate.log_sums[k]),
                         rtol, 1e-12, k)
    for name, got in (("net", pstate.net.state_dict()),
                      ("ema", pstate.ema.state_dict())):
        assert set(got) == set(want[name]), name
        for k, v in want[name].items():
            if k.endswith("num_batches_tracked"):
                continue   # the JAX package keeps no BN counters
            assert_close(got[k], v.numpy(), 0, param_atol, f"{name} {k}")
    for k in ("prototypes", "prototypes_sum", "prototypes_count"):
        assert_close(getattr(pstate, k), want[k].numpy(), 1e-9, 1e-12, k)
    assert_close(pstate.da.queue, want["da"][0].numpy(), 1e-9, 1e-12, "da")
    assert pstate.da.ptr == want["da"][1]
    assert float(pstate.acc_train.correct) == float(jstate.acc_train.correct)
    assert float(pstate.acc_train_u.correct) == \
        float(jstate.acc_train_u.correct)


@pytest.mark.parametrize("epoch", [0, 1])
def test_train_step_matches_jax(run, epoch):
    jstate, pstate = run["steps"][epoch]
    assert pstate.step == 1 == int(jstate.step)
    _compare_states(jstate, pstate)
    logs = {k: float(v) for k, v in pstate.log_sums.items()}
    # epoch 0 is not past start_epoch: the pseudo-label terms are logged
    # but left out of the loss; at epoch 1 they count
    extra = logs["loss"] - (
        0.2 * logs["CEloss"] + 3.0 * logs["ITCloss"] + 0.5 * sum(
            logs[k] for k in ("CLUBloss_imaging", "CLUBloss_imaging_est",
                              "CLUBloss_tabular", "CLUBloss_tabular_est")))
    assert (abs(extra) > 1e-6) == (epoch == 1)
    assert 0 < logs["threshold1_ratio"] < 1
    # the student and the EMA backbone both moved
    for name, module in (("net", pstate.net), ("ema", pstate.ema)):
        start = run["initial"][name]
        got = module.state_dict()
        assert not torch.equal(got["model.reduce.weight" if name == "net"
                                   else "reduce.weight"],
                               start["model.reduce.weight" if name == "net"
                                     else "reduce.weight"].double())


def test_short_trajectory_through_epoch_end_matches_jax(run):
    jlogs, plogs = run["epoch_logs"]
    assert set(plogs) == set(jlogs)
    for k, v in jlogs.items():
        assert plogs[k] == pytest.approx(v, rel=1e-7, abs=1e-12), k
    jstate, pstate = run["trajectory"]
    assert pstate.step == 5 == int(jstate.step)
    # epoch_end replaced the prototypes by the epoch's normalised sums
    assert not torch.equal(pstate.prototypes,
                           run["initial"]["prototypes"].double())
    _compare_states(jstate, pstate)
