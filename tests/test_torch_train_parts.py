"""The building blocks of the port's STiL train step against the JAX
package's: the pseudo-label losses, sharpening, distribution alignment,
the EMAN update, the streaming train metrics, the optimizer, the
learning-rate schedules, the labelled sampler, the tabular corruption and
the contrastive augmentation. Inputs are made with numpy from a seed;
random draws are made by JAX and fed to the port's apply functions."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stil_tta_torch.algorithms import base
from stil_tta_torch.config import load_config
from stil_tta_torch.data import augment, corrupt, loader
from stil_tta_torch.losses.common import soft_cross_entropy
from stil_tta_torch.losses.prototype_loss import prototype_loss
from stil_tta_torch.ops import metrics
from stil_tta_torch.ops.batch_norm import BatchNorm2d
from stil_tta_torch.train import optim
from stil_tta_tpu.algorithms import base as jbase
from stil_tta_tpu.data import augment as jaug
from stil_tta_tpu.data import corrupt as jcorrupt
from stil_tta_tpu.data import loader as jloader
from stil_tta_tpu.losses import prototype_loss as jax_prototype_loss
from stil_tta_tpu.losses import soft_cross_entropy as jax_soft_ce
from stil_tta_tpu.ops import metrics as jmetrics
from stil_tta_tpu.train import optim as joptim
from tests.torch_parity import assert_close, jax_augment_draws, x64
from tests.torch_parity import one_torch_thread  # noqa: F401

T = torch.from_numpy


def _probs(rng, n, c):
    p = rng.rand(n, c) ** 3
    return p / p.sum(1, keepdims=True)


def test_pseudo_label_losses_and_sharpen_match_jax():
    """soft_cross_entropy (reduction none), prototype_loss and sharpen at
    float64: the same formulas, rtol 1e-12."""
    rng = np.random.RandomState(0)
    logits, feat = rng.randn(10, 6) * 3, rng.randn(10, 8)
    target, protos = _probs(rng, 10, 6), rng.randn(6, 8)
    with x64():
        want = (jax_soft_ce(jnp.asarray(logits), jnp.asarray(target),
                            "none"),
                jax_prototype_loss(jnp.asarray(target), jnp.asarray(protos),
                                   jnp.asarray(feat), 0.1, 0.3),
                jbase.sharpen(jnp.asarray(logits), 0.5))
    got = (soft_cross_entropy(T(logits), T(target), "none"),
           prototype_loss(T(target), T(protos), T(feat), 0.1, 0.3),
           base.sharpen(T(logits), 0.5))
    for g, w in zip(got, want):
        assert_close(g, np.asarray(w), 1e-12, 1e-14)
    assert float((target.max(1) >= 0.3).mean()) not in (0.0, 1.0)


def test_distribution_alignment_ring_wraps_like_jax():
    """A ring of 3 fed 5 batches: it wraps twice. Queue, pointer and
    aligned probabilities at float64, rtol 1e-12."""
    rng = np.random.RandomState(1)
    ours = base.DAState.create(4, length=3, dtype=torch.float64)
    with x64():
        ref = jbase.DAState(jnp.zeros((3, 4), jnp.float64),
                            jnp.zeros((), jnp.int32))
        for _ in range(5):
            p = _probs(rng, 7, 4)
            ref, want = jbase.distribution_alignment(ref, jnp.asarray(p))
            ours, got = base.distribution_alignment(ours, T(p))
            assert_close(got, np.asarray(want), 1e-12, 1e-14)
            assert_close(ours.queue, np.asarray(ref.queue), 1e-12, 1e-14)
            assert ours.ptr == int(ref.ptr)
    assert ours.ptr == 2


@pytest.mark.parametrize("eman", [True, False])
def test_ema_update_matches_jax(eman):
    """The EMAN lerp of parameters, and of the BatchNorm running
    statistics only with ``eman``; float64, rtol 1e-12."""
    rng = np.random.RandomState(2)

    def module():
        m = torch.nn.Sequential(torch.nn.Linear(3, 4), BatchNorm2d(4))
        return m.double()

    ema, student = module(), module()
    values = {}
    for name, mod in (("e", ema), ("s", student)):
        with torch.no_grad():
            for t in list(mod.parameters()) + [mod[1].running_mean,
                                               mod[1].running_var]:
                t.copy_(T(rng.rand(*t.shape)))
        mod[1].num_batches_tracked.fill_(3 if name == "s" else 0)
        n = lambda t: t.detach().numpy().copy()  # noqa: E731
        values[name] = ({"w": n(mod[0].weight), "b": n(mod[0].bias),
                         "scale": n(mod[1].weight), "bias": n(mod[1].bias)},
                        {"mean": mod[1].running_mean.numpy().copy(),
                         "var": mod[1].running_var.numpy().copy()})
    base.ema_update(ema, student, 0.9, eman)
    with x64():
        p, s = jbase.ema_update(values["e"][0], values["s"][0], 0.9, eman,
                                values["e"][1], values["s"][1])
    for got, want in ((ema[0].weight, p["w"]), (ema[0].bias, p["b"]),
                      (ema[1].weight, p["scale"]), (ema[1].bias, p["bias"]),
                      (ema[1].running_mean, s["mean"]),
                      (ema[1].running_var, s["var"])):
        assert_close(got, np.asarray(want), 1e-12, 1e-14)
    assert int(ema[1].num_batches_tracked) == (3 if eman else 0)


@pytest.mark.parametrize("binary", [True, False])
def test_train_metric_states_match_jax(binary):
    """Accuracy counters are exact; the bucketised binary AUROC sums 0/1
    counts, so it is exact too (abs 1e-12)."""
    rng = np.random.RandomState(3)
    c = 2 if binary else 5
    acc, jacc = metrics.accuracy_init(), jmetrics.accuracy_init()
    auc, jauc = metrics.auroc_init(), jmetrics.auroc_init(2)
    for _ in range(3):
        p = _probs(rng, 9, c).astype(np.float32)
        y = rng.randint(0, c, 9)
        pred = p[:, 1] if binary else p
        acc = metrics.accuracy_update(acc, T(pred), T(y))
        jacc = jmetrics.accuracy_update(jacc, jnp.asarray(pred),
                                        jnp.asarray(y))
        if binary:
            auc = metrics.auroc_update(auc, T(pred), T(y))
            jauc = jmetrics.auroc_update(jauc, jnp.asarray(pred),
                                         jnp.asarray(y))
    assert float(acc.correct) == float(jacc.correct)
    assert float(acc.total) == float(jacc.total) == 27
    assert metrics.accuracy_compute(acc) == pytest.approx(
        float(jmetrics.accuracy_compute(jacc)), abs=1e-7)
    if binary:
        np.testing.assert_array_equal(auc.pos.numpy(), np.asarray(jauc.pos))
        np.testing.assert_array_equal(auc.neg.numpy(), np.asarray(jauc.neg))
        assert metrics.auroc_compute(auc) == pytest.approx(
            float(jmetrics.auroc_compute(jauc)), abs=1e-6)
    assert metrics.auroc_compute(metrics.auroc_init()) == 0.0


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_optimizer_matches_optax_over_three_steps(weight_decay):
    """torch Adam against the JAX package's optax chain at float64, three
    steps with the learning rate changed between steps 1 and 2; one
    parameter has a zero gradient throughout (weight decay still moves
    it). The JAX package keeps the learning rate as a float32 scalar, so
    each of its steps differs by float32 rounding of the learning rate:
    atol 1e-8, above 3 steps x lr 1e-2 x 2^-24."""
    rng = np.random.RandomState(4)
    p0 = {"a": rng.randn(3, 4), "b": rng.randn(5)}
    grads = [{"a": rng.randn(3, 4) * 0.1, "b": np.zeros(5)}
             for _ in range(3)]
    lrs = [1e-2, 3e-3, 3e-3]
    params = [torch.nn.Parameter(T(p0[k].copy())) for k in ("a", "b")]
    opt = optim.build_optimizer(params, lrs[0], weight_decay)
    with x64():
        tx = joptim.build_optimizer(lrs[0], weight_decay)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        state = tx.init(jp)
        for g, lr in zip(grads, lrs):
            optim.set_learning_rate(opt, lr)
            state = joptim.set_learning_rate(state, lr)
            for p, k in zip(params, ("a", "b")):
                p.grad = T(g[k].copy())
            opt.step()
            upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
            jp = optax.apply_updates(jp, upd)
            for p, k in zip(params, ("a", "b")):
                assert_close(p, np.asarray(jp[k]), 0, 1e-8, k)
    assert all(g["lr"] == lrs[-1] for g in opt.param_groups)
    moved = not np.allclose(params[1].detach().numpy(), p0["b"])
    assert moved == (weight_decay > 0)


def test_optimizer_refuses_unported_options():
    """Both options are ported: the encoder freeze builds a second param
    group at learning rate 0 (``tests/test_torch_warm_start.py``), a
    bfloat16 first moment (``adam_mu_dtype``) the port's own Adam; a
    first-moment dtype torch does not have raises."""
    p = [torch.nn.Parameter(torch.zeros(2)), torch.nn.Parameter(
        torch.zeros(3))]
    opt = optim.build_optimizer(p, 1e-3, frozen=p[1:])
    assert [len(g["params"]) for g in opt.param_groups] == [1, 1]
    assert opt.param_groups[1]["lr"] == 0.0
    with pytest.raises(AttributeError):
        optim.build_optimizer(p, 1e-3, mu_dtype="bfloat17")
    opt = optim.build_optimizer(p, 1e-3, mu_dtype="bfloat16")
    assert isinstance(opt, optim.Adam) and opt.mu_dtype == torch.bfloat16


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_bf16_mu_adam_matches_optax(weight_decay):
    """The port's Adam with a bfloat16 first moment against the JAX
    package's chain with ``scale_by_adam(mu_dtype=bfloat16)``, float32
    parameters, four steps with the learning rate changed between steps
    1 and 2, one parameter with a zero gradient throughout: parameters
    and both moments equal bit for bit (the same float32 and bfloat16
    operations in the same order). Rounding the new moment to bfloat16
    before the update, instead of after it, already moves the first
    step."""
    rng = np.random.RandomState(8)
    p0 = {"a": rng.randn(3, 40).astype(np.float32),
          "b": rng.randn(50).astype(np.float32)}
    grads = [{"a": (rng.randn(3, 40) * 0.1).astype(np.float32),
              "b": np.zeros(50, np.float32)} for _ in range(4)]
    lrs = [1e-2, 3e-3, 3e-3, 3e-3]
    params = [torch.nn.Parameter(T(p0[k].copy())) for k in ("a", "b")]
    opt = optim.build_optimizer(params, lrs[0], weight_decay,
                                mu_dtype="bfloat16")
    tx = joptim.build_optimizer(lrs[0], weight_decay, mu_dtype="bfloat16")
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for i, (g, lr) in enumerate(zip(grads, lrs)):
        optim.set_learning_rate(opt, lr)
        state = joptim.set_learning_rate(state, lr)
        for p, k in zip(params, ("a", "b")):
            p.grad = T(g[k].copy())
        opt.step()
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        adam = [s for s in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]
        for p, k in zip(params, ("a", "b")):
            st = opt.state[p]
            assert st["exp_avg"].dtype == torch.bfloat16
            assert st["exp_avg_sq"].dtype == torch.float32
            np.testing.assert_array_equal(p.detach().numpy(),
                                          np.asarray(jp[k]), f"{i} {k}")
            np.testing.assert_array_equal(
                st["exp_avg"].float().numpy(),
                np.asarray(adam.mu[k]).astype(np.float32), f"{i} mu {k}")
            np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                          np.asarray(adam.nu[k]))
    moved = not np.allclose(params[1].detach().numpy(), p0["b"])
    assert moved == (weight_decay > 0)
    # the trap: a moment rounded to bfloat16 before the update
    g, b1 = grads[0]["a"], 0.9
    mu = torch.tensor((1 - b1) * g).to(torch.bfloat16).float()
    early = p0["a"] - lrs[0] * (mu / (1 - b1)).numpy() / (
        np.sqrt((1 - 0.999) * g * g / (1 - 0.999)) + 1e-8)
    opt = optim.build_optimizer([torch.nn.Parameter(T(p0["a"].copy()))],
                                lrs[0], mu_dtype="bfloat16")
    opt.param_groups[0]["params"][0].grad = T(g.copy())
    opt.step()
    assert np.abs(early - opt.param_groups[0]["params"][0].detach()
                  .numpy()).max() > 1e-6


@pytest.mark.parametrize("scheduler", ["cosine", "anneal", "linear"])
def test_schedules_match_jax(scheduler):
    ov = [f"scheduler={scheduler}", "max_epochs=30", "anneal_max_epochs=20",
          "warmup_epochs=4", "dataset_length=7"]
    cfg = load_config("config_dvm_STiL", ov)
    from stil_tta_tpu.config import load_config as jax_load_config
    jcfg = jax_load_config("config_dvm_STiL", ov)
    plateau = optim.PlateauScheduler(1e-3, patience=2, min_lr=1e-6,
                                     mode="max")
    jplateau = joptim.PlateauScheduler(1e-3, patience=2, min_lr=1e-6,
                                       mode="max")
    vals = np.random.RandomState(5).rand(45) * 0.1
    vals[:10] = np.linspace(0, 1, 10)
    for epoch in range(45):
        metric = None if epoch == 0 else float(vals[epoch])
        got = optim.scheduled_lr(cfg, epoch, metric, plateau)
        want = joptim.scheduled_lr(jcfg, epoch, metric, jplateau)
        assert got == want, (scheduler, epoch)
    for e in range(25):
        assert optim.cosine_lr(1e-3, e, 9) == joptim.cosine_lr(1e-3, e, 9)
        assert optim.warmup_cosine_lr(1e-3, e, 1, 10) == \
            joptim.warmup_cosine_lr(1e-3, e, 1, 10)


def test_cycling_sampler_matches_jax():
    ours = loader.CyclingSampler(10, 4, seed=7)
    ref = jloader.CyclingSampler(10, 4, seed=7)
    for _ in range(8):   # three passes over the 10 rows
        (i, w), (ri, rw) = ours.next(), ref.next()
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(w, rw)


@pytest.mark.parametrize("rate", [0.3, 0.0])
def test_corruption_apply_matches_jax_given_its_draws(rate):
    """``apply_corruption`` fed the (B, F) noise and source rows that
    ``corrupt_tabular`` draws from its key gives its result exactly."""
    rng = np.random.RandomState(6)
    rows = rng.randn(6, 10).astype(np.float32)
    marginal = rng.randn(13, 10).astype(np.float32)
    key = jax.random.key(3)
    want = jcorrupt.corrupt_tabular(key, jnp.asarray(rows),
                                    jnp.asarray(marginal), rate)
    k_perm, k_pick = jax.random.split(key)
    draws = {"noise": torch.tensor(np.asarray(
                 jax.random.uniform(k_perm, (6, 10)))),
             "src_rows": torch.tensor(np.asarray(
                 jax.random.randint(k_pick, (6, 10), 0, 13))).long()}
    got = corrupt.apply_corruption(T(rows), T(marginal), rate, draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gen = torch.Generator().manual_seed(0)
    out = corrupt.corrupt_tabular(gen, T(rows), T(marginal), rate)
    assert int((out != T(rows)).sum(1).max()) <= int(10 * rate)


def test_contrastive_pipeline_apply_matches_jax_given_its_draws():
    """The DVM contrastive recipe at 40 -> 32 on 8 images, some gated
    off, with JAX's draws: jitter, grayscale, crop, flip and the blur
    composed into the resampling matrices. Both compute in float32 in
    different orders: atol 2e-5 on [0, 1] pixels."""
    rng = np.random.RandomState(8)
    imgs = rng.randint(0, 256, (8, 40, 40, 3), dtype=np.uint8)
    jpipe = jaug.contrastive_pipeline(32, "dvm", 0.08)
    key = jax.random.key(11)
    want = np.asarray(jax.jit(lambda k, x: jpipe(k, x, apply_rate=0.7))(
        key, jnp.asarray(imgs)))
    pipe = augment.contrastive_pipeline(32, "dvm", 0.08)
    draws = jax_augment_draws(jpipe, key, 8, 40, 40, 0.7)
    for k in ("gate", "jitter_on", "gray_on", "blur_on", "flip"):
        assert 0 < int(draws[k].sum()) < 8, k   # both branches are taken
    got = pipe.apply(T(imgs), draws)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert_close(got, want, 0, 2e-5)
    own = pipe(torch.Generator().manual_seed(0), T(imgs), 0.7)
    assert own.shape == want.shape and 0 <= float(own.min()) <= \
        float(own.max()) <= 1
    # the cardiac recipe is the rotating one of the JAX package
    cardiac = augment.contrastive_pipeline(32, "cardiac")
    jcardiac = jaug.contrastive_pipeline(32, "cardiac")
    assert (cardiac.rotate_limit, cardiac.crop_scale, cardiac.jitter,
            cardiac.scale_255) == (jcardiac.rotate_limit, jcardiac.crop_scale,
                                   jcardiac.jitter, jcardiac.scale_255) \
        == (45.0, (0.2, 1.0), (0.5, 0.5, 0.5, 0.0), False)
