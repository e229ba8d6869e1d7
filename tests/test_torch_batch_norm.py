"""The port's BatchNorm statistics against the JAX package: the plain
``bn_stats`` against the Pallas ``bn_stats`` (interpret mode, as
``tests/test_batch_norm.py`` runs it), and the port's ``BatchNorm2d`` in
train and eval mode against both JAX BN paths, ``TorchBatchNorm`` (the
default, which the port follows) and ``TPUBatchNorm``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch.ops.batch_norm import BatchNorm2d, bn_stats
from stil_tta_tpu.models.resnet import TorchBatchNorm
from stil_tta_tpu.ops.batch_norm import TPUBatchNorm
from stil_tta_tpu.ops.batch_norm import bn_stats as jax_bn_stats
from tests.torch_parity import as_torch, assert_close, x64
from tests.torch_parity import one_torch_thread  # noqa: F401


def test_plain_bn_stats_matches_pallas_kernel():
    # M = 512 has a large power-of-two factor, so _pick_tile takes one
    # 512-row tile and interpret mode stays fast. float32 sums of the same
    # values in two orders: rtol 1e-5 of the sum's magnitude.
    x = np.random.RandomState(0).randn(512, 48).astype(np.float32) + 0.3
    s, ss = bn_stats(torch.from_numpy(x))
    js, jss = jax_bn_stats(jnp.asarray(x))
    assert s.shape == ss.shape == (1, 48) and s.dtype == torch.float32
    scale = np.abs(x).sum(0)
    assert np.abs(s.numpy()[0] - np.asarray(js)[0]).max() \
        < 1e-5 * scale.max()
    assert_close(ss, np.asarray(jss), rtol=1e-5, atol=0)


def _port_bn(weight, bias, mean, var, dtype):
    bn = BatchNorm2d(weight.shape[0]).to(dtype)
    with torch.no_grad():
        bn.weight.copy_(as_torch(weight))
        bn.bias.copy_(as_torch(bias))
        bn.running_mean.copy_(as_torch(mean))
        bn.running_var.copy_(as_torch(var))
    return bn


def _inputs(seed, c=8, dtype=np.float64):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 6, 6, c) * 2.0 + 0.7).astype(dtype)   # NHWC
    weight = (rng.rand(c) + 0.5).astype(dtype)
    bias = rng.randn(c).astype(dtype)
    mean = (rng.randn(c) * 0.1).astype(dtype)
    var = (rng.rand(c) + 0.5).astype(dtype)
    return x, weight, bias, mean, var


def _nchw(x):
    return as_torch(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_torch_batchnorm_float64(train):
    """Against the JAX default BN at float64: the same formulas, so only
    float64 rounding separates them (rtol 1e-10)."""
    x, weight, bias, mean, var = _inputs(1)
    variables = {"params": {"scale": weight, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    with x64():
        jbn = TorchBatchNorm(use_running_average=not train,
                             dtype=jnp.float64)
        if train:
            y, mut = jbn.apply(variables, jnp.asarray(x),
                               mutable=["batch_stats"])
            stats = mut["batch_stats"]
        else:
            y, stats = jbn.apply(variables, jnp.asarray(x)), \
                variables["batch_stats"]
    bn = _port_bn(weight, bias, mean, var, torch.float64).train(train)
    out = bn(_nchw(x)).permute(0, 2, 3, 1)
    assert_close(out, np.asarray(y), rtol=1e-10, atol=1e-10)
    assert_close(bn.running_mean, np.asarray(stats["mean"]), 1e-10, 1e-12)
    assert_close(bn.running_var, np.asarray(stats["var"]), 1e-10, 1e-12)


def test_batch_mean_and_var_match_torch_batchnorm_float64():
    """Momentum 1 (decay 0 in JAX) puts the raw batch mean and the
    unbiased batch variance into the running buffers."""
    x, weight, bias, mean, var = _inputs(2)
    variables = {"params": {"scale": weight, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    with x64():
        jbn = TorchBatchNorm(use_running_average=False, momentum=0.0,
                             dtype=jnp.float64)
        _, mut = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = _port_bn(weight, bias, mean, var, torch.float64)
    bn.momentum = 1.0
    bn(_nchw(x))
    flat = x.reshape(-1, 8)
    assert_close(bn.running_mean, flat.mean(0), 1e-12, 1e-12)
    assert_close(bn.running_var, flat.var(0, ddof=1), 1e-12, 1e-12)
    assert_close(bn.running_mean, np.asarray(mut["batch_stats"]["mean"]),
                 1e-10, 1e-12)
    assert_close(bn.running_var, np.asarray(mut["batch_stats"]["var"]),
                 1e-10, 1e-12)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_tpu_batchnorm_float32(train):
    """Against ``TPUBatchNorm`` (Pallas statistics, interpret mode) at
    float32. It differs from the port only in not clamping the variance
    (never negative here) and in normalising in float32, which at
    float32 activations is the same; rtol 2e-5 covers float32 rounding
    of sums over 144 rows."""
    x, weight, bias, mean, var = _inputs(3, c=16, dtype=np.float32)
    variables = {"params": {"scale": weight, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    jbn = TPUBatchNorm(use_running_average=not train, dtype=jnp.float32)
    if train:
        y, mut = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        stats = mut["batch_stats"]
    else:
        y, stats = jbn.apply(variables, jnp.asarray(x)), \
            variables["batch_stats"]
    bn = _port_bn(weight, bias, mean, var, torch.float32).train(train)
    out = bn(_nchw(x)).permute(0, 2, 3, 1)
    assert_close(out, np.asarray(y), rtol=2e-5, atol=2e-5)
    assert_close(bn.running_mean, np.asarray(stats["mean"]), 2e-5, 1e-6)
    assert_close(bn.running_var, np.asarray(stats["var"]), 2e-5, 1e-6)


def test_variance_is_clamped_like_torch_batchnorm():
    """A constant channel has E[x²] − mean² ≈ 0, possibly negative in
    float32; TorchBatchNorm (and the port) clamp it at 0."""
    x = np.full((2, 4, 4, 3), 3.1, np.float32)
    variables = {"params": {"scale": np.ones(3, np.float32),
                            "bias": np.zeros(3, np.float32)},
                 "batch_stats": {"mean": np.zeros(3, np.float32),
                                 "var": np.ones(3, np.float32)}}
    y, _ = TorchBatchNorm(use_running_average=False, dtype=jnp.float32,
                          momentum=0.0).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = _port_bn(*[variables["params"]["scale"],
                    variables["params"]["bias"],
                    variables["batch_stats"]["mean"],
                    variables["batch_stats"]["var"]], torch.float32)
    out = bn(_nchw(x)).permute(0, 2, 3, 1)
    assert torch.isfinite(out).all() and (bn.running_var >= 0).all()
    assert_close(out, np.asarray(y), rtol=0, atol=1e-2)
    assert np.isfinite(np.asarray(y)).all()
