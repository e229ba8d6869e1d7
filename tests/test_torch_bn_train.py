"""Train-mode BatchNorm of the port: the plain ``bn_bwd_reduce`` against
the Pallas ``bn_bwd_reduce`` (interpret mode, as ``tests/test_batch_norm.py``
runs it), the ``BNTrain`` autograd Function's gradients against JAX's
(``jax.grad`` through ``TorchBatchNorm``, and ``TPUBatchNorm``'s custom
VJP), ``gradcheck``, and the kernel against its plain version on the card.

JAX is imported inside the CPU tests, so the card test also runs where only
PyTorch is installed:
``python -m pytest --noconftest -m gpu tests/test_torch_bn_train.py``."""

import numpy as np
import pytest
import torch

from stil_tta_torch.ops.batch_norm import (BatchNorm2d, BNTrain,
                                           bn_bwd_reduce,
                                           bn_bwd_reduce_plain, bn_functions,
                                           bn_stats, bn_stats_plain)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs under several xdist
    workers. Restored afterwards, so other files' tests keep theirs."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(got, want, scale):
    got, want, scale = (np.asarray(t, np.float64) for t in (got, want, scale))
    return float((np.abs(got - want) / np.maximum(scale, 1e-30)).max())


def test_plain_bn_bwd_reduce_matches_pallas_kernel():
    """M = 512 has a large power-of-two factor, so the Pallas kernel takes
    one 512-row tile and interpret mode stays fast. Both sum the same
    float32 products in two orders: 1e-5 of sum|dy| and sum|dy x_hat|."""
    import jax.numpy as jnp
    from stil_tta_tpu.ops.batch_norm import bn_bwd_reduce as jax_bwd
    rng = np.random.RandomState(0)
    x = (rng.randn(512, 48) * 1.5 + 0.4).astype(np.float32)
    dy = rng.randn(512, 48).astype(np.float32)
    mean = x.mean(0).astype(np.float32)
    inv = (1.0 / np.sqrt(x.var(0) + 1e-5)).astype(np.float32)
    sdy, sdyxh = bn_bwd_reduce(*map(torch.from_numpy, (x, dy, mean, inv)))
    js, jsx = jax_bwd(jnp.asarray(x), jnp.asarray(dy),
                      jnp.asarray(mean[None]), jnp.asarray(inv[None]))
    assert sdy.shape == sdyxh.shape == (1, 48)
    assert sdy.dtype == sdyxh.dtype == torch.float32
    xhat = (x - mean) * inv
    assert _rel(sdy, js, np.abs(dy).sum(0)) < 1e-5
    assert _rel(sdyxh, jsx, np.abs(dy * xhat).sum(0)) < 1e-5


def _inputs(seed, c, dtype):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 6, 6, c) * 2.0 + 0.7).astype(dtype)   # NHWC
    g = rng.randn(4, 6, 6, c).astype(dtype)                 # cotangent
    weight = (rng.rand(c) + 0.5).astype(dtype)
    bias = rng.randn(c).astype(dtype)
    return x, g, weight, bias


def _port_grads(x, g, weight, bias, dtype):
    """dx (NHWC), dweight, dbias of sum(BatchNorm2d(x) * g), train mode,
    input in channels_last."""
    bn = BatchNorm2d(weight.shape[0]).to(dtype).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    (bn(xt) * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    return (xt.grad.permute(0, 2, 3, 1).numpy(), bn.weight.grad.numpy(),
            bn.bias.grad.numpy())


def _jax_grads(module, x, g, weight, bias):
    import jax
    import jax.numpy as jnp

    def loss(x, params):
        y, _ = module.apply({"params": params,
                             "batch_stats": {"mean": jnp.zeros_like(bias),
                                             "var": jnp.ones_like(bias)}},
                            x, mutable=["batch_stats"])
        return jnp.sum(y * g)
    dx, dp = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x), {"scale": jnp.asarray(weight),
                         "bias": jnp.asarray(bias)})
    return np.asarray(dx), np.asarray(dp["scale"]), np.asarray(dp["bias"])


def test_gradients_match_torch_batchnorm_float64():
    """Against ``jax.grad`` through the JAX default BN at float64: the
    port's closed-form backward is the exact derivative of the same
    forward, so only float64 rounding separates them (rtol 1e-9)."""
    import jax.numpy as jnp
    from stil_tta_tpu.models.resnet import TorchBatchNorm
    from tests.torch_parity import x64
    x, g, weight, bias = _inputs(1, 8, np.float64)
    with x64():
        want = _jax_grads(TorchBatchNorm(use_running_average=False,
                                         dtype=jnp.float64),
                          x, g, weight, bias)
    got = _port_grads(x, g, weight, bias, torch.float64)
    for a, b, what in zip(got, want, ("dx", "dweight", "dbias")):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-10, err_msg=what)


def test_gradients_match_tpu_batchnorm_custom_vjp_float32():
    """Against ``TPUBatchNorm``, whose custom VJP is the one the port
    follows (Pallas ``bn_bwd_reduce`` in interpret mode), at float32. The
    two orders of float32 sums over 144 rows and the port's a*dy + b*x + c
    rearrangement of dx differ by float32 rounding: 1e-4 of each
    gradient's largest magnitude."""
    import jax.numpy as jnp
    from stil_tta_tpu.ops.batch_norm import TPUBatchNorm
    x, g, weight, bias = _inputs(2, 16, np.float32)
    want = _jax_grads(TPUBatchNorm(use_running_average=False,
                                   dtype=jnp.float32), x, g, weight, bias)
    got = _port_grads(x, g, weight, bias, torch.float32)
    for a, b, what in zip(got, want, ("dx", "dweight", "dbias")):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max(), err_msg=what)


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_bn_train_function_gradcheck_float64(layout):
    """Finite differences at float64 against the Function's backward, for
    input and parameters, with a channels_last input and a plain NCHW one
    (whose gradient arrives in another layout and is copied)."""
    rng = np.random.RandomState(3)
    fmt = {"channels_last": torch.channels_last,
           "contiguous": torch.contiguous_format}[layout]
    x = torch.from_numpy(rng.randn(3, 5, 4, 3) + 0.3).contiguous(
        memory_format=fmt).requires_grad_()
    w = torch.from_numpy(rng.rand(5) + 0.5).requires_grad_()
    b = torch.from_numpy(rng.randn(5)).requires_grad_()
    fn = lambda x, w, b: BNTrain.apply(  # noqa: E731
        x, w, b, 1e-5, bn_stats, bn_bwd_reduce)[0]
    assert torch.autograd.gradcheck(fn, (x, w, b), eps=1e-6, atol=1e-7)


def test_bn_functions_swaps_and_restores():
    bn = torch.nn.Sequential(BatchNorm2d(4), BatchNorm2d(4))
    with bn_functions(bn, bn_stats_plain, bn_bwd_reduce_plain):
        assert all(m.stats is bn_stats_plain
                   and m.bwd_reduce is bn_bwd_reduce_plain for m in bn)
    assert all(m.stats is bn_stats and m.bwd_reduce is bn_bwd_reduce
               for m in bn)


def test_wrapper_refuses_a_device_it_has_no_kernel_for():
    """Only a CPU tensor takes the plain version; any other device runs
    the kernel or raises."""
    x = torch.empty(8, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        bn_bwd_reduce(x, x, torch.empty(4, device="meta"),
                      torch.empty(4, device="meta"))


# Every distinct (M, C) of ResNet-50's 53 BatchNorms at batch 512 and
# 128x128, a tail batch at the stem and the last stage, and odd shapes.
RESNET50_SHAPES = [
    (2_097_152, 64), (524_288, 64), (524_288, 256), (524_288, 128),
    (131_072, 128), (131_072, 512), (131_072, 256), (32_768, 256),
    (32_768, 1024), (32_768, 512), (8_192, 512), (8_192, 2048),
]
ODD_SHAPES = [(300 * 4096, 64), (300 * 16, 2048), (7, 3), (1000, 24)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_kernel_matches_plain_on_card(dtype):
    """The kernel against its plain version. Tolerance: 1e-5 of sum|dy|
    and of sum|dy x_hat|: both sum the same float32 values in different
    orders (about 250 roundings deep at worst)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, c in RESNET50_SHAPES + ODD_SHAPES:
        x = (torch.randn(m, c, generator=gen, device="cuda") + 0.5).to(dtype)
        dy = torch.randn(m, c, generator=gen, device="cuda").to(dtype)
        mean = torch.rand(c, generator=gen, device="cuda")
        inv = torch.rand(c, generator=gen, device="cuda") + 0.5
        before = bn_bwd_reduce.launches
        s, q = bn_bwd_reduce(x, dy, mean, inv)
        s2, q2 = bn_bwd_reduce(x, dy, mean, inv)
        torch.cuda.synchronize()
        assert bn_bwd_reduce.launches == before + 2
        assert s.shape == q.shape == (1, c) and s.dtype == torch.float32
        assert torch.equal(s, s2) and torch.equal(q, q2)
        ps, pq = bn_bwd_reduce_plain(x, dy, mean, inv)
        dyf = dy.float()
        xhat = (x.float() - mean) * inv
        assert _rel(s.cpu(), ps.cpu(), dyf.abs().sum(0).cpu()) < 1e-5, (m, c)
        assert _rel(q.cpu(), pq.cpu(),
                    (dyf * xhat).abs().sum(0).cpu()) < 1e-5, (m, c)
        del x, dy
    x = torch.zeros(64, 32, device="cuda", dtype=dtype)
    mean = torch.zeros(32, device="cuda")
    with pytest.raises(ValueError):           # a strided view
        bn_bwd_reduce(x[:, ::2], x[:, ::2], mean[::2], mean[::2])
    with pytest.raises(ValueError):           # x and dy of two dtypes
        bn_bwd_reduce(x, x.double(), mean, mean)
    with pytest.raises(ValueError):           # mean of the wrong length
        bn_bwd_reduce(x, x, mean[:8], mean)


@pytest.mark.gpu
def test_bn_train_kernels_match_plain_function_on_card():
    """A train-mode BatchNorm forward and backward in bf16 with the two
    kernels against the same with the plain functions: the outputs and
    dx agree to a bf16 rounding step (the statistics differ by float32
    summation order), dweight and dbias to 1e-4 of their scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(64, 64, 32, 32, generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    g = torch.randn(x.shape, generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    outs = []
    for fns in ((bn_stats, bn_bwd_reduce),
                (bn_stats_plain, bn_bwd_reduce_plain)):
        bn = BatchNorm2d(64).cuda().train()
        xi = x.clone().requires_grad_()
        with bn_functions(bn, *fns):
            y = bn(xi)
            y.backward(g)
        outs.append((y.detach().float(), xi.grad.float(), bn.weight.grad,
                     bn.bias.grad))
    for a, b in zip(*outs):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2 ** -7 * scale + 1e-4 * scale
