"""The port's Tent and EATA (with and without the Fisher anchor) against
the JAX package's, and the parameters TTA adapts against the JAX mask.
Set-up, tolerances and why: ``tests/torch_tta_parity.py``; SAR is in
``tests/test_torch_tta_sar.py``."""

import pytest

from stil_tta_torch.tta.tent import bn_parameters
from stil_tta_torch.train.convert import export_state_dict
from stil_tta_tpu.tta.tent import bn_param_mask
from tests.torch_parity import one_torch_thread  # noqa: F401
from tests.torch_tta_parity import _port, check_case, make_reference


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return make_reference(tmp_path_factory.mktemp("tta"))


def test_bn_parameters_match_jax_mask(reference):
    """The port adapts as many tensors, of the same shapes, as the JAX
    mask selects: every BN scale and bias, nothing else."""
    params = reference["variables"]["params"]
    mask = export_state_dict(bn_param_mask(params))
    want = {k for k, m in mask.items() if m}
    _, algo, _ = _port("tent")
    got = dict(bn_parameters(algo.net))
    assert set(got) == want and len(want) == 2 * 20   # resnet18: 20 BNs
    shapes = export_state_dict(params)
    for k, p in got.items():
        assert tuple(p.shape) == shapes[k].shape, k


@pytest.mark.parametrize("case", ["tent", "eata", "eata_fisher"])
def test_strategy_matches_jax(reference, case):
    check_case(reference, case)


def test_bn_affine_gradients_reduce_in_float32_then_round_to_bf16():
    """On the card the net computes in bfloat16, and eval-mode BN casts
    its float32 weight and bias to the activation dtype, in the port as
    in the JAX package's ``TorchBatchNorm``: on both sides the affine
    gradients come out as one bfloat16 value per channel, cast back to
    float32. The port does not reduce in bf16 where JAX does not: it sums
    the bf16 terms in float32 and rounds once (torch's reduction). JAX
    on XLA:CPU accumulates the sum itself in bf16, rounding at every add,
    so here it lands up to a few percent away, within the bound of a
    bf16 running sum."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from stil_tta_torch.ops.batch_norm import BatchNorm2d
    from stil_tta_tpu.models.resnet import TorchBatchNorm

    rng = np.random.RandomState(3)
    n, c = 4 * 6 * 6, 16
    x = rng.randn(4, 6, 6, c).astype(np.float32)        # NHWC
    dy = rng.randn(4, 6, 6, c).astype(np.float32)
    w, b = rng.rand(c) + 0.5, rng.randn(c)
    mean, var = rng.randn(c) * 0.1, rng.rand(c) + 0.5
    bf = jnp.bfloat16
    mod = TorchBatchNorm(use_running_average=True, dtype=bf)
    stats = {"mean": jnp.asarray(mean, jnp.float32),
             "var": jnp.asarray(var, jnp.float32)}

    def f(params):
        y = mod.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x, bf))
        return jnp.sum(y.astype(jnp.float32) * dy)

    jg = jax.grad(f)({"scale": jnp.asarray(w, jnp.float32),
                      "bias": jnp.asarray(b, jnp.float32)})
    bn = BatchNorm2d(c).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    dyb = torch.from_numpy(dy).to(torch.bfloat16)
    y = bn(xb.permute(0, 3, 1, 2))
    y.backward(dyb.permute(0, 3, 1, 2))
    # the same chain by hand: bf16 terms, a float32 sum rounded once
    r = torch.rsqrt(torch.from_numpy(var).to(torch.bfloat16) + 1e-5)
    t = dyb * (xb - torch.from_numpy(mean).to(torch.bfloat16))
    terms = {"weight": t.reshape(n, c), "bias": dyb.reshape(n, c)}
    for name, jname in (("weight", "scale"), ("bias", "bias")):
        got = getattr(bn, name).grad
        s = terms[name].float().sum(0).to(torch.bfloat16)
        want = (s * r if name == "weight" else s).float()
        assert got.dtype == torch.float32
        assert torch.equal(got, want), name
        jax_g = torch.from_numpy(np.array(jg[jname]))
        assert torch.equal(jax_g, jax_g.to(torch.bfloat16).float())
        scale = terms[name].float().abs().sum(0) * (
            r.float() if name == "weight" else 1.0)
        assert bool(((jax_g - got).abs() <= n * 2 ** -8 * scale).all())
