"""The port's ``bn_stats`` kernel and its BatchNorm module.

This file imports neither JAX nor the JAX package, so its card test also
runs where only PyTorch is installed:
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
The JAX-side parity of the BN statistics is in
``tests/test_torch_batch_norm.py``.
"""

import numpy as np
import pytest
import torch

from stil_tta_torch.ops.batch_norm import (THREADS, BatchNorm2d, bn_stats,
                                           bn_stats_plain, launch_config)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs under several xdist
    workers. Restored afterwards, so other files' tests keep theirs."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# Every distinct (M, C) that ResNet-50's 53 BatchNorms see at batch 512
# and 128x128 images, plus a tail batch of 300 samples at the stem and the
# last stage (the BN-adapt pass keeps the tail batch's natural size).
RESNET50_SHAPES = [
    (2_097_152, 64), (524_288, 64), (524_288, 256), (524_288, 128),
    (131_072, 128), (131_072, 512), (131_072, 256), (32_768, 256),
    (32_768, 1024), (32_768, 512), (8_192, 512), (8_192, 2048),
]
TAIL_SHAPES = [(300 * 4096, 64), (300 * 16, 2048)]


@pytest.mark.parametrize("m,c", RESNET50_SHAPES + TAIL_SHAPES
                         + [(7, 3), (1, 2048), (1000, 24)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_launch_config_covers_every_row_and_channel(m, c, itemsize):
    cfg = launch_config(m, c, itemsize, aligned=True)
    assert cfg.chunks * cfg.rows_per_chunk >= m
    assert (cfg.chunks - 1) * cfg.rows_per_chunk < m
    assert cfg.threads_c in (1, 2, 4, 8, 16, 32)
    assert THREADS % cfg.threads_c == 0
    assert c % cfg.vec == 0 and cfg.vec in (1, 16 // itemsize)
    # the channel tiles cover all of C
    tile_c = cfg.threads_c * cfg.vec
    assert -(-c // tile_c) * tile_c >= c
    # an unaligned base pointer falls back to scalar loads
    assert launch_config(m, c, itemsize, aligned=False).vec == 1


def test_plain_stats_match_numpy():
    # float64 sums of float32 data: exact to float32 rounding of the
    # numpy reference (rtol 1e-5)
    x = np.random.RandomState(0).randn(1000, 24).astype(np.float32)
    s, ss = bn_stats(torch.from_numpy(x))
    assert s.shape == ss.shape == (1, 24) and s.dtype == torch.float32
    np.testing.assert_allclose(s.numpy()[0], x.sum(0, dtype=np.float64),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ss.numpy()[0],
                               (x.astype(np.float64) ** 2).sum(0),
                               rtol=1e-5)


def test_batchnorm2d_matches_torch_batchnorm_in_float64():
    # same math as torch.nn.BatchNorm2d (biased variance to normalise,
    # unbiased into the running variance); float64 leaves only rounding
    # at 1e-12
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(4, 8, 5, 5)).to(
        memory_format=torch.channels_last)
    ours = BatchNorm2d(8).double()
    ref = torch.nn.BatchNorm2d(8).double()
    weight, bias = rng.rand(8) + 0.5, rng.randn(8)
    with torch.no_grad():
        for m in (ours, ref):
            m.weight.copy_(torch.from_numpy(weight))
            m.bias.copy_(torch.from_numpy(bias))
        ref.running_mean.copy_(ours.running_mean)
        ref.running_var.copy_(ours.running_var)
    for mode in (True, False):
        ours.train(mode)
        ref.train(mode)
        y, yr = ours(x), ref(x)
        np.testing.assert_allclose(y.detach().numpy(), yr.detach().numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(ours.running_mean.numpy(),
                                   ref.running_mean.numpy(), rtol=1e-12)
        np.testing.assert_allclose(ours.running_var.numpy(),
                                   ref.running_var.numpy(), rtol=1e-12)


def _rel_err(got, want, scale):
    return float(((got - want).abs() / scale.clamp_min(1e-30)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_on_card(dtype):
    """The kernel against its plain version at every ResNet-50 BN shape.
    Tolerance: 1e-5 of sum|x| (sum|x|^2 for the squares). Both sum the
    same float32 values in different orders; the worst case for the
    kernel's ~250-deep summation tree is ~250 float32 roundings (1.5e-5)
    and the typical error is far smaller."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, c in RESNET50_SHAPES + TAIL_SHAPES + [(7, 3), (1000, 24)]:
        x = (torch.randn(m, c, generator=gen, device="cuda") + 0.5).to(dtype)
        before = bn_stats.launches
        s, ss = bn_stats(x)
        s2, ss2 = bn_stats(x)
        torch.cuda.synchronize()
        assert bn_stats.launches == before + 2
        assert s.dtype == ss.dtype == torch.float32
        assert s.shape == ss.shape == (1, c)
        # two launches on the same input are bitwise equal
        assert torch.equal(s, s2) and torch.equal(ss, ss2)
        ps, pss = bn_stats_plain(x)
        xf = x.float()
        assert _rel_err(s, ps, xf.abs().sum(0, keepdim=True)) < 1e-5, (m, c)
        assert _rel_err(ss, pss, pss) < 1e-5, (m, c)
    # a strided view is refused, not silently copied
    with pytest.raises(ValueError):
        bn_stats(torch.zeros(64, 32, device="cuda", dtype=dtype)[:, ::2])
