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

from stil_tta_torch.ops.batch_norm import (SMEM_FIXED, SMEM_LIMIT,
                                           STAGE_BYTES, STAGE_ROWS, THREADS,
                                           BatchNorm2d, bn_stats,
                                           bn_stats_plain, bn_stats_plan,
                                           launch_config, stats_plan)


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


def _coverage(plan, m, c):
    """How often the plan's items read each (row, column): the blocks
    b = 0..grid-1 take items b, b + grid, ...; item i is column tile
    i % tiles and row chunk i // tiles, and on the ring path the chunk's
    rows go in stages of stage_rows."""
    counts = np.zeros((plan.tiles, m + 1), np.int64)  # row counts per tile
    items = plan.tiles * plan.chunks
    taken = sorted(i for b in range(plan.grid)
                   for i in range(b, items, plan.grid))
    assert taken == list(range(items))  # every item once
    for i in taken:
        tile, chunk = i % plan.tiles, i // plan.tiles
        r0 = chunk * plan.rows_per_chunk
        r1 = min(m, r0 + plan.rows_per_chunk)
        assert r1 > r0  # no empty chunk
        if plan.vec > 1:
            n = -(-(r1 - r0) // plan.stage_rows)
            stage_rows = [min(plan.stage_rows, r1 - r0 - j * plan.stage_rows)
                          for j in range(n)]
            assert sum(stage_rows) == r1 - r0 and min(stage_rows) > 0
        counts[tile, r0] += 1
        counts[tile, r1] -= 1
    rows = np.cumsum(counts, axis=1)[:, :m]
    cols = np.zeros(c, np.int64)
    for tile in range(plan.tiles):
        col0 = tile * plan.tile_c
        cols[col0:min(c, col0 + plan.tile_c)] += 1
    return rows, cols


@pytest.mark.parametrize("m,c", RESNET50_SHAPES + TAIL_SHAPES
                         + [(7, 3), (1, 2048), (1000, 24), (1, 64),
                            (300, 264), (5000, 5000)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_stats_plan_covers_every_row_and_channel_once(m, c, itemsize):
    sms = 132
    for aligned, per_sm in ((True, 1), (False, 8)):
        plan = stats_plan(m, c, itemsize, aligned, sms, per_sm)
        rows, cols = _coverage(plan, m, c)
        assert (rows == 1).all() and (cols == 1).all()
        assert plan.grid <= sms * per_sm
        assert plan.smem <= SMEM_LIMIT
        assert plan.chunks * 2 * c * 4 <= 2**20  # partial rows <= 1 MB
        assert plan.tile_c % plan.vec == 0 and plan.tile_c <= 256
        assert plan.tile_c // plan.vec <= THREADS  # threads across a row
        assert THREADS % plan.combine_cols == 0
        assert plan.combine_cols & (plan.combine_cols - 1) == 0
        # the smem scratch of the block's row-lane sums fits
        assert plan.smem >= SMEM_FIXED + 2 * THREADS * plan.vec * 4
        if plan.vec > 1:
            assert (c * itemsize) % 16 == 0 and plan.vec == 16 // itemsize
            assert plan.stage_bytes % 16 == 0 and plan.stage_pitch % 128 == 0
            assert plan.stage_rows * plan.tile_c * itemsize == plan.stage_bytes
            assert plan.stage_bytes <= STAGE_BYTES
            assert 1 <= plan.stage_rows <= STAGE_ROWS  # a TMA box's rows
            assert plan.smem >= SMEM_FIXED + plan.stages * plan.stage_pitch
        # an unaligned base reads x directly
        if not aligned:
            assert plan.vec == 1 and plan.stages == 0
    # the shared memory does not depend on the grid
    assert (stats_plan(m, c, itemsize, True, 1, 1).smem
            == stats_plan(m, c, itemsize, True, sms, 1).smem)


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


def _check_on_card(x, twice=True):
    """bn_stats of x against the plain sums; two launches bitwise equal.
    Returns the kernel's sums."""
    c = x.shape[1]
    before = bn_stats.launches
    s, ss = bn_stats(x)
    if twice:
        s2, ss2 = bn_stats(x)
    torch.cuda.synchronize()
    assert bn_stats.launches == before + 1 + twice  # one count a call
    assert s.dtype == ss.dtype == torch.float32
    assert s.shape == ss.shape == (1, c)
    if twice:  # two launches on the same input are bitwise equal
        assert torch.equal(s, s2) and torch.equal(ss, ss2)
    ps, pss = bn_stats_plain(x)
    xf = x.float()
    assert _rel_err(s, ps, xf.abs().sum(0, keepdim=True)) < 1e-5, x.shape
    assert _rel_err(ss, pss, pss) < 1e-5, x.shape
    return s, ss


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_on_card(dtype):
    """The kernel against its plain version at every ResNet-50 BN shape,
    at M below, at and just past one ring stage and M = 1, on a view
    whose base is one element off 16-byte alignment (the direct-load
    variant), and on two streams at once. Tolerance: 1e-5 of sum|x|
    (sum|x|^2 for the squares). Both sum the same float32 values in
    different orders: each rounding is at most 2^-24 of a partial sum no
    larger than the column's sum|x|, a value passes through at most about
    550 of them (a thread's rows, the block's row lanes, the combine's
    tree), and roundings of random sign on partial sums mostly far below
    the total keep the typical error far smaller."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    itemsize = torch.empty((), dtype=dtype).element_size()
    shapes = RESNET50_SHAPES + TAIL_SHAPES + [(7, 3), (1000, 24)]
    for c in (64, 2048):
        rows = stats_plan(1, c, itemsize, True, 1, 1).stage_rows
        shapes += [(1, c), (rows - 1, c), (rows, c), (rows + 1, c)]
    for m, c in shapes:
        x = (torch.randn(m, c, generator=gen, device="cuda") + 0.5).to(dtype)
        assert bn_stats_plan(x).vec == 16 // itemsize or c == 3
        _check_on_card(x)
    # a contiguous view one element (2 or 4 bytes) off 16-byte alignment
    for m, c in ((32_768, 256), (1000, 24)):
        flat = (torch.randn(m * c + 1, generator=gen, device="cuda")
                + 0.5).to(dtype)
        x = flat[1:].view(m, c)
        assert x.is_contiguous() and x.data_ptr() % 16 == itemsize
        assert bn_stats_plan(x).vec == 1
        _check_on_card(x)
    # two streams at once give what each gives alone
    xs = [(torch.randn(m, c, generator=gen, device="cuda") + 0.5).to(dtype)
          for m, c in ((131_072, 256), (8_192, 2048))]
    alone = [_check_on_card(x, twice=False) for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    outs = []
    for _ in range(2):
        for x, st in zip(xs, streams):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                outs.append(bn_stats(x))
        torch.cuda.synchronize()
    for i, (s, ss) in enumerate(outs):
        assert torch.equal(s, alone[i % 2][0])
        assert torch.equal(ss, alone[i % 2][1])
    # a strided view is refused, not silently copied
    with pytest.raises(ValueError):
        bn_stats(torch.zeros(64, 32, device="cuda", dtype=dtype)[:, ::2])
