"""The port's conv-chain kernels (``stil_tta_torch/ops/conv_chain.py``) and
the probe's helpers (``stil_tta_torch/tools/bench_conv_probe.py``).

This file imports neither JAX nor the JAX package, so its card test also
runs where only PyTorch is installed:
``python -m pytest --noconftest -m gpu tests/test_torch_conv_chain.py``.
The plain versions' parity with the Pallas bodies is in
``tests/test_torch_conv_probe.py``.
"""

import pytest
import torch

from stil_tta_torch.ops.conv_chain import (SMEM_LIMIT, _plan, conv_bwd_join,
                                           conv_chain, conv_chain_scratch)
from stil_tta_torch.tools import bench_conv_probe as probe


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs under several xdist
    workers. Restored afterwards, so other files' tests keep theirs."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_bounds_at_the_probe_shape():
    """Bytes bound both at the H100's 3.35 TB/s: the chain reads raw
    (268.4 MB) and writes y (67.1 MB); the join reads dy_up, dy_res and
    x_raw and writes dy (872.4 MB). The products' 17.18 GFLOP take
    0.0174 ms at 989 TFLOP/s."""
    ms, by = probe.chain_bound(probe.M)
    assert by == "bytes" and ms == pytest.approx(0.1002, abs=5e-5)
    ms, by = probe.join_bound(probe.M)
    assert by == "bytes" and ms == pytest.approx(0.2604, abs=5e-5)
    assert 2 * probe.M * probe.K * probe.N / probe.BF16_FLOPS * 1e3 \
        == pytest.approx(0.0174, abs=5e-5)


def test_mismatch_counts_ulps_and_floors_small_values():
    a = torch.tensor([1.0, 2.0, 1e-6, 100.0]).to(torch.bfloat16)
    b = a.clone()
    assert probe.bf16_mismatch(a, b) == (0.0, 0.0)
    b[0] = torch.tensor(1.0078125)        # the next bf16 after 1.0
    b[2] = torch.tensor(3e-6)             # far below 2^-10 of 100
    share, ulps = probe.bf16_mismatch(b, a)
    assert share == 0.5 and ulps == pytest.approx(1.0)


def test_eager_variants_agree_with_plain_on_cpu():
    """The probe's unfused eager chain and join (a bf16 product where the
    plain versions take float32) agree with the plain versions to bf16
    rounding."""
    inputs = probe.make_inputs("cpu", m=256)
    want = conv_chain(*inputs)
    got = probe.eager_chain(*inputs)
    assert float((got[0].float() - want[0].float()).abs().max()) < 0.05
    join_in = probe.make_join_inputs("cpu", m=256)
    want = conv_bwd_join(*join_in)
    got = probe.eager_bwd_join(*join_in)
    assert float((got[0].float() - want[0].float()).abs().max()) < 0.05


# (K, N) of the chain and (N, NJ) of the join that the card test runs: the
# probe's, the reverse, narrow widths below one 64-column box, and the
# widest product that _plan accepts (K x N = 49,152; the join's 32,768)
CHAIN_WIDTHS = ((256, 64), (64, 256), (48, 16), (192, 256))
JOIN_WIDTHS = ((64, 256), (256, 64), (16, 48), (128, 256))
TILES = 132 * 64            # rows of one 64-row tile on each H100 SM


def test_plan_takes_the_card_widths_and_refuses_the_rest():
    """The shared-memory plan accepts every width the card test runs, puts
    the probe's shapes in 227 KB with at least two stages (four for the
    chain), and refuses a weight past the ceiling, an output wider than
    256 and widths that are not multiples of 16."""
    for k, n in CHAIN_WIDTHS:
        plan = _plan(k, n)
        assert 2 <= plan["stages"] <= 4 and plan["smem"] <= SMEM_LIMIT
    for n, nj in JOIN_WIDTHS:
        plan = _plan(n, nj, join=True)
        assert 2 <= plan["stages"] <= 4 and plan["smem"] <= SMEM_LIMIT
    chain = _plan(probe.K, probe.N)
    join = _plan(probe.N, probe.NJ, join=True)
    assert chain["stages"] == 4 and join["stages"] == 2
    assert max(chain["smem"], join["smem"]) <= 232_448
    assert chain["weight_bytes"] == 2 * probe.K * probe.N
    for k, n, join_ in ((256, 256, False), (192 + 64, 256, False),
                        (512 + 64, 64, False), (192, 256, True),
                        (128 + 64, 256, True)):
        with pytest.raises(ValueError, match="no room"):
            _plan(k, n, join=join_)
    with pytest.raises(ValueError, match="above 256"):
        _plan(64, 320)
    for k, n in ((40, 64), (64, 24), (0, 64)):
        with pytest.raises(ValueError, match="multiple of 16"):
            _plan(k, n)
        with pytest.raises(ValueError, match="multiple of 16"):
            _plan(k, n, join=True)


@pytest.mark.gpu
def test_conv_chain_kernels_match_plain_on_card():
    """Each kernel against its plain version, with the probe's gate
    (``bench_conv_probe.passes``), at M around one tile (63, 64, 65),
    around one tile on each SM, with four tiles a block and a ragged
    edge, with twenty tiles a block (more than the ring's stages), at a
    ragged M and one row, and at every width of ``CHAIN_WIDTHS`` and
    ``JOIN_WIDTHS``; two launches bitwise equal; refusals of what the
    kernels do not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows = (63, 64, 65, TILES - 1, TILES, TILES + 1, 4 * TILES + 29,
            20 * TILES, 4096, 1000 + 13, 1)
    cases = [(m, *CHAIN_WIDTHS[0], *JOIN_WIDTHS[0]) for m in rows]
    cases += [(777 + 64 * i, *c, *j)
              for i, (c, j) in enumerate(zip(CHAIN_WIDTHS[1:],
                                             JOIN_WIDTHS[1:]))]
    for m, k, n, n_up, nj in cases:
        inputs = probe.make_inputs("cuda", m=m, k=k, n=n)
        for name in ("conv_chain", "conv_chain_scratch"):
            fn = probe.KERNELS[name][0]
            before = fn.launches
            check = probe.check_kernel(name, inputs)
            assert fn.launches == before + 2
            assert probe.passes(check), (name, m, k, n, check)
        join_in = probe.make_join_inputs("cuda", m=m, n=n_up, nj=nj)
        before = conv_bwd_join.launches
        check = probe.check_kernel("conv_bwd_join", join_in)
        assert conv_bwd_join.launches == before + 2
        assert probe.passes(check), ("conv_bwd_join", m, n_up, nj, check)
    raw, w, a, b = probe.make_inputs("cuda", m=64)
    with pytest.raises(ValueError):     # K not a multiple of 16
        conv_chain(raw[:, :40].contiguous(), w[:40], a[:40], b[:40])
    with pytest.raises(ValueError):     # a strided view
        conv_chain_scratch(raw[:, ::2], w[::2], a[::2], b[::2])
    with pytest.raises(ValueError):     # float32 weights
        conv_chain(raw, w.float(), a, b)
    big = probe.make_inputs("cuda", m=64, k=256, n=256)
    with pytest.raises(ValueError):     # a weight past the ceiling
        conv_chain(*big)
