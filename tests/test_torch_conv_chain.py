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

from stil_tta_torch.ops.conv_chain import (conv_bwd_join, conv_chain,
                                           conv_chain_scratch)
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


@pytest.mark.gpu
def test_conv_chain_kernels_match_plain_on_card():
    """Each kernel against its plain version, with the probe's gate
    (``bench_conv_probe.passes``), at a multiple of the 64-row tile, a
    ragged M, one row, and at other widths; two launches bitwise equal;
    refusals of what the kernels do not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for m, k, n in ((4096, 256, 64), (1000 + 13, 256, 64), (1, 256, 64),
                    (777, 64, 256), (300, 48, 16)):
        inputs = probe.make_inputs("cuda", m=m, k=k, n=n)
        for name in ("conv_chain", "conv_chain_scratch"):
            fn = probe.KERNELS[name][0]
            before = fn.launches
            check = probe.check_kernel(name, inputs)
            assert fn.launches == before + 2
            assert probe.passes(check), (name, m, k, n, check)
        join_in = probe.make_join_inputs("cuda", m=m, n=n, nj=k)
        before = conv_bwd_join.launches
        check = probe.check_kernel("conv_bwd_join", join_in)
        assert conv_bwd_join.launches == before + 2
        assert probe.passes(check), ("conv_bwd_join", m, k, n, check)
    raw, w, a, b = probe.make_inputs("cuda", m=64)
    with pytest.raises(ValueError):     # K not a multiple of 16
        conv_chain(raw[:, :40].contiguous(), w[:40], a[:40], b[:40])
    with pytest.raises(ValueError):     # a strided view
        conv_chain_scratch(raw[:, ::2], w[::2], a[::2], b[::2])
    with pytest.raises(ValueError):     # float32 weights
        conv_chain(raw, w.float(), a, b)
