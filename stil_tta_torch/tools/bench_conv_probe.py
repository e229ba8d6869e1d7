"""Microbenchmark of the ResNet bottleneck's 1x1-conv + fused-BN pattern on
the card: the port of ``tools/bench_conv_probe.py``.

    python -m stil_tta_torch.tools.bench_conv_probe

At the hottest shape of ResNet-50's bottlenecks at batch 512 and 128x128
images (layer1 conv1: M = 512*32*32, K = 256, N = 64; the join's NJ =
256) it times, forward:

  gemm                  torch.matmul(raw, w), bf16 (cuBLAS): the conv alone
  conv1x1               F.conv2d on a channels_last (512, 256, 32, 32)
                        input (cuDNN): what the network runs
  xla_chain             the unfused eager chain: BN-apply + ReLU as
                        bf16 ops, torch.matmul, the float32 column sums
  pallas_chain          ops.conv_chain.conv_chain, the hand-written kernel
  pallas_chain_scratch  ops.conv_chain.conv_chain_scratch

and backward:

  xla_bwd_join          the unfused eager join (torch.matmul, add, mask,
                        three column sums)
  pallas_bwd_join       ops.conv_chain.conv_bwd_join

The JAX probe's ``pallas_chain_8k`` is the same kernel at another TPU tile
size and has no counterpart here. Inputs are made with numpy's
``RandomState`` from the JAX probe's seeds, so both probes see the same
values. Before anything is timed, each kernel is held against its plain
version (``*_plain`` in ``ops.conv_chain``, the Pallas body's dtypes step
by step): a wrong kernel must not win the timing. Timing is the JAX
probe's: per call, the slope between 6 and 30 back-to-back calls, each
count the best of 3, here between CUDA events on one stream after a spin
kernel that lets the host queue every call first. The bound is the larger
of the bytes each function must move over the H100's 3.35 TB/s and its
product's operations over 989 TFLOP/s bf16. The last line of output is
one JSON object of every variant's milliseconds.

Nothing runs at import; ``main`` needs a CUDA card.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stil_tta_torch.ops.conv_chain import (conv_bwd_join,
                                           conv_bwd_join_plain, conv_chain,
                                           conv_chain_plain,
                                           conv_chain_scratch,
                                           conv_chain_scratch_plain,
                                           prologue_plain)

N_IMG, H, W = 512, 32, 32
M = N_IMG * H * W            # 524,288
K, N = 256, 64               # layer1 conv1
NJ = 256                     # join channels (layer1 block output)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (data sheet)
BF16_FLOPS = 989e12          # H100 SXM bf16 tensor cores, dense
ULP_SHARE = 1e-3             # at most this share of bf16 outputs may differ
# ... each by at most this many ulps: y rounds once; the join's dy twice
# (dx, then dx + dy_res), and where the first rounding moved dx by an ulp
# onto a tie, rounding the tie to even can move dy by two
ULP_LIMIT = {"conv_chain": 1, "conv_chain_scratch": 1, "conv_bwd_join": 2}
SUM_TOL = 1e-5               # of sum|.|, for the float32 column sums

Tensor = torch.Tensor
BF16 = torch.bfloat16

# kernel name -> (kernel, its plain version)
KERNELS = {
    "conv_chain": (conv_chain, conv_chain_plain),
    "conv_chain_scratch": (conv_chain_scratch, conv_chain_scratch_plain),
    "conv_bwd_join": (conv_bwd_join, conv_bwd_join_plain),
}


def make_inputs(device, seed: int = 0, m: int = M, k: int = K,
                n: int = N) -> Tuple[Tensor, ...]:
    """raw (m, k) bf16, w (k, n) bf16, A and B (k,) float32."""
    rs = np.random.RandomState(seed)
    raw = torch.from_numpy(rs.randn(m, k)).to(BF16)
    w = torch.from_numpy(rs.randn(k, n) * 0.05).to(BF16)
    a = torch.from_numpy(rs.rand(k) + 0.5).float()
    b = torch.from_numpy(rs.randn(k) * 0.1).float()
    return tuple(t.to(device) for t in (raw, w, a, b))


def make_join_inputs(device, seed: int = 1, m: int = M, n: int = N,
                     nj: int = NJ) -> Tuple[Tensor, ...]:
    """dy_up (m, n), w1 (nj, n), dy_res and x_raw (m, nj), all bf16, and
    mu (nj,) float32."""
    rs = np.random.RandomState(seed)
    dy_up = torch.from_numpy(rs.randn(m, n)).to(BF16)
    w1 = torch.from_numpy(rs.randn(nj, n) * 0.05).to(BF16)
    dy_res = torch.from_numpy(rs.randn(m, nj)).to(BF16)
    x_raw = torch.from_numpy(rs.randn(m, nj)).to(BF16)
    mu = torch.from_numpy(rs.randn(nj) * 0.1).float()
    return tuple(t.to(device) for t in (dy_up, w1, dy_res, x_raw, mu))


def chain_bound(m: int, k: int = K, n: int = N) -> Tuple[float, str]:
    """Least milliseconds of a chain call and what bounds it: raw, w, A
    and B read once, y and the two sums written once, against the
    product's 2mkn operations."""
    nbytes = m * k * 2 + k * n * 2 + 2 * k * 4 + m * n * 2 + 2 * n * 4
    return _bound(nbytes, 2 * m * k * n)


def join_bound(m: int, n: int = N, nj: int = NJ) -> Tuple[float, str]:
    """Least milliseconds of a join call and what bounds it: dy_up, w1,
    dy_res, x_raw and mu read once, dy and the three sums written once,
    against the product's 2*m*n*nj operations."""
    nbytes = (m * n * 2 + nj * n * 2 + 2 * m * nj * 2 + nj * 4
              + m * nj * 2 + 3 * nj * 4)
    return _bound(nbytes, 2 * m * n * nj)


def _bound(nbytes: int, flops: int) -> Tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ variants

def eager_chain(raw: Tensor, w: Tensor, A: Tensor,
                B: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The chain as PyTorch runs it unfused: bf16 BN-apply and ReLU, a
    bf16 cuBLAS product, float32 column sums of y."""
    y = torch.matmul(prologue_plain(raw, A, B), w)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def eager_bwd_join(dy_up: Tensor, w1: Tensor, dy_res: Tensor, x_raw: Tensor,
                   mu: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The join as PyTorch runs it unfused, with a bf16 cuBLAS product."""
    dy = torch.matmul(dy_up, w1.T) + dy_res
    xc = x_raw.float() - mu
    dy = torch.where(xc > 0, dy, torch.zeros((), dtype=BF16,
                                             device=dy.device))
    dyf = dy.float()
    return dy, dyf.sum(0), (dyf * xc).sum(0), (dyf * dyf).sum(0)


def chain_variants(raw: Tensor, w: Tensor, A: Tensor,
                   B: Tensor) -> Dict[str, Callable[[], object]]:
    x = raw.view(N_IMG, H, W, K).permute(0, 3, 1, 2)   # channels_last view
    w_conv = w.T.contiguous().view(N, K, 1, 1)
    return {
        "gemm": lambda: torch.matmul(raw, w),
        "conv1x1": lambda: F.conv2d(x, w_conv),
        "xla_chain": lambda: eager_chain(raw, w, A, B),
        "pallas_chain": lambda: conv_chain(raw, w, A, B),
        "pallas_chain_scratch": lambda: conv_chain_scratch(raw, w, A, B),
    }


def join_variants(*join_inputs: Tensor) -> Dict[str, Callable[[], object]]:
    return {
        "xla_bwd_join": lambda: eager_bwd_join(*join_inputs),
        "pallas_bwd_join": lambda: conv_bwd_join(*join_inputs),
    }


# ------------------------------------------------------------ checks

def bf16_mismatch(got: Tensor, want: Tensor,
                  operand: Tensor = None) -> Tuple[float, float]:
    """(share of elements that differ, largest difference in bf16 ulps)
    between two bf16 tensors of one shape. A product summed in another
    float32 order can round to the neighbouring bf16 value; where the
    sum cancels to a small value, that order error exceeds the value's
    own ulp, so magnitudes below 2^-10 of the tensor's largest count with
    the ulp at that floor. ``operand`` bounds the magnitude of a value
    rounded on the way (the join's dx, at most |dy_res| + |dy|): its ulp
    counts where it is the larger."""
    g, w_ = got.float(), want.float()
    diff = (g - w_).abs()
    floor = max(float(w_.abs().max()) * 2.0 ** -10, torch.finfo(BF16).tiny)
    mag = torch.maximum(g.abs(), w_.abs()).clamp_min(floor)
    if operand is not None:
        mag = torch.maximum(mag, operand)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (float((diff > 0).float().mean()),
            float((diff / ulp).max()))


def sums_error(got: Tensor, want: Tensor, scale: Tensor) -> float:
    """Largest |got - want| in units of the column's sum|.|."""
    return float(((got - want).abs() / scale.clamp_min(1e-30)).max())


def _sums_of(name: str, inputs: tuple, y: Tensor) -> Tuple[Tensor, ...]:
    """The column sums of a bf16 output ``y``, as the plain versions form
    them, and the column sums of their absolute terms."""
    yf = y.float()
    if name == "conv_bwd_join":
        xc = inputs[3].float() - inputs[4]
        terms = (yf, yf * xc, yf * yf)
    else:
        terms = (yf, yf * yf)
    return (tuple(t.sum(0) for t in terms),
            tuple(t.abs().sum(0) for t in terms))


def compare(name: str, inputs: tuple, got: tuple,
            want: tuple) -> Dict[str, float]:
    """A kernel's outputs against its plain version's on ``inputs``.

    The bf16 matrix element by element: the share of elements that
    differ and by how many ulps. The float32 sums, in units of their
    columns' sums of absolute terms, against the same sums taken over
    the kernel's own bf16 output (``sum_err``), so that they check the
    reduction and not again the few outputs that rounded to the
    neighbouring bf16 value; a neighbour at |y| = 2 moves sum y^2 by
    2^-5, which at small M is above 1e-5 of the sum. The scratch
    variant's sums read the float32 y, which only the plain version
    exposes: they are held against the plain version's. ``sum_err_plain``
    is every kernel's against the plain version's sums."""
    # the join rounds dx to bf16 before the residual add: a dx that
    # rounded to its neighbour moves dy by one ulp of dx, which where dx
    # and dy_res cancel is many ulps of dy; |dx| <= |dy_res| + |dy|, with
    # a margin for a dy rounded down across a power of two
    operand = None
    if name == "conv_bwd_join":
        dy_mag = torch.maximum(got[0].float().abs(), want[0].float().abs())
        operand = (inputs[2].float().abs() + dy_mag) * (1 + 2 ** -7)
    share, ulps = bf16_mismatch(got[0], want[0], operand)
    own, scales = _sums_of(name, inputs, got[0])
    if name == "conv_chain_scratch":
        # the float32 y of the two differ by summation order, up to a few
        # float32 roundings of sum_k |h w|: that is the terms' scale
        raw, w, a, b = inputs
        habs = prologue_plain(raw, a, b).float().abs() @ w.float().abs()
        own, scales = want[1:], (habs.sum(0), (habs * habs).sum(0))
    errs = [sums_error(g, o, s) for g, o, s in zip(got[1:], own, scales)]
    errs_plain = [sums_error(g, w_, s)
                  for g, w_, s in zip(got[1:], want[1:], scales)]
    abs_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
    return {"mismatch_share": share, "max_ulps": ulps,
            "ulp_limit": ULP_LIMIT[name], "sum_err": max(errs),
            "sum_err_plain": max(errs_plain), "max_abs_err": abs_err}


def passes(check: Dict[str, float]) -> bool:
    return (check["mismatch_share"] <= ULP_SHARE
            and check["max_ulps"] <= check["ulp_limit"]
            and check["sum_err"] <= SUM_TOL and check.get("bitwise", True))


def check_kernel(name: str, inputs: tuple) -> Dict[str, float]:
    """The kernel ``name`` against its plain version on ``inputs`` (CUDA
    tensors), and two launches bitwise equal."""
    kernel, plain = KERNELS[name]
    got = kernel(*inputs)
    again = kernel(*inputs)
    want = plain(*inputs)
    torch.cuda.synchronize()
    check = compare(name, inputs, got, want)
    check["bitwise"] = all(torch.equal(a, b) for a, b in zip(got, again))
    return check


# ------------------------------------------------------------ timing

def measure(fn: Callable[[], object], k1: int = 6, k2: int = 30,
            reps: int = 3) -> float:
    """Milliseconds per call: the slope between k1 and k2 back-to-back
    calls, each the best of ``reps``, between CUDA events. A spin kernel
    before the first event gives the card a head start, so the host has
    queued every call before the card reaches them."""
    fn()
    torch.cuda.synchronize()
    best = {}
    for k in (k1, k2):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(100_000_000)   # ~50 ms of spinning
            start.record()
            for _ in range(k):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        best[k] = min(times)
    return (best[k2] - best[k1]) / (k2 - k1)


def run(chain_in: Tuple[Tensor, ...], join_in: Tuple[Tensor, ...],
        log=print) -> Dict[str, object]:
    """Check every kernel against its plain version on the inputs (CUDA
    tensors from :func:`make_inputs` and :func:`make_join_inputs`), then
    time every variant; returns the checks, the times and the bounds."""
    checks = {name: check_kernel(name, join_in if name == "conv_bwd_join"
                                 else chain_in) for name in KERNELS}
    for name, check in checks.items():
        log(f"# {name} vs plain: {json.dumps(check)}")
        if not passes(check):
            raise SystemExit(f"{name} disagrees with its plain version")
    times = {}
    for name, fn in {**chain_variants(*chain_in),
                     **join_variants(*join_in)}.items():
        times[name] = measure(fn)
    bounds = {"chain": chain_bound(M), "join": join_bound(M)}
    for name, ms in times.items():
        bound = bounds["join" if "join" in name else "chain"][0]
        log(f"{name:22s} {ms:8.4f} ms  ({bound / ms:.0%} of the "
            f"{bound:.4f} ms bound)")
    return {"checks": checks, "ms": times, "bounds": bounds}


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_conv_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"# shape M={M} K={K} N={N} NJ={NJ} on "
          f"{torch.cuda.get_device_name(0)}; bound: chain "
          f"{chain_bound(M)[0]:.4f} ms, join {join_bound(M)[0]:.4f} ms "
          f"(bytes at 3.35 TB/s, products at 989 TFLOP/s bf16)")
    result = run(make_inputs("cuda"), make_join_inputs("cuda"))
    print(json.dumps({k: round(v, 4) for k, v in result["ms"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
