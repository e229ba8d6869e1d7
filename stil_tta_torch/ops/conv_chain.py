"""The bottleneck 1x1-conv + BatchNorm pattern as three fused kernels: the
port of the Pallas kernels of ``tools/bench_conv_probe.py``.

- :func:`conv_chain` (``_chain_kernel``): for row-major (M, K) ``raw``,
  the BN-apply + ReLU prologue ``h = max(bf16(bf16(raw * bf16(A)) +
  bf16(B)), 0)``, one bfloat16 rounding after each op as the Pallas body
  computes it; the 1x1 conv ``y = h @ w`` with float32 accumulation,
  stored as bfloat16; and the next BN's column sums ``sum y`` and ``sum
  y^2`` taken from the bfloat16-rounded y.
- :func:`conv_chain_scratch` (``_chain_scratch_kernel``): the same, with
  the sums taken from the float32 y before rounding.
- :func:`conv_bwd_join` (``_join_kernel``): the backward residual join:
  ``dx = bf16(dy_up @ w1^T)`` (float32 accumulation), ``dy = bf16(dx +
  dy_res)``, ``xc = f32(x_raw) - mu``, ``dy = where(xc > 0, dy, 0)``, and
  ``sum dy``, ``sum dy * xc``, ``sum dy^2``.

Matrices are bfloat16, ``A``, ``B`` and ``mu`` float32, the sums float32
of shape (N,) (the join's (NJ,)). On a CUDA tensor each function launches
its hand-written kernel (``csrc/conv_chain.cu``, ``csrc/conv_bwd_join.cu``,
built with ``nvcc`` at first use) or raises; on a CPU tensor it takes its
plain version (:func:`conv_chain_plain`, :func:`conv_chain_scratch_plain`,
:func:`conv_bwd_join_plain`), which follows the Pallas body's dtypes step
by step. There is no fallback from one to the other.

Nothing in the network calls these yet: the JAX package keeps the pattern
in its probe, and the probe's port is ``stil_tta_torch.tools.
bench_conv_probe``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from stil_tta_torch.ops import cuda_build

Tensor = torch.Tensor
BF16 = torch.bfloat16
BLOCKS_PER_SM = 1   # rows of the per-block partial sums: the kernels
                    # launch at most one block an SM


def prologue_plain(raw: Tensor, A: Tensor, B: Tensor) -> Tensor:
    """h = max(bf16(bf16(raw * bf16(A)) + bf16(B)), 0): each op rounds to
    bfloat16, as the Pallas body's bf16 arithmetic does."""
    return torch.clamp_min(raw * A.to(BF16) + B.to(BF16), 0)


def _chain_plain(raw: Tensor, w: Tensor, A: Tensor, B: Tensor,
                 sums_from_f32: bool) -> Tuple[Tensor, Tensor, Tensor]:
    h = prologue_plain(raw, A, B)
    y = h.float() @ w.float()
    yb = y.to(BF16)
    ys = y if sums_from_f32 else yb.float()
    return yb, ys.sum(0), (ys * ys).sum(0)


def conv_chain_plain(raw: Tensor, w: Tensor, A: Tensor,
                     B: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(y, sum y, sum y^2) with the sums over the bfloat16 y."""
    return _chain_plain(raw, w, A, B, sums_from_f32=False)


def conv_chain_scratch_plain(raw: Tensor, w: Tensor, A: Tensor,
                             B: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(y, sum y, sum y^2) with the sums over the float32 y."""
    return _chain_plain(raw, w, A, B, sums_from_f32=True)


def conv_bwd_join_plain(dy_up: Tensor, w1: Tensor, dy_res: Tensor,
                        x_raw: Tensor, mu: Tensor
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(dy, sum dy, sum dy * xc, sum dy^2)."""
    dx = dy_up.float() @ w1.float().T
    dy = dx.to(BF16) + dy_res
    xc = x_raw.float() - mu
    dy = torch.where(xc > 0, dy, torch.zeros((), dtype=BF16,
                                             device=dy.device))
    dyf = dy.float()
    return dy, dyf.sum(0), (dyf * xc).sum(0), (dyf * dyf).sum(0)


# ---------------------------------------------------------------- launch

@functools.cache
def _launcher(name: str):
    """``<name>_launch`` of its built library, C signature declared."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    source = "conv_bwd_join" if name == "conv_bwd_join" else "conv_chain"
    fn = getattr(cuda_build.load(source), f"{name}_launch")
    inputs = [p] * (5 if name == "conv_bwd_join" else 4)
    fn.argtypes = inputs + [ll, i, i, p, p, i, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name: str, t: Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name}: expected {shape} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: inputs on different devices")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                         "aligned")


SMEM_LIMIT = 232_448    # shared memory a block may use on the H100 (227 KB)
BOX_BYTES = 64 * 64 * 2  # a 64 x 64 bf16 box of shared memory
MAX_STAGES = 4
MAX_WIDTH = 256          # output columns: four 64-wide chunks


def _plan(k: int, n: int, join: bool = False) -> dict:
    """The kernels' shared-memory plan, as ``csrc/conv_chain_common.cuh``
    (``make_plan``) lays it out, or ``ValueError`` for widths the kernels
    do not take.

    ``k`` is the product's depth and ``n`` its output width: the chain's
    (K, N), the join's (N, NJ). Each is a multiple of 16 and is padded to
    64-column boxes; ``n`` is at most 256. A stage holds one 64-row tile:
    the chain's raw and y boxes, the join's dy_up, dy_res (then dy) and
    x_raw boxes. The weight stays resident, so the plan fits 227 KB only
    with at least two stages beside it: that is the ceiling on k x n.
    Returns the stages (at most 4) and the bytes of a stage, of the
    weight and in all."""
    name = "conv_bwd_join" if join else "conv_chain"
    for dim, v in zip(("N", "NJ") if join else ("K", "N"), (k, n)):
        if v <= 0 or v % 16:
            raise ValueError(f"{name}: {dim}={v} must be a positive "
                             "multiple of 16")
    if n > MAX_WIDTH:
        raise ValueError(f"{name}: output width {n} above {MAX_WIDTH}")
    kb, nb = -(-k // 64), -(-n // 64)
    stage = (kb + (2 * nb if join else nb)) * BOX_BYTES
    weight = kb * nb * BOX_BYTES
    extra = nb * 64 * 4 if join else 2 * kb * 64 * 2   # mu, or bf16 A and B
    fixed = 1024 + weight + extra + 2 * MAX_STAGES * 8  # align, barriers
    if fixed + 2 * stage > SMEM_LIMIT:
        raise ValueError(f"{name}: a {k} x {n} weight leaves no room for "
                         f"two {stage}-byte stages in {SMEM_LIMIT} bytes of "
                         "shared memory")
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
    return {"stages": stages, "stage_bytes": stage, "weight_bytes": weight,
            "smem": fixed + stages * stage}


def _launch(name: str, inputs: Tuple[Tensor, ...], m: int, dims: Tuple[int,
            int], out: Tensor, n_sums: int, width: int) -> Tensor:
    """Launch ``name`` on the current stream; returns the (n_sums, width)
    float32 column sums."""
    dev = out.device
    max_blocks = BLOCKS_PER_SM * _sm_count(dev.index)
    partial = torch.empty((max_blocks, n_sums * width), dtype=torch.float32,
                          device=dev)
    sums = torch.empty((n_sums, width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher(name)(*(t.data_ptr() for t in inputs), m, *dims,
                              out.data_ptr(), partial.data_ptr(), max_blocks,
                              sums.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    return sums


def _chain(name: str, raw: Tensor, w: Tensor, A: Tensor, B: Tensor
           ) -> Tuple[Tensor, Tensor, Tensor]:
    if raw.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {raw.device}")
    if raw.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name}: raw and w must be 2-D")
    (m, k), n = raw.shape, w.shape[1]
    _plan(k, n)
    if m == 0:
        raise ValueError(f"{name}: empty input")
    dev = raw.device
    for t, shape, dt in ((raw, (m, k), BF16), (w, (k, n), BF16),
                         (A, (k,), torch.float32), (B, (k,), torch.float32)):
        _check(name, t, shape, dt, dev)
    y = torch.empty((m, n), dtype=BF16, device=dev)
    sums = _launch(name, (raw, w, A, B), m, (k, n), y, 2, n)
    return y, sums[0], sums[1]


def conv_chain(raw: Tensor, w: Tensor, A: Tensor,
               B: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(M, K) bf16 ``raw``, (K, N) bf16 ``w``, (K,) float32 ``A`` and
    ``B`` -> (y (M, N) bf16, sum y (N,), sum y^2 (N,)), the sums float32
    over the bfloat16 y. K and N are multiples of 16 that :func:`_plan`
    accepts (N <= 256, the weight within shared memory), M is any size.

    CPU tensors take :func:`conv_chain_plain`; CUDA tensors (contiguous,
    16-byte aligned) launch the kernel on the current stream, and
    ``conv_chain.launches`` counts the launches."""
    if raw.device.type == "cpu":
        return conv_chain_plain(raw, w, A, B)
    out = _chain("conv_chain", raw, w, A, B)
    conv_chain.launches += 1
    return out


conv_chain.launches = 0


def conv_chain_scratch(raw: Tensor, w: Tensor, A: Tensor,
                       B: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """As :func:`conv_chain`, with the sums over the float32 y before
    rounding. ``conv_chain_scratch.launches`` counts the launches."""
    if raw.device.type == "cpu":
        return conv_chain_scratch_plain(raw, w, A, B)
    out = _chain("conv_chain_scratch", raw, w, A, B)
    conv_chain_scratch.launches += 1
    return out


conv_chain_scratch.launches = 0


def conv_bwd_join(dy_up: Tensor, w1: Tensor, dy_res: Tensor, x_raw: Tensor,
                  mu: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(M, N) bf16 ``dy_up``, (NJ, N) bf16 ``w1``, (M, NJ) bf16 ``dy_res``
    and ``x_raw``, (NJ,) float32 ``mu`` -> (dy (M, NJ) bf16, sum dy,
    sum dy * xc, sum dy^2), each sum (NJ,) float32. N and NJ are
    multiples of 16 that :func:`_plan` accepts (NJ <= 256, the weight
    within shared memory), M is any size.

    CPU tensors take :func:`conv_bwd_join_plain`; CUDA tensors
    (contiguous, 16-byte aligned) launch the kernel on the current
    stream, and ``conv_bwd_join.launches`` counts the launches."""
    if dy_up.device.type == "cpu":
        return conv_bwd_join_plain(dy_up, w1, dy_res, x_raw, mu)
    name = "conv_bwd_join"
    if dy_up.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dy_up.device}")
    if dy_up.dim() != 2 or w1.dim() != 2:
        raise ValueError(f"{name}: dy_up and w1 must be 2-D")
    (m, n), nj = dy_up.shape, w1.shape[0]
    _plan(n, nj, join=True)
    if m == 0:
        raise ValueError(f"{name}: empty input")
    dev = dy_up.device
    for t, shape, dt in ((dy_up, (m, n), BF16), (w1, (nj, n), BF16),
                         (dy_res, (m, nj), BF16), (x_raw, (m, nj), BF16),
                         (mu, (nj,), torch.float32)):
        _check(name, t, shape, dt, dev)
    dy = torch.empty((m, nj), dtype=BF16, device=dev)
    sums = _launch(name, (dy_up, w1, dy_res, x_raw, mu), m, (nj, n), dy, 3,
                   nj)
    conv_bwd_join.launches += 1
    return dy, sums[0], sums[1], sums[2]


conv_bwd_join.launches = 0
