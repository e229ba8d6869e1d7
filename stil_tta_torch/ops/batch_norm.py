"""BatchNorm statistics on the card: the hand-written ``bn_stats`` kernel.

``bn_stats`` is the port of the Pallas kernel
``stil_tta_tpu/ops/batch_norm.py:bn_stats``: for a row-major (M, C)
activation it returns the per-channel sum and sum of squares, each (1, C)
float32. On a CUDA tensor it launches ``csrc/bn_stats.cu`` (built with
``nvcc`` at first use) or raises; on a CPU tensor it takes the plain
version, :func:`bn_stats_plain`. There is no fallback from one to the
other.

:class:`BatchNorm2d` follows the JAX package's default BN,
``TorchBatchNorm`` (``stil_tta_tpu/models/resnet.py:87-157``), not
``TPUBatchNorm``: eps 1e-5; batch mean and variance from the float32 sums
(variance ``E[x²] − mean²`` clamped at 0); normalisation in the
activation dtype; running statistics with torch's momentum 0.1 on the new
value and Bessel's correction on the variance. In train mode the
statistics always come from :func:`bn_stats`; eval mode reads the running
statistics. Gradients through the statistics are not provided: the
backward kernel (``bn_bwd_reduce``) is still to port.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Tuple

import torch
from torch import nn

from stil_tta_torch.ops import cuda_build

THREADS = 256          # kThreads in csrc/bn_stats.cu
TARGET_BLOCKS = 132 * 8  # eight blocks for each of the H100's 132 SMs

Tensor = torch.Tensor


def bn_stats_plain(x2d: Tensor) -> Tuple[Tensor, Tensor]:
    """(M, C) -> (sum, sum of squares), each (1, C), accumulated in at
    least float32 (float64 input keeps float64)."""
    acc = torch.promote_types(x2d.dtype, torch.float32)
    xf = x2d.to(acc)
    return xf.sum(0, keepdim=True), (xf * xf).sum(0, keepdim=True)


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """How ``bn_stats`` cuts an (M, C) input: ``vec`` elements per
    16-byte load (1 when unaligned), ``threads_c`` threads across a
    channel tile, ``chunks`` row chunks of ``rows_per_chunk`` rows."""

    vec: int
    threads_c: int
    chunks: int
    rows_per_chunk: int


def launch_config(m: int, c: int, itemsize: int,
                  aligned: bool) -> LaunchConfig:
    vec = 16 // itemsize
    if not aligned or c % vec:
        vec = 1
    units = c // vec
    threads_c = 1
    while threads_c < min(units, 32):
        threads_c *= 2
    tile_c = threads_c * vec
    tiles = -(-c // tile_c)
    rows_per_step = THREADS // threads_c
    chunks = max(1, min(-(-TARGET_BLOCKS // tiles), -(-m // rows_per_step)))
    rows_per_chunk = -(-m // chunks)
    return LaunchConfig(vec, threads_c, -(-m // rows_per_chunk),
                        rows_per_chunk)


@functools.cache
def _launcher():
    """``bn_stats_launch`` of the built library, with its C signature
    declared (pointers and the stream as ``void*``)."""
    fn = cuda_build.load("bn_stats").bn_stats_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, ll, i, i, i, i, ll, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def bn_stats(x2d: Tensor) -> Tuple[Tensor, Tensor]:
    """(M, C) -> (sum, sum of squares), each (1, C) float32.

    CPU tensors take :func:`bn_stats_plain`. A CUDA tensor must be
    2-D, contiguous, bfloat16 or float32 and non-empty; it launches the
    kernel on the current stream, and ``bn_stats.launches`` counts the
    launches."""
    if x2d.device.type == "cpu":
        return bn_stats_plain(x2d)
    if x2d.device.type != "cuda":
        raise ValueError(f"bn_stats: unsupported device {x2d.device}")
    if x2d.dim() != 2:
        raise ValueError(f"bn_stats: expected (M, C), got {tuple(x2d.shape)}")
    if x2d.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"bn_stats: unsupported dtype {x2d.dtype}")
    if not x2d.is_contiguous():
        raise ValueError("bn_stats: input must be contiguous")
    m, c = x2d.shape
    if m == 0 or c == 0:
        raise ValueError(f"bn_stats: empty input {tuple(x2d.shape)}")
    cfg = launch_config(m, c, x2d.element_size(), x2d.data_ptr() % 16 == 0)
    partial = torch.empty((cfg.chunks, 2 * c), dtype=torch.float32,
                          device=x2d.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x2d.device)
    launch = _launcher()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = launch(
            x2d.data_ptr(), int(x2d.dtype == torch.bfloat16), m, c, cfg.vec,
            cfg.threads_c, cfg.chunks, cfg.rows_per_chunk,
            partial.data_ptr(), out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"bn_stats: kernel launch failed, CUDA error "
                           f"{err}")
    bn_stats.launches += 1
    return out[0:1], out[1:2]


bn_stats.launches = 0

StatsFn = Callable[[Tensor], Tuple[Tensor, Tensor]]


class BatchNorm2d(nn.Module):
    """BatchNorm over the channel axis of an NCHW tensor (run it in
    ``torch.channels_last``, so the (N·H·W, C) rows are a view).

    Parameters and buffers carry torch's names (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``), so
    reference-layout checkpoints load with ``strict=True``. ``stats`` is
    the function that computes the train-mode sums; it is
    :func:`bn_stats` unless a caller swaps it for a comparison."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.stats: StatsFn = bn_stats
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: Tensor) -> Tensor:
        c = x.shape[1]
        if self.training:
            x2d = x.permute(0, 2, 3, 1).reshape(-1, c)
            n = x2d.shape[0]
            s, ss = self.stats(x2d)
            mean = s[0] / n
            var = (ss[0] / n - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(
                    mean.to(self.running_mean.dtype), alpha=m)
                self.running_var.mul_(1.0 - m).add_(
                    (var * (n / max(n - 1, 1))).to(self.running_var.dtype),
                    alpha=m)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        dt = x.dtype
        mul = torch.rsqrt(var.to(dt) + self.eps) * self.weight.to(dt)
        shape = (1, c, 1, 1)
        return ((x - mean.to(dt).view(shape)) * mul.view(shape)
                + self.bias.to(dt).view(shape))
