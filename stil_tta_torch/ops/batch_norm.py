"""BatchNorm on the card: the hand-written ``bn_stats`` and
``bn_bwd_reduce`` kernels, and train-mode BN as an autograd Function.

``bn_stats`` is the port of the Pallas kernel
``stil_tta_tpu/ops/batch_norm.py:bn_stats``: for a row-major (M, C)
activation it returns the per-channel sum and sum of squares, each (1, C)
float32. ``bn_bwd_reduce`` ports ``stil_tta_tpu/ops/batch_norm.py:
bn_bwd_reduce``: for (M, C) x and dy and the (C,) mean and inverse std it
returns sum(dy) and sum(dy * x_hat), each (1, C) float32. On a CUDA
tensor each launches its kernel (``csrc/bn_stats.cu``,
``csrc/bn_bwd_reduce.cu``, built with ``nvcc`` at first use) or raises; on
a CPU tensor each takes its plain version (:func:`bn_stats_plain`,
:func:`bn_bwd_reduce_plain`). There is no fallback from one to the other.

:class:`BatchNorm2d` follows the JAX package's default BN,
``TorchBatchNorm`` (``stil_tta_tpu/models/resnet.py:87-157``), not
``TPUBatchNorm``: eps 1e-5; batch mean and variance from the float32 sums
(variance ``E[x²] − mean²`` clamped at 0); normalisation in the
activation dtype; running statistics with torch's momentum 0.1 on the new
value and Bessel's correction on the variance. In train mode it runs
:class:`BNTrain`, the counterpart of the JAX package's ``bn_train``
custom VJP: statistics from :func:`bn_stats`, and a backward whose
reduction is :func:`bn_bwd_reduce`, so the gradient flows through the
batch mean and variance. Eval mode reads the running statistics with
plain tensor ops.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import Callable, Iterator, Tuple

import torch
from torch import nn

from stil_tta_torch.ops import cuda_build
from stil_tta_torch.parallel import collectives

THREADS = 256          # kThreads in csrc/bn_reduce_common.cuh
# the one-launch reduction of csrc/bn_reduce_ring.cuh: its ring, tiles, grid
STAGE_BYTES = 32 * 1024  # bn_stats: bytes of rows a ring stage holds
BWD_STAGE_BYTES = 16 * 1024  # bn_bwd_reduce: of each of x and dy
STAGE_ROWS = 256         # and at most this many rows (a TMA box's limit)
STAGES = 4               # ring depth: kMaxStages
MAX_TILE_C = 256         # channels of a column tile: kMaxTile
MAX_BLOCKS_PER_SM = 2    # more blocks an SM add partial rows, not bandwidth
MIN_BLOCK_BYTES = 32 * 1024  # bn_bwd_reduce: input bytes a block, at least
SMEM_FIXED = 256         # kSmemFixed: the mbarriers and 128 bytes to align
SMEM_LIMIT = 232_448     # shared memory a block may use on the H100

Tensor = torch.Tensor


def bn_stats_plain(x2d: Tensor) -> Tuple[Tensor, Tensor]:
    """(M, C) -> (sum, sum of squares), each (1, C), accumulated in at
    least float32 (float64 input keeps float64)."""
    acc = torch.promote_types(x2d.dtype, torch.float32)
    xf = x2d.to(acc)
    return xf.sum(0, keepdim=True), (xf * xf).sum(0, keepdim=True)


def bn_bwd_reduce_plain(x2d: Tensor, dy2d: Tensor, mean: Tensor,
                        inv: Tensor) -> Tuple[Tensor, Tensor]:
    """(M, C) x and dy, (C,) or (1, C) mean and inv -> (sum dy, sum dy *
    x_hat), each (1, C), with x_hat = (x - mean) * inv, accumulated in at
    least float32."""
    acc = torch.promote_types(x2d.dtype, torch.float32)
    dyf = dy2d.to(acc)
    xhat = (x2d.to(acc) - mean.reshape(1, -1)) * inv.reshape(1, -1)
    return dyf.sum(0, keepdim=True), (dyf * xhat).sum(0, keepdim=True)


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """How a one-launch reduction kernel (``csrc/bn_reduce_ring.cuh``)
    cuts its (M, C) inputs; the kernel checks the plan before launch.

    ``vec`` elements per 16-byte unit (1: the variant that reads the
    inputs directly, for an unaligned base or a row that is not a multiple
    of 16 bytes). The channels go in ``tiles`` column tiles of ``tile_c``
    (a multiple of ``vec``; tile_c / vec threads lie across a tile's row).
    The rows go in ``chunks`` contiguous chunks of ``rows_per_chunk``;
    each (tile, chunk) is one block's item, block b takes the items b,
    b + grid, ... The ring (vec > 1) has ``stages`` stages of
    ``stage_rows`` rows of each input, ``stage_bytes`` of data an input,
    each input's part 128-byte aligned, ``stage_pitch`` bytes from one
    stage to the next. ``smem`` bytes of dynamic shared memory a block.
    The partial buffer has one row of 2C floats per chunk; the combine
    adds ``combine_cols`` output columns a block at a time."""

    vec: int
    tile_c: int
    tiles: int
    stage_rows: int
    stage_bytes: int
    stages: int
    stage_pitch: int
    rows_per_chunk: int
    chunks: int
    grid: int
    smem: int
    combine_cols: int


def _reduce_plan(m: int, c: int, itemsize: int, aligned: bool, sms: int,
                 blocks_per_sm: int, inputs: int, stage_bytes: int,
                 min_block_bytes: int) -> ReducePlan:
    """The plan of ``inputs`` (M, C) inputs on a card with ``sms`` SMs
    that hold ``blocks_per_sm`` blocks each: at most
    ``min(blocks_per_sm, MAX_BLOCKS_PER_SM)`` blocks an SM and, when
    ``min_block_bytes`` is set, at most one block for each
    ``min_block_bytes`` of input. The shared memory does not depend on
    ``sms`` and ``blocks_per_sm``, so the wrapper can ask the card how
    many blocks of that size an SM holds first."""
    vec = 16 // itemsize
    if not aligned or c % vec:
        vec = 1
    tiles = -(-c // MAX_TILE_C)
    tile_c = -(-(-(-c // tiles)) // vec) * vec
    tiles = -(-c // tile_c)
    target = max(1, sms * min(blocks_per_sm, MAX_BLOCKS_PER_SM))
    if min_block_bytes:
        target = max(1, min(target,
                            inputs * m * c * itemsize // min_block_bytes))
    chunks_goal = max(1, target // tiles)
    if vec > 1:
        row_bytes = tile_c * itemsize
        stage_rows = max(1, min(stage_bytes // row_bytes, STAGE_ROWS))
        stage_bytes = stage_rows * row_bytes
        stage_pitch = inputs * (-(-stage_bytes // 128) * 128)
        stages = STAGES
    else:
        stage_rows = stage_bytes = stages = stage_pitch = 0
    rows_per_chunk = -(-m // chunks_goal)
    chunks = -(-m // rows_per_chunk)
    grid = min(tiles * chunks, target)
    smem = SMEM_FIXED + max(stages * stage_pitch, 2 * THREADS * vec * 4)
    combine_cols = 1
    while combine_cols < min(-(-2 * c // grid), THREADS):
        combine_cols *= 2
    return ReducePlan(vec, tile_c, tiles, stage_rows, stage_bytes, stages,
                      stage_pitch, rows_per_chunk, chunks, grid, smem,
                      combine_cols)


def stats_plan(m: int, c: int, itemsize: int, aligned: bool, sms: int,
               blocks_per_sm: int) -> ReducePlan:
    """The ``bn_stats`` launch for (m, c) of ``itemsize`` bytes: one
    input, 32 KB ring stages, a grid of the SMs times the blocks an SM
    holds (at most two), capped at the work."""
    return _reduce_plan(m, c, itemsize, aligned, sms, blocks_per_sm, 1,
                        STAGE_BYTES, 0)


def bwd_plan(m: int, c: int, itemsize: int, aligned: bool, sms: int,
             blocks_per_sm: int) -> ReducePlan:
    """The ``bn_bwd_reduce`` launch for (m, c) x and dy of ``itemsize``
    bytes: ring stages of 16 KB of each input (four stages: 128 KB, one
    block an SM), and ``stats_plan``'s grid capped at one block for each
    ``MIN_BLOCK_BYTES`` of x and dy, so that at small M·C a block's
    partial rows stay a small share of what it reads
    (``csrc/bn_bwd_reduce.cu``, point 3)."""
    return _reduce_plan(m, c, itemsize, aligned, sms, blocks_per_sm, 2,
                        BWD_STAGE_BYTES, MIN_BLOCK_BYTES)


@functools.cache
def _launcher(name: str):
    """``<name>_launch`` of the built library of ``csrc/<name>.cu``, with
    its C signature declared (pointers and the stream as ``void*``)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = getattr(cuda_build.load(name), f"{name}_launch")
    fn.argtypes = {
        "bn_stats": [p, i, ll, i, i, i, i, i, i, i, ll, i, i, i, i, p, p, p],
        "bn_bwd_reduce": [p, p, p, p, i, ll, i, i, i, i, i, i, i, ll, i,
                          i, i, i, p, p, p],
    }[name]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _capacity(name: str, device: int, is_bf16: bool, vec: int,
              smem: int) -> Tuple[int, int]:
    """(SMs, blocks an SM holds) for the variant of kernel ``name`` with
    ``smem`` bytes of shared memory, on ``device``."""
    fn = getattr(cuda_build.load(name), f"{name}_occupancy")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, i, p, p]
    fn.restype = ctypes.c_int
    sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(int(is_bf16), vec, smem, ctypes.addressof(sms),
                 ctypes.addressof(per_sm))
    if err or per_sm.value < 1:
        raise RuntimeError(f"{name}: no block of {smem} bytes of shared "
                           f"memory fits an SM (CUDA error {err})")
    return sms.value, per_sm.value


def _card_plan(name: str, plan_fn: Callable[..., ReducePlan], x2d: Tensor,
               aligned: bool) -> ReducePlan:
    """``plan_fn``'s plan for the CUDA tensor ``x2d``: the SM count and
    the blocks an SM holds come from the card."""
    m, c = x2d.shape
    itemsize = x2d.element_size()
    first = plan_fn(m, c, itemsize, aligned, 1, 1)
    sms, per_sm = _capacity(name, x2d.device.index,
                            x2d.dtype == torch.bfloat16, first.vec,
                            first.smem)
    return plan_fn(m, c, itemsize, aligned, sms, per_sm)


def _check_2d(name: str, t: Tensor) -> None:
    if t.dim() != 2:
        raise ValueError(f"{name}: expected (M, C), got {tuple(t.shape)}")
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: unsupported dtype {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if t.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(t.shape)}")


def _launch(name: str, pointers: Tuple[Tensor, ...], x2d: Tensor,
            plan: ReducePlan) -> Tuple[Tensor, Tensor]:
    """One cooperative launch of ``name`` on the current stream over the
    (M, C) rows of ``x2d``; ``pointers`` are the kernel's input tensors in
    the order of its C interface."""
    m, c = x2d.shape
    partial = torch.empty((plan.chunks, 2 * c), dtype=torch.float32,
                          device=x2d.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x2d.device)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = _launcher(name)(
            *(t.data_ptr() for t in pointers),
            int(x2d.dtype == torch.bfloat16), m, c, plan.vec, plan.tile_c,
            plan.tiles, plan.stage_rows, plan.stages, plan.stage_pitch,
            plan.rows_per_chunk, plan.chunks, plan.combine_cols, plan.grid,
            plan.smem, partial.data_ptr(), out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    return out[0:1], out[1:2]


def bn_stats(x2d: Tensor) -> Tuple[Tensor, Tensor]:
    """(M, C) -> (sum, sum of squares), each (1, C) float32.

    CPU tensors take :func:`bn_stats_plain`. A CUDA tensor must be
    2-D, contiguous, bfloat16 or float32 and non-empty; it launches the
    kernel on the current stream, and ``bn_stats.launches`` counts the
    launches. The launch can be captured in a CUDA graph (the plan's
    occupancy query is cached by its first, eager call; the partial rows
    and the output come from the caching allocator, the graph's pool
    under capture); a replay launches without Python, and
    ``train/multistep.py:GraphedStep`` adds the captured count to
    ``launches`` at each replay."""
    if x2d.device.type == "cpu":
        return bn_stats_plain(x2d)
    if x2d.device.type != "cuda":
        raise ValueError(f"bn_stats: unsupported device {x2d.device}")
    _check_2d("bn_stats", x2d)
    out = _launch("bn_stats", (x2d,), x2d, bn_stats_plan(x2d))
    bn_stats.launches += 1
    return out


def bn_stats_plan(x2d: Tensor) -> ReducePlan:
    """The plan :func:`bn_stats` launches for the CUDA tensor ``x2d``."""
    return _card_plan("bn_stats", stats_plan, x2d, x2d.data_ptr() % 16 == 0)


bn_stats.launches = 0


def bn_bwd_reduce(x2d: Tensor, dy2d: Tensor, mean: Tensor,
                  inv: Tensor) -> Tuple[Tensor, Tensor]:
    """(M, C) x and dy, (C,) or (1, C) mean and inv -> (sum dy, sum dy *
    x_hat), each (1, C) float32, x_hat = (x - mean) * inv.

    CPU tensors take :func:`bn_bwd_reduce_plain`. On the card x and dy
    must be 2-D, contiguous, of one shape and one dtype (bfloat16 or
    float32), and mean and inv float32 with C contiguous values, all on
    one device; it launches the kernel on the current stream, and
    ``bn_bwd_reduce.launches`` counts the launches (under capture and
    replay as :func:`bn_stats`)."""
    if x2d.device.type == "cpu":
        return bn_bwd_reduce_plain(x2d, dy2d, mean, inv)
    if x2d.device.type != "cuda":
        raise ValueError(f"bn_bwd_reduce: unsupported device {x2d.device}")
    for t in (x2d, dy2d):
        _check_2d("bn_bwd_reduce", t)
    if dy2d.shape != x2d.shape or dy2d.dtype != x2d.dtype:
        raise ValueError(
            f"bn_bwd_reduce: x {tuple(x2d.shape)} {x2d.dtype} and dy "
            f"{tuple(dy2d.shape)} {dy2d.dtype} differ")
    c = x2d.shape[1]
    for t in (mean, inv):
        if (t.dtype != torch.float32 or t.numel() != c
                or not t.is_contiguous()):
            raise ValueError("bn_bwd_reduce: mean and inv must be "
                             f"contiguous float32 with {c} values")
    if any(t.device != x2d.device for t in (dy2d, mean, inv)):
        raise ValueError("bn_bwd_reduce: inputs on different devices")
    out = _launch("bn_bwd_reduce", (x2d, dy2d, mean, inv), x2d,
                  bn_bwd_reduce_plan(x2d, dy2d))
    bn_bwd_reduce.launches += 1
    return out


def bn_bwd_reduce_plan(x2d: Tensor, dy2d: Tensor) -> ReducePlan:
    """The plan :func:`bn_bwd_reduce` launches for the CUDA tensors
    ``x2d`` and ``dy2d``."""
    aligned = x2d.data_ptr() % 16 == 0 and dy2d.data_ptr() % 16 == 0
    return _card_plan("bn_bwd_reduce", bwd_plan, x2d, aligned)


bn_bwd_reduce.launches = 0

StatsFn = Callable[[Tensor], Tuple[Tensor, Tensor]]
BwdReduceFn = Callable[[Tensor, Tensor, Tensor, Tensor],
                       Tuple[Tensor, Tensor]]


def rows(x: Tensor) -> Tensor:
    """(N, C, H, W) -> its (N·H·W, C) rows: a view when ``x`` is
    ``channels_last``, else a copy."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


class BNTrain(torch.autograd.Function):
    """Train-mode BatchNorm of an NCHW input: the port of
    ``stil_tta_tpu/ops/batch_norm.py:bn_train`` (``_bn_train_fwd`` /
    ``_bn_train_bwd``) with ``TorchBatchNorm``'s numerics.

    ``apply(x, weight, bias, eps, stats, bwd_reduce)`` returns
    ``(y, mean, var)``: the batch mean and biased variance (clamped at 0)
    come from ``stats`` (float32 sums), and y is normalised in x's dtype.
    Backward: ``bwd_reduce`` gives sum(dy) and sum(dy * x_hat) over the
    saved input (x itself, not a float32 copy), then
    ``dx = (weight * inv) * (dy - sum dy / M - x_hat * sum(dy x_hat) / M)``,
    computed in float32 as ``a * dy + b * x + c`` and cast to x's dtype;
    ``dweight = sum(dy x_hat)``, ``dbias = sum(dy)``. mean and var are not
    differentiable: they feed the running statistics only, as in the
    reference.

    In a sharded forward (:func:`stil_tta_torch.parallel.sharded`) the
    rows are the rank's share of the global batch: the forward's
    ``(sum, sum of squares)`` and the backward's ``(sum dy, sum dy *
    x_hat)`` are all-reduced over the mesh and M counts the global rows,
    so y, dx, mean and var are the global batch's; dweight and dbias stay
    the rank's sums, which the gradient all-reduce adds up."""

    dy_copies = 0  # grad_outputs that were not channels_last (copied)

    @staticmethod
    def forward(ctx, x: Tensor, weight: Tensor, bias: Tensor, eps: float,
                stats: StatsFn, bwd_reduce: BwdReduceFn):
        c = x.shape[1]
        x2d = rows(x)
        n = x2d.shape[0]
        s, ss = stats(x2d)
        shard = collectives.active_shard()
        ctx.mesh = None if shard is None else shard.mesh
        if ctx.mesh is not None:
            s, ss = collectives.all_reduce(ctx.mesh,
                                           torch.cat([s, ss])).split(1)
            n *= ctx.mesh.size
        mean = s[0] / n
        var = (ss[0] / n - mean * mean).clamp_min(0.0)
        inv = torch.rsqrt(var + eps)
        dt = x.dtype
        mul = torch.rsqrt(var.to(dt) + eps) * weight.to(dt)
        shape = (1, c, 1, 1)
        y = ((x - mean.to(dt).view(shape)) * mul.view(shape)
             + bias.to(dt).view(shape))
        ctx.save_for_backward(x, mean, inv, weight)
        ctx.bwd_reduce = bwd_reduce
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy: Tensor, _dmean, _dvar):
        x, mean, inv, weight = ctx.saved_tensors
        if not dy.is_contiguous(memory_format=torch.channels_last):
            BNTrain.dy_copies += 1
            dy = dy.contiguous(memory_format=torch.channels_last)
        x2d, dy2d = rows(x), rows(dy.to(x.dtype))
        m = x2d.shape[0]
        sdy, sdyxh = ctx.bwd_reduce(x2d, dy2d, mean, inv)
        dweight, dbias = sdyxh[0].to(weight.dtype), sdy[0].to(weight.dtype)
        if ctx.mesh is not None:
            sdy, sdyxh = collectives.all_reduce(
                ctx.mesh, torch.cat([sdy, sdyxh])).split(1)
            m *= ctx.mesh.size
        sdy, sdyxh = sdy[0], sdyxh[0]
        # dx = a*dy + b*x + c per channel, with x_hat = (x - mean) * inv
        a = weight.to(inv.dtype) * inv
        b = -a * inv * sdyxh / m
        c = -a * sdy / m - b * mean
        dx2d = torch.addcmul(torch.addcmul(c, x2d, b), dy2d, a).to(x.dtype)
        n, ch, h, w = x.shape
        dx = dx2d.view(n, h, w, ch).permute(0, 3, 1, 2)
        return dx, dweight, dbias, None, None, None


class BatchNorm2d(nn.Module):
    """BatchNorm over the channel axis of an NCHW tensor (run it in
    ``torch.channels_last``, so the (N·H·W, C) rows are a view).

    Parameters and buffers carry torch's names (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``), so
    reference-layout checkpoints load with ``strict=True``. ``stats`` and
    ``bwd_reduce`` are the functions of the train-mode forward sums and
    backward reduction; they are the kernels :func:`bn_stats` and
    :func:`bn_bwd_reduce` unless a caller swaps them for a comparison
    (:func:`bn_functions`). With ``update_running`` False a train-mode
    forward leaves the running statistics and the counter as they are
    (:func:`running_stats_frozen`)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.update_running = True
        self.stats: StatsFn = bn_stats
        self.bwd_reduce: BwdReduceFn = bn_bwd_reduce
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: Tensor) -> Tensor:
        c = x.shape[1]
        if self.training:
            y, mean, var = BNTrain.apply(x, self.weight, self.bias, self.eps,
                                         self.stats, self.bwd_reduce)
            if not self.update_running:
                return y
            shard = collectives.active_shard()
            n = x.numel() // c * (1 if shard is None else shard.mesh.size)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(
                    mean.to(self.running_mean.dtype), alpha=m)
                self.running_var.mul_(1.0 - m).add_(
                    (var * (n / max(n - 1, 1))).to(self.running_var.dtype),
                    alpha=m)
                self.num_batches_tracked.add_(1)
            return y
        mean, var = self.running_mean, self.running_var
        dt = x.dtype
        mul = torch.rsqrt(var.to(dt) + self.eps) * self.weight.to(dt)
        shape = (1, c, 1, 1)
        return ((x - mean.to(dt).view(shape)) * mul.view(shape)
                + self.bias.to(dt).view(shape))


@contextlib.contextmanager
def bn_functions(module: nn.Module, stats: StatsFn,
                 bwd_reduce: BwdReduceFn) -> Iterator[None]:
    """Run every :class:`BatchNorm2d` of ``module`` with ``stats`` and
    ``bwd_reduce`` (e.g. the plain versions, to compare a train step with
    the kernels'); the previous functions come back on exit."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    saved = [(m.stats, m.bwd_reduce) for m in bns]
    for m in bns:
        m.stats, m.bwd_reduce = stats, bwd_reduce
    try:
        yield
    finally:
        for m, (s, b) in zip(bns, saved):
            m.stats, m.bwd_reduce = s, b


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module) -> Iterator[None]:
    """Inside, the train-mode forwards of every :class:`BatchNorm2d` of
    ``module`` normalise by their batch's statistics (the ``bn_stats``
    kernel) and leave the running statistics and counters untouched, as
    the JAX package discards a train-mode forward's mutated statistics
    (CoMatch's momentum encoder, ``comatch.py:106-124``)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    saved = [m.update_running for m in bns]
    for m in bns:
        m.update_running = False
    try:
        yield
    finally:
        for m, flag in zip(bns, saved):
            m.update_running = flag
