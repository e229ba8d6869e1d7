"""Dynamically quantized int8 convolution, the port of
``stil_tta_tpu/models/resnet.py:quant_conv_apply``.

Three steps, in the JAX package's order of operations:

1. scales: per output channel ``s_w = max|w| / 127``, one for the whole
   input ``s_x = max|x| / 127``, each floored at 1e-30;
2. ``q = clip(round(v / s), -127, 127)`` to int8 (a division by the
   scale, rounding half to even) and an s8 x s8 -> s32 convolution;
3. the epilogue ``(y_s32 -> float) * (s_x * s_w)`` in the out dtype.

Scales, quantization and epilogue compute in float32, as the JAX code
casts to ``jnp.float32``; a float64 tower (the CPU parity tests, where
JAX's float32 reads as float64) computes them in float64.

``s_x`` is per call: a sample's int8 result depends on the batch it came
in (the JAX package's note on ``quant_conv_apply``). It stays a device
tensor, so a call makes no host round trip.

Two routes for the s32 convolution, chosen by the device of ``x``:

- CPU tensors: :func:`int8_conv_plain`, ``F.conv2d`` in float64 of the
  integer-valued tensors. Every partial sum is an integer below
  K * 127^2 <= 4,608 * 16,129 < 2^53, so it is exact.
- CUDA tensors: :func:`int8_conv_card`, an integer GEMM through
  ``torch._int_mm`` (s8 x s8 -> s32). A 1x1 conv multiplies the rows of
  the channels-last activation by the (Cin, Cout) weight; a larger
  kernel goes through an im2col of the zero-padded NHWC int8 tensor
  built from strided views, its K in (kh, kw, cin) order (JAX's HWIO).
  K and N are padded with zeros to multiples of 8 and M to 17 rows where
  ``_int_mm`` asks for it (the 7x7 stem's K = 147 becomes 152); the
  padding adds zeros to the sums. A failure of the GEMM raises: there is
  no fallback to a float convolution.

The JAX package leaves this convolution to XLA (no Pallas kernel), so
the card route is a library GEMM, not a hand kernel.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from stil_tta_torch.parallel import collectives

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def _q127(device: torch.device, dtype: torch.dtype) -> Tensor:
    """127 as a 0-d tensor on ``device``. A CUDA tensor divided by a
    Python number is multiplied by its reciprocal instead, which can
    differ from the division in the last bit."""
    return torch.full((), 127.0, dtype=dtype, device=device)


def quantize(x: Tensor, weight: Tensor
             ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``(x_q, w_q, s_x, s_w)``: x (B, Cin, H, W) and weight (Cout, Cin,
    kh, kw) as int8 in their own memory formats, the 0-d activation scale
    and the (Cout,) weight scales."""
    cdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    q127 = _q127(x.device, cdt)
    wf = weight.to(cdt)
    s_w = torch.clamp_min(wf.abs().amax(dim=(1, 2, 3)) / q127, 1e-30)
    w_q = torch.clamp(torch.round(wf / s_w[:, None, None, None]),
                      -127, 127).to(torch.int8)
    # |x| and its max are exact in x's dtype, and so is the cast; in a
    # sharded forward the max is the global batch's
    amax = collectives.global_max(x.abs().amax().to(cdt))
    s_x = torch.clamp_min(amax / q127, 1e-30)
    xf = x.to(cdt)
    xf = xf.div_(s_x) if xf is not x else xf / s_x
    x_q = xf.round_().clamp_(-127, 127).to(torch.int8)
    return x_q, w_q, s_x, s_w


def dequantize(y: Tensor, s_x: Tensor, s_w: Tensor,
               out_dtype: torch.dtype) -> Tensor:
    """The epilogue: s32 sums (B, Cout, Ho, Wo) times ``s_x * s_w`` in
    the scales' dtype, cast to ``out_dtype``."""
    scale = (s_x * s_w)[None, :, None, None]
    return (y.to(scale.dtype) * scale).to(out_dtype)


def int8_conv_plain(x_q: Tensor, w_q: Tensor, stride: int,
                    padding: int) -> Tensor:
    """The s32 sums by a float64 ``F.conv2d`` of the int8 values (exact,
    see the module's docstring), on any device."""
    y = F.conv2d(x_q.to(torch.float64), w_q.to(torch.float64),
                 stride=stride, padding=padding)
    return y.to(torch.int32)


def _up(n: int, k: int) -> int:
    return -(-n // k) * k


def im2col(x_q: Tensor, kh: int, kw: int, stride: int, padding: int
           ) -> Tuple[Tensor, Tuple[int, int, int]]:
    """The (M, Kp) int8 rows of the convolution's GEMM, M = B·Ho·Wo
    (padded to at least 17 rows) and Kp = kh·kw·Cin padded to a multiple
    of 8, the columns in (kh, kw, cin) order; and (B, Ho, Wo). A 1x1
    stride-1 conv of a channels-last tensor is a view."""
    b, c, h, w = x_q.shape
    xn = x_q.permute(0, 2, 3, 1)                     # NHWC
    if padding:
        xn = F.pad(xn, (0, 0, padding, padding, padding, padding))
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    k, m = kh * kw * c, b * ho * wo
    kp, mp = _up(k, 8), max(m, 17)
    if kh == kw == 1:
        src = xn[:, ::stride, ::stride, :][:, :ho, :wo, :]
        if kp == k and mp == m and src.is_contiguous():
            return src.reshape(m, k), (b, ho, wo)
        src = src[:, :, :, None, None, :]
    else:
        # (B, Ho, Wo, C, kh, kw) windows -> (B, Ho, Wo, kh, kw, C)
        src = xn.unfold(1, kh, stride).unfold(2, kw, stride)
        src = src.permute(0, 1, 2, 4, 5, 3)
    cols = torch.empty((mp, kp), dtype=torch.int8, device=x_q.device)
    if kp > k:
        cols[:, k:].zero_()
    if mp > m:
        cols[m:].zero_()
    cols[:m, :k].view(b, ho, wo, kh, kw, c).copy_(src)
    return cols, (b, ho, wo)


def weight_matrix(w_q: Tensor, kp: int) -> Tensor:
    """The (Kp, Np) int8 weight operand of the GEMM, K in (kh, kw, cin)
    order, zero-padded to ``kp`` rows and to Np = Cout rounded up to 8
    columns; column-major (the transpose of a row-major (Np, Kp))."""
    cout = w_q.shape[0]
    wm = w_q.permute(0, 2, 3, 1).reshape(cout, -1)   # (Cout, K)
    k, np_ = wm.shape[1], _up(cout, 8)
    if kp != k or np_ != cout:
        wm = F.pad(wm, (0, kp - k, 0, np_ - cout))
    return wm.contiguous().t()


def int8_conv_card(x_q: Tensor, w_q: Tensor, stride: int,
                   padding: int) -> Tensor:
    """The s32 sums by ``torch._int_mm`` on the card, as (B, Cout, Ho,
    Wo) in channels-last memory."""
    cout, _, kh, kw = w_q.shape
    cols, (b, ho, wo) = im2col(x_q, kh, kw, stride, padding)
    y = torch._int_mm(cols, weight_matrix(w_q, cols.shape[1]))
    return y[:b * ho * wo, :cout].reshape(b, ho, wo, cout).permute(
        0, 3, 1, 2)


def quant_conv2d_plain(x: Tensor, weight: Tensor, stride: int,
                       padding: int, out_dtype: torch.dtype) -> Tensor:
    """The whole int8 convolution with the plain s32 sums, on any
    device."""
    x_q, w_q, s_x, s_w = quantize(x, weight)
    return dequantize(int8_conv_plain(x_q, w_q, stride, padding), s_x, s_w,
                      out_dtype)


def quant_conv2d(x: Tensor, weight: Tensor, stride: int, padding: int,
                 out_dtype: torch.dtype) -> Tensor:
    """x (B, Cin, H, W), weight (Cout, Cin, kh, kw) -> (B, Cout, Ho, Wo)
    in ``out_dtype``: :func:`quant_conv2d_plain` for CPU tensors, the
    integer GEMM (:func:`int8_conv_card`) for CUDA tensors; any other
    device raises."""
    if x.device.type == "cpu":
        return quant_conv2d_plain(x, weight, stride, padding, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quant_conv2d: unsupported device {x.device}")
    x_q, w_q, s_x, s_w = quantize(x, weight)
    return dequantize(int8_conv_card(x_q, w_q, stride, padding), s_x, s_w,
                      out_dtype)
