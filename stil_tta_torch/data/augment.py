"""Image transforms on the card, the port of the part of
``stil_tta_tpu/data/augment.py`` STiL uses.

``default_pipeline`` (eval) resamples each image with the same
triangle-kernel matrices as the JAX package (``_resize_matrix``): ``out =
Ry @ img @ Rx^T`` as two float32 einsums over the batch. ``F.interpolate``
is not used, because it clamps the source coordinates at the edges
differently.

``contrastive_pipeline`` is the DVM train recipe
(``grab_image_augmentations``, ``utils.py:46-91``): colour jitter with
p 0.8 on the full image before the crop, grayscale with p 0.2, a 29-tap
Gaussian blur with p 0.5 composed into the resampling matrices, a
RandomResizedCrop box (clamped, as the JAX package does), a horizontal
flip, and the per-sample ``apply_rate`` gate that falls back to the
resize-only view. Sampling is split from applying:
:meth:`ContrastivePipeline.sample` draws every random parameter from an
explicit ``torch.Generator`` and :meth:`ContrastivePipeline.apply` takes
them as tensors, so a test can feed it the JAX package's draws. The
cardiac recipe (rotation through an affine gather) is not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

Tensor = torch.Tensor
_LUMA = (0.299, 0.587, 0.114)


def _resize_matrix(in_len: int, out_len: int, device) -> torch.Tensor:
    """(out_len, in_len) bilinear resampling matrix for the whole axis
    [0, in_len) -> out_len samples; triangle-kernel rows."""
    i = torch.arange(out_len, dtype=torch.float32, device=device)
    step = torch.tensor(float(in_len), dtype=torch.float32,
                        device=device) / out_len
    src = ((i + 0.5) * step - 0.5).clamp(0.0, in_len - 1.0)
    j = torch.arange(in_len, dtype=torch.float32, device=device)
    return (1.0 - (src[:, None] - j[None, :]).abs()).clamp_min(0.0)


class ResizePipeline:
    """``__call__(images)`` with images (B, H, W, 3) uint8 or float
    returns (B, img_size, img_size, 3) float32, in [0, 1] when
    ``scale_255`` (dvm) or at raw scale (cardiac)."""

    def __init__(self, img_size: int, scale_255: bool = True):
        self.img_size = img_size
        self.scale_255 = scale_255

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        imgs = images.float()
        if self.scale_255:
            imgs = imgs.clamp(0.0, 255.0) / 255.0
        _, h, w, _ = imgs.shape
        ry = _resize_matrix(h, self.img_size, imgs.device)
        rx = _resize_matrix(w, self.img_size, imgs.device)
        tmp = torch.einsum("sh,bhwc->bswc", ry, imgs)
        out = torch.einsum("tw,bswc->bstc", rx, tmp)
        return out.clamp(0.0, 1.0) if self.scale_255 else out


def default_pipeline(img_size: int, target: str) -> ResizePipeline:
    """Eval resize-only transform."""
    return ResizePipeline(img_size, scale_255=target.lower() == "dvm")


def _grayscale(img: Tensor) -> Tensor:
    """(..., 3) -> (..., 1) luma."""
    luma = torch.tensor(_LUMA, dtype=img.dtype, device=img.device)
    return (img @ luma)[..., None]


def _batched_resize_matrix(src0: Tensor, src_len: Tensor, in_len: int,
                           out_len: int, flip: Tensor = None) -> Tensor:
    """(B, out_len, in_len) resampling matrices of the crops [src0,
    src0 + src_len) (``augment.py:_resize_matrix``), optionally flipped."""
    dev = src0.device
    i = torch.arange(out_len, dtype=torch.float32, device=dev)[None, :]
    if flip is not None:
        i = torch.where(flip[:, None], out_len - 1.0 - i, i)
    src = (src0[:, None] + (i + 0.5) * (src_len / out_len)[:, None] - 0.5)
    src = src.clamp(0.0, in_len - 1.0)
    j = torch.arange(in_len, dtype=torch.float32, device=dev)
    return (1.0 - (src[:, :, None] - j).abs()).clamp_min(0.0)


def _compose_blur(r: Tensor, w: Tensor) -> Tensor:
    """Fold a separable Gaussian ``w`` (B, K) into resampling matrices
    ``r`` (B, S, H): ``C[s, m] = sum_k w[k] R[s, m - k + half]``, rows
    renormalised (``augment.py:_compose_blur``)."""
    k = w.shape[1]
    half = k // 2
    h = r.shape[2]
    rp = torch.nn.functional.pad(r, (half, half))
    c = torch.zeros_like(r)
    for i in range(k):
        c = c + w[:, i, None, None] * rp[:, :, k - 1 - i:k - 1 - i + h]
    return c / c.sum(2, keepdim=True).clamp_min(1e-8)


def _gaussian_kernels(sigma: Tensor, ksize: int) -> Tensor:
    half = ksize // 2
    x = torch.arange(-half, half + 1, dtype=torch.float32,
                     device=sigma.device)
    w = torch.exp(-(x ** 2) / (2.0 * sigma[:, None] ** 2))
    return w / w.sum(1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class ContrastivePipeline:
    """The DVM contrastive recipe, batched. ``__call__(generator, images,
    apply_rate)`` with images (B, H, W, 3) uint8 returns (B, img_size,
    img_size, 3) float32 in [0, 1]."""

    img_size: int
    crop_scale: Tuple[float, float] = (0.08, 1.0)
    crop_ratio: Tuple[float, float] = (0.75, 4.0 / 3.0)
    hflip_p: float = 0.5
    jitter: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    jitter_p: float = 0.8
    gray_p: float = 0.2
    blur_ksize: int = 29
    blur_sigma: Tuple[float, float] = (0.1, 2.0)
    blur_p: float = 0.5

    def sample(self, gen: torch.Generator, b: int, h: int, w: int,
               apply_rate: float = 1.0) -> Dict[str, Tensor]:
        """Every random parameter of a batch of ``b`` (h, w) images, drawn
        from ``gen`` on its device, in the JAX package's parameterisation
        (``color_jitter``, ``random_grayscale``, ``sample_crop_box``,
        ``_augment_one``)."""
        dev = gen.device

        def u(lo=0.0, hi=1.0):
            return lo + (hi - lo) * torch.rand(b, generator=gen, device=dev)

        def factor(x):
            return u(max(0.0, 1.0 - x), 1.0 + x)

        if apply_rate >= 1.0:
            gate = torch.ones(b, dtype=torch.bool, device=dev)
        else:
            gate = u() < apply_rate
        p = {"gate": gate, "jitter_on": u() < self.jitter_p,
             "brightness": factor(self.jitter[0]),
             "contrast": factor(self.jitter[1]),
             "saturation": factor(self.jitter[2]),
             "gray_on": u() < self.gray_p,
             "blur_sigma": u(*self.blur_sigma),
             "blur_on": u() < self.blur_p}
        area = float(h * w)
        target = u(*self.crop_scale) * area
        r = torch.exp(u(math.log(self.crop_ratio[0]),
                        math.log(self.crop_ratio[1])))
        cw = torch.sqrt(target * r).clamp(1.0, float(w))
        ch = torch.sqrt(target / r).clamp(1.0, float(h))
        p.update(y0=u() * (float(h) - ch), x0=u() * (float(w) - cw), ch=ch,
                 cw=cw, flip=u() < self.hflip_p)
        return p

    def apply(self, images: Tensor, p: Dict[str, Tensor]) -> Tensor:
        """The recipe with the drawn parameters ``p``; a row whose
        ``gate`` is False gets the resize-only view."""
        imgs = images.float().clamp(0.0, 255.0) / 255.0
        b, h, w, _ = imgs.shape
        gate = p["gate"]
        col = lambda t: t[:, None, None, None]  # noqa: E731
        # pointwise jitter and grayscale on the full image, gated
        on = p["jitter_on"]
        one = torch.ones_like(p["brightness"])
        fb, fc, fs = (torch.where(on, p[k], one)
                      for k in ("brightness", "contrast", "saturation"))
        out = (imgs * col(fb)).clamp(0.0, 1.0)
        mean_gray = _grayscale(out).mean(dim=(1, 2, 3))
        out = (col(mean_gray) + col(fc) * (out - col(mean_gray))).clamp(0, 1)
        gray = _grayscale(out)
        out = (gray + col(fs) * (out - gray)).clamp(0.0, 1.0)
        out = torch.where(col(p["gray_on"]),
                          _grayscale(out).expand(-1, -1, -1, 3), out)
        imgs = torch.where(col(gate), out, imgs)
        # blur composed into the crop + resize + flip matrices
        delta = torch.zeros(self.blur_ksize, device=imgs.device)
        delta[self.blur_ksize // 2] = 1.0
        blur_w = torch.where((p["blur_on"] & gate)[:, None],
                             _gaussian_kernels(p["blur_sigma"],
                                               self.blur_ksize), delta)
        zero = torch.zeros_like(p["y0"])
        y0 = torch.where(gate, p["y0"], zero)
        x0 = torch.where(gate, p["x0"], zero)
        ch = torch.where(gate, p["ch"], zero + float(h))
        cw = torch.where(gate, p["cw"], zero + float(w))
        s = self.img_size
        ry = _compose_blur(_batched_resize_matrix(y0, ch, h, s), blur_w)
        rx = _compose_blur(_batched_resize_matrix(x0, cw, w, s,
                                                  p["flip"] & gate), blur_w)
        tmp = torch.einsum("bsh,bhwc->bswc", ry, imgs)
        return torch.einsum("btw,bswc->bstc", rx, tmp).clamp(0.0, 1.0)

    def __call__(self, gen: torch.Generator, images: Tensor,
                 apply_rate: float = 1.0) -> Tensor:
        b, h, w, _ = images.shape
        return self.apply(images, self.sample(gen, b, h, w, apply_rate))


def contrastive_pipeline(img_size: int, target: str,
                         crop_scale_lower: float = 0.08
                         ) -> ContrastivePipeline:
    """``grab_image_augmentations`` (``utils.py:46-91``), DVM only."""
    if target.lower() != "dvm":
        raise NotImplementedError(
            f"the {target!r} contrastive recipe (rotation, affine warp) is "
            f"not ported to stil_tta_torch yet (ROADMAP.md)")
    return ContrastivePipeline(img_size, crop_scale=(crop_scale_lower, 1.0))
