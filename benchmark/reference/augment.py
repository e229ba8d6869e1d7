"""The views of a STiL train batch in plain PyTorch, for the reference:
a frozen copy of the port's image recipes (the DVM contrastive recipe
and the cardiac one with its rotation, the eval resize) and of its
tabular corruption, sampling split from applying as in the port. Given a
generator in the state the program's was in, :func:`draw_views` draws
the same parameters in the same order and so makes the same views."""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

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


@functools.lru_cache(maxsize=None)
def _luma(dtype: torch.dtype, device: torch.device) -> Tensor:
    """The luma weights on ``device``, made once: a copy from the host
    cannot run inside a CUDA graph capture, and the train step's first,
    eager call makes them."""
    return torch.tensor(_LUMA, dtype=dtype, device=device)


def _grayscale(img: Tensor) -> Tensor:
    """(..., 3) -> (..., 1) luma."""
    return (img @ _luma(img.dtype, img.device))[..., None]


def _rgb_to_hsv(img: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``augment.py:_rgb_to_hsv``: (..., 3) RGB -> hue in [0, 1),
    saturation, value."""
    r, g, b = img.unbind(-1)
    maxc = img.amax(-1)
    minc = img.amin(-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12),
                    torch.zeros_like(maxc))
    safe = delta.clamp_min(1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, (h / 6.0) % 1.0, torch.zeros_like(h))
    return h, s, maxc


def _hsv_to_rgb(h: Tensor, s: Tensor, v: Tensor) -> Tensor:
    """``augment.py:_hsv_to_rgb``: the six-sector formula."""
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.long() % 6

    def pick(*cs):
        out = cs[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, cs[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


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


def affine_warp(imgs: Tensor, y0: Tensor, x0: Tensor, ch: Tensor,
                cw: Tensor, out_size: int, flip: Tensor,
                angle: Tensor) -> Tensor:
    """The crop [y0, y0 + ch) x [x0, x0 + cw) of each image of ``imgs``
    (B, H, W, C), resized to ``out_size``², flipped where ``flip`` and
    rotated by ``angle`` (radians) about the full image's centre, by
    clipped bilinear gathers at the output grid's inverse-mapped points
    (``augment.py:affine_warp``); the box, flip and angle are (B,)."""
    b, h, w, _ = imgs.shape
    dev = imgs.device
    col = lambda t: t[:, None, None]  # noqa: E731
    i = torch.arange(out_size, dtype=torch.float32, device=dev)
    sy = y0[:, None] + (i + 0.5) * (ch / out_size)[:, None] - 0.5
    jx = torch.where(flip[:, None], out_size - 1.0 - i, i)
    sx = x0[:, None] + (jx + 0.5) * (cw / out_size)[:, None] - 0.5
    yy = sy[:, :, None].expand(b, out_size, out_size)
    xx = sx[:, None, :].expand(b, out_size, out_size)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ca, sa = col(torch.cos(angle)), col(torch.sin(angle))
    ys = (cy + ca * (yy - cy) - sa * (xx - cx)).clamp(0.0, h - 1.0)
    xs = (cx + sa * (yy - cy) + ca * (xx - cx)).clamp(0.0, w - 1.0)
    y0i, x0i = ys.floor().long(), xs.floor().long()
    y1i, x1i = (y0i + 1).clamp_max(h - 1), (x0i + 1).clamp_max(w - 1)
    wy = (ys - y0i)[..., None]
    wx = (xs - x0i)[..., None]
    bi = torch.arange(b, device=dev)[:, None, None]
    top = imgs[bi, y0i, x0i] * (1 - wx) + imgs[bi, y0i, x1i] * wx
    bot = imgs[bi, y1i, x0i] * (1 - wx) + imgs[bi, y1i, x1i] * wx
    return top * (1 - wy) + bot * wy


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


def _reflect_blur_matrix(w: Tensor, n: int) -> Tensor:
    """(B, n, n) matrices of the reflect-padded 1-D blur with taps ``w``
    (B, K) (``augment.py:gaussian_blur``'s ``sep_pass``): tap k of output
    s reads source s + k - half, reflected at both ends without repeating
    the edge."""
    k = w.shape[1]
    half = k // 2
    src = (torch.arange(n, device=w.device)[None, :]
           + torch.arange(k, device=w.device)[:, None] - half)
    src = torch.where(src < 0, -src, src)
    src = torch.where(src > n - 1, 2 * (n - 1) - src, src)
    taps = torch.nn.functional.one_hot(src, n).to(w.dtype)   # (K, n, n)
    return torch.einsum("bk,ksm->bsm", w, taps)


def _gaussian_kernels(sigma: Tensor, ksize: int) -> Tensor:
    half = ksize // 2
    x = torch.arange(-half, half + 1, dtype=torch.float32,
                     device=sigma.device)
    w = torch.exp(-(x ** 2) / (2.0 * sigma[:, None] ** 2))
    return w / w.sum(1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class AugmentPipeline:
    """One recipe of the JAX package's ``AugmentPipeline``.
    ``__call__(generator, images, apply_rate)`` with images (B,
    H, W, 3) uint8 or float returns (B, img_size, img_size, 3) float32,
    in [0, 1] when ``scale_255``.

    ``jitter`` is (brightness, contrast, saturation, hue) or None;
    ``jitter_before_crop`` jitters the full image (the contrastive and
    hard-eval recipes) or the crop (the strong recipe, whose contrast and
    saturation then take the crop's mean); ``blur_before_crop`` picks the
    blur's form (module docstring); ``rotate_limit`` > 0 (degrees) adds a
    rotation drawn uniform in +-``rotate_limit`` and takes the gather path
    (:func:`affine_warp`)."""

    img_size: int
    crop_scale: Tuple[float, float] = (0.08, 1.0)
    crop_ratio: Tuple[float, float] = (0.75, 4.0 / 3.0)
    hflip_p: float = 0.5
    jitter: Optional[Tuple[float, float, float, float]] = None
    jitter_p: float = 1.0
    gray_p: float = 0.0
    blur_ksize: int = 0
    blur_sigma: Tuple[float, float] = (0.1, 2.0)
    blur_p: float = 0.0
    rotate_limit: float = 0.0
    blur_before_crop: bool = True
    jitter_before_crop: bool = True
    scale_255: bool = True

    def sample(self, gen: torch.Generator, b: int, h: int, w: int,
               apply_rate: float = 1.0) -> Dict[str, Tensor]:
        """Every random parameter of a batch of ``b`` (h, w) images, drawn
        from ``gen`` on its device, in the JAX package's parameterisation
        (``color_jitter``, ``random_grayscale``, ``sample_crop_box``,
        ``_augment_one``; the angle in radians); an op the recipe lacks
        draws nothing."""
        dev = gen.device

        def u(lo=0.0, hi=1.0):
            return lo + (hi - lo) * torch.rand(b, generator=gen, device=dev)

        def factor(x):
            return u(max(0.0, 1.0 - x), 1.0 + x)

        if apply_rate >= 1.0:
            gate = torch.ones(b, dtype=torch.bool, device=dev)
        else:
            gate = u() < apply_rate
        p = {"gate": gate}
        if self.jitter is not None:
            p.update(jitter_on=u() < self.jitter_p,
                     brightness=factor(self.jitter[0]),
                     contrast=factor(self.jitter[1]),
                     saturation=factor(self.jitter[2]))
            if self.jitter[3] > 0:
                p["hue"] = u(-self.jitter[3], self.jitter[3])
        if self.gray_p > 0:
            p["gray_on"] = u() < self.gray_p
        if self.blur_ksize > 0:
            p.update(blur_sigma=u(*self.blur_sigma),
                     blur_on=u() < self.blur_p)
        area = float(h * w)
        target = u(*self.crop_scale) * area
        r = torch.exp(u(math.log(self.crop_ratio[0]),
                        math.log(self.crop_ratio[1])))
        cw = torch.sqrt(target * r).clamp(1.0, float(w))
        ch = torch.sqrt(target / r).clamp(1.0, float(h))
        p.update(y0=u() * (float(h) - ch), x0=u() * (float(w) - cw), ch=ch,
                 cw=cw, flip=u() < self.hflip_p)
        if self.rotate_limit > 0:
            lim = math.radians(self.rotate_limit)
            p["angle"] = u(-lim, lim)
        return p

    def _pointwise(self, imgs: Tensor, p: Dict[str, Tensor]) -> Tensor:
        """Jitter then grayscale (``AugmentPipeline._pointwise``), each
        row with its drawn factors; rows whose ``gate`` is False keep
        ``imgs``."""
        col = lambda t: t[:, None, None, None]  # noqa: E731
        out = imgs
        if self.jitter is not None:
            on = p["jitter_on"]
            one = torch.ones_like(p["brightness"])
            fb, fc, fs = (torch.where(on, p[k], one)
                          for k in ("brightness", "contrast", "saturation"))
            out = (out * col(fb)).clamp(0.0, 1.0)
            mean_gray = _grayscale(out).mean(dim=(1, 2, 3))
            out = (col(mean_gray) + col(fc) * (out - col(mean_gray))
                   ).clamp(0.0, 1.0)
            gray = _grayscale(out)
            out = (gray + col(fs) * (out - gray)).clamp(0.0, 1.0)
            if self.jitter[3] > 0:
                # the round trip runs whether or not the jitter is on
                hue, s, v = _rgb_to_hsv(out)
                fh = torch.where(on, p["hue"], torch.zeros_like(p["hue"]))
                out = _hsv_to_rgb((hue + col(fh)[..., 0]) % 1.0, s, v)
        if self.gray_p > 0:
            out = torch.where(col(p["gray_on"]),
                              _grayscale(out).expand(-1, -1, -1, 3), out)
        return torch.where(col(p["gate"]), out, imgs)

    def _blur_taps(self, p: Dict[str, Tensor], device) -> Tensor:
        """(B, K) blur taps: the drawn Gaussian where ``blur_on`` and the
        gate hold, else the identity delta."""
        delta = torch.zeros(self.blur_ksize, device=device)
        delta[self.blur_ksize // 2].fill_(1.0)   # no host copy (capturable)
        return torch.where((p["blur_on"] & p["gate"])[:, None],
                           _gaussian_kernels(p["blur_sigma"],
                                             self.blur_ksize), delta)

    def apply(self, images: Tensor, p: Dict[str, Tensor]) -> Tensor:
        """The recipe with the drawn parameters ``p``; a row whose
        ``gate`` is False gets the resize-only view."""
        imgs = images.float()
        if self.scale_255:
            imgs = imgs.clamp(0.0, 255.0) / 255.0
        b, h, w, _ = imgs.shape
        gate = p["gate"]
        if self.jitter_before_crop:
            imgs = self._pointwise(imgs, p)
        zero = torch.zeros_like(p["y0"])
        y0 = torch.where(gate, p["y0"], zero)
        x0 = torch.where(gate, p["x0"], zero)
        ch = torch.where(gate, p["ch"], zero + float(h))
        cw = torch.where(gate, p["cw"], zero + float(w))
        s = self.img_size
        flip = p["flip"] & gate
        if self.rotate_limit > 0:
            if self.blur_ksize > 0 and self.blur_before_crop:
                # the full image's reflect blur (``augment.py:338-341``)
                taps = self._blur_taps(p, imgs.device)
                imgs = torch.einsum(
                    "btw,bswc->bstc", _reflect_blur_matrix(taps, w),
                    torch.einsum("bsh,bhwc->bswc",
                                 _reflect_blur_matrix(taps, h), imgs))
            angle = torch.where(gate, p["angle"], zero)
            out = affine_warp(imgs, y0, x0, ch, cw, s, flip, angle)
        else:
            ry = _batched_resize_matrix(y0, ch, h, s)
            rx = _batched_resize_matrix(x0, cw, w, s, flip)
            if self.blur_ksize > 0 and self.blur_before_crop:
                taps = self._blur_taps(p, imgs.device)
                ry, rx = _compose_blur(ry, taps), _compose_blur(rx, taps)
            tmp = torch.einsum("bsh,bhwc->bswc", ry, imgs)
            out = torch.einsum("btw,bswc->bstc", rx, tmp)
        if not self.jitter_before_crop:
            out = self._pointwise(out, p)
        if self.blur_ksize > 0 and not self.blur_before_crop:
            blur = _reflect_blur_matrix(self._blur_taps(p, out.device), s)
            out = torch.einsum("btw,bswc->bstc", blur, torch.einsum(
                "bsh,bhwc->bswc", blur, out))
        return out.clamp(0.0, 1.0) if self.scale_255 else out

    def __call__(self, gen: torch.Generator, images: Tensor,
                 apply_rate: float = 1.0) -> Tensor:
        b, h, w, _ = images.shape
        return self.apply(images, self.sample(gen, b, h, w, apply_rate))


def contrastive_pipeline(img_size: int, target: str,
                         crop_scale_lower: float = 0.08
                         ) -> AugmentPipeline:
    """``grab_image_augmentations`` (``utils.py:46-91``). DVM: jitter
    with p 0.8 on the full image, grayscale p 0.2, a 29-tap blur p 0.5
    composed into the crop's matrices. Cardiac: jitter 0.5 with p 1, a
    (0.2, 1) crop and a rotation of up to 45 degrees, at raw scale."""
    if target.lower() == "dvm":
        return AugmentPipeline(
            img_size, crop_scale=(crop_scale_lower, 1.0),
            jitter=(0.8, 0.8, 0.8, 0.0), jitter_p=0.8, gray_p=0.2,
            blur_ksize=29, blur_sigma=(0.1, 2.0), blur_p=0.5)
    return AugmentPipeline(
        img_size, crop_scale=(0.2, 1.0), rotate_limit=45.0,
        jitter=(0.5, 0.5, 0.5, 0.0), jitter_p=1.0, scale_255=False)


def sample_corruption(gen: torch.Generator, b: int, f: int, n: int,
                      rate: float) -> Optional[Dict[str, Tensor]]:
    """(B, F) uniform noise (its per-row ranks choose the distinct
    columns) and (B, F) source-row indices in [0, n); None when the rate
    corrupts no feature."""
    if int(f * rate) == 0:
        return None
    dev = gen.device
    return {"noise": torch.rand(b, f, generator=gen, device=dev),
            "src_rows": torch.randint(0, n, (b, f), generator=gen,
                                      device=dev)}


def apply_corruption(rows: Tensor, marginal: Tensor, rate: float,
                     draws: Optional[Dict[str, Tensor]]) -> Tensor:
    """rows (B, F), marginal (N, F) training table -> (B, F)."""
    n_corrupt = int(rows.shape[1] * rate)
    if n_corrupt == 0 or draws is None:
        return rows
    ranks = draws["noise"].argsort(dim=1, stable=True).argsort(
        dim=1, stable=True)
    cols = torch.arange(rows.shape[1], device=rows.device)[None, :]
    sampled = marginal[draws["src_rows"], cols]
    return torch.where(ranks < n_corrupt, sampled.to(rows.dtype), rows)


def corrupt_tabular(gen: torch.Generator, rows: Tensor, marginal: Tensor,
                    rate: float) -> Tensor:
    b, f = rows.shape
    return apply_corruption(rows, marginal, rate, sample_corruption(
        gen, b, f, marginal.shape[0], rate))


def draw_views(cfg: dict, aug, gen: torch.Generator, bl: dict, bu: dict,
               marg_l: Tensor, marg_u: Tensor):
    """(img_l, tab_l, img_u, tab_u), drawn from ``gen`` in the port's
    order: both image views, then both corruptions."""
    rate = float(cfg["augmentation_rate"])
    crate = float(cfg["corruption_rate"])
    img_l = aug(gen, bl["images"], rate)
    img_u = aug(gen, bu["images"], rate)
    tab_l = corrupt_tabular(gen, bl["tabular"], marg_l, crate)
    tab_u = corrupt_tabular(gen, bu["tabular"], marg_u, crate)
    return img_l, tab_l, img_u, tab_u
