"""The resize-only eval transform (the part of
``stil_tta_tpu/data/augment.py`` the test-time path uses).

``default_pipeline`` resamples each image with the same triangle-kernel
matrices as the JAX package (``_resize_matrix``): ``out = Ry @ img @
Rx^T`` as two float32 einsums over the batch. ``F.interpolate`` is not
used, because it clamps the source coordinates at the edges differently.
The random recipes (crop, flip, jitter, blur) are still to port.
"""

from __future__ import annotations

import torch


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
