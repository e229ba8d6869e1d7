"""ResNet image tower (the part of ``stil_tta_tpu/models/resnet.py`` the
port uses).

torchvision-style ResNet: conv1 7x7/2, BN, ReLU, maxpool 3x3/2, four stages
of :class:`BasicBlock` / :class:`Bottleneck` (v1.5: stride on the 3x3
conv). The JAX package's space-to-depth stem is exact math for the 7x7/s2/p3
conv, so a plain conv ports it; its TPU layout lanes (channel padding,
1x1-as-dot, remat, fp8 residuals, custom maxpool) are not ported.

``forward(x, int8=True)`` in eval mode is the int8 forward (JAX
``QuantConv`` and the ``int8`` flags): every convolution, the stem and
the downsamples included, runs ``ops/quant_conv.py:quant_conv2d``; BN,
ReLU, the residual add, pooling and the head stay exact. Without channel
padding (not ported, set by no config) the JAX package quantizes every
conv too. Its int8 stem quantizes the space-to-depth form; the direct
7x7 conv on the same int8 values gives the same sums (the scattered
kernel keeps each output channel's max|w|, the re-laid input keeps
max|x|, and the sums have the same terms). Train mode ignores the flag,
as in JAX.

Inputs are NHWC (the JAX layout). Inside, tensors are NCHW in
``torch.channels_last`` memory, so every BatchNorm input is a row-major
(N·H·W, C) view for the ``bn_stats`` kernel. Feature maps come back as
NHWC views. Parameters are float32; convs run in the tower's ``dtype``
(bfloat16 on the card), as the JAX ``Conv(dtype, param_dtype=f32)`` does.
"""

from __future__ import annotations

from typing import List, Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from stil_tta_torch.ops.batch_norm import BatchNorm2d
from stil_tta_torch.ops.quant_conv import quant_conv2d

EMBEDDING_DIM = {"resnet18": 512, "resnet50": 2048}


class Conv2d(nn.Conv2d):
    """Bias-free conv whose float32 weight is cast to the input's dtype;
    ``int8=True`` quantizes it (``QuantConv``: the same ``weight``, out
    in the input's dtype)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=False)

    def forward(self, x: torch.Tensor, int8: bool = False) -> torch.Tensor:
        if int8:
            return quant_conv2d(x, self.weight, self.stride[0],
                                self.padding[0], x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), None)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    # torch keys downsample.0 (conv) / downsample.1 (BN)
    return nn.Sequential(Conv2d(cin, cout, 1, stride), BatchNorm2d(cout))


def _identity(block: nn.Module, x: torch.Tensor, q: bool) -> torch.Tensor:
    if block.downsample is None:
        return x
    conv, bn = block.downsample
    return bn(conv(x, q))


class BasicBlock(nn.Module):
    """``resnets.py:50-88``."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (_downsample(inplanes, planes, stride)
                           if downsample else None)

    def forward(self, x: torch.Tensor, int8: bool = False) -> torch.Tensor:
        q = int8 and not self.training
        out = F.relu(self.bn1(self.conv1(x, q)))
        out = self.bn2(self.conv2(out, q))
        return F.relu(out + _identity(self, x, q))


class Bottleneck(nn.Module):
    """``resnets.py:91-132`` (torchvision v1.5)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out, 1)
        self.bn3 = BatchNorm2d(out)
        self.downsample = (_downsample(inplanes, out, stride)
                           if downsample else None)

    def forward(self, x: torch.Tensor, int8: bool = False) -> torch.Tensor:
        q = int8 and not self.training
        out = F.relu(self.bn1(self.conv1(x, q)))
        out = F.relu(self.bn2(self.conv2(out, q)))
        out = self.bn3(self.conv3(out, q))
        return F.relu(out + _identity(self, x, q))


class ResNet(nn.Module):
    """``forward(x, int8=False)`` with x (B, H, W, 3) float returns
    ``[x0..x4]`` NHWC feature maps when ``return_all_feature_maps``
    (``resnets.py:254-260``) else ``[pooled]`` (B, C); ``int8`` is the
    int8 eval forward, ignored in train mode."""

    def __init__(self, block: Type[nn.Module], layers: Sequence[int],
                 return_all_feature_maps: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.return_all_feature_maps = return_all_feature_maps
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     layers)):
            stride = 1 if stage == 0 else 2
            mods = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1
                                 or inplanes != planes * block.expansion)
                mods.append(block(inplanes, planes, s, ds))
                inplanes = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*mods))

    def forward(self, x: torch.Tensor,
                int8: bool = False) -> List[torch.Tensor]:
        q = int8 and not self.training
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(self.bn1(self.conv1(x, q)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = [x]
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = block(x, q)
            feats.append(x)
        if self.return_all_feature_maps:
            return [f.permute(0, 2, 3, 1) for f in feats]
        return [x.mean(dim=(2, 3))]


def resnet18(**kw) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), **kw)


_ENCODERS = {"resnet18": resnet18, "resnet50": resnet50}


def image_encoder(name: str, return_all_feature_maps: bool = False,
                  dtype: torch.dtype = torch.bfloat16) -> ResNet:
    """``torchvision_ssl_encoder`` equivalent: encoder with no fc head."""
    if name not in _ENCODERS:
        raise NotImplementedError(
            f"image encoder {name!r} is not ported yet (ported: "
            f"{sorted(_ENCODERS)}; see ROADMAP.md)")
    return _ENCODERS[name](return_all_feature_maps=return_all_feature_maps,
                           dtype=dtype)
