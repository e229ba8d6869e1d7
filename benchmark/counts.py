"""The benchmark's frozen arithmetic: model FLOPs of the measured work,
BatchNorm shapes and the bytes the two BN reduction kernels must move,
and the peaks of one NVIDIA H100 SXM.

Everything here is computed from a configuration's shapes (the dict of
``benchmark/configs/<name>.json``, its ``model`` section), never from the
program. FLOPs count 2 per multiply-accumulate of every convolution,
linear layer and attention product of the nets (the model FLOPs
convention: a backward pass costs twice its forward); elementwise work,
the augmentation's resampling products and the loss matrices are left
out, so a share of the peak computed from these counts is a lower bound.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

RESNET50_STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))
EXPANSION = 4
IMAGE_DIM = 2048          # ResNet-50's pooled width
BF16_BYTES = 2


def _conv(b: int, h: int, w: int, cin: int, cout: int, k: int) -> int:
    """FLOPs of a bias-free conv producing (b, cout, h, w)."""
    return 2 * b * h * w * cin * cout * k * k


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def resnet50_layers(batch: int, img: int) -> List[dict]:
    """ResNet-50's convolutions and BatchNorms in forward order: each
    entry ``{"kind": "conv"|"bn", ...}``; a conv gives its FLOPs, a BN its
    (M, C) rows and channels (M = batch x H x W of its input)."""
    out = []
    s = _out(img, 7, 2, 3)
    out.append({"kind": "conv", "flops": _conv(batch, s, s, 3, 64, 7)})
    out.append({"kind": "bn", "m": batch * s * s, "c": 64})
    s = _out(s, 3, 2, 1)                      # max pool
    cin = 64
    for stage, (planes, blocks) in enumerate(RESNET50_STAGES):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            width, cout = planes, planes * EXPANSION
            so = _out(s, 3, stride, 1)
            out.append({"kind": "conv",
                        "flops": _conv(batch, s, s, cin, width, 1)})
            out.append({"kind": "bn", "m": batch * s * s, "c": width})
            out.append({"kind": "conv",
                        "flops": _conv(batch, so, so, width, width, 3)})
            out.append({"kind": "bn", "m": batch * so * so, "c": width})
            out.append({"kind": "conv",
                        "flops": _conv(batch, so, so, width, cout, 1)})
            out.append({"kind": "bn", "m": batch * so * so, "c": cout})
            if b == 0:
                out.append({"kind": "conv",
                            "flops": _conv(batch, so, so, cin, cout, 1)})
                out.append({"kind": "bn", "m": batch * so * so, "c": cout})
            cin, s = cout, so
    return out


def stage4_size(img: int) -> int:
    """Side of ResNet-50's last feature map (the fusion's image tokens)."""
    s = _out(_out(img, 7, 2, 3), 3, 2, 1)
    for stage in range(1, 4):
        s = _out(s, 3, 2, 1)
    return s


def bn_shapes(batch: int, img: int) -> List[Tuple[int, int]]:
    """(M, C) of each of ResNet-50's 53 BatchNorm inputs, forward order."""
    return [(e["m"], e["c"]) for e in resnet50_layers(batch, img)
            if e["kind"] == "bn"]


def bn_stats_bytes(batch: int, img: int) -> int:
    """Bytes ``bn_stats`` must read in one pass over every BN of the
    tower: each (M, C) bf16 input once."""
    return sum(m * c * BF16_BYTES for m, c in bn_shapes(batch, img))


def bn_bwd_reduce_bytes(batch: int, img: int) -> int:
    """Bytes ``bn_bwd_reduce`` must read in one backward pass: x and dy,
    each (M, C) bf16, once."""
    return 2 * bn_stats_bytes(batch, img)


def _linear(rows: int, fin: int, fout: int) -> int:
    return 2 * rows * fin * fout


def _attention(b: int, nq: int, nk: int, d: int) -> int:
    """Scores and weighted sum of one attention over all heads."""
    return 2 * 2 * b * nq * nk * d


def image_tower_flops(batch: int, img: int) -> int:
    return sum(e["flops"] for e in resnet50_layers(batch, img)
               if e["kind"] == "conv")


def tabular_flops(batch: int, m: dict) -> int:
    """The tabular transformer: the continuous fields' Linear(1, d) and
    ``layers`` pre-norm blocks over F + 1 tokens (MLP ratio 4)."""
    d = m["tabular_embedding_dim"]
    n_con = sum(1 for x in m["field_lengths"] if int(x) == 1)
    t = len(m["field_lengths"]) + 1
    block = (_linear(batch * t, d, 3 * d) + _attention(batch, t, t, d)
             + _linear(batch * t, d, d) + _linear(batch * t, d, 4 * d)
             + _linear(batch * t, 4 * d, d))
    return (_linear(batch * n_con, 1, d)
            + m["tabular_transformer_num_layers"] * block)


def fusion_flops(batch: int, m: dict) -> int:
    """DisCoBackbone past the two encoders: the four disentangling
    projections, ``reduce``, the MI transformer layers (MLP ratio 1) and
    the three classifiers."""
    h = m["multimodal_embedding_dim"]
    d = m["tabular_embedding_dim"]
    c = m["num_classes"]
    n_i = stage4_size(m["img_size"]) ** 2
    f = len(m["field_lengths"])
    proj = (_linear(batch * n_i, IMAGE_DIM, h) + _linear(batch * n_i, h, h)
            + _linear(batch, IMAGE_DIM, h) + _linear(batch, h, h)
            + _linear(batch * f, d, h) + _linear(batch * f, h, h)
            + _linear(batch, d, h) + _linear(batch, h, h))
    tokens = n_i + f + 1
    layer = (_linear(batch * tokens, h, 3 * h)
             + _attention(batch, n_i, n_i, h) + _attention(batch, f, f, h)
             + _attention(batch, 1, tokens, h)
             + _linear(batch * tokens, h, h)
             + 2 * _linear(batch * tokens, h, h))
    heads = _linear(batch, 3 * h, c) + 2 * _linear(batch, 2 * h, c)
    return (proj + _linear(batch, 2 * h, h)
            + m["multimodal_transformer_num_layers"] * layer + heads)


def backbone_flops(batch: int, m: dict) -> int:
    """One forward of the backbone (image tower, tabular encoder,
    fusion, heads)."""
    return (image_tower_flops(batch, m["img_size"]) + tabular_flops(batch, m)
            + fusion_flops(batch, m))


def heads_flops(batch: int, m: dict, teacher: bool = False) -> int:
    """STiLNet's parts outside the backbone: the multimodal projector
    (SimCLR head 3h -> 3h -> p), and for the student the image and
    tabular projectors (linear for the DVM target, SimCLR heads else) and
    the two CLUB mean heads (h -> 512 -> h)."""
    h = m["multimodal_embedding_dim"]
    p = m["projection_dim"]
    out = _linear(batch, 3 * h, 3 * h) + _linear(batch, 3 * h, p)
    if teacher:
        return out
    if m["target"] == "dvm":
        out += 2 * _linear(batch, h, p)
    else:
        out += 2 * (_linear(batch, h, h) + _linear(batch, h, p))
    return out + 2 * (_linear(batch, h, 512) + _linear(batch, 512, h))


def stil_forward_flops(batch: int, m: dict) -> int:
    """STiLNet's forward (the student's, and the eval step's)."""
    return backbone_flops(batch, m) + heads_flops(batch, m)


def stil_step_flops(batch: int, m: dict) -> int:
    """One STiL train step: the student's forward and backward (3x its
    forward) and the EMA teacher's forward (backbone and multimodal
    projector)."""
    return (3 * stil_forward_flops(batch, m) + backbone_flops(batch, m)
            + heads_flops(batch, m, teacher=True))


def stats_pass_flops(batch: int, m: dict) -> int:
    """One batch of TTA's statistics pass: the image tower alone."""
    return image_tower_flops(batch, m["img_size"])


def tent_step_flops(batch: int, m: dict) -> int:
    """One Tent step: the backbone's forward, and a backward that only
    has to reach the BN affine parameters, counted as one more pass of
    the image tower (its input gradients; no conv weight gradient)."""
    return backbone_flops(batch, m) + image_tower_flops(batch, m["img_size"])


def score_flops(batch: int, m: dict) -> int:
    """One scoring batch: the eval step's full STiLNet forward."""
    return stil_forward_flops(batch, m)


def peaks() -> Dict[str, float]:
    return {"bf16_flops_per_s": PEAK_BF16_FLOPS,
            "hbm_bytes_per_s": PEAK_HBM_BYTES_PER_S}
