"""STiL's network in plain PyTorch: the benchmark's reference.

A frozen copy of the published architecture as the port lays it out
(ResNet-50 image tower, BERT-style tabular transformer, the
disentangling projections, the MI fusion layer, three heads, the ITC
projectors and the CLUB mean heads), with the same parameter names, so
one state dict made by the benchmark loads into both sides. It imports
nothing of the program: BatchNorm is ``F.batch_norm``, every product is a
plain ``conv2d`` / ``linear`` / ``matmul``, and everything computes in
float32 (TF32 off, set by the caller).

``Precision("fp8")`` is the control: every operand of a convolution,
linear layer and attention product, every input of a BatchNorm or a
LayerNorm and a BatchNorm's per-channel constants (mean, scale, shift)
are rounded to float8 e4m3 with one scale a tensor (its absolute maximum
at 448) before the operation, which then runs in float32; the backward
passes straight through the rounding. So the control holds in float8
what the program holds in bfloat16.

Dropout and stochastic depth draw ``torch.rand`` from the device's
default generator, call for call in the order of the port's forward, so
a reference step given the same generator state draws the same masks.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor
FP8_MAX = 448.0


class Precision:
    """How the products' operands are rounded: ``"f32"`` not at all,
    ``"fp8"`` to float8 e4m3 with a per-tensor scale (straight-through
    in the backward)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def __call__(self, x: Tensor) -> Tensor:
        x = x.float()
        if self.mode == "f32":
            return x
        with torch.no_grad():
            scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
            q = (x / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x).detach()


F32 = Precision("f32")


def dropout(x: Tensor, rate: float, training: bool) -> Tensor:
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(tuple(x.shape), device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def drop_path(x: Tensor, rate: float, training: bool) -> Tensor:
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.floor(keep + torch.rand(shape, device=x.device))
    return (x / keep) * mask


class Linear(nn.Linear):
    def __init__(self, fin: int, fout: int, bias: bool = True,
                 prec: Precision = F32):
        super().__init__(fin, fout, bias=bias)
        self.prec = prec

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(self.prec(x), self.prec(self.weight),
                        None if self.bias is None else self.bias.float())


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim: int, prec: Precision = F32):
        super().__init__(dim, eps=1e-5)
        self.prec = prec

    def forward(self, x: Tensor) -> Tensor:
        return F.layer_norm(self.prec(x), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class Conv2d(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, prec: Precision = F32):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         bias=False)
        self.prec = prec

    def forward(self, x: Tensor) -> Tensor:
        return F.conv2d(self.prec(x), self.prec(self.weight), None,
                        self.stride, self.padding)


class BatchNorm2d(nn.Module):
    """torch's BatchNorm (eps 1e-5, momentum 0.1 on the new value,
    Bessel's correction on the running variance) by ``F.batch_norm``."""

    def __init__(self, c: int, prec: Precision = F32):
        super().__init__()
        self.prec = prec
        self.momentum = 0.1
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: Tensor) -> Tensor:
        if self.training:
            self.num_batches_tracked.add_(1)
        if self.prec.mode == "f32":
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, self.training,
                                self.momentum, 1e-5)
        # the control: the input and the normalisation's per-channel
        # constants rounded, as the program rounds them to its dtype
        x = self.prec(x)
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var * (n / max(n - 1, 1)),
                                       self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.prec(torch.rsqrt(var + 1e-5) * self.weight)
        col = lambda t: t.view(1, -1, 1, 1)  # noqa: E731
        return ((x - col(self.prec(mean))) * col(mul)
                + col(self.prec(self.bias)))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, down: bool,
                 prec: Precision):
        super().__init__()
        out = planes * 4
        self.conv1 = Conv2d(cin, planes, 1, prec=prec)
        self.bn1 = BatchNorm2d(planes, prec)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, prec=prec)
        self.bn2 = BatchNorm2d(planes, prec)
        self.conv3 = Conv2d(planes, out, 1, prec=prec)
        self.bn3 = BatchNorm2d(out, prec)
        self.downsample = (nn.Sequential(Conv2d(cin, out, 1, stride,
                                                prec=prec),
                                         BatchNorm2d(out, prec))
                           if down else None)

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idn)


class ResNet50(nn.Module):
    """NHWC images in, the stage-4 map (B, C, H, W) out."""

    def __init__(self, prec: Precision):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, prec=prec)
        self.bn1 = BatchNorm2d(64, prec)
        cin = 64
        for i, (planes, blocks) in enumerate(((64, 3), (128, 4), (256, 6),
                                              (512, 3))):
            mods = []
            for b in range(blocks):
                s = 2 if (i > 0 and b == 0) else 1
                mods.append(Bottleneck(cin, planes, s, b == 0, prec))
                cin = planes * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*mods))

    def forward(self, x: Tensor) -> Tensor:
        x = x.float().permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return x


def split_heads(x: Tensor, h: int) -> Tensor:
    b, n, c = x.shape
    return x.reshape(b, n, h, c // h).transpose(1, 2)


def merge_heads(x: Tensor) -> Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def attention(q, k, v, scale: float, prec: Precision, drop: float,
              training: bool) -> Tensor:
    attn = torch.softmax((prec(q) @ prec(k).transpose(-1, -2)) * scale, -1)
    return prec(dropout(attn, drop, training)) @ prec(v)


class Mlp(nn.Module):
    def __init__(self, din: int, hidden: int, dout: int, drop: float,
                 prec: Precision):
        super().__init__()
        self.fc1 = Linear(din, hidden, prec=prec)
        self.fc2 = Linear(hidden, dout, prec=prec)
        self.drop = drop

    def forward(self, x: Tensor) -> Tensor:
        x = dropout(F.gelu(self.fc1(x)), self.drop, self.training)
        return dropout(self.fc2(x), self.drop, self.training)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, qkv_bias: bool, drop: float,
                 prec: Precision):
        super().__init__()
        self.heads, self.scale, self.prec = heads, (dim // heads) ** -0.5, prec
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, prec=prec)
        self.proj = Linear(dim, dim, prec=prec)
        self.drop = drop

    def forward(self, x: Tensor) -> Tensor:
        q, k, v = (split_heads(t, self.heads)
                   for t in self.qkv(x).chunk(3, dim=-1))
        out = attention(q, k, v, self.scale, self.prec, 0.0, self.training)
        return dropout(self.proj(merge_heads(out)), self.drop, self.training)


class Block(nn.Module):
    def __init__(self, dim: int, drop: float, prec: Precision):
        super().__init__()
        self.norm1 = LayerNorm(dim, prec)
        self.attn = Attention(dim, 8, False, drop, prec)
        self.norm2 = LayerNorm(dim, prec)
        self.mlp = Mlp(dim, 4 * dim, dim, drop, prec)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class TabularTransformer(nn.Module):
    """Rows (B, F) with the categorical columns first -> (B, F+1, d)."""

    def __init__(self, field_lengths: Sequence[int], d: int, layers: int,
                 drop: float, prec: Precision):
        super().__init__()
        cat = [int(x) for x in field_lengths if int(x) > 1]
        self.num_cat = len(cat)
        self.num_con = sum(1 for x in field_lengths if int(x) == 1)
        lengths = torch.tensor(cat, dtype=torch.long)
        self.register_buffer("cat_lengths", lengths, persistent=False)
        self.register_buffer("cat_offsets", torch.cumsum(lengths, 0)
                             - lengths, persistent=False)
        self.cat_embedding = nn.Embedding(sum(cat), d)
        self.con_proj = Linear(1, d, prec=prec)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.mask_special_token = nn.Parameter(torch.zeros(1, 1, d))
        self.column_embedding = nn.Embedding(self.num_cat + self.num_con + 1,
                                             d)
        self.norm = LayerNorm(d, prec)
        self.transformer_blocks = nn.ModuleList(
            Block(d, drop, prec) for _ in range(layers))

    def forward(self, x: Tensor) -> Tensor:
        cat = torch.minimum(x[:, :self.num_cat].long().clamp_min(0),
                            self.cat_lengths - 1)
        parts = [self.cat_embedding(cat + self.cat_offsets),
                 self.con_proj(x[:, self.num_cat:].float()[..., None])]
        tokens = torch.cat(parts, dim=1)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + \
            self.column_embedding.weight[None]
        tokens = self.norm(tokens)
        for block in self.transformer_blocks:
            tokens = block(tokens)
        return tokens


class MLPHead(nn.Module):
    def __init__(self, din: int, hidden: int, dout: int, prec: Precision):
        super().__init__()
        self.model = nn.Sequential(Linear(din, hidden, prec=prec), nn.ReLU(),
                                   Linear(hidden, dout, prec=prec))

    def forward(self, x: Tensor) -> Tensor:
        return self.model(x)


class SimCLRHead(nn.Module):
    def __init__(self, din: int, hidden: int, dout: int, prec: Precision):
        super().__init__()
        self.layers = nn.Sequential(Linear(din, hidden, prec=prec), nn.ReLU(),
                                    Linear(hidden, dout, prec=prec))

    def forward(self, x: Tensor) -> Tensor:
        return self.layers(x)


class MIAttention(nn.Module):
    def __init__(self, dim: int, prec: Precision):
        super().__init__()
        self.heads, self.scale, self.prec = 4, (dim // 4) ** -0.5, prec
        self.qkv = Linear(dim, 3 * dim, prec=prec)
        self.proj = Linear(dim, dim, prec=prec)

    def forward(self, x_img, x_tab, x_glob):
        (q_i, k_i, v_i), (q_t, k_t, v_t), (q_g, k_g, v_g) = (
            [split_heads(t, self.heads) for t in self.qkv(x).chunk(3, -1)]
            for x in (x_img, x_tab, x_glob))
        tr = self.training

        def att(q, k, v):
            return attention(q, k, v, self.scale, self.prec, 0.1, tr)

        outs = (att(q_i, k_i, v_i), att(q_t, k_t, v_t),
                att(q_g, torch.cat([k_g, k_i, k_t], dim=2),
                    torch.cat([v_g, v_i, v_t], dim=2)))
        return tuple(dropout(self.proj(merge_heads(o)), 0.1, tr)
                     for o in outs)


class MILayer(nn.Module):
    """Shared norms and MLP over the three streams; DropPath 0.1."""

    def __init__(self, dim: int, prec: Precision):
        super().__init__()
        self.norm1 = LayerNorm(dim, prec)
        self.norm2 = LayerNorm(dim, prec)
        self.mlp = Mlp(dim, dim, dim, 0.1, prec)
        self.attn = MIAttention(dim, prec)

    def forward(self, x_img, x_tab, x_glob):
        tr = self.training
        attn = self.attn(self.norm1(x_img), self.norm1(x_tab),
                         self.norm1(x_glob))
        xs = [x + drop_path(a, 0.1, tr)
              for x, a in zip((x_img, x_tab, x_glob), attn)]
        return tuple(x + drop_path(self.mlp(self.norm2(x)), 0.1, tr)
                     for x in xs)


class Backbone(nn.Module):
    """STiL's disentangled backbone; ``forward`` returns the port's
    output dict (``out_m``, ``out_i``, ``out_t`` and the features)."""

    def __init__(self, m: dict, prec: Precision):
        super().__init__()
        h, d, c = (m["multimodal_embedding_dim"], m["tabular_embedding_dim"],
                   m["num_classes"])
        self.encoder_imaging = ResNet50(prec)
        self.encoder_tabular = TabularTransformer(
            m["field_lengths"], d, m["tabular_transformer_num_layers"],
            m.get("drop_rate", 0.0), prec)
        self.projection_si = MLPHead(2048, h, h, prec)
        self.projection_ai = MLPHead(2048, h, h, prec)
        self.projection_st = MLPHead(d, h, h, prec)
        self.projection_at = MLPHead(d, h, h, prec)
        self.reduce = Linear(2 * h, h, prec=prec)
        self.transformer = nn.ModuleList(
            MILayer(h, prec)
            for _ in range(m["multimodal_transformer_num_layers"]))
        self.classifier_multimodal = Linear(3 * h, c, prec=prec)
        self.classifier_imaging = Linear(2 * h, c, prec=prec)
        self.classifier_tabular = Linear(2 * h, c, prec=prec)

    def forward(self, image: Tensor, tabular: Tensor) -> Dict[str, Tensor]:
        fmap = self.encoder_imaging(image)
        b, c = fmap.shape[:2]
        x_i = fmap.permute(0, 2, 3, 1).reshape(b, -1, c)
        x_t = self.encoder_tabular(tabular)
        x_si, x_ai = self.projection_si(x_i), self.projection_ai(x_i.mean(1))
        x_st = self.projection_st(x_t[:, 1:])
        x_at = self.projection_at(x_t[:, 0])
        si_pool, st_pool = x_si.mean(1), x_st.mean(1)
        x_c = self.reduce(torch.cat([x_ai, x_at], dim=1))[:, None]
        for block in self.transformer:
            x_si, x_st, x_c = block(x_si, x_st, x_c)
        si_enh, st_enh, x_c = x_si.mean(1), x_st.mean(1), x_c.mean(1)
        return {
            "out_m": self.classifier_multimodal(
                torch.cat([si_enh, x_c, st_enh], dim=1)),
            "out_i": self.classifier_imaging(torch.cat([si_enh, x_ai], 1)),
            "out_t": self.classifier_tabular(torch.cat([st_enh, x_at], 1)),
            "x_si_enhance": si_enh, "x_si": si_pool, "x_ai": x_ai,
            "x_st_enhance": st_enh, "x_st": st_pool, "x_at": x_at,
            "x_c": x_c,
        }


class CLUBMean(nn.Module):
    def __init__(self, h: int, prec: Precision):
        super().__init__()
        self.p_mu = nn.Sequential(Linear(h, 512, prec=prec), nn.ReLU(),
                                  Linear(512, h, prec=prec))

    def forward(self, x: Tensor) -> Tensor:
        return self.p_mu(x)


def l2norm(x: Tensor) -> Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


class STiLNet(nn.Module):
    """Backbone, ITC projectors (linear for the DVM target, SimCLR heads
    else) and CLUB mean heads, with the port's parameter names."""

    def __init__(self, m: dict, prec: Precision = F32):
        super().__init__()
        h, p = m["multimodal_embedding_dim"], m["projection_dim"]
        self.model = Backbone(m, prec)
        self.projector_multimodal = SimCLRHead(3 * h, 3 * h, p, prec)
        if m["target"] == "dvm":
            self.projector_imaging = Linear(h, p, prec=prec)
            self.projector_tabular = Linear(h, p, prec=prec)
        else:
            self.projector_imaging = SimCLRHead(h, h, p, prec)
            self.projector_tabular = SimCLRHead(h, h, p, prec)
        self.CLUB_imaging = CLUBMean(h, prec)
        self.CLUB_tabular = CLUBMean(h, prec)

    def features(self, out: Dict[str, Tensor]) -> Tensor:
        return l2norm(self.projector_multimodal(torch.cat(
            [out["x_si_enhance"], out["x_c"], out["x_st_enhance"]], 1)))

    def forward(self, image: Tensor, tabular: Tensor) -> Dict[str, Tensor]:
        out = self.model(image, tabular)
        out["feat_m"] = self.features(out)
        out["feat_i"] = l2norm(self.projector_imaging(out["x_ai"]))
        out["feat_t"] = l2norm(self.projector_tabular(out["x_at"]))
        out["mu_i"] = self.CLUB_imaging(out["x_si"])
        out["mu_t"] = self.CLUB_tabular(out["x_st"])
        return out


def build(m: dict, device, mode: str = "f32",
          state: Optional[Dict[str, Tensor]] = None) -> STiLNet:
    """The reference net on ``device`` in float32, loaded from
    ``state`` (the benchmark's weights) when given."""
    net = STiLNet(m, Precision(mode)).to(device)
    if state is not None:
        net.load_state_dict(state, strict=True)
    return net


def init_scale(name: str, shape) -> float:
    """The standard deviation of a weight's init family, by its name and
    shape: convs kaiming-normal (fan out, ReLU); dense weights sqrt(1 /
    fan in); embeddings and tokens 0.02; biases and BN shifts 0, BN scales
    1 (constants, returned as negative: -1 for one, 0 for zero)."""
    if name.endswith(("cls_token", "mask_special_token")) or \
            "embedding" in name.split(".")[-2:][0]:
        return 0.02
    if len(shape) == 4:
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if len(shape) == 2:
        return math.sqrt(1.0 / shape[1])
    return 0.0
