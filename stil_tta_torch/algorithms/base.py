"""Shared semi-supervised machinery, the port of the part of
``stil_tta_tpu/algorithms/base.py`` the ported algorithms use: the EMAN
teacher update, the distribution-alignment ring, pseudo-label
sharpening, the chunk loop of the micro-batched train steps, the seeded
weight init and the contrastive views of a train batch."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from stil_tta_torch.data.corrupt import corrupt_tabular
from stil_tta_torch.losses.common import at_least_f32
from stil_tta_torch.models.resnet import Conv2d
from stil_tta_torch.models.saint import SAINTEncoder

Tensor = torch.Tensor


@torch.no_grad()
def ema_update(ema: nn.Module, student: nn.Module, momentum: float,
               eman: bool = True) -> None:
    """EMAN teacher update (``STiLModel.py:154-168``), in place: every
    parameter of ``ema`` becomes ``e * momentum + (1 - momentum) * p``.
    With ``eman`` the BatchNorm running statistics are lerped the same way
    and the integer batch counters copied; without it the teacher's
    statistics stay as they are."""
    e_params = list(ema.parameters())
    s_params = list(student.parameters())
    if eman:
        e_bufs = dict(ema.named_buffers())
        for name, b in student.named_buffers():
            if name not in e_bufs:
                continue
            if b.is_floating_point():
                e_params.append(e_bufs[name])
                s_params.append(b)
            else:
                e_bufs[name].copy_(b)
    torch._foreach_mul_(e_params, momentum)
    torch._foreach_add_(e_params, s_params, alpha=1.0 - momentum)


@dataclasses.dataclass
class DAState:
    """Distribution-alignment queue (``STiLModel.py:100-104, 171-180``):
    a ring of ``length`` batch-mean class distributions and its write
    position, a 0-dim int64 tensor on the ring's device, so that a step
    writes and advances it on the device (and a captured step's replays
    keep doing so)."""

    queue: Tensor  # (L, C)
    ptr: Tensor    # () int64

    @classmethod
    def create(cls, num_classes: int, length: int = 256,
               dtype=torch.float32, device="cpu") -> "DAState":
        return cls(torch.zeros((length, num_classes), dtype=dtype,
                               device=device),
                   torch.zeros((), dtype=torch.long, device=device))

    def clone(self) -> "DAState":
        return DAState(self.queue.clone(), self.ptr.clone())

    def row(self, ptr: Tensor) -> Tensor:
        """The (C,) row of the ring at position ``ptr`` (a 0-dim tensor)."""
        return self.queue.index_select(0, ptr.view(1))[0]

    @torch.no_grad()
    def write(self, row: Tensor) -> None:
        """Put ``row`` into the slot at the write position and advance it,
        in place on the device."""
        self.queue.index_copy_(0, self.ptr.view(1),
                               row.view(1, -1).to(self.queue.dtype))
        self.ptr.add_(1).remainder_(self.queue.shape[0])


class EpochScalars:
    """The scalars a train step reads for its epoch (loss gates, a
    schedule's weights) as 0-dim device tensors, so that a captured
    step's replays read the epoch's values (``train/multistep.py``).
    :meth:`fill` writes them, and only when they change."""

    def __init__(self, names: Iterable[str], dtype: torch.dtype, device):
        self.tensors = {k: torch.zeros((), dtype=dtype, device=device)
                        for k in names}
        self._filled: Optional[Dict[str, float]] = None

    def fill(self, values: Dict[str, float]) -> Dict[str, Tensor]:
        """Write ``values`` into :attr:`tensors` in place and return
        them; raises when they change inside a CUDA graph capture (the
        dispatcher fills them before its replays)."""
        if values != self._filled:
            if torch.cuda.is_available() and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError("set_epoch: the epoch's values change "
                                   "inside a CUDA graph capture")
            for k, v in values.items():
                self.tensors[k].fill_(v)
            self._filled = dict(values)
        return self.tensors


def distribution_alignment(da: DAState, probs: Tensor
                           ) -> Tuple[DAState, Tensor]:
    """Put the batch mean of ``probs`` into the ring (in place: ``da`` is
    written and advanced), divide ``probs`` by the ring's mean and
    renormalise. Returns ``da`` and the detached aligned probabilities; a
    caller that must keep the ring as it was aligns against
    ``da.clone()``."""
    probs = probs.detach()
    da.write(probs.mean(0))
    aligned = probs / da.queue.mean(0).clamp_min(1e-12)
    aligned = aligned / aligned.sum(1, keepdim=True)
    return da, aligned


def sharpen(logits: Tensor, temperature: float) -> Tensor:
    """``STiLModel.py:195-196``: softmax of the detached logits over T."""
    return torch.softmax(at_least_f32(logits.detach()) / temperature, dim=1)


def accumulate_chunks(optimizer: torch.optim.Optimizer, m: int,
                      chunk: Callable[..., Tensor], *batched: Tensor) -> None:
    """The chunk loop of a micro-batched train step (``micro_batches:
    m``; the JAX package's ``step_micro`` scans it): cut each tensor of
    ``batched`` along its first axis into ``m`` equal chunks, in order;
    for each chunk call ``chunk(*its_parts)``, which returns the chunk's
    loss, and back-propagate that loss, so the gradients add up in
    ``.grad``. Leaves the mean of the ``m`` chunk gradients in ``.grad``;
    the caller then steps the optimizer once. ``m`` must divide every
    first axis, as the JAX step asserts."""
    for t in batched:
        if t.shape[0] % m:
            raise ValueError(f"micro_batches={m} must divide the batch "
                             f"sizes, got {[b.shape[0] for b in batched]}")
    optimizer.zero_grad(set_to_none=True)
    for parts in zip(*(t.chunk(m) for t in batched)):
        chunk(*parts).backward()
    grads = [p.grad for group in optimizer.param_groups
             for p in group["params"] if p.grad is not None]
    torch._foreach_div_(grads, float(m))


@torch.no_grad()
def init_weights(net: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights in the JAX package's init families: convs
    kaiming-normal (fan_out, ReLU), dense layers truncated-normal with
    std sqrt(1/fan_in) (SAINT's stacked per-column MLPs too), embeddings
    and tokens truncated-normal std 0.02, biases zero, BatchNorm scale 1 /
    shift 0; a ViT's patch embedding truncated-normal std
    sqrt(1/fan_in) with a zero bias, its position embedding std 0.02.
    ``generator`` lives on the weights' device."""
    def normal_(t: Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator,
                            device=t.device).clamp_(-2.0, 2.0) * std)

    for mod in net.modules():
        if isinstance(mod, Conv2d):
            cout, _, kh, kw = mod.weight.shape
            mod.weight.copy_(torch.randn(
                mod.weight.shape, generator=generator,
                device=mod.weight.device) * math.sqrt(2.0 / (cout * kh * kw)))
        elif isinstance(mod, nn.Conv2d):     # ViT's patch_embed
            normal_(mod.weight, math.sqrt(1.0 / mod.weight[0].numel()))
            mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            normal_(mod.weight, math.sqrt(1.0 / mod.in_features))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 0.02)
        elif isinstance(mod, SAINTEncoder):
            normal_(mod.con_mlp_w1, 1.0)
            normal_(mod.con_mlp_w2, math.sqrt(1.0 / mod.con_mlp_w2.shape[1]))
            mod.con_mlp_b1.zero_()
            mod.con_mlp_b2.zero_()
    for name, p in net.named_parameters():
        if name.endswith(("cls_token", "mask_special_token", "pos_embed")):
            normal_(p, 0.02)


def draw_views(cfg, aug_train, gen: torch.Generator, bl: dict, bu: dict,
               marg_l: Tensor, marg_u: Tensor):
    """Augmented image view and corrupted tabular view of each stream
    (``ContrastiveImagingAndTabularDataset.__getitem__``: the image is
    augmented with probability augmentation_rate, the row corrupted at
    corruption_rate), drawn from ``gen``: (img_l, tab_l, img_u, tab_u)."""
    rate = float(cfg.augmentation_rate)
    crate = float(cfg.corruption_rate)
    img_l = aug_train(gen, bl["images"], rate)
    img_u = aug_train(gen, bu["images"], rate)
    tab_l = corrupt_tabular(gen, bl["tabular"], marg_l, crate)
    tab_u = corrupt_tabular(gen, bu["tabular"], marg_u, crate)
    return img_l, tab_l, img_u, tab_u
