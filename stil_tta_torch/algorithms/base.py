"""Shared semi-supervised machinery, the port of the part of
``stil_tta_tpu/algorithms/base.py`` STiL uses: the EMAN teacher update,
the distribution-alignment ring, pseudo-label sharpening, and the chunk
loop of the micro-batched train steps."""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
from torch import nn

from stil_tta_torch.losses.common import at_least_f32

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
    position."""

    queue: Tensor  # (L, C)
    ptr: int

    @classmethod
    def create(cls, num_classes: int, length: int = 256,
               dtype=torch.float32, device="cpu") -> "DAState":
        return cls(torch.zeros((length, num_classes), dtype=dtype,
                               device=device), 0)


def distribution_alignment(da: DAState, probs: Tensor
                           ) -> Tuple[DAState, Tensor]:
    """Put the batch mean of ``probs`` into the ring, divide ``probs`` by
    the ring's mean and renormalise. Returns the new state (the old one is
    not modified) and the detached aligned probabilities."""
    probs = probs.detach()
    queue = da.queue.clone()
    queue[da.ptr] = probs.mean(0).to(queue.dtype)
    aligned = probs / queue.mean(0).clamp_min(1e-12)
    aligned = aligned / aligned.sum(1, keepdim=True)
    return DAState(queue, (da.ptr + 1) % queue.shape[0]), aligned


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
