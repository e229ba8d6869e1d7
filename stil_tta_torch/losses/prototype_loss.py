"""Prototype clustering loss of PGLS, the port of
``stil_tta_tpu/losses/prototype_loss.py``: softmax of feat @ prototypes.T
/ T, log, cross entropy against the hard argmax of the soft label, masked
to confident rows (max prob >= threshold), mean over all rows."""

from __future__ import annotations

import torch

from stil_tta_torch.losses.common import at_least_f32

Tensor = torch.Tensor


def prototype_loss(label: Tensor, prototypes: Tensor, feat: Tensor,
                   temperature: float, threshold: float) -> Tensor:
    label = at_least_f32(label)
    sim = (at_least_f32(feat) @ at_least_f32(prototypes).T) / temperature
    log_sim = torch.log(torch.softmax(sim, dim=1) + 1e-7)
    max_id = label.argmax(dim=1)
    conf = (label.amax(dim=1) >= threshold).to(log_sim.dtype)
    picked = log_sim.gather(1, max_id[:, None])[:, 0]
    return (-picked * conf).mean()
