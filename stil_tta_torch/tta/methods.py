"""Test-time adaptation strategies EATA and SAR: the port of
``stil_tta_tpu/tta/methods.py``.

- ``eata`` (Niu et al., ICML 2022): entropy minimisation restricted to
  reliable (entropy below ``tta_e_margin_scale * ln C``) and novel
  (|cosine| to the running mean of earlier selected predictions below
  ``tta_d_margin``) samples, weighted by the detached ``exp(E0 − e)``,
  plus an optional Fisher-weighted anchor to the starting parameters
  (``tta_fisher_alpha > 0``, the Fisher of the pseudo-label cross
  entropy over the first ``tta_fisher_samples`` test samples).
- ``sar`` (Niu et al., ICLR 2023): the reliable filter and a SAM two-step
  update (ascend ``tta_sam_rho`` along the normalised gradient, take the
  gradient there on the samples that stay reliable, apply it at the
  unperturbed point), with the model-recovery reset to the starting
  parameters and a fresh Adam when the smoothed loss falls below
  ``tta_reset_constant``.

Both run after the shared BN-statistics phase, in eval mode, with Adam
(``tta_lr``, optax's Adam semantics: ``train/optim.py``) on the BatchNorm
affine parameters only. Where the JAX package folds SAR's EMA and reset
into its jitted step with ``where``, the port decides them on the host
after each step; the values are the same.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stil_tta_torch.train import optim
from stil_tta_torch.train.optim import build_optimizer
from stil_tta_torch.tta.tent import (bn_affine_only, head_logits, knob,
                                     tta_batches)

Tensor = torch.Tensor
Batch = Tuple[Tensor, Tensor, Optional[Tensor]]


def eata_sample_weights(ent: Tensor, e_margin: float, sel: Tensor) -> Tensor:
    """EATA per-sample weights ``exp(E0 − e)`` over the selected mask.
    The weight is detached, as official EATA's ``entropys.detach()``:
    otherwise ``d/dθ[e·exp(E0−e)]`` flips sign for e > 1 nat."""
    return torch.exp(e_margin - ent).detach() * sel


def _common(cfg, algo, cache: dict):
    """The logits function, the batch iterator (a fresh permutation for
    each adaptation epoch), the entropy margin and the class count."""
    num_classes = int(cfg.num_classes)
    e_margin = (float(knob(cfg.tta_e_margin_scale, 0.4))
                * float(np.log(num_classes)))

    def logits_fn(images, tabular, missing) -> Tensor:
        return head_logits(algo, images, tabular, missing)

    def batches(seed: int = 0) -> Iterator[Batch]:
        return tta_batches(cache, int(cfg.batch_size), seed=seed)

    return logits_fn, batches, e_margin, num_classes


def _entropies(logits: Tensor) -> Tuple[Tensor, Tensor]:
    """(probs, entropy) from log-softmax, as the JAX methods form them."""
    logp = F.log_softmax(logits, dim=-1)
    probs = torch.exp(logp)
    return probs, -torch.sum(probs * logp, dim=-1)


def _fisher(logits_fn: Callable, batches: Callable, params: list,
            budget: int) -> List[Tensor]:
    """Diagonal Fisher of the pseudo-label cross entropy at the current
    parameters, averaged over the first batches until ``budget`` samples
    are seen (EATA eq. 1-2)."""
    acc = [torch.zeros_like(p) for p in params]
    seen = used = 0
    for images, tabular, missing in batches():
        logits = logits_fn(images, tabular, missing)
        labels = logits.detach().argmax(dim=1)
        ce = -F.log_softmax(logits, dim=1).gather(1, labels[:, None]).mean()
        grads = torch.autograd.grad(ce, params)
        acc = [a + g * g for a, g in zip(acc, grads)]
        used += 1
        seen += int(images.shape[0])
        if seen >= budget:
            break
    return [a / max(used, 1) for a in acc]


def eata_adapt(cfg, algo, cache: dict) -> Dict[str, int]:
    """EATA phase 2 (after BN-stat re-estimation); returns the steps and
    the samples selected over them."""
    logits_fn, batches, e_margin, num_classes = _common(cfg, algo, cache)
    d_margin = float(knob(cfg.tta_d_margin, 0.05))
    fisher_alpha = float(knob(cfg.tta_fisher_alpha, 0.0))
    steps = 0
    with bn_affine_only(algo.net) as params:
        opt = build_optimizer(params, float(knob(cfg.tta_lr, 1e-4)))
        params0 = [p.detach().clone() for p in params]
        fisher = None
        if fisher_alpha > 0.0:
            fisher = _fisher(logits_fn, batches, params,
                             int(knob(cfg.tta_fisher_samples, 2000)))
        dev = params[0].device
        probs_ema = torch.zeros(num_classes, dtype=torch.float32, device=dev)
        ema_valid = torch.zeros((), dtype=torch.bool, device=dev)
        n_sel = torch.zeros((), dtype=torch.long, device=dev)
        for ep in range(int(knob(cfg.tta_steps, 1))):
            for images, tabular, missing in batches(seed=ep):
                probs, ent = _entropies(logits_fn(images, tabular, missing))
                reliable = ent < e_margin
                # redundancy filter: cosine similarity of the prediction
                # to the running mean of earlier selected predictions
                pd = probs.detach()
                cos = ((pd * probs_ema[None, :]).sum(-1)
                       / (torch.linalg.norm(pd, dim=-1)
                          * torch.linalg.norm(probs_ema) + 1e-12))
                novel = torch.where(ema_valid, cos.abs() < d_margin, True)
                sel = reliable & novel
                w = eata_sample_weights(ent, e_margin, sel)
                loss = torch.sum(ent * w) / sel.sum().clamp_min(1)
                if fisher is not None:
                    loss = loss + fisher_alpha * sum(
                        torch.sum(f * (p - p0) ** 2)
                        for f, p, p0 in zip(fisher, params, params0))
                opt.zero_grad(set_to_none=True)
                loss.backward()
                optim.step(opt)
                # running mean of selected predictions (0.9/0.1 EMA, held
                # when a batch selects nothing)
                nsel = sel.sum()
                batch_mean = ((pd * sel[:, None]).sum(0)
                              / nsel.clamp_min(1))
                new_ema = torch.where(ema_valid,
                                      0.9 * probs_ema + 0.1 * batch_mean,
                                      batch_mean)
                probs_ema = torch.where(nsel > 0, new_ema, probs_ema)
                ema_valid = ema_valid | (nsel > 0)
                n_sel += nsel
                steps += 1
    return {"steps": steps, "selected": int(n_sel)}


def sar_adapt(cfg, algo, cache: dict) -> Dict[str, int]:
    """SAR phase 2 (after BN-stat re-estimation); returns the steps, the
    samples the second filter kept over them, and the recovery resets."""
    logits_fn, batches, e_margin, _ = _common(cfg, algo, cache)
    rho = float(knob(cfg.tta_sam_rho, 0.05))
    reset_constant = float(knob(cfg.tta_reset_constant, 0.2))
    steps = selected = resets = 0

    def filtered_entropy(images, tabular, missing):
        _, ent = _entropies(logits_fn(images, tabular, missing))
        sel = ent < e_margin
        return torch.sum(ent * sel) / sel.sum().clamp_min(1), ent, sel

    with bn_affine_only(algo.net) as params:
        opt = build_optimizer(params, float(knob(cfg.tta_lr, 1e-4)))
        params0 = [p.detach().clone() for p in params]
        ema_loss = torch.zeros((), dtype=torch.float32)
        ema_valid = False
        for ep in range(int(knob(cfg.tta_steps, 1))):
            for images, tabular, missing in batches(seed=ep):
                # first step: ascend to the sharpness point along the
                # gradient, normalised by its global norm
                loss1, _, sel = filtered_entropy(images, tabular, missing)
                g1 = torch.autograd.grad(loss1, params)
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in g1))
                at = [p.detach().clone() for p in params]
                with torch.no_grad():
                    for p, g in zip(params, g1):
                        p.add_(rho * g / (gnorm + 1e-12))
                # second step: the gradient at the perturbed point,
                # re-filtering on the perturbed entropies (SAR's
                # filter_ids_2), applied at the unperturbed point
                _, ent2, _ = filtered_entropy(images, tabular, missing)
                sel2 = sel & (ent2 < e_margin)
                loss2 = torch.sum(ent2 * sel2) / sel2.sum().clamp_min(1)
                g2 = torch.autograd.grad(loss2, params)
                with torch.no_grad():
                    for p, a, g in zip(params, at, g2):
                        p.copy_(a)
                        p.grad = g
                optim.step(opt)
                steps += 1
                # the EMA only tracks batches whose second filter selected
                # something: an empty sel2 makes loss2 an artificial 0
                n2 = int(sel2.sum())
                selected += n2
                loss2 = loss2.detach().float().cpu()
                if bool(torch.isfinite(loss2)) and n2 > 0:
                    ema_loss = (0.9 * ema_loss + 0.1 * loss2 if ema_valid
                                else loss2)
                    ema_valid = True
                # model recovery (paper section 3.3): a collapsed model
                # drives the smoothed loss towards zero
                if ema_valid and float(ema_loss) < reset_constant:
                    with torch.no_grad():
                        for p, p0 in zip(params, params0):
                            p.copy_(p0)
                    opt.state.clear()
                    ema_loss = torch.zeros((), dtype=torch.float32)
                    ema_valid = False
                    resets += 1
    return {"steps": steps, "selected": selected, "resets": resets}
