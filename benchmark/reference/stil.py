"""STiL's train step, its eval forward and Tent adaptation in plain
PyTorch: the benchmark's reference for the train and TTA cells.

The step follows the published method in the port's order of operations
(``STiLModel.py:228-386``): the student's train-mode forward on the
concatenated labelled and unlabelled views, the EMAN lerp of the EMA
backbone, the teacher's forward, the consensus (CGPL) and prototype
(PGLS) targets, the losses, the backward and a float32 ``torch.optim.Adam``
step in which a parameter the loss did not reach takes a zero gradient.
Tent re-estimates the BatchNorm statistics over a split in one momentum
sweep of the image tower, then minimises the multimodal head's mean
entropy with Adam on the BatchNorm affine parameters, the net in eval
mode. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from reference import augment
from reference.nets import BatchNorm2d, STiLNet

Tensor = torch.Tensor


def cross_entropy(logits: Tensor, labels: Tensor,
                  reduction: str = "mean") -> Tensor:
    nll = -torch.log_softmax(logits.float(), -1).gather(
        -1, labels.long()[:, None])[:, 0]
    return nll.mean() if reduction == "mean" else nll


def soft_cross_entropy(logits: Tensor, target: Tensor) -> Tensor:
    return -(target.float() * torch.log_softmax(logits.float(), -1)).sum(-1)


def clip_loss(a: Tensor, b: Tensor, temperature: float, lam: float) -> Tensor:
    a = a / a.norm(dim=1, keepdim=True).clamp_min(1e-12)
    b = b / b.norm(dim=1, keepdim=True).clamp_min(1e-12)
    logits = (a @ b.T) / temperature
    labels = torch.arange(a.shape[0], device=a.device)
    return (lam * cross_entropy(logits, labels)
            + (1.0 - lam) * cross_entropy(logits.T, labels))


def club_losses(mu: Tensor, y: Tensor):
    positive = -((mu - y) ** 2).sum(-1) / 2.0
    negative = -((y ** 2).sum(-1).mean() - 2.0 * (mu @ y.mean(0))
                 + (mu ** 2).sum(-1)) / 2.0
    return (positive - negative).mean(), ((mu - y) ** 2).sum(1).mean()


def prototype_loss(label: Tensor, prototypes: Tensor, feat: Tensor,
                   temperature: float, threshold: float) -> Tensor:
    log_sim = torch.log(torch.softmax(feat @ prototypes.T / temperature, 1)
                        + 1e-7)
    conf = (label.amax(1) >= threshold).float()
    picked = log_sim.gather(1, label.argmax(1)[:, None])[:, 0]
    return (-picked * conf).mean()


def sharpen(logits: Tensor, temperature: float) -> Tensor:
    return torch.softmax(logits.detach().float() / temperature, dim=1)


class Trainer:
    """A reference STiL run: the student ``net``, its EMA backbone
    ``ema``, the prototypes and a float32 Adam at ``lr``."""

    def __init__(self, cfg: dict, net: STiLNet, ema, lr: float):
        self.cfg, self.net, self.ema = cfg, net, ema.eval()
        self.ema.requires_grad_(False)
        c, p = cfg["num_classes"], cfg["projection_dim"]
        dev = next(net.parameters()).device
        self.prototypes = torch.zeros((c, p), device=dev)
        self.opt = torch.optim.Adam(
            net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=float(cfg["weight_decay_eval"]))
        self.aug = augment.contrastive_pipeline(
            cfg["img_size"], cfg["target"], float(cfg["crop_scale_lower"]))

    @torch.no_grad()
    def ema_update(self) -> None:
        m = float(self.cfg["ema_momentum"])
        e_params = list(self.ema.parameters())
        s_params = list(self.net.model.parameters())
        e_bufs = dict(self.ema.named_buffers())
        for name, b in self.net.model.named_buffers():
            if name in e_bufs:
                if b.is_floating_point():
                    e_params.append(e_bufs[name])
                    s_params.append(b)
                else:
                    e_bufs[name].copy_(b)
        torch._foreach_mul_(e_params, m)
        torch._foreach_add_(e_params, s_params, alpha=1.0 - m)

    def step(self, cache_l: dict, cache_u: dict, idx_l: Tensor,
             idx_u: Tensor, gen: torch.Generator, use_pseudo: float
             ) -> Tensor:
        """One step; returns its total loss. The gradients stay in the
        parameters' ``.grad`` until the next step."""
        cfg, net = self.cfg, self.net
        c = cfg["num_classes"]
        temp, th1 = float(cfg["temperature"]), float(cfg["th1"])
        rate_pseudo = float(cfg["rate_pseudo"])
        keys = ("images", "tabular", "labels")
        bl = {k: cache_l[k].index_select(0, idx_l) for k in keys}
        bu = {k: cache_u[k].index_select(0, idx_u) for k in keys}
        img_l, tab_l, img_u, tab_u = augment.draw_views(
            cfg, self.aug, gen, bl, bu, cache_l["tabular"], cache_u["tabular"])
        y_l = bl["labels"]
        b_l = y_l.shape[0]
        images = torch.cat([img_l, img_u], 0)
        tabs = torch.cat([tab_l, tab_u], 0)
        mask_rand = (torch.rand(idx_u.shape[0], generator=gen,
                                device=gen.device) >= 0.5).float()
        net.train()
        outs = net(images, tabs)
        self.ema_update()
        with torch.no_grad():
            t = self.ema(images, tabs)
            feat_m_t = net.features(t)
        yh_m, yh_i, yh_t = (t[k][b_l:] for k in ("out_m", "out_i", "out_t"))
        top_m, top_i, top_t = (x.argmax(1) for x in (yh_m, yh_i, yh_t))
        case1 = (top_m == top_i) & (top_m == top_t)
        case2_i = (top_m == top_i) & (top_m != top_t)
        case2_t = (top_m == top_t) & (top_m != top_i)
        case3 = ~(case1 | case2_i | case2_t)
        f = lambda m: m.float()[:, None]  # noqa: E731
        pseudo = (f(case1) * sharpen((yh_m + yh_i + yh_t) / 3.0, 1.0)
                  + f(case2_i) * sharpen((yh_m + yh_i) / 2.0, 1.0)
                  + f(case2_t) * sharpen((yh_m + yh_t) / 2.0, 1.0)
                  + f(case3) * sharpen(yh_m, 1.0))
        prediction = sharpen(yh_m, 1.0)
        tprobs = torch.softmax((feat_m_t[b_l:] @ self.prototypes.T) / temp, 1)
        pseudo = rate_pseudo * pseudo + (1 - rate_pseudo) * tprobs
        prediction = rate_pseudo * prediction + (1 - rate_pseudo) * tprobs
        mask1 = (prediction.amax(1) >= th1).float()
        pla = torch.cat([F.one_hot(y_l.long(), c).float(),
                         prediction * use_pseudo], 0)
        c1, c2i, c2t, c3 = (m.float() for m in (case1, case2_i, case2_t,
                                                 case3))

        def sce(logits):
            return soft_cross_entropy(logits[b_l:], pseudo) * mask1

        o_m, o_i, o_t = outs["out_m"], outs["out_i"], outs["out_t"]
        loss_ce = (cross_entropy(o_m[:b_l], y_l)
                   + cross_entropy(o_i[:b_l], y_l)
                   + cross_entropy(o_t[:b_l], y_l))
        loss_m_u = (sce(o_m) * c1).mean()
        loss_i_u = (sce(o_i) * (c1 + c2t + c3 * mask_rand)).mean()
        loss_t_u = (sce(o_t) * (c1 + c2i + c3 * (1 - mask_rand))).mean()
        loss_itc = clip_loss(outs["feat_i"], outs["feat_t"], temp,
                             float(cfg["lambda_0"]))
        ci, ci_est = club_losses(outs["mu_i"], outs["x_ai"])
        ct, ct_est = club_losses(outs["mu_t"], outs["x_at"])
        loss_pt = prototype_loss(pla, self.prototypes, outs["feat_m"], temp,
                                 th1)
        base = (float(cfg["alpha"]) * loss_ce + float(cfg["beta"]) * loss_itc
                + float(cfg["gamma"]) * (ci + ci_est + ct + ct_est))
        extra = (float(cfg["rate_pt"]) * loss_pt
                 + float(cfg["rate_uce"]) * (loss_m_u + loss_i_u + loss_t_u))
        total = base + use_pseudo * extra
        self.opt.zero_grad(set_to_none=True)
        total.backward()
        for p in net.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.opt.step()
        return total.detach()


@torch.no_grad()
def eval_probs(net: STiLNet, cfg: dict, images: Tensor,
               tabular: Tensor) -> Dict[str, Tensor]:
    """The eval step's three heads' probabilities (resize-only images,
    clean rows, the net in eval mode)."""
    net.eval()
    aug = augment.default_pipeline(cfg["img_size"], cfg["target"])
    outs = net.model(aug(images), tabular)
    return {k: torch.softmax(outs[f"out_{k}"].float(), 1)
            for k in ("m", "i", "t")}


def split_batches(n: int, batch: int, seed: int):
    """TTA's batches of a split: one shuffled epoch (numpy
    ``RandomState(seed)``), the tail at its own size."""
    order = np.random.RandomState(seed).permutation(n)
    return [order[s:s + batch] for s in range(0, n, batch)]


def tent(net: STiLNet, cfg: dict, cache: dict, batch: int,
         first_grads: Optional[dict] = None) -> None:
    """BN-adapt then Tent on ``cache``, in place: one momentum sweep of
    the image tower over the split (``tta_momentum``), then
    ``tta_steps`` epochs of entropy minimisation of the multimodal head
    with Adam (``tta_lr``) on the BN affine parameters, in eval mode.
    ``first_grads``, when given, receives the first entropy step's
    gradients by parameter name."""
    n = int(cache["labels"].shape[0])
    dev = cache["labels"].device
    aug = augment.default_pipeline(cfg["img_size"], cfg["target"])
    tower = net.model.encoder_imaging
    bns = [m for m in tower.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.momentum = float(cfg["tta_momentum"])
    tower.train()
    with torch.no_grad():
        for idx in split_batches(n, batch, 0):
            j = torch.from_numpy(idx.astype(np.int64)).to(dev)
            tower(aug(cache["images"].index_select(0, j)))
    for m in bns:
        m.momentum = 0.1
    net.eval()
    named = [(f"{name}.{k}", getattr(m, k))
             for name, m in net.named_modules() if isinstance(m, BatchNorm2d)
             for k in ("weight", "bias")]
    params = [p for _, p in named]
    net.requires_grad_(False)
    for p in params:
        p.requires_grad_(True)
    opt = torch.optim.Adam(params, lr=float(cfg["tta_lr"]),
                           betas=(0.9, 0.999), eps=1e-8)
    for ep in range(int(cfg["tta_steps"])):
        for idx in split_batches(n, batch, ep):
            j = torch.from_numpy(idx.astype(np.int64)).to(dev)
            logits = net.model(aug(cache["images"].index_select(0, j)),
                               cache["tabular"].index_select(0, j))["out_m"]
            probs = torch.softmax(logits.float(), 1)
            loss = -(probs * torch.log(probs + 1e-12)).sum(-1).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if first_grads is not None and not first_grads:
                first_grads.update((k, p.grad.detach().clone())
                                   for k, p in named)
            opt.step()


def bn_state(net: STiLNet) -> Dict[str, Tensor]:
    """Every BatchNorm's running statistics and affine parameters by
    name, cloned."""
    out: Dict[str, Tensor] = {}
    for name, m in net.named_modules():
        if isinstance(m, BatchNorm2d):
            for k in ("running_mean", "running_var", "weight", "bias"):
                out[f"{name}.{k}"] = getattr(m, k).detach().clone()
    return out

