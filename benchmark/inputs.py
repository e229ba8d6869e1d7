"""The benchmark's inputs and weights, made on the card from ``--seed``.

Splits are the device caches the port's training and scoring read
(``images`` uint8 NHWC, ``tabular`` float32 rows with the categorical
columns first, ``labels`` int64, ``labelled`` bool), each made in a few
large calls of one ``torch.Generator``. Weights are a state dict in the
port's key layout (the reference net's), drawn in one call and cut into
the leaves, each scaled to its init family. The same seed gives the same
inputs and weights; both sides of the check get them.
"""

from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor

# streams of one seed, so that adding a draw to one leaves the others
STREAM = {"weights": 1, "views": 2, "train": 3, "val": 4, "test": 5,
          "shift": 6, "rows": 7}


def stream_seed(seed: int, stream: str) -> int:
    """The seed of one stream of ``seed``."""
    return (int(seed) * 1000003 + STREAM[stream]) % (2 ** 63 - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def make_split(n: int, cfg: dict, g: torch.Generator, labelled: bool,
               balanced: bool) -> Dict[str, Tensor]:
    """``n`` rows of the configuration's widths. ``balanced`` labels
    every class about equally often (a stratified labelled or validation
    split); otherwise labels are drawn uniformly."""
    dev = g.device
    s, c = int(cfg["img_size"]), int(cfg["num_classes"])
    fl = [int(x) for x in cfg["field_lengths"]]
    cards = torch.tensor([x for x in fl if x > 1], dtype=torch.float32,
                         device=dev)
    n_con = sum(1 for x in fl if x == 1)
    images = torch.randint(0, 256, (n, s, s, 3), generator=g, device=dev,
                           dtype=torch.uint8)
    cat = torch.floor(torch.rand((n, len(cards)), generator=g, device=dev)
                      * cards)
    con = torch.randn((n, n_con), generator=g, device=dev)
    if balanced:
        labels = torch.arange(n, device=dev) % c
        labels = labels[torch.randperm(n, generator=g, device=dev)]
    else:
        labels = torch.randint(0, c, (n,), generator=g, device=dev)
    return {"images": images, "tabular": torch.cat([cat, con], 1),
            "labels": labels.long(),
            "labelled": torch.full((n,), labelled, dtype=torch.bool,
                                   device=dev)}


def shift_split(base: Dict[str, Tensor], cfg: dict,
                g: torch.Generator) -> Dict[str, Tensor]:
    """A shifted copy of ``base``: each colour channel scaled by a factor
    in [0.6, 1.4] and offset by [-40, 40] grey levels, and each
    continuous column's mean moved by [-1, 1]."""
    dev = g.device
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)  # noqa
    gain, offset = 0.6 + 0.8 * u(3), -40.0 + 80.0 * u(3)
    n_cat = sum(1 for x in cfg["field_lengths"] if int(x) > 1)
    tab = base["tabular"].clone()
    tab[:, n_cat:] += -1.0 + 2.0 * u(tab.shape[1] - n_cat)
    images = (base["images"].float() * gain + offset).clamp_(0, 255)
    return {"images": images.to(torch.uint8), "tabular": tab,
            "labels": base["labels"], "labelled": base["labelled"]}


def _is_weight_norm(name: str) -> bool:
    return name.endswith(".weight")


def make_weights(shapes: Dict[str, tuple], scales: Dict[str, float],
                 seed: int, device) -> Dict[str, Tensor]:
    """A state dict for ``shapes`` (name -> shape, in state-dict order):
    a leaf with a positive scale is a normal draw clamped at two standard
    deviations (convolutions: unclamped) times the scale, cut from one
    float32 draw; a 1-D ``weight`` of scale 0 (a norm's scale) is 1, every
    other leaf 0 (biases, shifts, running means, counters), a running
    variance 1."""
    g = generator(seed, "weights", device)
    drawn = [k for k in shapes if scales[k] > 0]
    total = sum(int(torch.Size(shapes[k]).numel()) for k in drawn)
    flat = torch.randn(total, generator=g, device=device)
    out: Dict[str, Tensor] = {}
    pos = 0
    for k, shape in shapes.items():
        if scales[k] > 0:
            n = int(torch.Size(shape).numel())
            w = flat[pos:pos + n].view(shape)
            pos += n
            if len(shape) != 4:
                w = w.clamp(-2.0, 2.0)
            out[k] = w * scales[k]
        elif k.endswith("num_batches_tracked"):
            out[k] = torch.zeros(shape, dtype=torch.long, device=device)
        elif k.endswith("running_var") or (len(shape) == 1
                                           and _is_weight_norm(k)):
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out
