"""The numbers that decide ``correct``: each a gap between what the
program produced and what the plain reference works out from the same
inputs, weights and draws."""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

Tensor = torch.Tensor
# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone (a key's bias under softmax)
NEGLIGIBLE = 1e-3


def norms(tensors: Dict[str, Tensor]) -> Dict[str, float]:
    """Each tensor's norm; a fused query-key-value projection (``qkv``)
    counts as three leaves, its thirds, since its key part has no
    gradient but round-off under softmax."""
    out = {}
    for k, v in tensors.items():
        v = v.detach().double()
        if ".qkv." in k:
            for part, t in zip("qkv", v.chunk(3, dim=0)):
                out[f"{k}[{part}]"] = float(t.norm())
        else:
            out[k] = float(v.norm())
    return out


def _median(values: Iterable[float]) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def leaves_that_count(ref_grad: Dict[str, float]) -> set:
    """The leaves whose reference gradient norm is at least a thousandth
    of the median leaf's."""
    med = _median(ref_grad.values())
    return {k for k, g in ref_grad.items() if g >= NEGLIGIBLE * med}


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    keep: Optional[set] = None) -> float:
    """The median over the leaves kept of the gap of
    :func:`worst_leaf_gap`."""
    keys = [k for k in ref if keep is None or k in keep]
    med = _median(ref[k] for k in keys)
    return _median(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                   for k in keys)


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keep: Optional[set] = None) -> float:
    """max over the leaves kept of |norm(program) - norm(reference)|,
    each against the larger of the reference leaf's norm and the median
    reference leaf's."""
    keys = [k for k in ref if keep is None or k in keep]
    med = _median(ref[k] for k in keys)
    return max((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                for k in keys), default=float("inf"))


def loss_gap(prog: Iterable[float], ref: Iterable[float]) -> float:
    """max over the steps of |loss(program) - loss(reference)| /
    |loss(reference)|."""
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def prob_gap(prog_probs: Tensor, ref_probs: Tensor) -> float:
    """max over rows and classes of |p(program) - p(reference)|."""
    return float((prog_probs.double() - ref_probs.double()).abs().max())


def flip_share(prog_probs: Tensor, ref_probs: Tensor) -> float:
    """The share of rows whose most likely class differs between the
    program and the reference."""
    return float((prog_probs.argmax(1) != ref_probs.argmax(1)).double()
                 .mean())


def kl_gap(prog_probs: Tensor, ref_probs: Tensor) -> float:
    """The mean over rows of KL(reference || program), in nats."""
    p = ref_probs.double()
    q = prog_probs.double().clamp_min(1e-300)
    kl = (p * (torch.log(p.clamp_min(1e-300)) - torch.log(q))).sum(1)
    return float(kl.mean())


def worst_diff(prog: Dict[str, Tensor], ref: Dict[str, Tensor]) -> float:
    """max over the tensors of norm(program - reference), each against
    the larger of the reference tensor's norm and the median one's."""
    med = _median(float(v.double().norm()) for v in ref.values())
    return max(float((prog[k].double() - ref[k].double()).norm())
               / max(float(ref[k].double().norm()), med, 1e-30)
               for k in ref)
