"""Tabular corruption on the card, the port of
``stil_tta_tpu/data/corrupt.py`` (``ContrastiveImagingAndTabularDataset.
py:146-158``): per row, ``floor(F * rate)`` distinct features are
replaced by the value of that feature in a uniformly drawn row of the
training table (its empirical marginal).

Sampling is split from applying: :func:`sample_corruption` draws the
(B, F) ranking noise and source rows from an explicit generator, and
:func:`apply_corruption` takes them as tensors, so a test can feed it the
JAX package's draws."""

from __future__ import annotations

from typing import Dict, Optional

import torch

Tensor = torch.Tensor


def sample_corruption(gen: torch.Generator, b: int, f: int, n: int,
                      rate: float) -> Optional[Dict[str, Tensor]]:
    """(B, F) uniform noise (its per-row ranks choose the distinct
    columns) and (B, F) source-row indices in [0, n); None when the rate
    corrupts no feature."""
    if int(f * rate) == 0:
        return None
    dev = gen.device
    return {"noise": torch.rand(b, f, generator=gen, device=dev),
            "src_rows": torch.randint(0, n, (b, f), generator=gen,
                                      device=dev)}


def apply_corruption(rows: Tensor, marginal: Tensor, rate: float,
                     draws: Optional[Dict[str, Tensor]]) -> Tensor:
    """rows (B, F), marginal (N, F) training table -> (B, F)."""
    n_corrupt = int(rows.shape[1] * rate)
    if n_corrupt == 0 or draws is None:
        return rows
    ranks = draws["noise"].argsort(dim=1, stable=True).argsort(
        dim=1, stable=True)
    cols = torch.arange(rows.shape[1], device=rows.device)[None, :]
    sampled = marginal[draws["src_rows"], cols]
    return torch.where(ranks < n_corrupt, sampled.to(rows.dtype), rows)


def corrupt_tabular(gen: torch.Generator, rows: Tensor, marginal: Tensor,
                    rate: float) -> Tensor:
    b, f = rows.shape
    return apply_corruption(rows, marginal, rate, sample_corruption(
        gen, b, f, marginal.shape[0], rate))
