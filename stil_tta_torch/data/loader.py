"""Epoch sampler and device-resident dataset cache (the part of
``stil_tta_tpu/data/loader.py`` the test-time path uses).

:class:`DeviceCache` puts a whole split on the card once (uint8 images
are small: 2,048 DVM test images at 128² are 100 MB), so a batch is an
index gather on the device and the host only makes index vectors.
:class:`EpochSampler` draws the same permutations as the JAX package's
(``np.random.RandomState``), so both see batches in the same order.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from stil_tta_torch.data.source import ArraySource


class EpochSampler:
    """Shuffled epoch index batches (np.int32), padded or dropped."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 0):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)

    def steps_per_epoch(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def epoch(self) -> Iterator[tuple]:
        """Yields (idx (B,), weight (B,)) — weight 0 marks padding."""
        order = (self.rng.permutation(self.n) if self.shuffle
                 else np.arange(self.n))
        bs = self.batch_size
        limit = (self.n // bs) * bs if self.drop_last else self.n
        for start in range(0, limit, bs):
            chunk = order[start:start + bs]
            w = np.ones(len(chunk), np.float32)
            if len(chunk) < bs:  # pad to the batch size
                pad = bs - len(chunk)
                chunk = np.concatenate([chunk, chunk[:1].repeat(pad)])
                w = np.concatenate([w, np.zeros(pad, np.float32)])
            yield chunk.astype(np.int32), w


class DeviceCache:
    """A split held on ``device``; batches are gathered there by index."""

    def __init__(self, source: ArraySource, device="cuda"):
        def put(a):
            return torch.tensor(np.asarray(a), device=device)

        self.images = put(np.asarray(source.images))
        self.tabular = put(np.asarray(source.tabular, np.float32))
        self.labels = put(np.asarray(source.labels, np.int64))
        self.labelled = put(np.asarray(source.labelled))
        self.missing = put(np.asarray(source.missing)) \
            if source.missing is not None else None
        self.n = len(source)

    def as_dict(self):
        d = {"images": self.images, "tabular": self.tabular,
             "labels": self.labels, "labelled": self.labelled}
        if self.missing is not None:
            d["missing"] = self.missing
        return d


def gather_batch(cache: dict, idx: torch.Tensor) -> dict:
    """Device-side batch assembly; ``idx`` is an index tensor on the
    cache's device."""
    keys = ("images", "tabular", "labels", "labelled", "missing")
    return {k: cache[k].index_select(0, idx) for k in keys if k in cache}
