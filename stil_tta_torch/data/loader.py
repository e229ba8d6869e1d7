"""Epoch samplers, the device-resident dataset cache and the host
stream, the port of ``stil_tta_tpu/data/loader.py``.

:class:`DeviceCache` puts a whole split on the card once (uint8 images
are small: 2,048 DVM test images at 128² are 100 MB), so a batch is an
index gather on the device and the host only makes index vectors.
:class:`EpochSampler`, :class:`CyclingSampler` and
:class:`WeightedSampler` draw the same indices as the JAX package's
(``np.random.RandomState``), so both see batches in the same order.
:class:`HostStream` serves splits larger than device memory: a worker
thread gathers each batch from the (memmapped) host arrays with the
native gather and ships it to the device, and each batch is a
batch-shaped "virtual cache" (:data:`VIRTUAL_CACHE_KEYS`) that the train
step reads with ``arange`` indices. Not ported: the JAX class's
``epoch_blocks`` (it serves ``steps_per_dispatch``, which the port runs
as single steps) and its ``sharding`` argument (read only by the JAX
package's benchmark).
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
import time
from typing import Iterator, Optional

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


class CyclingSampler:
    """Infinite shuffled stream for the labelled loader, which is shorter
    than the unlabelled epoch and cycles."""

    def __init__(self, n: int, batch_size: int, seed: int = 0):
        self.sampler = EpochSampler(n, batch_size, shuffle=True,
                                    drop_last=False, seed=seed)
        self._it = self.sampler.epoch()

    def next(self) -> tuple:
        try:
            return next(self._it)
        except StopIteration:
            self._it = self.sampler.epoch()
            return next(self._it)


class CyclingEpochView:
    """A cycling labelled sampler under the ``.epoch()`` protocol with a
    fixed step count (the unlabelled epoch's): the host stream's form of
    the dual-loader cycling."""

    def __init__(self, cycling, steps: int):
        self.cycling = cycling
        self.steps = steps

    def epoch(self) -> Iterator[tuple]:
        for _ in range(self.steps):
            yield self.cycling.next()


class WeightedSampler:
    """Class-weighted sampling with replacement (``loader.py:100-117``;
    the reference's ``WeightedRandomSampler``, ``trainers/evaluate.py:
    108-112``): a row's weight is its label's class weight. Draws come
    from ``np.random.RandomState(seed)``, index for index the JAX
    package's."""

    def __init__(self, labels: np.ndarray, class_weights, batch_size: int,
                 seed: int = 0):
        w = np.asarray([class_weights[int(lab)] for lab in labels],
                       np.float64)
        self.p = w / w.sum()
        self.n = len(labels)
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)

    def next(self) -> tuple:
        idx = self.rng.choice(self.n, size=self.batch_size, replace=True,
                              p=self.p)
        return idx.astype(np.int32), np.ones(self.batch_size, np.float32)


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


def marginal_table(cache: dict) -> torch.Tensor:
    """The full tabular table of a split, the corruption marginal
    (``TabularDataset.py:63-78``)."""
    return cache.get("marginal", cache["tabular"])


def gather_batch(cache: dict, idx: torch.Tensor) -> dict:
    """Device-side batch assembly; ``idx`` is an index tensor on the
    cache's device."""
    keys = ("images", "tabular", "labels", "labelled", "missing")
    return {k: cache[k].index_select(0, idx) for k in keys if k in cache}


# threads of each native gather of a HostStream: on the H100's 8-core
# host two keep a batch of 512 DVM rows well ahead of the step, and the
# step's own launches keep the other cores
GATHER_THREADS = 2

# the keys of a train step's virtual cache: every host-stream consumer
# filters its batches to these. "index" must stay: without it
# dataset_indices() returns the raw gather index (arange(B)) and
# index-addressed state (SimMatch's bank) would alias batch slots
VIRTUAL_CACHE_KEYS = ("images", "tabular", "labels", "labelled",
                      "missing", "index")


def dataset_indices(cache: dict, idx: torch.Tensor) -> torch.Tensor:
    """The dataset indices of the rows ``gather_batch(cache, idx)``
    returns (``loader.py:172``): ``idx`` itself for a
    :class:`DeviceCache`; a :class:`HostStream` virtual cache is already
    batch-shaped (``idx`` is ``arange(B)``) and carries its rows' dataset
    indices under ``"index"``. Index-addressed state (SimMatch's instance
    bank, ``simmatch_model.py:140-147``) is written through this."""
    if "index" in cache:
        return cache["index"].index_select(0, idx)
    return idx


class HostStream:
    """Batches gathered on the host and moved to ``device`` ahead of use.

    ``epoch()`` yields one dict a batch of ``sampler.epoch()``: the keys,
    dtypes and layout of :meth:`DeviceCache.as_dict` rows (``images`` as
    stored, ``tabular`` float32, ``labels`` int64, ``labelled``,
    ``missing`` where the split has it), ``index`` (the rows' dataset
    indices, int32, as the samplers give them) on ``device``, and
    ``weight`` (the padding mask, a host array). A worker thread keeps
    up to ``depth`` batches ready. ``waits_ms`` (the consumer's wait for
    each batch, the end-of-epoch marker included) and ``occupancy`` (the
    batches ready right after each wait) are reset by each ``epoch()``,
    and so are ``gather_s`` and ``gather_bytes`` (the native gathers'
    seconds and bytes). Each gather runs on ``GATHER_THREADS`` threads.

    On a CUDA device the worker gathers each batch with the native
    gather into a pinned host buffer from a pool of ``depth + 2``,
    copies it to the card with ``non_blocking=True`` on its own stream
    and records an event; the consumer's stream waits on that event and
    the handed-out tensors are marked used on it (``record_stream``), so
    the caching allocator keeps them until the step is done. A buffer
    returns to the pool once its copy's event has completed. On the CPU
    the gathered arrays are the batch. An exception in the worker is
    raised in the consumer; leaving an epoch early stops the worker."""

    def __init__(self, source: ArraySource, sampler, depth: int = 2,
                 device="cuda"):
        self.source = source
        self.sampler = sampler
        self.depth = depth
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the worker thread sets this card as its own
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.pool_size = depth + 2 if self.device.type == "cuda" else 0
        self.waits_ms: list = []
        self.occupancy: list = []
        self.gather_s = 0.0       # the native gathers' seconds this epoch
        self.gather_bytes = 0     # and the bytes they wrote
        # the host arrays in DeviceCache's dtypes (small next to images)
        arrays = {"images": source.images,
                  "tabular": np.asarray(source.tabular, np.float32),
                  "labels": np.asarray(source.labels, np.int64),
                  "labelled": np.asarray(source.labelled)}
        if source.missing is not None:
            arrays["missing"] = np.asarray(source.missing)
        self.arrays = {k: np.ascontiguousarray(v) if k != "images" else v
                       for k, v in arrays.items()}
        self._pool: collections.deque = collections.deque()
        self._stream = None

    def _host_batch(self, idx: np.ndarray, slot: Optional[dict]) -> dict:
        """The batch's host arrays, written into ``slot``'s pinned
        tensors where given."""
        from stil_tta_torch.data import native_loader
        t0 = time.perf_counter()
        out = {}
        for k, a in self.arrays.items():
            dst = None if slot is None else slot[k].numpy()
            out[k] = native_loader.gather_rows(a, idx, out=dst,
                                               n_threads=GATHER_THREADS)
            self.gather_bytes += out[k].nbytes
        self.gather_s += time.perf_counter() - t0
        index = np.ascontiguousarray(idx, np.int32)
        if slot is None:
            out["index"] = index
        else:
            slot["index"].numpy()[:] = index
            out["index"] = slot["index"].numpy()
        return out

    def _new_slot(self, n: int) -> dict:
        slot = {k: torch.empty((n,) + a.shape[1:], pin_memory=True,
                               dtype=torch.from_numpy(
                                   np.empty(0, a.dtype)).dtype)
                for k, a in self.arrays.items()}
        slot["index"] = torch.empty(n, dtype=torch.int32, pin_memory=True)
        return slot

    def _produce(self, put, stop: threading.Event) -> None:
        """The worker: gather, ship and ``put`` each batch."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.set_device(self.device)
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
        inflight: collections.deque = collections.deque()
        try:
            for idx, w in self.sampler.epoch():
                if stop.is_set():
                    return
                if not cuda:
                    host = self._host_batch(idx, None)
                    put(({k: torch.from_numpy(v) for k, v in host.items()},
                         None, w))
                    continue
                while inflight and inflight[0][0].query():
                    self._pool.append(inflight.popleft()[1])
                if self._pool:
                    slot = self._pool.popleft()
                    if len(slot["index"]) != len(idx):
                        slot = self._new_slot(len(idx))
                elif len(inflight) < self.pool_size:
                    slot = self._new_slot(len(idx))
                else:   # every buffer is in a copy: wait for the oldest
                    ev, slot = inflight.popleft()
                    ev.synchronize()
                self._host_batch(idx, slot)
                with torch.cuda.stream(self._stream):
                    batch = {k: t.to(self.device, non_blocking=True)
                             for k, t in slot.items()}
                    event = torch.cuda.Event()
                    event.record(self._stream)
                inflight.append((event, slot))
                put((batch, event, w))
        finally:
            for ev, slot in inflight:
                ev.synchronize()
                self._pool.append(slot)

    def epoch(self) -> Iterator[dict]:
        from stil_tta_torch.data import native_loader
        native_loader.load()     # a build's time is no gather's
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.depth)
        stop = threading.Event()
        end = object()
        failure = []
        self.waits_ms, self.occupancy = [], []
        self.gather_s, self.gather_bytes = 0.0, 0

        def put(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue_mod.Full:
                    pass

        def worker() -> None:
            try:
                self._produce(put, stop)
            except BaseException as exc:   # raised again in the consumer
                failure.append(exc)
            put(end)

        thread = threading.Thread(target=worker, daemon=True,
                                  name="HostStream")
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.waits_ms.append((time.perf_counter() - t0) * 1e3)
                self.occupancy.append(q.qsize())
                if item is end:
                    break
                batch, event, w = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for t in batch.values():
                        t.record_stream(current)
                batch["weight"] = w
                yield batch
            if failure:
                raise failure[0]
        finally:
            stop.set()
            thread.join()
