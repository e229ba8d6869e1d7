"""The port's host stream (``stil_tta_torch/data/loader.py:HostStream``,
``data/native_loader.py``) on the CPU.

The native gather is held to its numpy version bit for bit (uint8 and
float32 rows, the scaled uint8 -> float32 form, a caller's ``out``
buffer); a failed build raises with the compiler's output. A
``HostStream`` epoch gives the rows, keys and dtypes a ``DeviceCache``
gather gives; its instrumentation is reset by each epoch; a worker's
exception is raised in the consumer; leaving an epoch early stops the
worker; the worker gathers ahead of the consumer (a handshake on
events, no wall-clock threshold). Then ``evaluate`` with
``host_stream=true`` against ``false`` at float64: STiL, and
MultiSimMatch on memmapped splits, whose instance bank is addressed
through the virtual cache's ``index``; the parameters (and the bank) are
bitwise equal, because the train step reads the very same tensors.
The JAX package's host stream is held the same way
(``tests/test_host_stream_mode.py``); no JAX step runs here."""

import threading

import numpy as np
import pytest
import torch

from stil_tta_torch.config import load_config
from stil_tta_torch.data import native_loader as nl
from stil_tta_torch.data.loader import (VIRTUAL_CACHE_KEYS, CyclingEpochView,
                                        CyclingSampler, DeviceCache,
                                        EpochSampler, HostStream,
                                        gather_batch)
from stil_tta_torch.data.source import ArraySource, synthetic_source
from tests.torch_parity import one_torch_thread  # noqa: F401

FL = [5, 4, 2, 1, 1, 1]
OVERRIDES = [
    "dataset=synthetic_dvm", "models=resnet18", "img_size=32",
    "synthetic_image_size=40", "batch_size=8", "unlabelled_ratio=3",
    "synthetic_labelled=8", "synthetic_unlabelled=24", "synthetic_val=8",
    "synthetic_test=8", "num_classes=4", "tabular_embedding_dim=32",
    "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
    "projection_dim=8", "start_epoch=0", "strict_prototypes=false",
    "enable_progress_bar=false", "max_epochs=1", "test_and_eval=false",
    "save_checkpoints=false",
]


def _source(n=20, seed=0, missing=True) -> ArraySource:
    src = synthetic_source(n, num_classes=4, field_lengths=FL,
                           image_size=12, labelled_frac=0.5, seed=seed)
    if missing:
        src.missing = np.random.RandomState(seed).rand(n, len(FL)) < 0.3
    return src


# ---- the native gather ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["uint8", "float32", "int64", "bool"])
def test_native_gather_matches_numpy(dtype):
    rng = np.random.RandomState(1)
    src = (rng.randn(50, 6, 5, 3) * 100).astype(dtype)
    idx = rng.randint(0, 50, 33).astype(np.int32)
    got = nl.gather_rows(src, idx)
    want = nl.gather_rows_plain(src, idx)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    out = np.zeros_like(want)
    assert nl.gather_rows(src, idx, out=out) is out
    assert np.array_equal(out, want)


def test_native_scaled_gather_matches_numpy_and_fills_a_pinned_buffer():
    rng = np.random.RandomState(2)
    src = rng.randint(0, 256, (40, 7, 7, 3), dtype=np.uint8)
    idx = rng.randint(0, 40, 17)
    want = nl.gather_rows_scaled_plain(src, idx)
    assert want.dtype == np.float32
    assert np.array_equal(nl.gather_rows_scaled(src, idx), want)
    for scale in (1.0, 0.5, 1.0 / 3.0):
        assert np.array_equal(nl.gather_rows_scaled(src, idx, scale),
                              nl.gather_rows_scaled_plain(src, idx, scale))
    # a host tensor's memory as the destination (pinned on the card)
    buf = torch.empty((17, 7, 7, 3), dtype=torch.uint8)
    nl.gather_rows(src, idx, out=buf.numpy())
    assert np.array_equal(buf.numpy(), src[idx])


def test_native_gather_refuses_what_it_cannot_do():
    src = np.zeros((5, 3), np.float32)
    with pytest.raises(IndexError):
        nl.gather_rows(src, [0, 5])
    with pytest.raises(IndexError):
        nl.gather_rows(src, [-1])
    with pytest.raises(ValueError, match="out must be"):
        nl.gather_rows(src, [0, 1], out=np.zeros((2, 3), np.float64))
    with pytest.raises(ValueError, match="C-contiguous"):
        nl.gather_rows(np.zeros((5, 4), np.float32)[:, ::2], [0])
    with pytest.raises(TypeError, match="uint8"):
        nl.gather_rows_scaled(src, [0])


def test_failed_native_build_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    """No numpy fallback: a source that does not compile raises."""
    bad = tmp_path / "loader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nl, "SOURCE", bad)
    monkeypatch.setattr(nl, "BUILD", tmp_path / "build")
    nl.library_path.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            nl.build()
    finally:
        nl.library_path.cache_clear()
    assert not list((tmp_path / "build").glob("*.so"))


# ---- HostStream ----------------------------------------------------------

def test_epoch_rows_equal_a_device_cache_gather():
    src = _source()
    cache = DeviceCache(src, device="cpu").as_dict()
    sampler = EpochSampler(len(src), 6, shuffle=True, drop_last=False,
                           seed=3)
    want = list(EpochSampler(len(src), 6, shuffle=True, drop_last=False,
                             seed=3).epoch())
    got = list(HostStream(src, sampler, device="cpu").epoch())
    assert len(got) == len(want) == 4           # 20 rows: a padded tail
    for batch, (idx, w) in zip(got, want):
        ref = gather_batch(cache, torch.from_numpy(idx))
        assert set(batch) == set(VIRTUAL_CACHE_KEYS) | {"weight"}
        for k, v in ref.items():
            assert v.dtype == batch[k].dtype and torch.equal(v, batch[k]), k
        assert batch["index"].dtype == torch.int32
        assert torch.equal(batch["index"], torch.from_numpy(idx))
        assert np.array_equal(batch["weight"], w)


def test_cycling_view_and_instrumentation_reset_per_epoch():
    src = _source(missing=False)
    view = CyclingEpochView(CyclingSampler(len(src), 8, seed=0), 5)
    stream = HostStream(src, view, depth=2, device="cpu")
    for _ in range(2):
        batches = list(stream.epoch())
        assert len(batches) == 5 and "missing" not in batches[0]
        # one wait and one reading a batch, and the end marker's
        assert len(stream.waits_ms) == len(stream.occupancy) == 6
        assert all(0 <= o <= 2 for o in stream.occupancy)
        assert stream.gather_bytes > 0


class _Handshake:
    """A sampler that signals each batch it hands out and raises after
    ``fail_after`` batches, if given."""

    def __init__(self, n: int, batches: int, fail_after=None):
        self.n, self.batches, self.fail_after = n, batches, fail_after
        self.handed = [threading.Event() for _ in range(batches)]

    def epoch(self):
        for i in range(self.batches):
            if i == self.fail_after:
                raise RuntimeError("sampler failed")
            self.handed[i].set()
            yield np.arange(4, dtype=np.int32) + i, np.ones(4, np.float32)


def test_worker_gathers_ahead_of_the_consumer():
    sampler = _Handshake(20, 4)
    it = HostStream(_source(), sampler, depth=2, device="cpu").epoch()
    first = next(it)
    # while the consumer holds batch 0, the worker goes on to batch 1 and
    # then 2 (the queue holds 2); the events only bound a broken stream
    assert sampler.handed[2].wait(timeout=60)
    assert torch.equal(first["index"], torch.arange(4, dtype=torch.int32))
    assert [int(b["index"][0]) for b in it] == [1, 2, 3]


def test_worker_exception_reaches_the_consumer():
    it = HostStream(_source(), _Handshake(20, 4, fail_after=2),
                    device="cpu").epoch()
    assert int(next(it)["index"][0]) == 0
    assert int(next(it)["index"][0]) == 1
    with pytest.raises(RuntimeError, match="sampler failed"):
        next(it)


def test_leaving_an_epoch_early_stops_the_worker():
    sampler = EpochSampler(400, 4, seed=0)
    it = HostStream(_source(400), sampler, depth=1, device="cpu").epoch()
    next(it)
    it.close()
    assert not [t for t in threading.enumerate() if t.name == "HostStream"]


# ---- evaluate with host_stream -------------------------------------------

def _train(name, host_stream: bool, logdir, *extra):
    """``evaluate`` on the CPU, the net at float64 (the algorithm class
    built with ``dtype``); returns the config, the trained state and a
    copy of its initial tensor buffers (``extra``)."""
    from stil_tta_torch.algorithms import registry
    from stil_tta_torch.train.evaluate import evaluate
    cfg = load_config(name, OVERRIDES + list(extra) + [
        f"host_stream={str(host_stream).lower()}", f"logdir={logdir}"])
    states = []
    real = registry.get_algorithm

    def capturing(algo_name):
        cls = real(algo_name)

        class Capturing(cls):
            def __init__(self, cfg, field_lengths, device):
                super().__init__(cfg, field_lengths, dtype=torch.float64,
                                 device=device)

            def init_state(self, *a, **kw):
                state = super().init_state(*a, **kw)
                states.append((state, {
                    k: v.clone() for k, v in getattr(state, "extra",
                                                     {}).items()
                    if isinstance(v, torch.Tensor)}))
                return state
        return Capturing

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(registry, "get_algorithm", capturing)
        evaluate(cfg, device="cpu")
    return (cfg,) + states[0]


def _assert_same_net(a, b):
    sa, sb = a.net.state_dict(), b.net.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.step == b.step == 4


def test_host_stream_trains_stil_bitwise_like_the_device_cache(tmp_path):
    _, cached, _ = _train("config_dvm_STiL", False, tmp_path / "c")
    _, streamed, _ = _train("config_dvm_STiL", True, tmp_path / "h")
    _assert_same_net(cached, streamed)
    for k in ("prototypes", "prototypes_sum", "prototypes_count"):
        assert torch.equal(getattr(cached, k), getattr(streamed, k)), k


def test_host_stream_simmatch_bank_on_memmapped_splits(tmp_path):
    """MultiSimMatch on splits read back as memmaps: the bank is written
    at the rows' dataset indices (the virtual cache's ``index``), so the
    streamed run's bank equals the cached run's and the epoch writes more
    slots than one labelled batch has rows."""
    from stil_tta_torch.data.datasets import load_sources
    root = tmp_path / "data"
    for i, (split, n, frac) in enumerate((
            ("train_labelled", 8, 1.0), ("train_unlabelled", 24, 0.0),
            ("val", 8, 1.0), ("test", 8, 1.0))):
        synthetic_source(n, num_classes=4, field_lengths=FL, image_size=40,
                         labelled_frac=frac, seed=i).save(root / split)
    extra = ("synthetic=false", f"data_base={root}", "DA=false")
    cfg, cached, _ = _train("config_dvm_MultiSimMatch", False,
                            tmp_path / "c", *extra)
    _, streamed, initial = _train("config_dvm_MultiSimMatch", True,
                                  tmp_path / "h", *extra)
    assert isinstance(load_sources(cfg)["train_unlabelled"].images,
                      np.memmap)
    _assert_same_net(cached, streamed)
    assert set(cached.extra) == set(streamed.extra)
    for k, v in cached.extra.items():
        assert (v == streamed.extra[k] if isinstance(v, int)
                else torch.equal(v, streamed.extra[k])), k
    # 4 steps of 2 labelled rows: more slots written than a batch's rows
    l_batch = int(cfg.batch_size) // (1 + int(cfg.unlabelled_ratio))
    written = (streamed.extra["bank"] != initial["bank"]).any(0)
    assert int(written.sum()) > l_batch
