"""The port's embedding helpers (``stil_tta_torch/utils/embeddings.py``)
against ``stil_tta_tpu/utils/embeddings.py`` on the same numpy inputs.

Both sides compute in float32; here JAX runs in x64 with ``jnp.float32``
read as float64, and the port with its ``DTYPE`` set to float64, so the
two agree to 1e-12 (float64 round-off of one normalised matmul)."""

import numpy as np
import pytest
import torch

from stil_tta_torch.utils import embeddings as pemb
from stil_tta_tpu.utils import embeddings as jemb
from tests.torch_parity import jnp64, x64
from tests.torch_parity import one_torch_thread  # noqa: F401

TOL = 1e-12


@pytest.fixture
def jax64():
    with x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jemb, "jnp", jnp64())
        mp.setattr(pemb, "DTYPE", torch.float64)
        yield


@pytest.mark.parametrize("threshold", [None, 0.2, -0.1])
def test_cosine_similarity_matrix_matches_jax(jax64, threshold):
    emb = np.random.RandomState(0).randn(9, 12)
    want = np.asarray(jemb.cosine_similarity_matrix(emb, threshold))
    got = pemb.cosine_similarity_matrix(torch.from_numpy(emb), threshold)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    if threshold is not None:
        # the zeroed entries are the same ones on both sides
        np.testing.assert_array_equal(got.numpy() == 0, want == 0)


def test_cos_sim_collate_matches_jax(jax64):
    rng = np.random.RandomState(1)
    n = 5
    v1 = [rng.randn(3, 4, 4) for _ in range(n)]
    v2 = [rng.randn(3, 4, 4) for _ in range(n)]
    y = list(rng.randint(0, 3, n))
    emb = [rng.randn(2, 3) for _ in range(n)]   # flattened to 6
    want = jemb.cos_sim_collate(v1, v2, y, emb, threshold=0.1)
    got = pemb.cos_sim_collate(v1, v2, y, emb, threshold=0.1)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("temperature", [0.1, 0.07])
def test_calc_logits_labels_matches_jax(jax64, temperature):
    rng = np.random.RandomState(2)
    a, b = rng.randn(6, 8), rng.randn(6, 8)
    wl, wy = jemb.calc_logits_labels(a, b, temperature)
    gl, gy = pemb.calc_logits_labels(torch.from_numpy(a),
                                     torch.from_numpy(b), temperature)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0,
                               atol=TOL / temperature)
    assert gy.dtype == torch.int32
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


def test_default_dtype_is_float32_as_in_jax():
    """Unpatched, the port computes in float32, as the JAX functions
    always do (JAX here in its float32 default)."""
    emb = np.random.RandomState(3).randn(7, 5).astype(np.float32)
    got = pemb.cosine_similarity_matrix(torch.from_numpy(emb))
    want = np.asarray(jemb.cosine_similarity_matrix(emb))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
