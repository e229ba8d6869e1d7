"""Embedding-space helpers, the port of
``stil_tta_tpu/utils/embeddings.py``: the pairwise cosine-similarity
matrix (optionally thresholded), batch assembly with it, and InfoNCE
logits with their diagonal labels, as torch functions on tensors. The
similarity matrix is one normalised matmul, computed in ``DTYPE``
(float32, as the JAX functions compute).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor
DTYPE = torch.float32


def _l2norm(x: Tensor, dim: int = -1, eps: float = 1e-12) -> Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim,
                                        keepdim=True).clamp_min(eps)


def cosine_similarity_matrix(embeddings, threshold: Optional[float] = None
                             ) -> Tensor:
    """Pairwise cosine similarity of row embeddings (N, D) -> (N, N).

    With ``threshold`` set, entries <= threshold are zeroed
    (``torch.threshold`` semantics)."""
    z = _l2norm(torch.as_tensor(embeddings).to(DTYPE))
    sim = z @ z.T
    if threshold is not None:
        sim = torch.where(sim > threshold, sim, torch.zeros_like(sim))
    return sim


def cos_sim_collate(view_1: Sequence, view_2: Sequence, labels: Sequence,
                    embeddings: Sequence, threshold: Optional[float] = None):
    """Batch assembly and similarity matrix: stacks the two view lists,
    makes the labels a tensor, and returns the (optionally thresholded)
    cosine-similarity matrix of the flattened sample embeddings."""
    v1 = torch.stack([torch.as_tensor(v) for v in view_1])
    v2 = torch.stack([torch.as_tensor(v) for v in view_2])
    y = torch.as_tensor(labels)
    emb = torch.stack([torch.as_tensor(e).to(DTYPE).ravel()
                       for e in embeddings])
    return v1, v2, y, cosine_similarity_matrix(emb, threshold)


def calc_logits_labels(out0, out1, temperature: float = 0.1
                       ) -> Tuple[Tensor, Tensor]:
    """InfoNCE logits between two normalised embedding batches and the
    matching diagonal labels."""
    z0 = _l2norm(torch.as_tensor(out0).to(DTYPE), dim=1)
    z1 = _l2norm(torch.as_tensor(out1).to(DTYPE), dim=1)
    logits = (z0 @ z1.T) / temperature
    labels = torch.arange(z0.shape[0], dtype=torch.int32, device=z0.device)
    return logits, labels
