"""Attention-map capture for visualisation, the port of
``capture_attention`` and ``attention_gradients`` in
``stil_tta_tpu/utils/profiling.py`` (the reference's hooks,
``Transformer.py:48-61``). The JAX module's ``trace`` and ``StepTimer``
have their counterpart in ``utils/trace.py``: program spans at the
port's layer boundaries, kept while a ``torch.profiler`` session runs.

The port's modules hold their parameters, so neither function takes the
JAX package's ``variables``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

Tensor = torch.Tensor


def capture_attention(encoder, x: Tensor,
                      missing_mask: Optional[Tensor] = None
                      ) -> Tuple[Tensor, List[Tensor]]:
    """The tabular encoder's tokens and each block's (B, heads, N, N)
    post-softmax self-attention map."""
    return encoder(x, missing_mask, return_attn=True)


def attention_gradients(encoder, x: Tensor,
                        scalar_fn: Callable[[Tensor], Tensor],
                        missing_mask: Optional[Tensor] = None
                        ) -> List[Tensor]:
    """The gradient of ``scalar_fn(tokens)`` with respect to each block's
    post-softmax attention map (the reference's ``save_attn_gradients``),
    taken through a zero float32 probe added to each map (the gradients
    are float32, as the JAX package's). Parameters get no gradient."""
    n = encoder.num_cat + encoder.num_con + 1
    probes = [torch.zeros((x.shape[0], block.attn.num_heads, n, n),
                          dtype=torch.float32, device=x.device,
                          requires_grad=True)
              for block in encoder.transformer_blocks]
    tokens = encoder(x, missing_mask, attn_probes=probes)
    return list(torch.autograd.grad(scalar_fn(tokens), probes))
