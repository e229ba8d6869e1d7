"""STiL-TTA in PyTorch for NVIDIA Hopper (H100).

The PyTorch port of ``stil_tta_tpu``, which stays the reference it is
tested against. This package imports torch, numpy, scipy and PyYAML and
nothing of JAX or of ``stil_tta_tpu``.

Slice 1 holds the test-time path of STiL: BN-adapt test-time adaptation
(``tta.tent``), the eval step and its metrics (``algorithms.stil``,
``train.evaluate``), the test entry point (``train.test``), serving
(``serve``) and the CLI (``run``). BatchNorm statistics on the card come
from the hand-written CUDA kernel ``csrc/bn_stats.cu``
(``ops.batch_norm.bn_stats``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Public functions keep the JAX package's layouts: NHWC images, (B, F)
tabular rows with categorical columns first, (1, C) float32 BN sums.
"""
