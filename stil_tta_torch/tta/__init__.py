"""Test-time adaptation of the PyTorch port (BN-adapt)."""

from stil_tta_torch.tta.tent import adapt, estimate_bn_stats  # noqa: F401
