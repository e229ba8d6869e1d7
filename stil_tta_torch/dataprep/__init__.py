"""Offline data preparation (the port's copies of
``stil_tta_tpu/dataprep``)."""
