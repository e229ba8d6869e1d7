"""Offline data preparation (the port's copies of
``stil_tta_tpu/dataprep``).

Importing any of these modules loads numpy and torch only. The functions
that parse raw host files import pandas, scikit-learn, PIL or nibabel
inside their bodies, as the JAX package's do, so that the split ids and
imputations are scikit-learn's own; where one is missing, the call raises
``ImportError`` naming the package."""
