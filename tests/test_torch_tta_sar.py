"""The port's SAR against the JAX package's, also with a recovery reset
forced at every step. Set-up, tolerances and why:
``tests/torch_tta_parity.py``."""

import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401
from tests.torch_tta_parity import check_case, make_reference


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return make_reference(tmp_path_factory.mktemp("tta_sar"))


@pytest.mark.parametrize("case", ["sar", "sar_reset"])
def test_sar_matches_jax(reference, case):
    check_case(reference, case)
