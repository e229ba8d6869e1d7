"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both sides as
arrays. JAX stays on the CPU. Float64 comparisons enable JAX's x64 mode
only inside :func:`x64`, so other test files in the same worker keep the
float32 default.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from stil_tta_torch.train.convert import state_dict_from_jax


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test: the suite runs under several xdist
    workers. Restored afterwards, so other files' tests keep theirs."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def to_numpy(tree, dtype=None):
    """JAX variable tree -> nested dicts of numpy arrays; floating leaves
    cast to ``dtype`` when given."""
    def leaf(a):
        a = np.asarray(a)
        if dtype is not None and np.issubdtype(a.dtype, np.floating):
            a = a.astype(dtype)
        return a
    return jax.tree_util.tree_map(leaf, tree)


def init_jax(module, *args, dtype=np.float64, **kw):
    """``module.init`` with key 0, every floating leaf cast to ``dtype``."""
    key = jax.random.key(0)
    variables = module.init({"params": key, "dropout": key}, *args, **kw)
    return to_numpy(dict(variables), dtype)


def load_port(port_module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load a JAX variable tree into a port module, strictly."""
    port_module.load_state_dict(state_dict_from_jax(
        variables["params"], variables.get("batch_stats", {})), strict=True)
    return port_module


def as_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def assert_close(got, want, rtol, atol, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)
