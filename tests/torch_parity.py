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


# ---------------------------------------------------------------------------
# MMatch and Co-Training (tests/test_torch_cotrain.py, test_torch_mmatch.py)

MATCH_OVERRIDES = [
    "dataset=synthetic_dvm", "models=resnet18", "img_size=32",
    "num_classes=4", "tabular_embedding_dim=32",
    "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
    "projection_dim=8", "augmentation_rate=0.0", "corruption_rate=0.0",
    "start_epoch=0", "ema_momentum=0.9", "lr_eval=1e-3",
    "weight_decay_eval=1e-4", "saint_ff_dropout=0",
]


def match_cfg(loader, name: str, *extra, field_lengths=(5, 4, 2, 1, 1, 1)):
    """A comparison family's config at the parity tests' size."""
    cfg = loader(name, MATCH_OVERRIDES + list(extra))
    cfg.field_lengths = list(field_lengths)
    return cfg


def port_match_state(algo):
    """Seeded weights; an EMA backbone of other weights (where the family
    keeps one); random BatchNorm running statistics on both."""
    from stil_tta_torch.algorithms.base import init_weights
    from stil_tta_torch.ops.batch_norm import BatchNorm2d
    state = algo.init_state(seed=0)
    mods = list(state.net.modules())
    if state.ema is not None:
        init_weights(state.ema, torch.Generator().manual_seed(1))
        mods += list(state.ema.modules())
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for mod in mods:
            if isinstance(mod, BatchNorm2d):
                mod.running_mean.normal_(0, 0.05, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
    return state


def jax_match_state(jalgo, port_state, img: int, n_fields: int):
    """A JAX ``MatchState`` (float64) holding the port state's weights and
    EMA (the student's copy where the port keeps none, as the JAX init
    makes it), the JAX family's own buffers (``extra_state``), an empty
    DA ring where the config asks for one, and zero sums."""
    import jax.numpy as jnp
    from stil_tta_tpu.algorithms.base import DAState
    from stil_tta_tpu.algorithms.match_common import MatchState
    from stil_tta_tpu.ops.metrics import accuracy_init
    from stil_tta_tpu.train.convert import convert_torch_state_dict
    key = jax.random.key(0)
    shapes = jax.eval_shape(lambda: jalgo.net.init(
        {"params": key, "dropout": key}, jnp.zeros((2, img, img, 3)),
        jnp.zeros((2, n_fields)), train=False))
    target = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float64), dict(shapes))
    sd = {k: v.numpy() for k, v in port_state.net.state_dict().items()}
    variables, _ = convert_torch_state_dict(sd, target)
    ema = variables
    if port_state.ema is not None:
        ema, _ = convert_torch_state_dict(
            {"model." + k: v.numpy()
             for k, v in port_state.ema.state_dict().items()}, target)
    c = jalgo.num_classes
    z = lambda *s: jnp.zeros(s, jnp.float64)  # noqa: E731
    extra = to_numpy(jalgo.extra_state(key), np.float64)
    return MatchState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jalgo.tx.init(variables["params"]),
        ema_params=ema["params"], ema_batch_stats=ema["batch_stats"],
        rng=jax.random.key(5), step=jnp.zeros((), jnp.int32),
        da=(DAState(z(256, c), jnp.zeros((), jnp.int32))
            if bool(jalgo.cfg.DA) else None),
        extra={k: jnp.asarray(v) for k, v in extra.items()},
        acc_train=accuracy_init(), acc_train_u=accuracy_init(),
        log_sums={k: z() for k in jalgo.LOG_KEYS}, log_count=z())


def compare_match_states(jstate, pstate, log_keys, loss_rtol=1e-8,
                         ratio_rtol=2e-7, param_atol=1e-9):
    """Logs, the net's and the EMA's tensors, ``extra``, the DA ring and
    the train accuracies of a port state against a JAX ``MatchState``.
    The ``*_ratio`` logs are float32 means on the port's side."""
    from stil_tta_torch.train.convert import train_state_from_jax
    want = train_state_from_jax(jstate)
    for k in log_keys:
        rtol = ratio_rtol if k.endswith("_ratio") else loss_rtol
        assert_close(pstate.log_sums[k], np.asarray(jstate.log_sums[k]),
                     rtol, 1e-12, k)
    pairs = [("net", pstate.net.state_dict())]
    if pstate.ema is not None:
        pairs.append(("ema", pstate.ema.state_dict()))
    for name, got in pairs:
        assert set(got) == set(want[name]), name
        for k, v in want[name].items():
            if k.endswith("num_batches_tracked"):
                continue   # the JAX package keeps no BN counters
            assert_close(got[k], v.numpy(), 0, param_atol, f"{name} {k}")
    assert set(pstate.extra) == set(want["extra"])
    for k, v in want["extra"].items():
        if isinstance(v, int):
            assert pstate.extra[k] == v, k
        else:
            assert_close(pstate.extra[k], v.numpy(), 1e-9, 1e-12, k)
    if want["da"] is not None:
        assert_close(pstate.da.queue, want["da"][0].numpy(), 1e-9, 1e-12,
                     "da")
        assert pstate.da.ptr == want["da"][1]
    for k in ("acc_train", "acc_train_u"):
        for f in ("correct", "total"):
            assert float(getattr(getattr(pstate, k), f)) == \
                float(getattr(getattr(jstate, k), f)), (k, f)
