"""Shared set-up of the parity tests of the port's test-time adaptation
(``tests/test_torch_tta.py``, ``tests/test_torch_tta_sar.py``): Tent,
EATA and SAR of ``stil_tta_torch.tta.adapt`` against the JAX package's,
at tiny size: ``config_dvm_STiL dataset=synthetic_dvm models=resnet18``
with small widths, 32² images, float64, batch 8 over 16 test samples and
``tta_steps=2``. Every batch has 8 rows: a ragged tail would double the
JAX compilations of each case (one per batch shape), and the test suite
runs close to its time limit. The tail batch goes through the same code
(``tta_batches``, then shape-agnostic steps), and its BN-adapt pass is
held to JAX at 20 samples in ``tests/test_torch_slice.py``.

Every strategy starts with the BN-statistics phase, whose parity with
the JAX package is held in ``tests/test_torch_slice.py``. Here both sides
start their second phase from the same statistics: the port runs its
whole ``adapt``, and the JAX side runs its second phase
(``tent._tent_phase``, ``methods.eata_adapt``, ``methods.sar_adapt``, as
``stil_tta_tpu.tta.adapt`` dispatches them) from the port's re-estimated
statistics, which saves the JAX stats pass's two compilations per case.
The weights are the port's seeded random weights, carried into the JAX
tree by the JAX package's own converter.

Both sides compute the head's logits in float32 (the JAX methods cast
``out_m`` to float32), so the gradients agree to float32 rounding, about
1e-7 of their size. Adam divides each moment by its root mean square, so
where a gradient is near Adam's eps (1e-8) that rounding moves the update
by a visible share of lr; elsewhere an update is about ±lr per step. So
the adapted BN weights and biases are compared as updates in units of
lr, each within ``UPDATE_TOL`` lr (an update over 4 steps is up to 4 lr);
``prob_m`` of the eval step after adaptation within ``PROB_TOL``. Every
other parameter is bitwise unchanged.

The margins are set so that the filters make choices at this size: with
random weights over 4 classes the entropies lie at 0.67-0.88 of ln 4,
beyond the default margin (0.4 ln 4), so ``tta_e_margin_scale`` is 0.805,
inside that spread and at least 8e-3 of ln 4 from every entropy; and
``tta_d_margin`` 0.99, inside the spread of the predictions' cosine to
their running mean.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stil_tta_torch.config import load_config
from stil_tta_torch.data.loader import DeviceCache
from stil_tta_torch.train.convert import export_state_dict
from stil_tta_torch.train.test import build_algo, load_test_split
from stil_tta_torch.tta import adapt, estimate_bn_stats
from stil_tta_torch.tta.tent import bn_parameters
from stil_tta_tpu.algorithms.stil import STiL as JaxSTiL
from stil_tta_tpu.config import load_config as jax_load_config
from stil_tta_tpu.data.datasets import load_sources as jax_load_sources
from stil_tta_tpu.data.loader import DeviceCache as JaxDeviceCache
from stil_tta_tpu.train.convert import convert_torch_state_dict
from stil_tta_tpu.tta import methods as jax_methods
from stil_tta_tpu.tta.tent import _tent_phase as jax_tent_phase
from tests.torch_parity import to_numpy, x64

FIELD_LENGTHS = [5, 4, 2, 1, 1, 1]
OVERRIDES = [
    "dataset=synthetic_dvm", "models=resnet18", "batch_size=8",
    "img_size=32", "synthetic_image_size=40", "synthetic_test=16",
    "num_classes=4", "tabular_embedding_dim=32",
    "multimodal_embedding_dim=32", "tabular_transformer_num_layers=1",
    "projection_dim=8", "test=True", "tta=True", "tta_steps=2",
    "tta_e_margin_scale=0.805", "tta_d_margin=0.99",
    "enable_progress_bar=false",
]
LR = 1e-4
UPDATE_TOL = 1e-3    # in units of lr
PROB_TOL = 1e-6
# case -> (strategy, extra knobs)
CASES = {
    "tent": ("tent", {}),
    "eata": ("eata", {}),
    "eata_fisher": ("eata", {"tta_fisher_alpha": 1.0,
                             "tta_fisher_samples": 8}),
    "sar": ("sar", {}),
    "sar_reset": ("sar", {"tta_reset_constant": 100.0}),
}
JAX_PHASE2 = {"tent": jax_tent_phase, "eata": jax_methods.eata_adapt,
              "sar": jax_methods.sar_adapt}


@dataclasses.dataclass
class _State:
    params: dict
    batch_stats: dict


def cfg_for(loader, strategy: str, **extra):
    cfg = loader("config_dvm_STiL", OVERRIDES + [f"tta_strategy={strategy}"]
                 + [f"{k}={v}" for k, v in extra.items()])
    cfg.field_lengths = list(FIELD_LENGTHS)
    return cfg


def _port(case: str, **extra):
    """The port's algo on the CPU at float64, its config and test cache."""
    strategy, knobs = CASES[case]
    cfg = cfg_for(load_config, strategy, **knobs, **extra)
    src = load_test_split(cfg)
    algo = build_algo(cfg, src.field_lengths, device="cpu",
                      dtype=torch.float64)
    return cfg, algo, DeviceCache(src, device="cpu").as_dict()


def make_reference(tmp_dir) -> dict:
    """The port's seeded weights as a ``.ckpt``; the JAX algo, test cache
    and eval step; and the JAX variables holding those weights with the
    port's re-estimated BN statistics."""
    cfg, algo, cache = _port("tent")
    ckpt = tmp_dir / "init.ckpt"
    torch.save({"state_dict": algo.net.state_dict(),
                "hyper_parameters": {"algorithm_name": "STiL"}}, ckpt)
    estimate_bn_stats(cfg, algo, cache)
    adapted_sd = {k: v.numpy() for k, v in algo.net.state_dict().items()}
    with x64():
        jcfg = cfg_for(jax_load_config, "tent")
        src = jax_load_sources(jcfg)["test"]
        jalgo = JaxSTiL(jcfg, FIELD_LENGTHS, dtype=jnp.float64)
        key = jax.random.key(0)
        shapes = jax.eval_shape(
            lambda img, tab: jalgo.net.init(
                {"params": key, "dropout": key}, img, tab, train=False),
            jnp.zeros((2, 32, 32, 3)), jnp.asarray(src.tabular[:2]))
        zeros = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float64), shapes)
        variables, _ = convert_torch_state_dict(adapted_sd, zeros)
        variables = jax.tree_util.tree_map(jnp.asarray, variables)
    return {"ckpt": str(ckpt), "variables": variables, "jax_algo": jalgo,
            "jax_cache": JaxDeviceCache(src).as_dict(),
            "jax_eval": jalgo.make_eval_step()}


def jax_adapted(ref: dict, case: str):
    """JAX's second phase of ``case`` from the reference state: the
    adapted params in the port's layout, and prob_m of the first 8 test
    samples."""
    strategy, knobs = CASES[case]
    with x64():
        cfg = cfg_for(jax_load_config, strategy, **knobs)
        v = ref["variables"]
        state = _State(v["params"], v["batch_stats"])
        adapted = JAX_PHASE2[strategy](cfg, ref["jax_algo"], state,
                                       ref["jax_cache"])
        idx = jnp.arange(8, dtype=jnp.int32)
        prob_m = np.asarray(ref["jax_eval"](
            adapted.params, adapted.batch_stats, ref["jax_cache"],
            idx)["prob_m"])
    return export_state_dict(to_numpy(adapted.params)), prob_m


def check_case(ref: dict, case: str) -> None:
    """The port's whole ``adapt`` of ``case`` against JAX's, from the
    same weights."""
    want, want_prob = jax_adapted(ref, case)
    cfg, algo, cache = _port(case, checkpoint=ref["ckpt"])
    before = {k: v.detach().clone()
              for k, v in algo.net.named_parameters()}
    counts = adapt(cfg, algo, cache)
    prob_m = algo.make_eval_step()(cache, torch.arange(8))["prob_m"]
    assert counts["stats_batches"] == 2 and counts["steps"] == 4, counts
    bn = dict(bn_parameters(algo.net))
    moved = 0.0
    for k, p in algo.net.named_parameters():
        if k not in bn:
            assert torch.equal(p, before[k]), k   # bitwise unchanged
            continue
        got_upd = (p.detach() - before[k]).numpy() / LR
        want_upd = (want[k] - before[k].numpy()) / LR
        np.testing.assert_allclose(got_upd, want_upd, rtol=0,
                                   atol=UPDATE_TOL, err_msg=k)
        moved = max(moved, float(np.abs(got_upd).max()))
    np.testing.assert_allclose(prob_m.numpy(), want_prob, rtol=0,
                               atol=PROB_TOL)
    if case == "sar_reset":
        # every step whose second filter keeps a sample resets to the
        # starting point, and after a reset Adam starts afresh: a step
        # that keeps none has no moments to move by
        assert counts["resets"] > 0 and moved == 0.0, (counts, moved)
    else:
        assert moved > 0.5, moved   # the BN affine parameters adapted
    if case != "tent":
        # the filters kept some samples and dropped others
        assert 0 < counts["selected"] < 2 * 16, counts
