"""The data-parallel slice of the port against the JAX package on a
2-device mesh: a STiL train step, train-mode BatchNorm and serving.

The port runs in two gloo ranks (``tests/torch_parity.py:dp_port_job``,
two processes started at once), while this process runs the JAX side:

- one STiL train step of ``tests/test_torch_train_step.py``'s setup
  (ResNet-18 at 32x32, 4 labelled + 12 unlabelled rows, float64, Adam,
  DA on, augmentation, corruption and the fusion's dropout off, the
  case-3 routing draw handed to the port) from one state, the JAX step
  sharded over ``create_mesh(2)``, the port's over its 2-rank mesh. This
  is the file's one JAX step compile. Tolerances are the single-process
  test's: float64 sums in other orders, rtol 1e-8 on the losses, atol
  1e-9 on parameters moved by Adam steps of lr 1e-3;
- train-mode BatchNorm, the port's ``BatchNorm2d`` (its plain sums on CPU
  tensors) sharded over the 2 ranks against JAX's ``bn_train`` custom VJP
  on the global batch, at float32: forward, dx, dweight, dbias and the
  running statistics, within 1e-4 of each result's largest magnitude
  (float32 sums in two orders, as ``tests/test_torch_bn_train.py``);
- ``Predictor`` at batch 5 (6 on 2 ranks) over 10 rows, the tail padded,
  against the JAX ``Predictor(mesh=create_mesh(2))``: float32
  probabilities on both sides, the JAX view x * (1/255) one float32
  rounding from the port's x / 255, hence atol 1e-6.
"""

import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stil_tta_torch.algorithms.stil import STiL
from stil_tta_torch.config import load_config
from stil_tta_torch.train.convert import train_state_from_jax
from stil_tta_tpu.algorithms.stil import STiL as JaxSTiL
from stil_tta_tpu.config import load_config as jax_load_config
from stil_tta_tpu.models import backbones as jbackbones
from stil_tta_tpu.ops.batch_norm import bn_train
from stil_tta_tpu.parallel.mesh import batch_sharding, create_mesh, replicate
from stil_tta_tpu.serve import Predictor as JaxPredictor
from tests.test_torch_train_step import (B_L, B_U, FL, OVERRIDES,
                                         PARAM_ATOL, _cfg, _compare_states,
                                         _data, _jax_state, _mask_rand,
                                         _no_fusion_dropout,
                                         _port_initial_state)
from tests.torch_parity import assert_close, x64
from tests.torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64
N_SERVE, SERVE_BATCH = 10, 5


def _bn_inputs():
    rng = np.random.RandomState(7)
    x = (rng.randn(4, 6, 6, 16) * 2.0 + 0.7).astype(np.float32)   # NHWC
    g = rng.randn(4, 6, 6, 16).astype(np.float32)
    return x, g, (rng.rand(16) + 0.5).astype(np.float32), \
        rng.randn(16).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The port's 2-rank results and the JAX package's on a 2-device
    mesh, from one job's inputs."""
    def dropfree(**kw):
        kw.update(attn_drop=0.0, proj_drop=0.0, drop_path=0.0)
        return real_layer(**kw)

    real_layer = jbackbones.MITransformerLayer
    tmp = tmp_path_factory.mktemp("dp")
    (jcl, cl), (jcu, cu) = _data()
    x, g, w, b = _bn_inputs()
    with x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbackbones, "MITransformerLayer", dropfree)
        jalgo = JaxSTiL(_cfg(jax_load_config), FL, dtype=jnp.float64)
        jalgo._views = lambda key, il, tl, iu, tu, ml, mu: (il, tl, iu, tu)
        algo = STiL(_cfg(load_config), FL, dtype=F64, device="cpu")
        _no_fusion_dropout(algo.net)
        j0 = _jax_state(jalgo, _port_initial_state(algo))
        carried = train_state_from_jax(j0)
        step = {"overrides": OVERRIDES, "field_lengths": FL,
                "repeat_ratio": 3, "carried": carried}
        images = cl["images"].numpy()[np.arange(N_SERVE) % B_L]
        tabular = cu["tabular"].numpy()[:N_SERVE]
        job = {"bn": {"x": _nchw(x), "g": _nchw(g),
                      "weight": torch.from_numpy(w),
                      "bias": torch.from_numpy(b)},
               "step": dict(step, cl=cl, cu=cu, b_l=B_L, b_u=B_U, epoch=1,
                            mask=torch.tensor(_mask_rand(j0))),
               "serve": dict(step, batch_size=SERVE_BATCH, images=images,
                             tabular=tabular)}
        path = tmp / "job.pt"
        torch.save(job, path)
        address = f"tcp://localhost:{_free_port()}"
        procs = [subprocess.Popen(
            [sys.executable, "-c", "from tests.torch_parity import "
             f"dp_port_job; dp_port_job({r}, 2, {address!r}, {str(path)!r})"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        try:
            mesh = create_mesh(2)
            bsh = batch_sharding(mesh)
            jstep = jax.jit(jalgo.make_train_step().__wrapped__)
            jstate = jstep(replicate(mesh, j0), replicate(mesh, jcl),
                           replicate(mesh, jcu),
                           jax.device_put(jnp.arange(B_L, dtype=jnp.int32),
                                          bsh),
                           jax.device_put(jnp.arange(B_U, dtype=jnp.int32),
                                          bsh),
                           jnp.asarray(1, jnp.int32))
            jprobs = JaxPredictor(jalgo, j0, batch_size=SERVE_BATCH,
                                  mesh=mesh)(images, tabular)
        finally:
            logs = []
            for p in procs:
                try:
                    logs.append(p.communicate(timeout=600)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    logs.append(p.communicate()[0])
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    x2d = jnp.asarray(x.reshape(-1, 16))
    (y, mean, var), vjp = jax.vjp(
        lambda x, s, b: bn_train(x, s, b, 1e-5), x2d, jnp.asarray(w),
        jnp.asarray(b))
    dx, dw, db = vjp((jnp.asarray(g.reshape(-1, 16)), jnp.zeros_like(mean),
                      jnp.zeros_like(var)))
    n = x2d.shape[0]
    jbn = {"y": np.asarray(y).reshape(x.shape),
           "dx": np.asarray(dx).reshape(x.shape), "dweight": np.asarray(dw),
           "dbias": np.asarray(db),
           # torch's momentum 0.1 from zeros and ones, Bessel on the var
           "running_mean": 0.1 * np.asarray(mean),
           "running_var": 0.9 + 0.1 * np.asarray(var) * n / (n - 1)}
    port = torch.load(str(path) + ".out", weights_only=False)
    return {"port": port, "jax_step": jstate, "jax_bn": jbn,
            "jax_probs": np.asarray(jprobs)}


def test_two_rank_stil_step_matches_the_sharded_jax_step(both):
    """Every parameter, BN running statistic, prototype sum, the DA ring
    and the loss sums of the port's 2-rank step against the JAX step
    sharded over a 2-device mesh; the two ranks bitwise equal."""
    jstate = both["jax_step"]
    port = both["port"]["step"]
    pstate = port["state"]
    assert pstate.step == 1 == int(jstate.step)
    assert len(set(port["digests"])) == 1
    _compare_states(jstate, pstate, param_atol=PARAM_ATOL)


@pytest.mark.parametrize("what", ["y", "dx", "dweight", "dbias",
                                  "running_mean", "running_var"])
def test_two_rank_batch_norm_matches_bn_train_on_the_global_batch(both,
                                                                    what):
    got = both["port"]["bn"][what]
    if got.dim() == 4:
        got = got.permute(0, 2, 3, 1)
    want = both["jax_bn"][what]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max(), err_msg=what)


def test_two_rank_predictor_matches_the_jax_mesh_predictor(both):
    probs = both["port"]["serve"]
    want = both["jax_probs"]
    assert probs.shape == want.shape == (N_SERVE, 4)
    assert_close(probs, want, 0, 1e-6)
    np.testing.assert_array_equal(probs.argmax(1), want.argmax(1))
    # the tail batch (rows 6..9) was padded to 6 rows on both sides
    assert N_SERVE % (-(-SERVE_BATCH // 2) * 2)
