"""The plain versions of the port's conv-chain kernels
(``stil_tta_torch/ops/conv_chain.py``) against the Pallas bodies of
``tools/bench_conv_probe.py`` (``_chain_kernel``,
``_chain_scratch_kernel``, ``_join_kernel``), run here through a
``pl.pallas_call(..., interpret=True)`` built around each body, on the
same numpy inputs.

Shapes: K = 256, N = 64, NJ = 256 as in the probe, M = 2048 in row tiles
of 512, and a ragged M = 1000 (the Pallas grid takes tiles of 200 there,
the port any M). Tolerances (``bench_conv_probe.compare``): the bf16
outputs equal except at most 0.1% of elements, each within one bf16 ulp
(values that cancel to below 2^-10 of the largest count with the ulp at
that floor; the join's dy, rounded twice, within two ulps of the larger
of dy and dx): both sides sum exact bf16 products in float32, in
different orders, and a sum near a rounding boundary rounds to the
neighbouring bf16 value. The float32 sums within 1e-5 of their columns'
sums of absolute terms. The probe's own XLA chain
(``xla_chain``) computes the prologue in float32 and is not the
reference: it differs from the Pallas body in about a fifth of the h
values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stil_tta_torch.ops.conv_chain import (conv_bwd_join, conv_chain,
                                           conv_chain_scratch)
from stil_tta_torch.tools.bench_conv_probe import (SUM_TOL, compare,
                                                   make_inputs,
                                                   make_join_inputs, passes)
from tests.torch_parity import one_torch_thread  # noqa: F401
from tools import bench_conv_probe as jax_probe

K, N, NJ = 256, 64, 256
F32 = jnp.float32


def _jax(t: torch.Tensor) -> jax.Array:
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _torch(a: jax.Array, bf16: bool = False) -> torch.Tensor:
    t = torch.from_numpy(np.array(a.astype(F32)))
    return t.to(torch.bfloat16) if bf16 else t


def _rows(tm, width):
    return pl.BlockSpec((tm, width), lambda i: (i, 0))


def _whole(rows, cols):
    return pl.BlockSpec((rows, cols), lambda i: (0, 0))


def pallas_chain(body, raw, w, a, b, tm):
    """``body`` (the chain or the chain-scratch kernel) over a grid of
    row tiles of ``tm``, as ``pallas_chain_call`` and
    ``pallas_chain_scratch_call`` launch it."""
    m = raw.shape[0]
    scratch = ([pltpu.VMEM((1, N), F32)] * 2
               if body is jax_probe._chain_scratch_kernel else [])
    y, s1, s2 = pl.pallas_call(
        body, grid=(m // tm,),
        in_specs=[_rows(tm, K), _whole(K, N), _whole(2, K)],
        out_specs=[_rows(tm, N), _whole(1, N), _whole(1, N)],
        out_shape=[jax.ShapeDtypeStruct((m, N), jnp.bfloat16),
                   jax.ShapeDtypeStruct((1, N), F32),
                   jax.ShapeDtypeStruct((1, N), F32)],
        scratch_shapes=scratch, interpret=True,
    )(_jax(raw), _jax(w), jnp.stack([_jax(a), _jax(b)]))
    return _torch(y, bf16=True), _torch(s1[0]), _torch(s2[0])


def pallas_join(dy_up, w1, dy_res, x_raw, mu, tm):
    """``_join_kernel`` as ``pallas_bwd_join_call`` launches it."""
    m = dy_up.shape[0]
    outs = pl.pallas_call(
        jax_probe._join_kernel, grid=(m // tm,),
        in_specs=[_rows(tm, N), _whole(NJ, N), _rows(tm, NJ),
                  _rows(tm, NJ), _whole(1, NJ)],
        out_specs=[_rows(tm, NJ)] + [_whole(1, NJ)] * 3,
        out_shape=[jax.ShapeDtypeStruct((m, NJ), jnp.bfloat16)]
        + [jax.ShapeDtypeStruct((1, NJ), F32)] * 3,
        scratch_shapes=[pltpu.VMEM((1, NJ), F32)] * 3, interpret=True,
    )(*(_jax(t) for t in (dy_up, w1, dy_res, x_raw)), _jax(mu)[None, :])
    return (_torch(outs[0], bf16=True),) + tuple(_torch(s[0])
                                                for s in outs[1:])


# M and the Pallas tile: the probe's multiple of the tile, and a ragged M
SHAPES = [(2048, 512), (1000, 200)]


@pytest.mark.parametrize("m,tm", SHAPES)
@pytest.mark.parametrize("name", ["conv_chain", "conv_chain_scratch"])
def test_chain_plain_matches_pallas_body(name, m, tm):
    inputs = make_inputs("cpu", m=m)
    fn, body = {"conv_chain": (conv_chain, jax_probe._chain_kernel),
                "conv_chain_scratch": (conv_chain_scratch,
                                       jax_probe._chain_scratch_kernel)}[name]
    launches = fn.launches
    got = fn(*inputs)  # CPU tensors: the plain version
    assert fn.launches == launches
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (m, N)
    assert got[1].dtype == got[2].dtype == torch.float32
    assert got[1].shape == got[2].shape == (N,)
    check = compare(name, inputs, got, pallas_chain(body, *inputs, tm))
    assert passes(check) and check["sum_err_plain"] <= SUM_TOL, check


@pytest.mark.parametrize("m,tm", SHAPES)
def test_join_plain_matches_pallas_body(m, tm):
    inputs = make_join_inputs("cpu", m=m)
    launches = conv_bwd_join.launches
    got = conv_bwd_join(*inputs)
    assert conv_bwd_join.launches == launches
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (m, NJ)
    assert all(s.dtype == torch.float32 and s.shape == (NJ,)
               for s in got[1:])
    # the mask zeroes about half of dy, and the sums see it
    assert 0.3 < float((got[0] == 0).float().mean()) < 0.7
    check = compare("conv_bwd_join", inputs, got,
                    pallas_join(*inputs, tm))
    assert passes(check) and check["sum_err_plain"] <= SUM_TOL, check


def test_sums_from_f32_and_from_bf16_differ():
    """The two chain kernels differ only in where their sums read y: the
    scratch variant's sums are over the float32 y, so they differ from
    the chain's by bf16 rounding (about 2^-9 of a term), and y agrees."""
    inputs = make_inputs("cpu", m=512)
    y1, s1, q1 = conv_chain(*inputs)
    y2, s2, q2 = conv_chain_scratch(*inputs)
    assert torch.equal(y1, y2)
    assert not torch.equal(q1, q2)
    yf = y1.float()
    assert float(((s1 - s2).abs() / yf.abs().sum(0)).max()) < 2 ** -8
    assert float(((q1 - q2).abs() / q1).max()) < 2 ** -7
